"""Training metrics: JSONL, mirrored to TensorBoard where it imports
(counterpart of ``gscream_tpu/train/metrics_log.py``; the reference's
``training_report``, train.py:644-708).

Scalars go to ``metrics.jsonl`` always — greppable, no dependency — and
to ``<out>/tb`` when ``torch.utils.tensorboard`` imports (and
``tensorboard`` is on), as do the image grids of :meth:`log_images`.
With ``wandb_project`` set, scalars are mirrored to wandb where it
imports (reference train.py:309-330); it is absent on the card's machine.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, out_dir: str, tensorboard: bool = True,
                 wandb_project: str = ""):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project=wandb_project,
                           name=os.path.basename(out_dir.rstrip("/")),
                           dir=out_dir)
                self._wandb = wandb
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(dict(scalars), step=step)

    def log_images(self, step: int, images) -> None:
        """TensorBoard image grids (reference training_report,
        train.py:668-683: render, GT and error per evaluation view).

        ``images``: name → (H,W,3) or (3,H,W) float [0, 1] array.  No-op
        without TensorBoard (the JSONL stays scalar-only)."""
        if self._tb is None:
            return
        for name, img in images.items():
            arr = np.asarray(img)
            if arr.ndim == 3 and arr.shape[0] not in (1, 3):
                arr = arr.transpose(2, 0, 1)       # HWC → CHW
            self._tb.add_image(name, np.clip(arr, 0.0, 1.0), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
