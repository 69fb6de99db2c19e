"""Training metrics: JSONL, mirrored to TensorBoard where it imports
(counterpart of ``gscream_tpu/train/metrics_log.py``; the reference's
``training_report``, train.py:644-708).

Scalars go to ``metrics.jsonl`` always — greppable, no dependency — and
to ``<out>/tb`` when ``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
