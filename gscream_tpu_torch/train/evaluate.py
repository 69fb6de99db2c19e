"""Evaluation: PSNR / SSIM / LPIPS, full and masked → results.json
(counterpart of ``gscream_tpu/train/evaluate.py`` and of the root
``evaluate.py``'s disk-artifact helpers).

The reference ``evaluate()`` (train.py:905-992) compares the test
split's renders with ground truth by PSNR, the kornia-style ``my_ssim``
and VGG-LPIPS, plus the *masked* variants over the object-removal region
(``test_label`` masks resized to the render size, train.py:895-901), and
writes ``results.json`` and ``per_view.json`` in its format.  Every pair
is scored on ``device`` (the card unless ``device="cpu"`` is given).
Without LPIPS weights the summary holds ``"LPIPS": null`` and no view
has an LPIPS key.

PIL and imageio are imported only where they are needed: masks resize
with PIL's LANCZOS, and PNGs are read by imageio where it imports, else
by the port's own reader (``utils/png.py``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..metrics.lpips import lpips, lpips_available
from ..ops.losses import psnr
from ..ops.ssim import my_ssim


@torch.no_grad()
def evaluate_pairs(renders: List[np.ndarray], gts: List[np.ndarray],
                   masks: Optional[List[np.ndarray]] = None,
                   names: Optional[List[str]] = None,
                   device="cuda") -> Dict:
    """renders/gts: (3,H,W) float arrays in [0, 1]; masks: (1,H,W) or
    None per view."""
    dev = resolve_device(device)
    have_lpips = lpips_available()
    per_view: Dict[str, Dict[str, float]] = {}
    agg: Dict[str, List[float]] = {}

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    for i, (r, g) in enumerate(zip(renders, gts)):
        name = names[i] if names else f"{i:05d}"
        r_t, g_t = t(r), t(g)
        row = {"PSNR": float(psnr(r_t, g_t)),
               "SSIM": float(my_ssim(r_t, g_t))}
        if have_lpips:
            row["LPIPS"] = float(lpips(r_t, g_t))
        if masks is not None and masks[i] is not None:
            m = t(masks[i])
            row["PSNR_masked"] = float(psnr(r_t, g_t, m))
            row["SSIM_masked"] = float(my_ssim(r_t, g_t, m))
            if have_lpips:
                row["LPIPS_masked"] = float(lpips(r_t, g_t, m[0]))
        per_view[name] = row
        for k, v in row.items():
            agg.setdefault(k, []).append(v)

    summary = {k: float(np.mean(v)) for k, v in agg.items()}
    if not have_lpips:
        summary["LPIPS"] = None   # reported as unavailable, never wrong
    return {"summary": summary, "per_view": per_view}


def write_results(out_dir: str, results: Dict, method: str = "ours") -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump({method: results["summary"]}, f, indent=2)
    with open(os.path.join(out_dir, "per_view.json"), "w") as f:
        json.dump({method: results["per_view"]}, f, indent=2)


def _read_image(path: str) -> np.ndarray:
    """PNG → (3,H,W) float32 in [0, 1]."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        from ..utils.png import read_png
        arr = read_png(path)
    else:
        arr = np.asarray(imageio.imread(path))
    arr = np.asarray(arr, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, -1)
    return arr[..., :3].transpose(2, 0, 1)


def load_test_label_masks(source_path: str, n: int,
                          size: Optional[tuple] = None
                          ) -> Optional[List[np.ndarray]]:
    """The reference's masked-evaluation masks (train.py:895-899):
    ``images_4/test_label/out_%05d.png`` for render idx → ``out_{idx+1}``
    (1-indexed), resized to the render size with LANCZOS, binarized
    ``> 0``.  None when the directory or a file is absent."""
    mask_dir = os.path.join(source_path, "images_4", "test_label")
    if not os.path.isdir(mask_dir):
        return None
    from PIL import Image
    masks = []
    for idx in range(n):
        p = os.path.join(mask_dir, "out_%05d.png" % (1 + idx))
        if not os.path.exists(p):
            return None
        m = Image.open(p)
        if size is not None:
            m = m.resize(size, Image.LANCZOS)
        arr = np.asarray(m, np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        masks.append((arr > 0).astype(np.float32)[None])   # (1,H,W)
    return masks


def find_method_dirs(model_path: str, split: str) -> List[str]:
    """``<model>/<split>`` when it holds ``renders/`` (this port's and the
    JAX package's layout), else each ``<model>/<split>/<method>`` that
    does (the reference's)."""
    base = os.path.join(model_path, split)
    if os.path.isdir(os.path.join(base, "renders")):
        return [base]
    out = []
    if os.path.isdir(base):
        for method in sorted(os.listdir(base)):
            if os.path.isdir(os.path.join(base, method, "renders")):
                out.append(os.path.join(base, method))
    return out


def evaluate_dir(method_dir: str, source_path: str = "",
                 method: str = "ours", device="cuda") -> Dict:
    """renders/ + gt/ (+ test_label masks) → results.json and
    per_view.json beside them."""
    rdir = os.path.join(method_dir, "renders")
    gdir = os.path.join(method_dir, "gt")
    names = sorted(f for f in os.listdir(rdir) if f.endswith(".png"))
    renders = [_read_image(os.path.join(rdir, f)) for f in names]
    gts = [_read_image(os.path.join(gdir, f)) for f in names]
    masks = None
    if source_path and renders:
        h, w = renders[0].shape[1:]
        masks = load_test_label_masks(source_path, len(renders), (w, h))
    results = evaluate_pairs(renders, gts, masks, names=names, device=device)
    write_results(method_dir, results, method=method)
    return results
