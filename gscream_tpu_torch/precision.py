"""Numerical-precision policy (counterpart of ``gscream_tpu/precision.py``).

Reduced-precision matmuls are a correctness cliff for this model, not a
quality knob: with bf16-input matmuls the Scaffold-GS training loop
collapses within ~50 iterations (BASELINE.md:91-96).  On the GPU the
equivalent hazard is TF32: PyTorch keeps float32 matmuls in full float32
by default, but cuDNN convolutions run in TF32 unless told otherwise.
Both switches are pinned off here, at import and again by every entry
point through :func:`ensure_fp32_matmuls`, which also has cuDNN pick
deterministic algorithms for the SSIM convolutions: a training run
resumed from a checkpoint must replay the uninterrupted run bit for bit.
"""
from __future__ import annotations

import torch


def ensure_fp32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


ensure_fp32_matmuls()
