"""Device selection shared by every entry point of the port.

Entry points take ``device="cuda"`` by default and raise when no GPU is
present; the plain PyTorch versions of the kernels run only when the
caller asks for the CPU explicitly (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import precision  # noqa: F401  (pins fp32 matmuls on import)


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gscream_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


_CONSTANTS: Dict = {}


def device_constant(values, device) -> torch.Tensor:
    """A small float32 constant on ``device``, made once: a copy from the
    host inside a training step would make the host wait for the
    device."""
    key = (tuple(values), str(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=torch.float32,
                                       device=device)
    return _CONSTANTS[key]
