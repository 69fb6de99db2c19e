"""gscream_tpu_torch — the PyTorch/CUDA port of ``gscream_tpu``.

The JAX package ``gscream_tpu`` is the reference; this package mirrors its
module layout and public names so each function has an obvious
counterpart, and runs on an NVIDIA Hopper GPU (sm_90a).  Every Pallas
kernel of the JAX package on a ported path becomes a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``; each has a plain PyTorch twin in the same module, which is
what runs when the tensors lie on the CPU.

Ported so far: the render (serving) path — anchor decode, EWA
projection, row-tight tile binning and the tile forward blend —
reached through ``train.render_sets.render_set`` and ``render_torch.py``;
and one phase-1 training step, ``train.step.train_step``: the
rasterizer's analytic backward (tile backward, gradient unpack,
per-gaussian segment reduction), the losses, the masked Adam and the
densification statistics.

Subpackages
-----------
- ``gscream_tpu_torch.cameras``  camera model + projection matrices
- ``gscream_tpu_torch.config``   typed config tree (copy of the JAX one)
- ``gscream_tpu_torch.data``     COLMAP / SPIN-NeRF readers, PLY, spiral
- ``gscream_tpu_torch.ops``      projection, binning, emission,
  rasterizer and shuffle kernels, losses, SSIM, KNN
- ``gscream_tpu_torch.model``    Scaffold-GS state, MLP decoders, model IO,
  densification statistics
- ``gscream_tpu_torch.train``    capacity tiers, render sets, train state
  (Adam), the phase-1 train step

Nothing here imports ``jax`` or ``gscream_tpu``.
"""

__version__ = "0.1.0"
