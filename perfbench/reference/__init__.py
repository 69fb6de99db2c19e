"""The benchmark's plain reference: GScream's training step and render in
plain PyTorch, float32, with TF32 off.

It imports neither JAX nor any package of this repository: it is the
yardstick the program under test is held against, and later changes to
the program do not reach it.  It follows the published description of
Scaffold-GS and GScream; each departure is noted where it is made:

* ``model``: the anchors, the four decoder MLPs and their seeded
  initialisation, the neural-gaussian decode;
* ``project``: EWA splatting (the 3D Gaussian Splatting rasterizer's
  preprocess);
* ``blend``: per-pixel front-to-back alpha blending of colour, depth and
  uncertainty, tile by tile, with its vector-Jacobian product;
* ``losses``: GScream's masked RGB + SSIM and scale/shift depth terms;
* ``attention``: the bidirectional cross-attention and its token draws;
* ``optim``: Adam with the per-group learning-rate schedules;
* ``draws``: the training loop's host draws (view order, boxes);
* ``step``: one training iteration from these parts.
"""
