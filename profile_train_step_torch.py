#!/usr/bin/env python3
"""Wall-clock and trace profile of the port's whole ``train_step``
(counterpart of ``scripts/profile_train_step.py``).

Loads a trained model (``<model_dir>/point_cloud/``, a mid-list camera
of its ``cameras.json``, the optimizer settings of its ``cfg.json``), or
without one ``bench_torch.py``'s synthetic scene at 1008×567 (30,000
anchors, seed 0), sizes the instance capacity as the training loop
would from a counting pass (``bench_torch._count_instances`` and
``_capacity``), and times ``train/step.py::train_step`` for ``iters``
calls after a warm-up, each block ended by a device sync, in three
variants: phase 1, phase 1 without the densification statistics, and
phase 2 with cross-attention.  Then it times the loss head alone
(``train/step.py::loss_terms`` on random images at the same shapes, for
a reference view and another): forward, and forward+backward through
``torch.autograd``.  ``GSCREAM_TRACE=<dir>`` records each variant's
timed block to ``<dir>/<label>/trace.json`` (``utils/trace.py``), which
``trace_summary_torch.py`` summarizes.

The port's Adam updates the parameters and moments in place, so the
state advances from call to call: each call starts from the state the
last one left (the JAX script calls its functional step on one state).
Each variant starts again from the loaded model's state (a
``StatePool`` snapshot restored before its warm-up).  A step whose
instance demand overflows the capacity writes no state, and the first
Adam steps can raise the demand past the counted tier (they do on the
bench scene at 1008×567); so where the warm-up or a timed step
overflowed, the variant is run again from the model's state at the tier
the training loop would re-run it at (``train/loop.py::overflow_tier``),
which the later variants keep, and stderr says so.

It runs on the card; ``--device cpu`` runs the plain PyTorch versions
of the kernels instead.  Without a card and without that flag it
raises.  Usage::

    python3 profile_train_step_torch.py [model_dir] [iters] [--device cpu]

(defaults ``output/synth_spin30k`` and 10).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

# the synthetic scene without a trained model: bench.py's at the
# flagship resolution, as the JAX script's fallback
SYNTHETIC = dict(width=1008, height=567, n_anchors=30000)

VARIANTS = (
    ("train_step phase1",
     dict(use_crossattn=False, accumulate=True, feat_frozen=False)),
    ("train_step phase1 no-stats",
     dict(use_crossattn=False, accumulate=False, feat_frozen=False)),
    ("train_step phase2 crossattn",
     dict(use_crossattn=True, accumulate=False, feat_frozen=True)),
)


def load_model(model, dev):
    """(ScaffoldConfig, ScaffoldState, Camera, width, height,
    OptimConfig, model iteration) of ``model``, or of the synthetic
    scene where ``model`` holds no ``point_cloud/``."""
    from gscream_tpu_torch.config import OptimConfig, load_config
    opt = OptimConfig()
    if os.path.isdir(os.path.join(model, "point_cloud")):
        from gscream_tpu_torch.cameras import make_camera_from_c2w
        from gscream_tpu_torch.model.io import load_trained_scaffold
        scaffold, cfg, it0 = load_trained_scaffold(model, device=dev)
        with open(os.path.join(model, "cameras.json")) as f:
            cams = json.load(f)
        c = cams[len(cams) // 2]
        c2w = np.eye(4)
        c2w[:3, :3] = np.asarray(c["rotation"], np.float64)
        c2w[:3, 3] = np.asarray(c["position"], np.float64)
        w, h = int(c["width"]), int(c["height"])
        fovx = 2.0 * np.arctan(w / (2.0 * c["fx"]))
        fovy = 2.0 * np.arctan(h / (2.0 * c["fy"]))
        cam = make_camera_from_c2w(c2w, fovx, fovy, w, h, device=dev)
        run_cfg = os.path.join(model, "cfg.json")
        if os.path.exists(run_cfg):
            opt = load_config(run_cfg).optim
    else:
        import bench_torch
        w, h = SYNTHETIC["width"], SYNTHETIC["height"]
        cfg, scaffold, cam = bench_torch._bench_scene(
            w, h, SYNTHETIC["n_anchors"], 10, 0, dev)
        it0 = 0
        print(f"(no trained model at {model}; synthetic scene)")
    return cfg, scaffold, cam, w, h, opt, it0


def step_inputs(rng, w, h, dev):
    """The step's targets, drawn as the JAX script draws them: (gt,
    mask, depth, fg_box, cross_box)."""
    import torch

    def t(a):
        return torch.as_tensor(a, device=dev)
    gt = t(rng.random((3, h, w), np.float32))
    mask = t((rng.random((1, h, w)) > 0.8).astype(np.float32))
    depth = t(rng.random((1, h, w), np.float32))
    fg_box = torch.zeros((h, w), dtype=torch.float32, device=dev)
    cross_box = torch.tensor([10, 10, 266, 266], dtype=torch.int32,
                             device=dev)
    return gt, mask, depth, fg_box, cross_box


def step_fn(cfg, opt, cam, inputs, w, h):
    """``step(ts, capacity, **variant) -> (ts, StepAux)``: one
    ``train_step`` on ``inputs``."""
    from gscream_tpu_torch.train.step import train_step

    def step(ts, capacity, **kw):
        return train_step(ts, cam, *inputs, cfg=cfg, opt=opt, is_ref=False,
                          capacity=capacity, width=w, height=h,
                          white_bg=False, spatial_lr_scale=1.0,
                          precise_sort=True, **kw)
    return step


def time_variant(step, pool, start, ts, capacity, label, kw, iters, sync):
    """From the state ``start`` (restored into ``ts``'s tensors), one
    warm-up step, then ``iters`` timed steps inside ``maybe_trace(label)``
    ended by ``sync()``; run again at the loop's overflow tier while a
    step's demand overflowed.  Returns (state after the last step, the
    capacity that fitted, seconds per timed step)."""
    from gscream_tpu_torch.train.loop import overflow_tier
    from gscream_tpu_torch.train.step import aux_values
    from gscream_tpu_torch.utils.trace import maybe_trace
    while True:
        ts = pool.restore(start, ts)
        ts, aux = step(ts, capacity, **kw)
        auxes = [aux]
        sync()
        with maybe_trace(label):
            t0 = time.perf_counter()
            for _ in range(iters):
                ts, aux = step(ts, capacity, **kw)
                auxes.append(aux)
            sync()
            dt = (time.perf_counter() - t0) / iters
        demand = [int(aux_values(a)[2]) for a in auxes]
        if max(demand) <= capacity:
            return ts, capacity, dt
        new = overflow_tier(max(demand), capacity)
        print(f"# {label}: demand {demand} (warm-up, then the timed "
              f"steps) > tier {capacity}; run again at tier {new}",
              file=sys.stderr)
        capacity = new


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dir", nargs="?", default="output/synth_spin30k")
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernels)")
    args = ap.parse_args(argv)
    import torch
    import bench_torch
    from gscream_tpu_torch.device import resolve_device
    from gscream_tpu_torch.ops.rasterize_tiled import TiledOut
    from gscream_tpu_torch.precision import ensure_fp32_matmuls
    from gscream_tpu_torch.train.state import StatePool, init_train_state
    from gscream_tpu_torch.train.step import loss_terms

    dev = resolve_device(args.device)
    ensure_fp32_matmuls()
    iters = args.iters

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg, scaffold, cam, w, h, opt, it0 = load_model(args.model_dir, dev)
    ts = init_train_state(scaffold, cfg, 0)
    # emission demand at this view → the tier training would use
    n_inst, n_rows = bench_torch._count_instances(cfg, scaffold, cam, w, h)
    capacity = bench_torch._capacity(n_inst, n_rows)
    print(f"model iter {it0}  {w}x{h}  anchors "
          f"{scaffold.params.anchor.shape[0]}  instances {n_inst}  tier "
          f"{capacity}")

    rng = np.random.default_rng(0)
    inputs = step_inputs(rng, w, h, dev)
    step = step_fn(cfg, opt, cam, inputs, w, h)

    pool = StatePool()
    start = pool.snapshot(ts)
    for label, kw in VARIANTS:
        ts, capacity, dt = time_variant(step, pool, start, ts, capacity,
                                        label, kw, iters, sync)
        print(f"{label:34s} {dt*1e3:9.2f} ms  ({1.0/dt:.2f} it/s)")

    # the loss head alone at these shapes (rendered image -> loss)
    gt, mask, depth, fg_box, _ = inputs
    out_fake = TiledOut(
        color=torch.as_tensor(rng.random((h, w, 3), np.float32), device=dev),
        depth=torch.as_tensor(rng.random((h, w), np.float32), device=dev),
        uncertainty=torch.zeros((h, w), device=dev),
        final_t=torch.zeros((h, w), device=dev))

    for is_ref in (False, True):
        def fwd(o):
            with torch.no_grad():
                return loss_terms(o, gt, mask, depth, fg_box, opt, is_ref)[0]

        def fwd_bwd(o):
            leaves = [x.detach().requires_grad_() for x in o]
            loss = loss_terms(TiledOut(*leaves), gt, mask, depth, fg_box,
                              opt, is_ref)[0]
            return torch.autograd.grad(loss, leaves, allow_unused=True)
        for fn, nm in ((fwd, "fwd"), (fwd_bwd, "fwd+bwd")):
            fn(out_fake)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(out_fake)
            sync()
            dt = (time.perf_counter() - t0) / iters
            print(f"loss_terms is_ref={is_ref} {nm:10s} {dt*1e3:9.2f} ms")


if __name__ == "__main__":
    main()
