#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: rays/s per card, forward+backward,
at SPIN-NeRF resolution (counterpart of ``bench.py``).

Prints ONE JSON line with ``bench.py``'s keys::

  {"metric": "rays_per_s_fwd_bwd_1297x840", "value": N, "unit": "rays/s",
   "vs_baseline": N, "iter_ms": ..., "instances": ..., "overflow_demand":
   ..., "capacity": ..., "tight_cull": ..., "backend": "cuda:<card>",
   "sort": "precise", ...extras}

Workload (``bench.py:27-139``): a Scaffold-GS-scale synthetic scene —
30,000 anchors ~ N(0, 0.6) (numpy seed 0), feat_dim 32, 10 offsets,
voxel 0.01, anchor capacity 2^15, features ×0.3 and offsets ×0.5 normal
draws — decoded to neural gaussians, projected, binned and rasterized
forward and backward through the port's kernels under the loss
``mean|color| + 0.1·mean depth + 0.05·mean unc``, differentiated with
respect to the anchor parameters and the decoder MLPs.  The instance
capacity is the tier the training loop would settle at, from a two-pass
count (rect rows, then row-tight instances).  One warm-up call, then 10
timed calls ended by ``torch.cuda.synchronize()`` (inside
``maybe_trace("bench_<w>x<h>")``: ``GSCREAM_TRACE=<dir>`` writes a
``torch.profiler`` trace there).

``vs_baseline`` keeps ``bench.py``'s denominator: 7e7 rays/s, an
unmeasured estimate for the reference CUDA rasterizer
(diff-gaussian-rasterization) on an RTX 3090 at this scale; the
reference publishes no number.

Extras: ``GSCREAM_BENCH_EXTRA=1`` adds the 1008×567 figure; a trained
model directory (``--ply DIR`` or ``GSCREAM_BENCH_PLY``, default
``output/synth_spin30k``) holding ``point_cloud/`` adds its figure on a
mid-list camera of its ``cameras.json``.

Without a CUDA device, or on any error, it prints ``bench.py``'s error
record and exits non-zero; it never falls back to the CPU.  Usage:
``python3 bench_torch.py [--ply MODEL_DIR]``.
"""
import json
import os
import sys
import time
import traceback

import numpy as np

BASELINE_RAYS_PER_S = 7.0e7
METRIC = "rays_per_s_fwd_bwd_1297x840"
KEYS = ("metric", "value", "unit", "vs_baseline", "iter_ms", "instances",
        "overflow_demand", "capacity", "tight_cull", "backend", "sort")


def _bench_scene(width, height, n_anchors, k, seed, device="cuda"):
    """(ScaffoldConfig, ScaffoldState, Camera) of ``bench.py``'s scene:
    the anchors and the feature and offset draws from numpy seed
    ``seed``, the decoders from a torch.Generator seeded alike."""
    import torch
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig,
                                                  init_scaffold)
    rng = np.random.default_rng(seed)
    cfg = ScaffoldConfig(feat_dim=32, n_offsets=k, voxel_size=0.01,
                         capacity=1 << 15)
    pts = rng.normal(0, 0.6, (n_anchors, 3)).astype(np.float32)
    st = init_scaffold(pts, cfg, torch.Generator().manual_seed(seed),
                       device=device)
    p = st.params

    def draw(scale, shape):
        return torch.as_tensor(
            (scale * rng.normal(size=tuple(shape))).astype(np.float32),
            device=st.alive.device)
    st = st._replace(params=p._replace(feat=draw(0.3, p.feat.shape),
                                       offset=draw(0.5, p.offset.shape)))
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                      1.0 * height / width, width, height, device=device)
    return cfg, st, cam


def _count_instances(cfg, scaffold, cam, width, height):
    """(instances, rows) emission demand of the scene (``bench.py:54-93``):
    the first pass counts the rect rows exactly, the second the row-tight
    instances at a row table sized from the first."""
    import torch
    from gscream_tpu_torch.model.scaffold import decode
    from gscream_tpu_torch.ops.binning import emission_counts
    from gscream_tpu_torch.ops.projection import preprocess
    from gscream_tpu_torch.ops.rasterize_tiled import TILE_H, TILE_W
    with torch.no_grad():
        dec = decode(scaffold, cam.cam_center, None, cfg)
        s = preprocess(dec.xyz, dec.scale, dec.rot, cam.w2c, cam.full_proj,
                       width, height, cam.tan_fovx, cam.tan_fovy,
                       tile_w=TILE_W, tile_h=TILE_H, active_mask=dec.active,
                       opacity=dec.opacity)
        rh = s.rect_max[:, 1] - s.rect_min[:, 1]
        rw = s.rect_max[:, 0] - s.rect_min[:, 0]
        ok = (s.radius > 0) & (rw > 0)
        n_rows = int(torch.sum(torch.where(ok, rh, torch.zeros_like(rh))))
        row_cap = max(-(-max(n_rows, 1) // 8) * 8, 8)
        n_inst = int(emission_counts(s, TILE_W, TILE_H, row_cap)[0])
    return n_inst, n_rows


def _capacity(n_emit, n_rows):
    """The tier the training loop would settle at (``bench.py:147-154``)."""
    from gscream_tpu_torch.ops.binning import row_ratio
    from gscream_tpu_torch.train.loop import capacity_tier
    return max(capacity_tier(max(n_emit, row_ratio() * n_rows)), 1 << 14)


def _build_workload(cfg, scaffold, cam, width, height, capacity):
    """``grad_fn() -> (loss, grads, (num_instances, overflow_demand))``
    (``bench.py:102-139``): ``grads`` by ``named_params`` key, for the
    anchor parameters and the decoder MLPs (the cross-attention's are
    not on this path); the last two are device values."""
    import torch
    from gscream_tpu_torch.ops.binning import overflow_demand
    from gscream_tpu_torch.train.state import named_params
    from gscream_tpu_torch.train.step import render_from_params
    dev = scaffold.alive.device
    target = torch.zeros((height, width, 3), device=dev)
    bg = torch.zeros(3, device=dev)
    zero = torch.zeros((), device=dev)
    names = [n for n in named_params(scaffold)
             if not n.startswith("mlps/crossattn/")]

    def grad_fn():
        params = type(scaffold.params)(*(t.detach().requires_grad_()
                                         for t in scaffold.params))
        out, _, _, binning = render_from_params(
            params, scaffold.mlps, scaffold, cam, bg, zero, cfg, capacity)
        loss = (torch.mean(torch.abs(out.color - target))
                + 0.1 * torch.mean(out.depth)
                + 0.05 * torch.mean(out.uncertainty))
        leaves = named_params(scaffold._replace(params=params))
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        return (loss.detach(),
                {n: (torch.zeros_like(leaves[n]) if g is None else g)
                 for n, g in zip(names, grads)},
                (binning.num_instances, overflow_demand(binning)))
    return grad_fn


def _time_scene(cfg, scaffold, cam, width, height, iters=10):
    import torch
    from gscream_tpu_torch.utils.trace import maybe_trace
    n_emit, n_rows = _count_instances(cfg, scaffold, cam, width, height)
    capacity = _capacity(n_emit, n_rows)
    grad_fn = _build_workload(cfg, scaffold, cam, width, height, capacity)
    out = grad_fn()                                        # warm-up
    torch.cuda.synchronize()
    n_inst, demand = (int(v) for v in out[2])
    assert demand <= capacity, (demand, capacity)
    with maybe_trace(f"bench_{width}x{height}"):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = grad_fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
    return width * height / dt, dt, n_inst, demand, capacity


def time_config(width, height, iters=10):
    cfg, scaffold, cam = _bench_scene(width, height, 30000, 10, 0)
    return _time_scene(cfg, scaffold, cam, width, height, iters)


def time_trained(model_path, iters=10):
    """The rate at a trained model's opacity and scale distribution, on a
    mid-list camera of its ``cameras.json`` (``bench.py:172-203``)."""
    from gscream_tpu_torch.cameras import make_camera_from_c2w
    from gscream_tpu_torch.model.io import load_trained_scaffold
    scaffold, cfg, it = load_trained_scaffold(model_path)
    with open(os.path.join(model_path, "cameras.json")) as f:
        cams = json.load(f)
    c = cams[len(cams) // 2]
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(c["rotation"], np.float64)
    c2w[:3, 3] = np.asarray(c["position"], np.float64)
    w, h = int(c["width"]), int(c["height"])
    fovx = 2.0 * np.arctan(w / (2.0 * c["fx"]))
    fovy = 2.0 * np.arctan(h / (2.0 * c["fy"]))
    cam = make_camera_from_c2w(c2w, fovx, fovy, w, h)
    rays, dt, n_inst, demand, cap = _time_scene(cfg, scaffold, cam, w, h,
                                                iters)
    return {"rays_per_s": rays, "iter_ms": dt * 1e3, "width": w,
            "height": h, "instances": n_inst, "capacity": cap,
            "iteration": it, "model_path": model_path}


def main() -> int:
    try:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench runs on the card "
                               "only")
        from gscream_tpu_torch.precision import ensure_fp32_matmuls
        ensure_fp32_matmuls()
        rays, dt, n_inst, demand, cap = time_config(1297, 840, iters=10)
        extra = {}
        if os.environ.get("GSCREAM_BENCH_EXTRA"):
            rays_q, dt_q, _, _, _ = time_config(1008, 567, iters=10)
            extra = {"rays_per_s_1008x567": rays_q,
                     "iter_ms_1008x567": dt_q * 1e3}
        ply_dir = os.environ.get("GSCREAM_BENCH_PLY", "output/synth_spin30k")
        if os.path.isdir(os.path.join(ply_dir, "point_cloud")):
            extra["trained"] = time_trained(ply_dir, iters=10)
        result = {
            "metric": METRIC, "value": rays, "unit": "rays/s",
            "vs_baseline": rays / BASELINE_RAYS_PER_S,
            "iter_ms": dt * 1e3, "instances": n_inst,
            "overflow_demand": demand, "capacity": cap,
            "tight_cull": os.environ.get("GSCREAM_TIGHT_CULL") != "0",
            "backend": f"cuda:{torch.cuda.get_device_name(0)}",
            "sort": "precise", **extra}
    except Exception as e:     # the line says what failed, as bench.py's
        traceback.print_exc()
        print(json.dumps({"metric": METRIC, "value": None, "unit": "rays/s",
                          "vs_baseline": None, "status": "error",
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # `bench_torch.py --ply <model_dir>` pins the trained-scene figure to a
    # trained model directory (same as GSCREAM_BENCH_PLY)
    if "--ply" in sys.argv:
        os.environ["GSCREAM_BENCH_PLY"] = sys.argv[
            sys.argv.index("--ply") + 1]
    sys.exit(main())
