"""The render cell runner: one viewer in a closed loop over the configuration's
test cameras and its spiral, cycling, through ``train.render_sets.
make_render_fn``.

The state is the scene's anchors (the PLY both sides read) with the
decoders the program initialises from the configuration's ``run_seed``.  Set-up renders every
camera at a capacity tier and raises the tier
(``train.loop.capacity_tier``) past the largest demand until every
camera fits, as a caller of ``render_set`` sizes it; the last pass is the
warm-up.  In the window
each frame is timed from the call to its host copy (the frame as ``uint8``
on the host, as ``render_set`` holds it before it writes).  Sampled
frames, drawn from the seed, keep their float outputs for the comparison
(a window that would close before the last of them runs on to it).
"""
from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from reference import model as ref_model
from reference import step as ref_step

from . import compare, scene as scene_mod


def run(cell, seed: int, seconds: float, trace: bool, dev, tmp, t_start,
        capture_cls=None):
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.model.io import load_anchors_ply
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig,
                                                  init_scaffold)
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.render_sets import make_render_fn

    cfg, tr = cell["config"], cell["traffic"]
    m = cfg["model"]
    sc = scene_mod.cameras(cfg)
    cols = scene_mod.anchor_columns(cfg, seed, dev)
    ply = os.path.join(tmp, "anchors.ply")
    ref_model.write_anchor_ply(ply, cols)
    points = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    scfg = ScaffoldConfig(feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
                          voxel_size=m["voxel_size"],
                          capacity=m["anchor_capacity"],
                          attn_heads=cfg["optim"]["attn_head_num"],
                          attn_head_dim=cfg["optim"]["attn_head_dim"])
    state = init_scaffold(
        points, scfg,
        torch.Generator().manual_seed(scene_mod.run_seed(cfg)), device=dev)
    params, alive = load_anchors_ply(ply, scfg, dev)
    state = state._replace(params=params, alive=alive)
    poses = sc.test + sc.spiral
    cams = [make_camera(p.R, p.T, sc.fov_x, sc.fov_y, sc.width, sc.height,
                        device=dev) for p in poses]

    def frame(render, cam):
        out, _, demand = render(state.params, state.mlps, cam)
        u8 = (torch.clamp(out.color, 0.0, 1.0) * 255.0).to(torch.uint8)
        return out, demand, u8.cpu()

    # the tier render_set would settle at: every camera rendered at a tier,
    # the tier raised past the largest demand until every camera fits (a
    # truncated binning may report less than the whole demand); the last
    # pass is the warm-up
    cap = cfg["scene"]["start_capacity"]
    while True:
        render = make_render_fn(state, scfg, sc.width, sc.height, cap)
        demand = max(int(frame(render, c)[1]) for c in cams)
        if demand <= cap:
            break
        cap = max(capacity_tier(demand), capacity_tier(cap + 1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    sample = set(rng.choice(tr["sample_range"], tr["samples"],
                            replace=False).tolist())
    kept, lat, demands = {}, [], []
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    n = 0
    while True:
        cam = cams[n % len(cams)]
        f0 = time.perf_counter()
        out, d, _ = frame(render, cam)
        f1 = time.perf_counter()
        lat.append(f1 - f0)
        demands.append(d)
        if n in sample:
            kept[n] = (out.color.clone(), out.depth.clone(),
                       out.uncertainty.clone())
        n += 1
        if f1 - t0 >= seconds and n > max(sample):
            break
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    failed = int(sum(int(d) > cap for d in demands))
    res = SimpleNamespace(
        kind="render", setup_s=setup_s, window_s=t1 - t0, units=n,
        rate=n / (t1 - t0), latencies=lat, peak=peak, attempted=n,
        failed=failed, capture=None, trace_t=(0.0, 0.0), trace_units=0,
        work=None, numbers=None, capacity=cap)
    if trace:
        res.capture = capture_cls()
        k = tr["trace_frames"]
        s0 = time.perf_counter()
        res.capture.start()
        for i in range(k):
            frame(render, cams[(n + i) % len(cams)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res.trace_t = (s0, time.perf_counter())
        res.capture.stop()
        res.trace_units = k
        res.work = render_work(cfg, ply, sc, poses,
                               [(n + i) % len(cams) for i in range(k)], dev)
    del render, state, params, alive, cams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res.numbers = compare.render_numbers(
        [kept[i] for i in sorted(kept)],
        reference_frames(cfg, ply, sc,
                         [poses[i % len(poses)] for i in sorted(kept)], dev))
    return res


def reference_state(cfg, ply, dev):
    m, o = cfg["model"], cfg["optim"]
    p, alive = ref_model.anchors_from_ply(
        ref_model.read_anchor_ply(ply), m["anchor_capacity"],
        m["n_offsets"], dev)
    p.update(ref_model.init_mlps(scene_mod.run_seed(cfg), m["feat_dim"],
                                 m["n_offsets"],
                                 o["attn_head_num"], o["attn_head_dim"],
                                 dev))
    return p, alive


def reference_frames(cfg, ply, sc, poses, dev):
    p, alive = reference_state(cfg, ply, dev)
    bg = torch.zeros(3, device=dev)
    out = []
    for pose in poses:
        v = ref_step.View(pose.R, pose.T, sc.fov_x, sc.fov_y, sc.width,
                          sc.height, dev)
        out.append(ref_step.render_view(p, alive, v, cfg["model"]
                                        ["n_offsets"], bg))
    return out


def render_work(cfg, ply, sc, poses, idx, dev):
    """Per traced frame (the camera ``poses[i]`` for each ``i`` of
    ``idx``): the blended work and the visible anchors."""
    from reference import blend
    p, alive = reference_state(cfg, ply, dev)
    per_cam = {}
    for i in idx:
        if i in per_cam:
            continue
        pose = poses[i]
        v = ref_step.View(pose.R, pose.T, sc.fov_x, sc.fov_y, sc.width,
                          sc.height, dev)
        with torch.no_grad():
            g, bins = ref_step.splat(p, alive, v,
                                     cfg["model"]["n_offsets"])[:2]
            w = blend.blended_work(g, bins)
            visible, _ = ref_step.prefilter(p, alive, v)
            per_cam[i] = dict(w, anchors=int(visible.sum()), tokens=0)
    return [per_cam[i] for i in idx]
