#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (NVIDIA Hopper, sm_90a) and ``nvcc``; imports nothing
of JAX or of the JAX package.  Phases, each failing loudly (no phase
catches its own failure):

(a) environment and build: the card's name and power limit, the torch
    and CUDA versions, and the parallel ``nvcc`` build of every kernel
    under ``gscream_tpu_torch/csrc/`` (with ``ptxas`` register counts);
(b) each kernel against its plain PyTorch version on the card — K5 and
    K6 bit-equal, K1 within tolerance — at a small seeded scene (fitting
    and overflowing capacities) and at the full-width scene's shapes,
    with median times from CUDA events;
(c) the render path through its entry points at full width: the
    Scaffold-GS model of the repo's benchmark (feat_dim 32, 10 offsets,
    30,000 anchors ~ N(0, 0.6) from numpy seed 0, random decoders from a
    seeded torch.Generator) saved with the port's model IO, loaded back
    the way ``render_torch.py`` loads it, its capacity sized by one
    counting pass, then ``render_set`` over 10 orbit cameras at 1297×840
    with the kernel launch counters reset just before and read just
    after; outputs must be finite, cover the image, never overflow, and
    one view must match the all-plain path on the card;
(d) the phase-1 training path on the same scene: targets rendered by a
    second seeded "teacher" scaffold through the port's forward (a
    central box as the object mask, mono depth ``0.1 + 0.8·depth/max`` as
    ``gscream_tpu/data/synthetic.py`` makes it); one step's gradients at
    view 0 with the arguments of every kernel call recorded, all six
    kernels held against their plain versions and timed on those
    arguments (K2 within tolerance and bit-equal to the path's own
    output, K4 and K3 bit-equal, K3 also on a rerun and to K7 on the
    transposed columns; K3's line carries the run statistics that set its
    time), the step's gradients kernel path
    against plain path, then ``N_STEPS`` ``train_step`` calls over
    reference and other views with the launch counters reset just before
    and summed over the steps alone (each step's capacity is sized by a
    counting pass between them); losses must be finite, nothing may
    overflow, and the densification statistics must fill;
(e) the Pallas-emission training configuration (``GSCREAM_EMIT=pallas
    GSCREAM_REORDER=gather``) on the same scene and targets: one step's
    gradients at view 0 with the kernel arguments recorded, K9a, K9b, K8
    and K7 held bit-equal to their plain versions and timed on them (K7
    also on a rerun and to K3 on the transposed rows, with its run
    statistics), the
    route's binning held to the default route's (index fields bit-equal
    over the live instances, K8's records against
    ``pack_instance_data``'s), the step's gradients against the default
    route's (XLA emission + cm; ``scatter`` and ``sort`` run the same
    reorder as ``gather``), then ``N_PALLAS_STEPS`` ``train_step`` calls
    over views 0-3 in which K1, K2, K7, K8, K9a and K9b launch once per
    step and K3, K4, K5 and K6 never; the environment is restored after.

It prints a ``{"kernels": [...]}`` JSON line (each kernel's line from
its path: K7-K9 from phase (e), the others from phase (d), with the
render path's and each training route's launch counts and the render
path's line beside it), then the card's
``nvidia-smi`` name/power-limit line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or outside a checkout of the repo, it exits
non-zero without printing a result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT = 1297, 840
N_ANCHORS = 30_000
N_VIEWS = 10
N_TRAIN_VIEWS = 4       # training views 0..3; view 0 is the reference
N_STEPS = 8
N_PALLAS_STEPS = 4      # phase (e): train_step calls under GSCREAM_EMIT=pallas
# the kernels each training route launches once per step (by their names
# in launch_counters); the other four must not launch on that route
DEFAULT_ROUTE = ("tile_forward", "tile_backward", "segment_reduce",
                 "unpack_columns", "expand_gauss_rows", "expand_rows")
PALLAS_ROUTE = ("tile_forward", "tile_backward", "segment_reduce_rows",
                "pack_columns", "expand1", "expand2")
PALLAS_ENV = {"GSCREAM_EMIT": "pallas", "GSCREAM_REORDER": "gather"}
# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3
# bandwidth and non-tensor float32 throughput (132 SMs x 128 lanes x 2 per
# FMA at 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the exponential's MUFU.EX2 runs on the special-function pipe, 16 results
# per clock per SM (CUDA C++ Programming Guide, throughput table, compute
# capability 9.0): 1/16 of the float32 rate above, in results per second
EX2_PER_S = F32_OPS_PER_S / 16
# K1 float32 operations (a multiply-add counts 2, as in the peak rate), by
# how far a (instance, pixel) pair gets in the blend:
K1_OPS_EVAL = 11    # every evaluated pair: the power polynomial, power > 0
K1_OPS_EXP = 4      # power <= 0: the exponential at its least cost, one
                    # multiply by log2(e) before its MUFU.EX2 (the kernel's
                    # accurate expf spends 9 more on range reduction), then
                    # op·e, min and the α test
K1_OPS_ALPHA = 3    # α >= 1/255: 1 − α, T·(1 − α), the T < 1e-4 test
K1_OPS_BLEND = 11   # blended: w = α·T and the five weighted channel sums
K1_RECORD_BYTES = 64    # one 16-float instance record
K1_OUT_ROWS = 6         # output rows a caller reads (rgb, depth, unc, T)
# K2: the K1 pair costs, and per applied (blended) pair 42 more float32
# operations: w, γ (5 multiply-adds), the prefix, the suffix, ∂L/∂α (one
# division counted once), X, the shifted coordinates, the five channel
# products w·g, the five moment products and the 11 additions that fold
# the pair into its instance's sums
K2_OPS_APPLIED = 42
K2_PIX_ROWS = 7         # pixel rows K2 reads (its 8th is zero)
# K2 and the full step's gradients, kernel path against plain path: per
# output lane (per gradient leaf), |kernel − plain| ≤ GRAD_ATOL·scale +
# GRAD_RTOL·|plain| (scale = max |plain|), except at most GRAD_FLIP_SHARE
# of the elements, which must lie within GRAD_FLIP_REL·scale.  The two
# sum in other orders (warp butterflies against torch's reductions and
# scans) and the kernel contracts multiply-adds; Total − prefix cancels
# where Total is large, and a pixel's T < 1e-4 stop can move by one
# instance, which moves that instance's gradients by O(α)
GRAD_ATOL = 1e-3
GRAD_RTOL = 1e-2
GRAD_FLIP_SHARE = 5e-3
GRAD_FLIP_REL = 5e-2
# K1 / image tolerance: |kernel − plain| ≤ 1e-4·max(1, |plain|), except
# at pixels where the T < 1e-4 stop moves by one instance (the kernel's
# contracted multiply-adds round differently from PyTorch's separate
# operations), which may be at most 0.1% of the pixels
ATOL = 1e-4
MAX_FLIP_FRACTION = 1e-3


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, rounds: int = 5, warmup: int = 1) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def wall_ms_per_call(fn, n):
    """Host wall time of one ``fn()``, each call run to a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_calls(fn, prefixes, n=3):
    """torch.profiler over ``n`` calls of ``fn``: (kernels as (device ms
    per call, launches per call, name), device ms per call of each
    ``record_function`` range whose name starts with one of
    ``prefixes``, device busy ms and wall ms per call under the
    profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels, layers = [], {}
    for e in prof.key_averages():
        if e.key.startswith(prefixes):
            # the CPU-side range: device time of the kernels it launched;
            # its GPU-side twin spans first to last kernel, gaps included
            if e.device_type == DeviceType.CPU:
                layers[e.key] = e.device_time_total / n / 1e3
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.self_device_time_total / n / 1e3,
                            e.count // n, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return kernels, layers, busy_ms, wall_ms


def grad_close(got, ref, label):
    """Hold ``got`` to ``ref`` with the GRAD_* tolerance; returns (max abs
    error, share of elements beyond the tight bound)."""
    import torch
    got, ref = got.double(), ref.double()
    require(bool(torch.isfinite(got).all()), f"{label}: not finite")
    scale = max(float(ref.abs().max()), 1e-30)
    err = (got - ref).abs()
    bad = err > GRAD_ATOL * scale + GRAD_RTOL * ref.abs()
    share = float(bad.double().mean()) if bad.numel() else 0.0
    worst = float(err.max()) if err.numel() else 0.0
    if share > GRAD_FLIP_SHARE or worst > GRAD_FLIP_REL * scale:
        raise AssertionError(f"{label}: kernel path vs plain path max abs "
                             f"{worst:.3e} (scale {scale:.3e}), "
                             f"{share:.2e} of the elements beyond "
                             "tolerance")
    return worst, share


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the span of a ``with`` and restore
    them after (the selectors of the training path read them per call)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare_images(got, ref):
    """(max abs error, fraction of elements beyond the tolerance)."""
    import torch
    err = (got - ref).abs()
    bad = err > ATOL * torch.clamp_min(ref.abs(), 1.0)
    return float(err.max()), float(bad.float().mean())


# ---------------------------------------------------------------------------
# scenes and cameras

def orbit_cameras(device, n=N_VIEWS):
    """Cameras at distance 3 around the origin, looking at it; view 0 is
    the benchmark camera (identity rotation, camera at z = -3)."""
    from gscream_tpu_torch.cameras import make_camera_from_c2w
    cams = []
    for i in range(n):
        th = 2.0 * math.pi * i / n
        R = np.array([[math.cos(th), 0.0, math.sin(th)], [0.0, 1.0, 0.0],
                      [-math.sin(th), 0.0, math.cos(th)]])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = R @ np.array([0.0, 0.0, -3.0])
        cams.append(make_camera_from_c2w(c2w, 1.0, 1.0 * HEIGHT / WIDTH,
                                         WIDTH, HEIGHT, device=device))
    return cams


def bench_scene(device, seed=0):
    """The repo's benchmark model (``bench.py::_bench_scene``), drawn with
    numpy seed ``seed`` and a torch.Generator seeded alike."""
    import torch
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, \
        init_scaffold
    rng = np.random.default_rng(seed)
    cfg = ScaffoldConfig(feat_dim=32, n_offsets=10, voxel_size=0.01,
                         capacity=1 << 15)
    pts = rng.normal(0, 0.6, (N_ANCHORS, 3)).astype(np.float32)
    st = init_scaffold(pts, cfg, torch.Generator().manual_seed(seed),
                       device=device)
    p = st.params

    def draw(scale, shape):
        return torch.as_tensor(
            (scale * rng.normal(size=tuple(shape))).astype(np.float32),
            device=device)
    st = st._replace(params=p._replace(feat=draw(0.3, p.feat.shape),
                                       offset=draw(0.5, p.offset.shape)))
    return cfg, st


def small_splats(device):
    """A seeded scene of 600 thin, rotated gaussians at 160×96."""
    import torch
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops.projection import preprocess
    rng = np.random.default_rng(1)
    n, w, h = 600, 160, 96
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 6.0, n)], -1)
    scales = np.exp(rng.normal(-2.5, 1.0, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = 10.0 ** rng.uniform(-3, -0.02, n)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, w, h, device=device)
    s = preprocess(t(means), t(scales), t(q), cam.w2c, cam.full_proj, w, h,
                   cam.tan_fovx, cam.tan_fovy, tile_w=32, tile_h=32,
                   opacity=t(op))
    return s, t(rng.uniform(0, 1, (n, 3))), t(op), t(rng.uniform(0, 1, n)), \
        w, h


def instance_demand(scaffold, cfg, cam):
    """The capacity this view's emission needs (``overflow_demand``),
    from one counting pass (``bench.py::_count_instances``)."""
    from gscream_tpu_torch.ops.binning import (ROW_RATIO, _row_offsets,
                                               emission_counts)
    import torch
    with torch.no_grad():
        _, sp = splats_of(scaffold, cfg, cam)
        ni, nr = emission_counts(sp, 32, 32, int(_row_offsets(sp)[-1]))
    return max(int(ni), ROW_RATIO * int(nr))


def splats_of(scaffold, cfg, cam):
    from gscream_tpu_torch.model.scaffold import decode
    from gscream_tpu_torch.ops.projection import preprocess
    dec = decode(scaffold, cam.cam_center, None, cfg)
    s = preprocess(dec.xyz, dec.scale, dec.rot, cam.w2c, cam.full_proj,
                   cam.width, cam.height, cam.tan_fovx, cam.tan_fovy,
                   tile_w=32, tile_h=32, active_mask=dec.active,
                   opacity=dec.opacity)
    return dec, s


# ---------------------------------------------------------------------------
# phase (b): kernels against their plain versions

def kernel_inputs(splats, colors, opacity, unc, capacity, w, h):
    """The three kernels' inputs as the render path builds them."""
    from gscream_tpu_torch.ops import binning as bn
    from gscream_tpu_torch.ops.rasterize_tiled import pack_instance_data
    gx = -(-w // 32)
    n_tiles = bn.num_tiles(w, h, 32, 32)
    row_cap = bn.row_table_size(capacity)
    row_offs = bn._row_offsets(splats)
    k5_args = (row_offs, splats.rect_min.contiguous(),
               splats.rect_max.contiguous(), splats.mean2d.contiguous(),
               splats.conic.contiguous(), splats.t_iso.contiguous(),
               splats.depth.contiguous(), row_cap, 32, 32, gx)
    binning = bn.bin_instances(splats, capacity, w, h, 32, 32)
    rows = bn.expand_gauss_rows(*k5_args)
    ioffs = (rows[3].cumsum(0) - rows[3]).int()
    inst = pack_instance_data(splats.mean2d, splats.conic, opacity, colors,
                              splats.depth, unc, binning, gx)
    return {"k5": k5_args, "k6": (rows, ioffs, capacity, n_tiles),
            "k1": (inst, binning.tile_start, binning.tile_count, n_tiles),
            "binning": binning}


def k1_work(inst, tile_start, tile_count):
    """What the blend must do on this data.  At each pixel it evaluates
    every instance up to and including the one that stops it; of those,
    ``exp`` pairs have power <= 0, ``alpha`` pairs also pass α >= 1/255,
    and ``blend`` pairs also keep T >= 1e-4 and are accumulated.
    ``records`` counts the instances some pixel of their tile evaluates
    (a prefix of each tile's range: the records the blend must read)."""
    import torch
    from gscream_tpu_torch.ops.rasterize_tiled import _pixel_coords
    x, y = _pixel_coords(inst.device)
    work = dict.fromkeys(("eval", "exp", "alpha", "blend", "records"), 0)
    for s, c in zip(tile_start.tolist(), tile_count.tolist()):
        if c == 0:
            continue
        d = inst[s:s + c]
        power = d[:, 6:7] + (d[:, 7:8] + d[:, 9:10] * x + d[:, 10:11] * y) \
            * x + (d[:, 8:9] + d[:, 11:12] * y) * y
        alpha = torch.clamp_max(d[:, 0:1] * torch.exp(power), 0.99)
        passes = (power <= 0) & (alpha >= 1.0 / 255.0)
        alpha = torch.where(passes, alpha, torch.zeros_like(alpha))
        t_after = torch.cumprod(1.0 - alpha, 0)
        t_before = torch.cat([torch.ones_like(t_after[:1]), t_after[:-1]])
        ev = t_before >= 1e-4
        work["eval"] += int(ev.sum())
        work["exp"] += int((ev & (power <= 0)).sum())
        work["alpha"] += int((ev & passes).sum())
        work["blend"] += int((ev & passes & (t_after >= 1e-4)).sum())
        work["records"] += int(ev.any(1).sum())
    return work


def k1_bound(work, n_tiles):
    """(operations s, bytes s) of K1's least time on this data: the float32
    pipe and the special-function pipe run side by side, so the operations
    time is the slower of the two."""
    flops = (K1_OPS_EVAL * work["eval"] + K1_OPS_EXP * work["exp"]
             + K1_OPS_ALPHA * work["alpha"] + K1_OPS_BLEND * work["blend"])
    ops_s = max(flops / F32_OPS_PER_S, work["exp"] / EX2_PER_S)
    moved = (work["records"] * K1_RECORD_BYTES + n_tiles * 2 * 4
             + n_tiles * K1_OUT_ROWS * 1024 * 4)
    return ops_s, moved / HBM_BYTES_PER_S, flops, moved


def k5_bytes(k5_args, row_cap):
    """Bytes K5 must move: the row prefix in full, the fields it uses of
    the gaussians that own a row below ``row_cap`` (rect x/y min, rect x
    max, mean2d, conic, t_iso, depth: 40 bytes), and the (4, row_cap)
    table it writes."""
    row_offs = k5_args[0]
    emit = ((row_offs[1:] > row_offs[:-1])
            & (row_offs[:-1] < row_cap)).sum()
    return nbytes(row_offs) + 40 * int(emit) + 4 * 4 * row_cap


def k6_bytes(rows, capacity):
    """Bytes K6 must move: each live row that emits (w_row > 0) read once
    as (tile_base, gid, depth_bits, its slot offset), and the (3, capacity)
    slots it writes."""
    return 16 * int((rows[3] > 0).sum()) + 3 * 4 * capacity


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def run_stats(offsets, cap):
    """What sets K3's and K7's time on this data: the live instances, the
    gaussians with a non-empty run, the run lengths (median, mean, p99,
    p99.9 over those, the longest), the 32-instance chunks, the most
    chunks one run spans (level 2's longest chain), and the share of
    useful lanes had one thread per gaussian walked its run (each warp of
    32 gaussians waiting on its longest)."""
    import torch
    offs = offsets.long().clamp_max(cap)
    lo, hi = offs[:-1], offs[1:]
    n_live = int(offs[-1])
    runs = hi - lo
    emit = runs > 0
    if not bool(emit.any()):
        return {"live": n_live, "emitting": 0}
    lens = runs[emit].double()
    q = torch.quantile(lens, torch.tensor([0.5, 0.99, 0.999],
                                          dtype=torch.float64,
                                          device=lens.device)).tolist()
    span = ((hi - 1) // 32 - lo // 32 + 1)[emit]
    warps = torch.nn.functional.pad(runs, (0, -runs.shape[0] % 32))
    serial = int(warps.reshape(-1, 32).amax(1).sum())
    return {"live": n_live, "emitting": int(emit.sum()),
            "median_run": q[0], "mean_run": float(lens.mean()),
            "p99_run": q[1], "p999_run": q[2], "longest_run": int(lens.max()),
            "chunks": -(-n_live // 32), "longest_span": int(span.max()),
            "thread_per_gaussian_lane_use": n_live / (32 * serial)}


def check_segment_reduce(tag, kern, plain, other, values, offsets, label):
    """``kern`` (K3 or K7) bit-equal to its plain version and to itself on
    a rerun, and to ``other`` (the other layout's kernel) on the
    transposed values; returns its output."""
    import torch
    out = kern(values, offsets)
    sync()              # a fault during the launch surfaces here
    require(torch.equal(out, plain(values, offsets)),
            f"{tag} differs from its plain version ({label})")
    require(torch.equal(out, kern(values, offsets)),
            f"{tag} rerun is not bit-equal ({label})")
    require(torch.equal(out, other(values.T.contiguous(), offsets)),
            f"K3 and K7 differ on the same values ({label})")
    sync()
    return out


def sync():
    import torch
    torch.cuda.synchronize()


def check_kernels(inp, label, timed):
    """Hold K5, K6 and K1 against their plain versions on ``inp``; when
    ``timed``, time both and return each kernel's line, its launch count
    left to the caller."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt

    def run(fn, args):
        out = fn(*args)
        sync()          # a fault during the launch surfaces here
        return out

    k5_k, k5_p = run(em.expand_gauss_rows, inp["k5"]), run(
        em.expand_gauss_rows_plain, inp["k5"])
    if not torch.equal(k5_k, k5_p):
        raise AssertionError(f"K5 differs from its plain version ({label}): "
                             f"{int((k5_k != k5_p).sum())} entries")
    k6_k, k6_p = run(em.expand_rows, inp["k6"]), run(em.expand_rows_plain,
                                                     inp["k6"])
    if not torch.equal(k6_k, k6_p):
        raise AssertionError(f"K6 differs from its plain version ({label}): "
                             f"{int((k6_k != k6_p).sum())} entries")
    k1_k, k1_p = run(rt.run_forward, inp["k1"]), run(rt.run_forward_plain,
                                                     inp["k1"])
    err, bad = compare_images(k1_k, k1_p)
    if bad > MAX_FLIP_FRACTION or not torch.isfinite(k1_k).all():
        raise AssertionError(f"K1 differs from its plain version ({label}): "
                             f"max abs {err}, {bad:.2e} of outputs beyond "
                             "tolerance")
    log(f"{label}: K5 bit-equal {tuple(k5_k.shape)}, K6 bit-equal "
        f"{tuple(k6_k.shape)}, K1 max abs err {err:.3e}, beyond tolerance "
        f"{bad:.2e}")
    if not timed:
        return {}
    rows, _, capacity, _ = inp["k6"]
    inst, ts, tc, n_tiles = inp["k1"]
    k5_moved = k5_bytes(inp["k5"], rows.shape[1])
    k6_moved = k6_bytes(rows, capacity)
    work = k1_work(inst, ts, tc)
    k1_ops_s, k1_bytes_s, k1_flops, k1_moved = k1_bound(work, n_tiles)
    specs = [
        ("expand_gauss_rows", "K5", em.expand_gauss_rows,
         em.expand_gauss_rows_plain, inp["k5"], "emission.cu",
         "gscream_tpu/ops/emission.py:346", 0.0,
         k5_moved / HBM_BYTES_PER_S, "bytes"),
        ("expand_rows", "K6", em.expand_rows, em.expand_rows_plain,
         inp["k6"], "emission.cu", "gscream_tpu/ops/emission.py:321", 0.0,
         k6_moved / HBM_BYTES_PER_S, "bytes"),
        ("tile_forward", "K1", rt.run_forward, rt.run_forward_plain,
         inp["k1"], "rasterize_fwd.cu",
         "gscream_tpu/ops/rasterize_tiled.py:360", err,
         max(k1_ops_s, k1_bytes_s),
         "operations" if k1_ops_s > k1_bytes_s else "bytes"),
    ]
    results = {}
    for name, tag, kern, plain, args, src, repl, e, bound_s, by in specs:
        ms = cuda_ms(lambda: kern(*args), reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: plain(*args), reps=1, rounds=3)
        results[name] = {
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"gscream_tpu_torch/csrc/{src}", "replaces": repl,
            "shapes": label, "max_abs_err": e, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": by,
            "library_ms": None, "check": "bit-equal" if tag != "K1" else
            f"max abs err {e:.3e}, beyond tolerance {bad:.2e}"}
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({by}) "
            f"[{SMI}]")
    log(f"K1 pairs {work}, float32 operations {k1_flops} "
        f"({k1_flops / F32_OPS_PER_S * 1e3:.4f} ms), exponentials "
        f"{work['exp'] / EX2_PER_S * 1e3:.4f} ms on the special-function "
        f"pipe, bytes {k1_moved} ({k1_bytes_s * 1e3:.4f} ms); K5 bytes "
        f"{k5_moved}, K6 bytes {k6_moved}")
    return results


def kernel_slots():
    """(module, name, plain version) of each kernel wrapper where the
    render and training paths look it up."""
    from gscream_tpu_torch.ops import binning as bn
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh
    return [(bn, "expand_gauss_rows", em.expand_gauss_rows_plain),
            (bn, "expand_rows", em.expand_rows_plain),
            (rt, "run_forward", rt.run_forward_plain),
            (rt, "run_backward", rt.run_backward_plain),
            (rt, "unpack_columns", sh.unpack_columns_plain),
            (rt, "segment_reduce_cm", rt.segment_reduce_cm_plain),
            (bn, "expand1", em.expand1_plain),
            (bn, "expand2", em.expand2_plain),
            (rt, "pack_columns", sh.pack_columns_plain),
            (rt, "segment_reduce_rows", rt.segment_reduce_rows_plain)]


class swap_kernels:
    """For the span of a ``with``, the paths call ``wrap(name, wrapper,
    plain)`` in place of each kernel wrapper (a harness substitution; the
    package itself only takes the plain versions for CPU tensors)."""

    def __init__(self, wrap):
        self.wrap = wrap

    def __enter__(self):
        self.saved = []
        for mod, name, plain in kernel_slots():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self.wrap(name, fn, plain))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def plain_kernels():
    """Route the paths through the plain versions on the card."""
    return swap_kernels(lambda name, fn, plain: plain)


def recorded_kernel_args(fn):
    """``fn()`` with the arguments of each wrapper's last call recorded:
    (its result, {wrapper name: args})."""
    args = {}

    def wrap(name, kern, plain):
        def record(*a):
            args[name] = a
            return kern(*a)
        # a wrapper counts its launch on the module attribute by its own
        # name, which is this recorder for the span of the ``with``
        record.launches = 0
        return record
    with swap_kernels(wrap):
        out = fn()
    return out, args


def launch_counters():
    """{kernel name: its wrapper}, in the order of the kernels line."""
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh
    return {"tile_forward": rt.run_forward,
            "tile_backward": rt.run_backward,
            "segment_reduce": rt.segment_reduce_cm,
            "unpack_columns": sh.unpack_columns,
            "expand_gauss_rows": em.expand_gauss_rows,
            "expand_rows": em.expand_rows,
            "segment_reduce_rows": rt.segment_reduce_rows,
            "pack_columns": sh.pack_columns,
            "expand1": em.expand1,
            "expand2": em.expand2}


# ---------------------------------------------------------------------------
# phase (d): the phase-1 training path

def training_targets(dev, cfg, cams):
    """Per training view (gt image (3,H,W), object mask (1,H,W), mono
    depth (1,H,W), fg box (H,W)): a second seeded "teacher" scaffold
    (numpy seed 1) rendered by the port's forward; the mask is the
    central third, the fg box the central half, the mono depth ``0.1 +
    0.8·depth/max`` (``gscream_tpu/data/synthetic.py:89-98``)."""
    import torch
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.render_sets import make_render_fn
    _, teacher = bench_scene(dev, seed=1)
    capacity = capacity_tier(max(instance_demand(teacher, cfg, c)
                                 for c in cams))
    render = make_render_fn(teacher, cfg, WIDTH, HEIGHT, capacity)
    mask = torch.zeros((1, HEIGHT, WIDTH), device=dev)
    mask[:, HEIGHT // 3:2 * HEIGHT // 3, WIDTH // 3:2 * WIDTH // 3] = 1.0
    fg = torch.zeros((HEIGHT, WIDTH), device=dev)
    fg[HEIGHT // 4:3 * HEIGHT // 4, WIDTH // 4:3 * WIDTH // 4] = 1.0
    targets = []
    for cam in cams:
        out, _, demand = render(teacher.params, teacher.mlps, cam)
        require(int(demand) <= capacity, "teacher render overflowed")
        d = out.depth
        mono = 0.1 + 0.8 * d / torch.clamp_min(d.max(), 1e-6)
        targets.append((out.color.permute(2, 0, 1).contiguous(), mask,
                        mono[None].contiguous(), fg))
    return targets


def check_backward_kernels(args, label):
    """K2 within tolerance and bit-equal to the path's own output on a
    rerun, K4 and K3 bit-equal, each against its plain version on the
    card, on the arguments ``args`` the training path gave them; returns
    each kernel's line with its time and bound, its launch count left to
    the caller."""
    import torch
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh

    def run(fn, *a):
        out = fn(*a)
        sync()          # a fault during the launch surfaces here
        return out

    k2 = args["run_backward"]
    (rows,) = args["unpack_columns"]        # the path's own K2 output
    ge, offsets = args["segment_reduce_cm"]
    inst, pix, ts, tc, n_tiles = k2
    cap = inst.shape[0]
    n = min(int(offsets[-1]), cap)
    rows_p = run(rt.run_backward_plain, *k2)
    require(torch.equal(rows, run(rt.run_backward, *k2)),
            f"K2 rerun is not bit-equal to the path's output ({label})")
    require(not bool(rows[n:].any()), f"K2 left slots past {n} non-zero")
    k2_err, k2_share = 0.0, 0.0
    for lane in range(16):
        e, sh_ = grad_close(rows[:n, lane], rows_p[:n, lane],
                            f"K2 lane {lane} ({label})")
        k2_err, k2_share = max(k2_err, e), max(k2_share, sh_)
    cols = run(sh.unpack_columns, rows)
    require(torch.equal(cols, sh.unpack_columns_plain(rows)),
            f"K4 differs from its plain version ({label})")
    seg = check_segment_reduce("K3", rt.segment_reduce_cm,
                               rt.segment_reduce_cm_plain,
                               rt.segment_reduce_rows, ge, offsets, label)
    require(bool(seg[:, 6].abs().max() > 0), "K3 summed no moment")
    runs = run_stats(offsets, cap)
    log(f"{label}: K2 max abs err {k2_err:.3e}, worst lane's share beyond "
        f"tolerance {k2_share:.2e}, rerun bit-equal; K4 bit-equal "
        f"{tuple(cols.shape)}; K3 bit-equal {tuple(seg.shape)}, rerun "
        "bit-equal, K7 on the transposed columns bit-equal")

    work = k1_work(inst, ts, tc)
    flops = (K1_OPS_EVAL * work["eval"] + K1_OPS_EXP * work["exp"]
             + K1_OPS_ALPHA * work["alpha"] + K2_OPS_APPLIED * work["blend"])
    k2_ops_s = max(flops / F32_OPS_PER_S, work["exp"] / EX2_PER_S)
    k2_moved = (work["records"] * K1_RECORD_BYTES + n_tiles * 2 * 4
                + n_tiles * K2_PIX_ROWS * 1024 * 4 + cap * 64)
    k4_moved = 2 * cap * 64
    n_gauss = offsets.shape[0] - 1
    k3_moved = n * 64 + nbytes(offsets) + n_gauss * 64
    rows_t = ge.T.contiguous()
    offs64 = offsets.long()
    specs = [
        ("tile_backward", "K2", lambda: rt.run_backward(*k2),
         lambda: rt.run_backward_plain(*k2), None,
         "rasterize_bwd.cu", "gscream_tpu/ops/rasterize_tiled.py:513",
         k2_err, max(k2_ops_s, k2_moved / HBM_BYTES_PER_S),
         "operations" if k2_ops_s > k2_moved / HBM_BYTES_PER_S else "bytes",
         f"max abs err {k2_err:.3e}, worst lane beyond tolerance "
         f"{k2_share:.2e}", 10),
        ("segment_reduce", "K3", lambda: rt.segment_reduce_cm(ge, offsets),
         lambda: rt.segment_reduce_cm_plain(ge, offsets),
         lambda: torch.segment_reduce(rows_t, "sum", offsets=offs64),
         "segreduce.cu", "gscream_tpu/ops/rasterize_tiled.py:899", 0.0,
         k3_moved / HBM_BYTES_PER_S, "bytes",
         "bit-equal, rerun bit-equal, equal to K7 on the transposed "
         "columns", 50),
        ("unpack_columns", "K4", lambda: sh.unpack_columns(rows),
         lambda: sh.unpack_columns_plain(rows), lambda: rows.t().contiguous(),
         "shuffle.cu", "gscream_tpu/ops/shuffle.py:75", 0.0,
         k4_moved / HBM_BYTES_PER_S, "bytes", "bit-equal", 50),
    ]
    results = {}
    for (name, tag, kern, plain, lib, src, repl, e, bound_s, by, check,
         reps) in specs:
        ms = cuda_ms(kern, reps=reps, warmup=2)
        plain_ms = cuda_ms(plain, reps=1, rounds=3)
        lib_ms = cuda_ms(lib, reps=reps, warmup=2) if lib else None
        results[name] = {
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"gscream_tpu_torch/csrc/{src}", "replaces": repl,
            "shapes": label, "max_abs_err": e, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": by,
            "library_ms": lib_ms, "check": check}
        if tag == "K3":
            results[name]["runs"] = runs
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", bound {bound_s * 1e3:.4f} ms ({by})"
            + (f", runs {runs}" if tag == "K3" else "") + f" [{SMI}]")
    log(f"K2 pairs {work}, float32 operations {flops} "
        f"({flops / F32_OPS_PER_S * 1e3:.4f} ms), exponentials "
        f"{work['exp'] / EX2_PER_S * 1e3:.4f} ms, bytes {k2_moved} "
        f"({k2_moved / HBM_BYTES_PER_S * 1e3:.4f} ms); K3 bytes {k3_moved}; "
        f"K4 bytes {k4_moved}")
    return results


def run_steps(ts, cfg, opt, cams, targets, n, label):
    """``n`` ``train_step`` calls through the entry point over the views
    in turn, each at the capacity a counting pass sizes for it; losses
    finite, no overflow.  Returns the state, the wall ms of each step
    (each run to a sync) and each kernel's launches summed over the steps
    alone (the counting passes between them left out)."""
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.step import train_step
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)
    step_ms = []
    for i in range(n):
        v = i % len(cams)
        capacity = capacity_tier(instance_demand(ts.scaffold, cfg, cams[v]))
        before = {name: fn.launches for name, fn in counters.items()}
        sync()
        t0 = time.perf_counter()
        ts, aux = train_step(ts, cams[v], *targets[v], cfg=cfg, opt=opt,
                             is_ref=(v == 0), capacity=capacity,
                             width=WIDTH, height=HEIGHT, accumulate=True)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for name, fn in counters.items():
            launches[name] += fn.launches - before[name]
        loss, l1, demand, n_active, _ = aux.packed.tolist()
        require(math.isfinite(loss) and math.isfinite(l1),
                f"{label} step {i}: loss {loss}, l1 {l1}")
        require(demand <= capacity, f"{label} step {i}: overflow, demand "
                f"{demand} > capacity {capacity}")
        log(f"{label} step {i + 1} view {v}{' (ref)' if v == 0 else ''}: "
            f"loss {loss:.6f} l1 {l1:.6f}, instances {int(demand)} of "
            f"capacity {capacity}, active gaussians {int(n_active)}, "
            f"{step_ms[-1]:.2f} ms")
    log(f"{label} launches over {n} train_step calls (the counting passes "
        f"between them left out): {launches}")
    return ts, step_ms, launches


def own_kernel_names():
    """The names of the ``__global__`` functions in the port's CUDA
    sources (a template's profiler name adds its arguments)."""
    import re
    from gscream_tpu_torch.ops import cuda_build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)")
    return {name for src in cuda_build.CSRC.glob("*.cu")
            for name in pat.findall(src.read_text())}


def profile_step(ts, cfg, opt, cams, targets, step_ms, label):
    """Log the median of ``step_ms``, then ``torch.profiler`` over steps
    on view 1 (the state advances): device busy time, launches, the idle
    share against that median, the ranges and the largest kernels."""
    import torch
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.step import train_step
    median_ms = float(np.median(step_ms))
    log(f"{label} train_step ms per step (each to a sync, counting pass "
        f"outside): {[round(t, 3) for t in step_ms]}; median over the "
        f"{len(step_ms)} steps {median_ms:.3f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{SMI}]")
    cap1 = capacity_tier(int(1.125 * instance_demand(ts.scaffold, cfg,
                                                     cams[1])))
    state = [ts]

    def one_step():
        state[0], _ = train_step(state[0], cams[1], *targets[1], cfg=cfg,
                                 opt=opt, is_ref=False, capacity=cap1,
                                 width=WIDTH, height=HEIGHT, accumulate=True)
    kernels, layers, busy_ms, wall_ms = profile_calls(
        one_step, ("step/", "raster_bwd/"))
    log(f"{label} profile of one step on view 1: device busy "
        f"{busy_ms:.3f} ms in {sum(k[1] for k in kernels)} kernel "
        f"launches; wall {wall_ms:.3f} ms under the profiler (idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}); idle share against the "
        f"median of the {len(step_ms)} steps above "
        f"{max(0.0, 1 - busy_ms / median_ms):.3f} [{SMI}]")
    for name, dev_ms in sorted(layers.items()):
        log(f"  range {name}: {dev_ms:.4f} ms device")
    # the repo's own kernels (launched through ctypes, not as PyTorch
    # ops): the profiler may leave them out of a range's device time
    mine = own_kernel_names()
    own = {}
    for dev_ms, _, name in kernels:
        short = name.removeprefix("void ").removeprefix(
            "(anonymous namespace)::").split("(")[0]
        if short.split("<")[0] in mine:
            own[short] = dev_ms
    log(f"  hand-written kernels (device ms per step): "
        + ", ".join(f"{k} {v:.4f}" for k, v in own.items())
        + f"; ranges sum to {sum(layers.values()):.4f} ms of the "
        f"{busy_ms:.4f} ms busy")
    for dev_ms, calls, name in kernels[:14]:
        log(f"  {dev_ms:9.4f} ms  x{calls:<3d} {name[:90]}")


def train_phase(dev, cfg, scaffold, cams, targets):
    """Phase (d): the six kernels against their plain versions on the
    arguments one training step at view 0 gave them, and that step's
    gradients kernel path against plain path; then N_STEPS training
    steps with the launch counters around them.  Returns each kernel's
    line, timed at view 0's shapes, with the training path's launch
    counts, and the counts of every kernel over those steps."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.state import init_train_state
    from gscream_tpu_torch.train.step import loss_and_grads, phase1_masks
    t_start = time.perf_counter()
    opt = OptimConfig()
    cams = cams[:N_TRAIN_VIEWS]
    ts = init_train_state(scaffold, cfg)
    cap0 = capacity_tier(instance_demand(scaffold, cfg, cams[0]))

    kw = dict(cfg=cfg, opt=opt, is_ref=True, capacity=cap0,
              masks=phase1_masks(False))
    g_k, args = recorded_kernel_args(
        lambda: loss_and_grads(scaffold, cams[0], *targets[0], **kw))
    label = (f"training view 0, capacity {cap0}, "
             f"{int(args['segment_reduce_cm'][1][-1])} instances")
    with torch.no_grad():
        results = check_kernels({"k5": args["expand_gauss_rows"],
                                 "k6": args["expand_rows"],
                                 "k1": args["run_forward"]}, label, True)
    results.update(check_backward_kernels(args, label))
    del args

    # the full step's gradients, kernel path against plain path
    with plain_kernels():
        g_p = loss_and_grads(scaffold, cams[0], *targets[0], **kw)
    compare_grads(g_k, g_p, "step gradients, kernel path vs plain path",
                  loss_rtol=1e-4)
    del g_k, g_p

    ts, step_ms, launches = run_steps(ts, cfg, opt, cams, targets, N_STEPS,
                                      "training")
    for name, n in launches.items():
        if name not in DEFAULT_ROUTE:
            require(n == 0, f"kernel {name} of another route was launched "
                    f"{n} times by the default training route")
            continue
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "training path")
        results[name]["launches"] = results[name]["launches_train"] = n
    st = ts.stats
    require(ts.step == N_STEPS, f"step count {ts.step}")
    require(bool(st.anchor_demon.sum() > 0) and bool(
        st.offset_denom.sum() > 0) and bool(st.offset_grad_accum.sum() > 0)
        and bool(st.opacity_accum.sum() > 0),
        "the densification statistics did not fill")
    for name, m in ts.m.items():
        require(bool(torch.isfinite(m).all()), f"moment {name} not finite")
    profile_step(ts, cfg, opt, cams, targets, step_ms, "training")
    log(f"phase (d) took {time.perf_counter() - t_start:.1f} s")
    return results, launches


# ---------------------------------------------------------------------------
# phase (e): the Pallas-emission training configuration

# record lanes the port computes bit-equal on both routes; lanes 6-8 (the
# power coefficients) are held to rtol 1e-5, atol 1e-6, the tolerance of
# the JAX package's own test of this build (tests/test_emission.py:65-69),
# and reported bit-equal or not
RECORD_EXACT = [0, 1, 2, 3, 4, 5, 9, 10, 11, 12, 13, 14, 15]


def check_pallas_kernels(args, label):
    """K9a, K9b, K8 and K7 bit-equal to their plain versions on the
    arguments ``args`` the Pallas-emission route gave them, each timed
    beside its bytes bound; returns each kernel's line, its launch count
    left to the caller."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh

    def run(fn, *a):
        out = fn(*a)
        sync()          # a fault during the launch surfaces here
        return out

    def same(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    k9a, k9b = args["expand1"], args["expand2"]
    (cols,) = args["pack_columns"]
    ge, offsets = args["segment_reduce_rows"]
    checks = (("K9a", em.expand1, em.expand1_plain, k9a),
              ("K9b", em.expand2, em.expand2_plain, k9b),
              ("K8", sh.pack_columns, sh.pack_columns_plain, (cols,)))
    for tag, kern, plain, a in checks:
        require(same(run(kern, *a), run(plain, *a)),
                f"{tag} differs from its plain version ({label})")
    check_segment_reduce("K7", rt.segment_reduce_rows,
                         rt.segment_reduce_rows_plain, rt.segment_reduce_cm,
                         ge, offsets, label)
    log(f"{label}: K9a, K9b, K8 and K7 bit-equal to their plain versions; "
        "K7 rerun bit-equal, K3 on the transposed rows bit-equal")

    ro, _, _, row_cap = k9a[:4]
    io, _, _, capacity = k9b[:4]
    emit = int(((ro[1:] > ro[:-1]) & (ro[:-1] < row_cap)).sum())
    kept = int(((io[1:] > io[:-1]) & (io[:-1] < capacity)).sum())
    cap = ge.shape[0]
    n = min(int(offsets[-1]), cap)
    runs = run_stats(offsets, cap)
    moved = {
        # the row prefix, 16 + 48 bytes of each emitting gaussian's
        # tables, the (4 + 11, row_cap) tables written
        "expand1": nbytes(ro) + 64 * emit + 60 * row_cap,
        # the row prefix, 12 + 44 bytes of each kept row's tables, the
        # (14 + 2, capacity) records and indices written
        "expand2": nbytes(io) + 56 * kept + 64 * capacity,
        "pack_columns": 2 * 64 * cols.shape[1],
        "segment_reduce_rows": n * 64 + nbytes(offsets)
        + (offsets.shape[0] - 1) * 64,
    }
    offs64 = offsets.long()
    specs = [
        ("expand1", "K9a", em.expand1, em.expand1_plain, k9a, None,
         "emission.cu", "gscream_tpu/ops/emission.py:118", 20),
        ("expand2", "K9b", em.expand2, em.expand2_plain, k9b, None,
         "emission.cu", "gscream_tpu/ops/emission.py:185", 20),
        ("pack_columns", "K8", sh.pack_columns, sh.pack_columns_plain,
         (cols,), lambda: cols.t().contiguous(), "shuffle.cu",
         "gscream_tpu/ops/shuffle.py:59", 50),
        ("segment_reduce_rows", "K7", rt.segment_reduce_rows,
         rt.segment_reduce_rows_plain, (ge, offsets),
         lambda: torch.segment_reduce(ge, "sum", offsets=offs64),
         "segreduce.cu", "gscream_tpu/ops/rasterize_tiled.py:992", 50),
    ]
    results = {}
    for name, tag, kern, plain, a, lib, src, repl, reps in specs:
        ms = cuda_ms(lambda: kern(*a), reps=reps, warmup=2)
        plain_ms = cuda_ms(lambda: plain(*a), reps=1, rounds=3)
        lib_ms = cuda_ms(lib, reps=reps, warmup=2) if lib else None
        bound_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        results[name] = {
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"gscream_tpu_torch/csrc/{src}", "replaces": repl,
            "shapes": label, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "check": "bit-equal"}
        if tag == "K7":
            results[name]["check"] = ("bit-equal, rerun bit-equal, equal to "
                                      "K3 on the transposed rows")
            results[name]["runs"] = runs
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms (bytes: {moved[name]})"
            + (f", runs {runs}" if tag == "K7" else "") + f" [{SMI}]")
    log(f"K9a: {emit} emitting gaussians, row table {row_cap}; K9b: {kept} "
        f"kept rows, capacity {capacity}; K7: {n} live instances")
    return results


def compare_routes(g_pallas, g_default, cap, label):
    """The Pallas route's binning against the default route's on the same
    splats: index fields bit-equal over the live instances, K8's records
    against ``pack_instance_data``'s."""
    import torch
    from gscream_tpu_torch.ops import shuffle as sh
    from gscream_tpu_torch.ops.rasterize_tiled import pack_instance_data
    bp, bx = g_pallas.binning, g_default.binning
    require(bp.cols16 is not None and bx.cols16 is None,
            "the two steps did not take the two emission routes")
    n = min(int(bx.num_instances), cap)
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        require(torch.equal(getattr(bp, f), getattr(bx, f)),
                f"{label}: binning field {f} differs between the routes")
    for f in ("gauss_id", "emit_slot"):
        require(torch.equal(getattr(bp, f)[:n], getattr(bx, f)[:n]),
                f"{label}: binning field {f} differs over the live prefix")
    sp, dec = g_default.splats, g_default.dec
    with torch.no_grad():
        rec_p = sh.pack_columns(bp.cols16)[:n]
        rec_x = pack_instance_data(sp.mean2d, sp.conic, dec.opacity,
                                   dec.color, sp.depth, dec.uncertainty, bx,
                                   -(-WIDTH // 32))[:n]
    require(torch.equal(rec_p[:, RECORD_EXACT], rec_x[:, RECORD_EXACT]),
            f"{label}: records differ outside the power coefficients")
    a, b = rec_p[:, 6:9].double(), rec_x[:, 6:9].double()
    err = float((a - b).abs().max())
    require(bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all()),
            f"{label}: k0..k2 differ beyond rtol 1e-5, atol 1e-6 ({err})")
    log(f"{label}: binning index fields bit-equal to the default route's "
        f"over {n} live instances; K8 records vs pack_instance_data: lanes "
        f"{RECORD_EXACT} bit-equal, k0..k2 "
        + ("bit-equal" if err == 0 else f"max abs err {err:.3e}"))


def compare_grads(got, ref, label, loss_rtol):
    """Hold one step's loss (within ``loss_rtol``) and gradients (per leaf,
    the GRAD_* tolerance) to another's, and log each leaf's max abs error
    and share of elements beyond the tight bound."""
    loss, loss_ref = float(got.loss.detach()), float(ref.loss.detach())
    require(abs(loss - loss_ref) <= loss_rtol * abs(loss_ref),
            f"{label}: loss {loss} vs {loss_ref}")
    worst = {}
    for name, g in list(got.grads.items()) + [("screen", got.screen)]:
        r = ref.screen if name == "screen" else ref.grads[name]
        if not bool(r.any()):
            require(not bool(g.any()), f"{label} {name}: a gradient where "
                    "the reference has none")
            continue
        worst[name] = grad_close(g, r, f"{label} {name}")
    n_equal = sum(e == 0.0 for e, _ in worst.values())
    log(f"{label} (max abs err/share beyond tolerance; {n_equal} of "
        f"{len(worst)} leaves bit-equal): " + ", ".join(
            f"{k} {e:.2e}/{s_:.1e}" for k, (e, s_) in worst.items()))


def pallas_phase(dev, cfg, scaffold, cams, targets):
    """Phase (e): the training path under GSCREAM_EMIT=pallas
    GSCREAM_REORDER=gather.  Returns K7's, K8's and K9's lines, timed at
    view 0's shapes, and every kernel's launches over N_PALLAS_STEPS
    ``train_step`` calls."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.state import init_train_state
    from gscream_tpu_torch.train.step import loss_and_grads, phase1_masks
    t_start = time.perf_counter()
    opt = OptimConfig()
    cams = cams[:N_TRAIN_VIEWS]
    cap0 = capacity_tier(instance_demand(scaffold, cfg, cams[0]))
    require(cap0 % 1024 == 0, f"capacity {cap0}: the selector would take "
            "the XLA build")
    kw = dict(cfg=cfg, opt=opt, is_ref=True, capacity=cap0,
              masks=phase1_masks(False))

    def grads():
        return loss_and_grads(scaffold, cams[0], *targets[0], **kw)

    with environ(**PALLAS_ENV):
        g_k, args = recorded_kernel_args(grads)
    route = sorted(args)
    require(route == sorted(["run_forward", "run_backward", "expand1",
                             "expand2", "pack_columns",
                             "segment_reduce_rows"]),
            f"the Pallas-emission route called {route}")
    label = (f"Pallas-emission route, training view 0, capacity {cap0}, "
             f"{int(g_k.binning.num_instances)} instances")
    with torch.no_grad():
        results = check_pallas_kernels(args, label)
    del args

    with environ(GSCREAM_EMIT="xla", GSCREAM_REORDER="cm"):
        g_x = grads()
    compare_routes(g_k, g_x, cap0, "view 0")
    compare_grads(g_k, g_x, "step gradients, Pallas route (gather) vs "
                  "default route (xla + cm)", loss_rtol=1e-6)
    del g_k, g_x

    with environ(**PALLAS_ENV):
        ts, step_ms, launches = run_steps(
            init_train_state(scaffold, cfg), cfg, opt, cams, targets,
            N_PALLAS_STEPS, "Pallas-route")
        for name, n in launches.items():
            want = N_PALLAS_STEPS if name in PALLAS_ROUTE else 0
            require(n == want, f"kernel {name} launched {n} times on the "
                    f"Pallas-emission route, not {want}")
        for m in ts.m.values():
            require(bool(torch.isfinite(m).all()), "a moment is not finite")
        profile_step(ts, cfg, opt, cams, targets, step_ms, "Pallas-route")
    log(f"phase (e) took {time.perf_counter() - t_start:.1f} s")
    return results, launches


SMI = ""


def build_kernels():
    """Phase (a): the card, the versions, and the parallel nvcc build."""
    import torch
    from gscream_tpu_torch.ops import cuda_build
    log(f"card: {SMI}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = cuda_build.build()
    log(f"nvcc build of {sorted(took) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s (parallel: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    for name in cuda_build.SOURCES:
        for ln in cuda_build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"ptxas {name}: {ln.strip()}")


def render_phase(dev):
    """Phases (b) and (c) on ``dev``; returns K1's, K5's and K6's lines
    timed at the render path's view 0 with the render path's launch
    counts, the scene and the orbit cameras."""
    import torch
    from gscream_tpu_torch.config import ModelConfig, RunConfig, save_config
    from gscream_tpu_torch.model.io import (load_trained_scaffold,
                                            save_anchors_ply, save_mlps_npz)
    from gscream_tpu_torch.ops.binning import ROW_RATIO, row_table_size
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.render_sets import (make_render_fn,
                                                     render_set)
    t_start = time.perf_counter()

    # (b) kernels against their plain versions ------------------------------
    with torch.no_grad():
        s, colors, op, unc, w, h = small_splats(dev)
        for cap in (1 << 14, 512):
            inp = kernel_inputs(s, colors, op, unc, cap, w, h)
            demand = max(int(inp["binning"].num_instances),
                         ROW_RATIO * int(inp["binning"].num_rows))
            check_kernels(inp, f"small scene, capacity {cap} (demand "
                          f"{demand})", False)

    cfg, scaffold = bench_scene(dev)
    log(f"scene: {int(scaffold.alive.sum())} anchors, "
        f"{int(scaffold.alive.sum()) * cfg.n_offsets} neural gaussians")
    cams = orbit_cameras(dev)

    # one counting pass sizes the capacity (bench.py::_count_instances)
    demand = max(instance_demand(scaffold, cfg, cam) for cam in cams)
    capacity = capacity_tier(demand)
    log(f"counting pass: max instance demand {demand} over {N_VIEWS} views "
        f"-> capacity tier {capacity} (row table "
        f"{row_table_size(capacity)})")

    with torch.no_grad():
        dec, sp = splats_of(scaffold, cfg, cams[0])
        inp = kernel_inputs(sp, dec.color, dec.opacity, dec.uncertainty,
                            capacity, WIDTH, HEIGHT)
        results = check_kernels(
            inp, f"render view 0, capacity {capacity}, "
            f"{int(inp['binning'].num_instances)} instances", True)
    del inp

    # (c) the render path through its entry points --------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ply_dir = os.path.join(tmp, "point_cloud", "iteration_0")
        save_config(RunConfig(model=ModelConfig(
            feat_dim=cfg.feat_dim, n_offsets=cfg.n_offsets,
            voxel_size=cfg.voxel_size, anchor_capacity=cfg.capacity)),
            os.path.join(tmp, "cfg.json"))
        save_anchors_ply(os.path.join(ply_dir, "point_cloud.ply"), scaffold,
                         cfg)
        save_mlps_npz(os.path.join(ply_dir, "mlp_checkpoints.npz"),
                      scaffold.mlps)
        loaded, lcfg, _ = load_trained_scaffold(tmp, -1, dev)
        require(lcfg == cfg, f"loaded config {lcfg} != saved {cfg}")
        require(torch.equal(loaded.alive, scaffold.alive),
                "model IO round trip changed the alive mask")
        for a, b in zip(loaded.params, scaffold.params):
            require(torch.equal(a[loaded.alive], b[scaffold.alive]),
                    "model IO round trip changed the anchors")

        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        res = render_set(tmp, "test", cams, loaded, lcfg, capacity=capacity,
                         save_images=True)
        launches = {name: counters[name].launches for name in (
            "tile_forward", "expand_gauss_rows", "expand_rows")}
        n_png = len(os.listdir(os.path.join(tmp, "test", "renders")))
    log(f"render_set launches over {N_VIEWS} views: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "render path")
        results[name]["launches"] = n
    require(n_png == N_VIEWS, f"{n_png} renders written, not {N_VIEWS}")
    for d in res["overflow_demand"]:
        require(d <= capacity, f"overflow: demand {d} > capacity {capacity}")
    for img in res["renders"]:
        require(img.shape == (3, HEIGHT, WIDTH) and np.isfinite(img).all(),
                "a render is not a finite (3, H, W) image")
    log(f"render_set: {N_VIEWS} views at {WIDTH}x{HEIGHT}, FPS "
        f"{res['fps']:.2f} (skip-5 protocol), instance demand per view "
        f"{res['overflow_demand']}, capacity {capacity}, visible gaussians "
        f"{res['visible_counts']} [{SMI}]")

    # one view against the all-plain path on the card
    with torch.no_grad():
        render = make_render_fn(loaded, lcfg, WIDTH, HEIGHT, capacity)
        out_k, _, _ = render(loaded.params, loaded.mlps, cams[0])
        with plain_kernels():
            out_p, _, _ = render(loaded.params, loaded.mlps, cams[0])
        args0 = (loaded.params, loaded.mlps, cams[0])
        plain_wall = wall_ms_per_call(lambda: render(*args0), 10)
        kernels, layers, busy_ms, wall_ms = profile_calls(
            lambda: render(*args0), ("render/",))
    log(f"profile of one render of view 0: device busy {busy_ms:.3f} ms in "
        f"{sum(k[1] for k in kernels)} kernel launches; wall {wall_ms:.3f} "
        f"ms under the profiler (idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}), {plain_wall:.3f} ms "
        f"without it over 10 renders each to a sync (idle share "
        f"{max(0.0, 1 - busy_ms / plain_wall):.3f}) [{SMI}]")
    for name, dev_ms in layers.items():
        log(f"  layer {name}: {dev_ms:.4f} ms device")
    for dev_ms, calls, name in kernels[:12]:
        log(f"  {dev_ms:9.4f} ms  x{calls:<3d} {name[:90]}")
    cover = float(out_k.final_t.mean())
    require(cover < 1.0, f"mean final T {cover}: the view is empty")
    for f in out_k._fields:
        a, b = getattr(out_k, f), getattr(out_p, f)
        require(bool(torch.isfinite(a).all()), f"view 0 {f} is not finite")
        err, bad = compare_images(a, b)
        if bad > MAX_FLIP_FRACTION:
            raise AssertionError(f"view 0 {f}: kernels vs plain max abs "
                                 f"{err}, {bad:.2e} beyond tolerance")
        log(f"view 0 {f}: kernels vs all-plain max abs err {err:.3e}, "
            f"beyond tolerance {bad:.2e}")
    log(f"view 0 mean final T {cover:.4f}; phases (b)-(c) took "
        f"{time.perf_counter() - t_start:.1f} s")
    return results, cfg, scaffold, cams


def kernels_line(render, train, train_launches, pallas, pallas_launches):
    """The ``{"kernels": [...]}`` record: each kernel's line from the
    training route that runs it (K7-K9 from phase (e), the others from
    phase (d)), timed at its view 0 and holding that route's launch
    count; beside it both training routes' counts and the render path's,
    and, for the kernels the render path runs, its own line."""
    out = []
    for name in launch_counters():
        if name in pallas:
            rec = dict(pallas[name])
            rec["launches"] = pallas_launches[name]
        else:
            rec = dict(train[name])
        rec["launches_train"] = train_launches[name]
        rec["launches_emit_pallas"] = pallas_launches[name]
        r = render.get(name)
        rec["launches_render"] = r["launches"] if r else 0
        if r:
            rec["render"] = {k: r[k] for k in (
                "shapes", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
        out.append(rec)
    return {"kernels": out}


def main():
    global SMI
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "False; this check needs a CUDA card")
    import gscream_tpu_torch  # noqa: F401  (fails outside a checkout)
    SMI = smi_line()
    build_kernels()
    dev = torch.device("cuda")
    render, cfg, scaffold, cams = render_phase(dev)
    targets = training_targets(dev, cfg, cams[:N_TRAIN_VIEWS])
    train, train_launches = train_phase(dev, cfg, scaffold, cams, targets)
    pallas, pallas_launches = pallas_phase(dev, cfg, scaffold, cams,
                                           targets)
    # the kernels line, the card, the result
    print(json.dumps(kernels_line(render, train, train_launches, pallas,
                                  pallas_launches)))
    print(SMI)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
