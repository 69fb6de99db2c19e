#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (NVIDIA Hopper, sm_90a) and ``nvcc``; imports nothing
of JAX or of the JAX package.  Phases, each failing loudly (no phase
catches its own failure):

(a) environment and build: the card's name and power limit, the torch
    and CUDA versions, and the parallel ``nvcc`` build of every kernel
    under ``gscream_tpu_torch/csrc/`` (with ``ptxas`` register counts);
(b) each kernel against its plain PyTorch version on the card — K5 and
    K6 bit-equal, also on a second call and after CUDA-graph replays,
    and K5's counting launch bit-equal; K1 within tolerance — at a small
    seeded scene (fitting and overflowing capacities) and at the
    full-width scene's view 0 (the render's capacity tier, and one
    capacity that overflows the row table and one that overflows only
    the instance slots), with times from CUDA events around host-paced
    calls (``ms``), from CUDA-graph replays (``graph_ms``, the device
    time without the host's) and from the profiler, and the emission
    front (K5 and K6, against the parent's torch ops around its K5 and K6
    with ``--parent``) timed the same ways with its launches per
    ``bin_instances`` call;
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
    arguments (K5 and K6 as in (b), with the front; K2 within tolerance
    and bit-equal to the path's own
    output, K4 and K3 bit-equal, K3 also on a rerun and to K7 on the
    transposed columns; K3's line carries the run statistics that set its
    time), K1 and K2 blending the same pairs (at every pixel of every
    tile, K1's Σw bit-equal to the w K2 gives each instance there, summed
    in K1's order), K1 and K2 built with -DGS_NO_CULL bit-equal to the
    port's (the cull changes nothing), the step's gradients kernel path
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
    step and K3, K4, K5 and K6 never; the environment is restored after;
(f) the training loop: ``train_scene`` for 48 iterations on the same
    model and targets (compressed schedule: densifications, phase 2, a
    checkpoint) at pipeline depth 3 (``GSCREAM_PIPELINE``), the same
    schedule at depths 1 and 3 in turns, each bit-equal to it (every
    state tensor, the losses, steps and events), the wall ms per
    iteration of each depth and phase, a second run resumed from the
    checkpoint bit-equal, the costs of densification and checkpoints, the
    synchronizing calls of one launched phase-1 and phase-2 step (sync
    debug mode "warn", by file:line), one phase-2 step profiled;
(g) evaluation and the spiral split at full width on the model (f)
    trained: the test split (views 4-9, teacher targets, the central
    box as mask) through ``render_set`` with K1, K5 and K6 counted,
    scored by ``evaluate_pairs`` on the card with seeded random LPIPS
    weights (every key of JAX's ``results.json``/``per_view.json``), the
    same renders scored on the CPU within stated tolerances, one view
    rendered through the plain twins scored within a stated tolerance,
    the card's ms per view per metric; ``N_SPIRAL`` ``get_spiral`` poses
    through ``render_set(..., "spiral")`` (renders, inferno depths,
    normal maps, a video; the PNG-in-AVI fallback's ``N_SPIRAL`` frames
    each bit-equal to its render), one frame's normals on the card
    bit-equal to the CPU's; then ``train_torch.py --synthetic`` at
    128x128 with the evaluation callback and evaluation, and
    ``render_torch.py --eval`` and ``evaluate_torch.py`` on what it
    wrote;
(h) multi-GPU training over a (data, tiles) mesh on a fresh copy of the
    model: at view 0 of the training path, K1 and K2 per band for 2 and
    4 bands (the stitched band images bit-equal to the full frame's K1,
    each band's K2 rows bit-equal to the full frame's in the band's
    slots and zero outside them, and within GRAD_* of the plain twin;
    the per-band K4+K3 sums added over the bands within BAND_SUM_* of the
    full frame's); then ``SHARD_STEPS`` steps of
    ``make_sharded_train_step`` at meshes (1, 2) and (2, 1) in a world
    of two spawned ranks (NCCL with a card each where there are two
    cards, else gloo sharing the one card, staged through host memory:
    these are the path's costs, not a scaling result), (1, 2) held to
    the single-device ``train_step`` (TRAJ_*), (2, 1)'s first loss to
    the mean of its views' losses (DP_LOSS_RTOL), the replicas bit-equal, wall ms per
    step and launches per rank-step; then ``train_torch.py --synthetic
    --mesh_tiles 2`` as two ranks against one process; then
    ``train_scene`` at mesh (1, 2) in two ranks at pipeline depths 1
    and 3, with an overflow re-run, a densification and phase 2,
    bit-equal;
(i) the JAX package's other configurations, on a fresh copy of the
    model at view 0 of the training targets: raw K1 and K2
    (``GSCREAM_KERNEL_COEFF=1``) on the arguments one ``loss_and_grads``
    call gave them, against their plain twins (ATOL and
    MAX_FLIP_FRACTION, GRAD_* per lane), against legacy K1 and K2 on the
    legacy records of the same binning (bit-equal by design: reported,
    else held to the same tolerances), timed in turns with them, then per
    band for 2 and 4 bands with ``tile_base`` (the stitched bands bit-equal
    to the whole frame); the counting passes' row-tight and full-rect
    instance counts; for each mode of MODES (raw records, ``ROW_TIGHT=0``,
    ``TIGHT_CULL=0``, ``precise_sort=False``, ``SORT_FUSED=1``,
    ``loss_dtype="bfloat16"``, ``SCATTER_REDUCE=1``) the render and one
    ``loss_and_grads`` call, sized by its own counting pass, against the
    default's (raw, full-rect and scatter gradients within GRAD_*, the
    fused sort bit-equal, the quantized sort's render held to the plain
    twins on its own binning and its distance to the precise one
    reported, the bfloat16 head within ``tests/test_bf16_losses.py``'s
    bounds on that test's inputs); one sharded step at mesh (1, 2) in two
    spawned ranks with raw records against legacy; then 3 ``train_step``
    calls per mode with the launch counters reset just before each and
    read just after (each mode launches exactly its route's kernels once
    a step), their wall ms and instances;
(j) the port's bench: ``bench_torch.py`` in a subprocess, its JSON line
    (every key of ``bench.py``'s, a finite positive rate, no overflow)
    printed, again with ``GSCREAM_TRACE`` set (a trace must be written),
    then one iteration of its workload with the launch counters reset
    just before and read just after (``launches_bench``);
(k) the profiling scripts: ``profile_train_step_torch.py`` in a
    subprocess on ``bench_torch.py``'s scene at 1008×567, plain and with
    ``GSCREAM_TRACE`` (``PROFILE_ITERS`` calls per variant: phase 1,
    phase 1 without statistics, phase 2; then the loss head alone), its
    lines checked; ``trace_summary_torch.py`` on each variant's trace and
    on phase (j)'s bench trace (each must exit 0 and name K1 and K2);
    for each, the device busy ms per call against the wall, the idle
    share, the five largest device entries and the default route's
    kernels per call in the trace; then one ``train_step`` of each
    variant in this process with the launch counters reset just before
    and read just after (``launches_profile``: K1-K6 once a step, the
    dual softmax pair once in the phase-2 step and never in the others);
(l) the cross-attention's dual softmax (``ops/attention.py``): both
    kernels at ``ATTN_SHAPE`` against their plain versions (each element
    within the module's KERNEL_RTOL plus KERNEL_ATOL of the largest plain
    element), a rerun bit-equal, then each timed (CUDA events, graph
    replays, the profiler's kernels) beside its plain version, the
    library's backward and its byte bound; its JSON line printed.  The
    pair's launch counters are held in the other phases: at least once
    each per phase-2 iteration of the loop (f) and of the mesh (1, 2)
    loop (h), once in one launched phase-2 step, never in a phase-1 step
    (d, e, f, h, i, j, k) or a render (c, g).

It prints a ``{"kernels": [...]}`` JSON line (each kernel's line from
its path: K7-K9 from phase (e), raw K1 and K2 from phase (i), the dual
softmax pair A1 and A2 from phase (l), the others from phase (d), with the
render path's, each training route's, the loop's and phase (g)'s
launch counts (``launches_eval``, ``launches_spiral``), phase (h)'s
summed over its ranks and meshes (``launches_sharded``) and over the
mesh (1, 2) loop's ranks and depths (``launches_sharded_loop``), phase (i)'s
over its steps (``launches_modes``), phase (j)'s per bench iteration
(``launches_bench``), phase (k)'s over its three steps
(``launches_profile``) and the render
path's line beside it; K3-K9's lines also carry ``graph_ms`` and the
profiler's device time and launches per call; K1's and K2's lines also
carry the tile-count
distribution, the registers, shared and local memory and CTAs per SM
that the card reports for the loaded kernels, the no-cull builds' times
and, with ``--parent DIR``, the times of DIR's K1 and K2 measured in
turns with the port's: ``python3 chip_smoke.py --parent DIR``, DIR a
checkout of an earlier tree, whose K5 and K6 and the torch ops around
them are also timed beside this tree's), then the card's
``nvidia-smi`` name/power-limit line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or outside a checkout of the repo, it exits
non-zero without printing a result.  ``--phase f|h|i|j|k|l`` builds the
kernels and runs that phase alone (k after j, whose bench trace it
reads; l the cross-attention's dual softmax alone; on a host with two or
more cards
phase (h)'s ranks take a card each, over NCCL), printing its launches
(phase (i): raw K1's and K2's lines too) and the card's line but no
result line.
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
# phase (f): the training loop's schedule, the reference OptimConfig's
# (start_stat 500, densify every 100 from 1,500 to 15,000, phase 2 from
# 15,000) compressed to 48 iterations; its thresholds stay the reference's
LOOP_ITERS = 48
LOOP_CHECKPOINT = 24
LOOP_OPTIM = dict(iterations=LOOP_ITERS, start_stat=2, update_from=4,
                  update_interval=12, update_until=LOOP_ITERS,
                  start_crossattn_from=LOOP_CHECKPOINT)
# the loop's pipeline depths (GSCREAM_PIPELINE) held bit-equal to each
# other and timed in turns; the last is the counted run's, the default
LOOP_DEPTHS = (1, 3)
# phase (h): the loop at mesh (1, 2) at each pipeline depth, bit-equal: an
# overflow re-run at the first step, a densification at 3, phase 2 from 4
SHARD_PIPE_OPTIM = dict(iterations=6, start_stat=1, update_from=2,
                        update_interval=3, update_until=6,
                        start_crossattn_from=3)
# phase (j): bench_torch.py's keys and its time limit; the calls its
# traced block holds (bench_torch.time_config's default)
BENCH_TIMEOUT_S = 600
BENCH_ITERS = 10
# phase (k): profile_train_step_torch.py's calls per variant and the
# symbols of the default route's kernels in a profiler trace
PROFILE_ITERS = 5
ROUTE_SYMBOLS = {"tile_forward": "tile_forward_kernel",
                 "tile_backward": "tile_backward_kernel",
                 "segment_reduce": "segreduce_chunks",
                 "unpack_columns": "unpack_columns_kernel",
                 "expand_gauss_rows": "expand_gauss_rows_kernel",
                 "expand_rows": "expand_rows_kernel"}
# phase (l): the dual softmax of the cross-attention at its benchmark shape
# (8 heads, the 2,000-token cap on both sides), both sides valid on one
# prefix as the token draw leaves them, and the yardstick's seed
ATTN_SHAPE = (8, 2000, 2000)
ATTN_VALID = 1733
ATTN_SCALE = 64 ** -0.5
# its two wrappers (by their names in launch_counters): once each per
# phase-2 step, never in a phase-1 step or a render
ATTN_KERNELS = ("dual_softmax_fwd", "dual_softmax_bwd")
# phase (g): the spiral's poses, the views scored again on the CPU (VGG16
# at 1297x840 takes seconds there), and the keys JAX's results.json and
# per_view.json carry with LPIPS weights and masks
N_SPIRAL = 12
EVAL_CPU_VIEWS = 2
RESULT_KEYS = ("PSNR", "SSIM", "LPIPS", "PSNR_masked", "SSIM_masked",
               "LPIPS_masked")
SMOKE_DIR = "smoke_out"     # git-ignored: the random LPIPS weights
# phase (g) tolerances.  The card's scores against the CPU's on the same
# render: the means run in other orders and cuDNN's convolutions sum
# otherwise than the CPU's (TF32 off on both), so PSNR within 1e-4 dB,
# SSIM within 1e-6, LPIPS within 1e-4 relative
EVAL_PSNR_ATOL = 1e-4
EVAL_SSIM_ATOL = 1e-6
EVAL_LPIPS_RTOL = 1e-4
# the render through the plain twins against the kernels' render, both
# scored on the card: the images agree to ATOL except where a T < 1e-4
# stop moves by one instance, whose weight is below 1e-4
PLAIN_PSNR_ATOL = 1e-2
PLAIN_SSIM_ATOL = 1e-4
PLAIN_LPIPS_RTOL = 1e-3
# normals on the card against the same function on the CPU: bit-equal
# (every step is elementwise, the solve a float64 closed form), so the
# flip fraction allowed is 0
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


GRAPH_CALLS = 10        # calls of the wrapper captured in one CUDA graph


def graph_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Device time of one ``fn()`` without its host cost: GRAPH_CALLS
    calls captured in one CUDA graph (after a warm call on a side stream,
    as capture wants), ``reps`` replays back to back between CUDA events,
    divided by the calls; the median of ``rounds``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (reps * GRAPH_CALLS))
    del graph
    return float(np.median(times))


def device_ms(fn, n=20):
    """:func:`profile_calls`' view of one ``fn()`` over ``n`` calls: the
    device time of every kernel and memset it launched, its launches, and
    {kernel name: device ms}, per call."""
    kernels, _, busy, _ = profile_calls(fn, (), n)
    names = {}
    for ms, _, key in kernels:
        name = key.removeprefix("void ").removeprefix(
            "(anonymous namespace)::").split("(")[0]
        names[name] = names.get(name, 0.0) + ms
    return busy, sum(k[1] for k in kernels), names


def device_times(rec, fn):
    """Add ``fn``'s (one wrapper call's) device times to its kernel line
    ``rec``: ``graph_ms`` (:func:`graph_ms`) and the profiler's device ms,
    launches and kernel names per call (:func:`device_ms`); returns them
    as a phrase for the log."""
    rec["graph_ms"] = graph_ms(fn)
    rec["device_ms"], rec["launches_per_call"], rec["device_kernels"] = \
        device_ms(fn)
    return (f", graph {rec['graph_ms']:.4f} ms, profiler device "
            f"{rec['device_ms']:.4f} ms in {rec['launches_per_call']} "
            f"launches {rec['device_kernels']}")


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
    profiler).  A kernel's device ms per call is its mean time times its
    launches per call, so that an event the profiler drops does not count
    as a shorter call."""
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
        elif e.device_type == DeviceType.CUDA and e.count:
            per_call = round(e.count / n)
            kernels.append((e.self_device_time_total / e.count / 1e3
                            * per_call, per_call, e.key))
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
    from gscream_tpu_torch.ops.binning import emission_counts, row_ratio
    import torch
    with torch.no_grad():
        _, sp = splats_of(scaffold, cfg, cam)
        ni, nr = emission_counts(sp, 32, 32)
    return max(int(ni), row_ratio() * int(nr))


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
    k5_args = bn._splat_fields(splats) + (row_cap, capacity, 32, 32, gx)
    binning = bn.bin_instances(splats, capacity, w, h, 32, 32)
    table = bn.expand_gauss_rows(*k5_args)
    inst = pack_instance_data(splats.mean2d, splats.conic, opacity, colors,
                              splats.depth, unc, binning, gx)
    return {"k5": k5_args,
            "k6": (table.rows, table.ioffs, table.counts, capacity, n_tiles),
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


def k5_bytes(k5_args):
    """Bytes K5 must move: the radius and rect (20 bytes) of every
    gaussian, mean2d, conic, t_iso and depth (28 bytes) of each that owns
    a row below ``row_cap``, the (4, row_cap) table and ``ioffs`` it
    writes (20 bytes a slot), the (N+1) offsets, the two counts, and its
    look-back scratch (8 bytes per chunk and chain, and the ticket)."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    radius, rmin, rmax = k5_args[:3]
    n, row_cap = radius.shape[0], k5_args[7]
    h = em.rect_heights(radius, rmin, rmax).long()
    first = torch.cumsum(h, 0) - h
    emit = int(((h > 0) & (first < row_cap)).sum())
    scratch = 8 * (2 * -(-n // em.K5_CHUNK) + 1)
    return 20 * n + 28 * emit + 20 * row_cap + 4 * (n + 1) + 8 + scratch


def k6_bytes(rows, capacity):
    """Bytes K6 must move: each live row that emits (w_row > 0) read once
    as (tile_base, gid, depth_bits, its slot offset), the two counts, and
    the (3, capacity) slots it writes."""
    return 16 * int((rows[3] > 0).sum()) + 8 + 3 * 4 * capacity


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


def tile_stats(tile_count):
    """The tile-count distribution that sets K1's and K2's time: the
    number of tiles, the mean, p99 and most instances per tile, and the
    empty tiles."""
    import torch
    c = tile_count.double()
    return {"tiles": int(c.numel()), "mean": float(c.mean()),
            "p99": float(torch.quantile(c, 0.99)), "max": int(c.max()),
            "empty": int((c == 0).sum())}


def ptxas_stats(log: str, kernel: str):
    """Registers, static shared memory and spills of the ``__global__``
    function whose mangled name matches the pattern ``kernel``, from an
    ``nvcc -Xptxas -v`` log."""
    import re
    stats, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            current = m.group(1)
            continue
        if current is None or not re.search(kernel, current):
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, ln)
            if m:
                stats[key] = int(m.group(1))
    return stats


def kernel_attributes(name, symbol):
    """What the card reports for the loaded kernel behind the C entry
    ``symbol`` of ``csrc/<name>.cu`` (``gs::kernel_attributes``,
    ``cudaFuncGetAttributes``): registers per thread, static shared
    memory, local memory per thread (0: no spills) and CTAs per SM."""
    import ctypes
    from gscream_tpu_torch.ops import cuda_build as cb
    out = (ctypes.c_int * 4)()
    cb.raise_on_error(cb.function(name, symbol, "p")(
        ctypes.cast(out, ctypes.c_void_p)), symbol)
    return dict(zip(("registers", "smem_bytes", "local_bytes",
                     "ctas_per_sm"), out))


# K1's Σw at a pixel is a float32 sum of n terms w ≥ 0 (products by 1.0,
# exact); in any order it lies within γ(n − 1)·Σw of the exact sum,
# γ(k) = k·u/(1 − k·u), u = 2^-24 (Higham, Accuracy and Stability of
# Numerical Algorithms, §4.2)
F32_UNIT = 2.0 ** -24
AGREE_PIXELS = 5        # pixels per backward call: one per cotangent lane
AGREE_GROUP = 255       # pixels whose weights are held at once


def blend_agreement(inst, tile_start, tile_count, n_tiles, forward,
                    backward, pixels=range(1024)):
    """K1's and K2's weights w = α·T at each tile's pixels ``pixels``, on
    the records with their five channels r, g, b, depth, unc set to 1.
    K1's row 1 at a pixel is then Σ w over the instances it blends there,
    summed in float32 in instance order; K2's lane c + 1 of an instance
    is its w at the pixel whose cotangent c alone is 1 (one term, exact),
    five pixels per call.  Returns, each (n_tiles, len(pixels)): K1's
    sums, K2's w summed in float32 in instance order (K1's own order),
    in float64, and the count of K2's nonzero w.  The tile ranges must be
    ascending and contiguous from slot 0."""
    import torch
    dev = inst.device
    pixels = [int(q) for q in pixels]
    rec = inst.clone()
    rec[:, 1:6] = 1.0
    k1 = forward(rec, tile_start, tile_count, n_tiles)[:, 1][:, pixels]
    starts, counts = tile_start.long(), tile_count.long()
    n_live = int(starts[-1] + counts[-1]) if n_tiles else 0
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                      counts)
    seq = torch.zeros_like(k1)
    s64 = torch.zeros(k1.shape, dtype=torch.float64, device=dev)
    n = torch.zeros(k1.shape, dtype=torch.float64, device=dev)
    for g0 in range(0, len(pixels), AGREE_GROUP):
        cols = slice(g0, min(g0 + AGREE_GROUP, len(pixels)))
        w = torch.empty((n_live, cols.stop - g0), dtype=torch.float32,
                        device=dev)
        for c0 in range(g0, cols.stop, AGREE_PIXELS):
            group = pixels[c0:min(c0 + AGREE_PIXELS, cols.stop)]
            pix = torch.zeros((n_tiles, 8, 1024), dtype=torch.float32,
                              device=dev)
            for lane, q in enumerate(group):
                pix[:, lane, q] = 1.0
            rows = backward(rec, pix, tile_start, tile_count, n_tiles)
            w[:, c0 - g0:c0 - g0 + len(group)] = rows[:n_live,
                                                      1:1 + len(group)]
        acc = seq[:, cols]
        for k in range(int(counts.max()) if n_tiles else 0):
            live = (counts > k)[:, None]
            acc = torch.where(live, acc + w[(starts + k).clamp_max(
                n_live - 1)], acc)
        seq[:, cols] = acc
        s64[:, cols].index_add_(0, tile_of, w.double())
        n[:, cols].index_add_(0, tile_of, (w != 0).double())
    return k1, seq, s64, n


def check_agreement(inst, tile_start, tile_count, n_tiles, forward,
                    backward, label, pixels=range(1024), sequential=True):
    """:func:`blend_agreement` held per (tile, pixel): K1's Σw within
    γ(n − 1)·Σw of K2's float64 sum of the same n weights, which any
    float32 order keeps, and with ``sequential`` (K1's kernel, which sums
    in instance order) bit-equal to K2's weights summed in that order.
    A pair that one side blends and the other does not moves Σw by its w,
    which the first test sees above 2·γ(n − 1)·Σw and the second once it
    moves the float32 sum.  Returns (pairs of (tile, pixel) checked, the
    largest |K1 − float64 sum| over its limit, the pairs bit-equal to the
    sequential sum)."""
    import torch
    k1, seq, s64, n = blend_agreement(inst, tile_start, tile_count,
                                      n_tiles, forward, backward, pixels)
    ku = (n - 1).clamp_min(0) * F32_UNIT
    limit = ku / (1 - ku) * s64
    err = (k1.double() - s64).abs()
    ratio = float(torch.where(err == 0, torch.zeros_like(err),
                              err / limit.clamp_min(1e-300)).max())
    same = int((k1 == seq).sum())
    require(ratio <= 1.0, f"K1 and K2 blend different pairs ({label}): "
            f"Σw at a pixel differs from K2's by {ratio:.3g} times the "
            "float32 rounding limit")
    require(not sequential or same == k1.numel(), f"K1 and K2 blend "
            f"different pairs ({label}): Σw at {k1.numel() - same} of "
            f"{k1.numel()} (tile, pixel) pairs differs from K2's weights "
            "summed in K1's order")
    return k1.numel(), ratio, same


# ---------------------------------------------------------------------------
# K1 and K2 built from other sources or flags (the parent's with
# ``--parent DIR``; the port's with -DGS_NO_CULL, which evaluates every
# pair), called through their own C signatures

PARENT = {}
NOCULL = {}
# the legacy kernel's name in ptxas's log: a template instance since raw
# records came (``ILb0E``), a plain function in an earlier tree (``E``)
TILE_SYMBOLS = {"rasterize_fwd": ("gs_tile_forward",
                                  r"tile_forward_kernel(ILb0E|E)"),
                "rasterize_bwd": ("gs_tile_backward",
                                  r"tile_backward_kernel(ILb0E|E)")}


def nvcc_start(src, so, extra=()):
    """Start ``nvcc`` on ``src`` with the port's flags and ``extra``;
    returns the process (:func:`tile_kernel_from` waits for it)."""
    from gscream_tpu_torch.ops import cuda_build as cb
    os.makedirs(os.path.dirname(str(so)), exist_ok=True)
    return subprocess.Popen(
        [cb.nvcc()] + cb.ARCH + cb.BASE_FLAGS + list(extra)
        + ["-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def tile_kernel_from(kind, src, so, proc):
    """Once ``proc`` built ``src`` (a K1 source if ``kind`` is
    ``rasterize_fwd``, a K2 source if ``rasterize_bwd``) into ``so``: a
    function with its wrapper's arguments (``run_forward``'s or
    ``run_backward``'s) that calls the C entry with the arguments named
    by its parameter names (``work`` gets scratch of 1 + n_tiles int32),
    and the kernel's ``ptxas`` statistics."""
    import ctypes
    import re
    import torch
    from gscream_tpu_torch.ops import cuda_build as cb
    out, _ = proc.communicate()
    require(proc.returncode == 0, f"nvcc of {src} failed:\n{out}")
    symbol, kernel = TILE_SYMBOLS[kind]
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                     open(src).read()).group(1)
    params = [(("i" if re.match(r"\s*int\s+\w+\s*$", a) else "p"),
               re.findall(r"\w+", a)[-1]) for a in decl.split(",")]
    fn = getattr(ctypes.CDLL(str(so)), symbol)
    fn.argtypes = [ctypes.c_int if k == "i" else ctypes.c_void_p
                   for k, _ in params]
    fn.restype = ctypes.c_int

    def call(*args):
        if kind == "rasterize_fwd":
            inst, ts, tc, n_tiles = args
            out = torch.empty((n_tiles, 8, 1024), device=inst.device)
            named = dict(inst=inst, tile_start=ts, tile_count=tc,
                         n_tiles=n_tiles, out=out)
        else:
            inst, pix, ts, tc, n_tiles = args
            out = torch.empty_like(inst)
            named = dict(inst=inst, pix=pix, tile_start=ts, tile_count=tc,
                         n_tiles=n_tiles, capacity=inst.shape[0], out=out)
        named["work"] = torch.empty(1 + n_tiles, dtype=torch.int32,
                                    device=inst.device)
        vals = [cb.stream_of(inst) if n == "stream" else named[n]
                if k == "i" else cb.ptr(named[n]) for k, n in params]
        cb.raise_on_error(fn(*vals), f"{src}")
        return out
    return call, ptxas_stats(out, kernel)


def variant_build(root, tag, extra=()):
    """Start ``nvcc`` on ``root``'s ``rasterize_fwd.cu`` and
    ``rasterize_bwd.cu`` with ``extra``; :func:`variant_load` finishes."""
    from gscream_tpu_torch.ops import cuda_build as cb
    procs = {}
    for kind in TILE_SYMBOLS:
        src = os.path.join(root, "gscream_tpu_torch", "csrc", f"{kind}.cu")
        so = cb.BUILD / f"lib{tag}_{kind}.so"
        procs[kind] = (src, so, nvcc_start(src, so, extra))
    return procs


def variant_load(procs, into, tag):
    for kind, (src, so, proc) in procs.items():
        into[kind] = tile_kernel_from(kind, src, so, proc)
        log(f"{tag} {kind} built from {src}: ptxas {into[kind][1]}")


def time_against_parent(name, kern, args, reps, new_ms, plain, check):
    """The parent's kernel beside the new one in turns (new, parent,
    parent, new; ``new_ms`` is the first), after holding the parent's
    output to the plain version with ``check``; ``parent_ms`` null
    without ``--parent``."""
    if name not in PARENT:
        return {"parent_ms": None, "parent": "not measured (no --parent)"}
    call, ptx = PARENT[name]
    check(call(*args), plain)
    p1 = cuda_ms(lambda: call(*args), reps=reps, warmup=2)
    p2 = cuda_ms(lambda: call(*args), reps=reps, warmup=2)
    n2 = cuda_ms(lambda: kern(*args), reps=reps, warmup=2)
    return {"parent_ms": [p1, p2], "new_ms_turns": [new_ms, n2],
            "parent_ptxas": ptx}


def check_without_cull(k1_args, k2_args, label):
    """K1 and K2 built with -DGS_NO_CULL, which evaluate every (instance,
    block) pair, bit-equal to the port's on the same arguments: the cull
    (``may_pass``, ``csrc/blend.cuh``) changes no output.  Returns the
    no-cull builds' times, what the cull saves."""
    import torch
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    ms = {}
    for kind, kern, args, reps in (("rasterize_fwd", rt.run_forward,
                                    k1_args, 20),
                                   ("rasterize_bwd", rt.run_backward,
                                    k2_args, 10)):
        call = NOCULL[kind][0]
        got, ref = call(*args), kern(*args)
        sync()
        require(torch.equal(got, ref), f"{kind} without the cull differs "
                f"from the port's ({label}): {int((got != ref).sum())} "
                "entries")
        ms[kind] = cuda_ms(lambda: call(*args), reps=reps, warmup=2)
        log(f"{kind} built with -DGS_NO_CULL is bit-equal ({label}): "
            f"{ms[kind]:.4f} ms [{SMI}]")
    return ms


def same(a, b):
    """Bit-equal tensors, or tuples of them (K5's ``RowTable``)."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def check_expand(k5_args, n_tiles, label):
    """K5 and K6 (K6 on K5's table) bit-equal to their plain versions, to
    themselves on a second call and after CUDA-graph replays of one
    captured call of each (the capture holds the zeroing of K5's
    look-back scratch); K5's counting launch bit-equal to its plain
    version and, where the table holds every row, to K5's counts.
    Returns K5's table and K6's slots."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    row_cap, capacity, tile_w, tile_h = k5_args[7:11]

    def both():
        t = em.expand_gauss_rows(*k5_args)
        return t, em.expand_rows(t.rows, t.ioffs, t.counts, capacity,
                                 n_tiles)
    table, inst = both()
    sync()              # a fault during the launch surfaces here
    ref = em.expand_gauss_rows_plain(*k5_args)
    for f in table._fields:
        a, b = getattr(table, f), getattr(ref, f)
        require(torch.equal(a, b), f"K5 {f} differs from its plain version "
                f"({label}): {int((a != b).sum())} entries")
    inst_p = em.expand_rows_plain(table.rows, table.ioffs, table.counts,
                                  capacity, n_tiles)
    require(torch.equal(inst, inst_p), f"K6 differs from its plain version "
            f"({label}): {int((inst != inst_p).sum())} entries")
    again = both()
    sync()
    require(same(again[0], table) and torch.equal(again[1], inst),
            f"K5 or K6 rerun is not bit-equal ({label})")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = both()
    for i in range(2):
        graph.replay()
        sync()
        require(same(replayed[0], table) and torch.equal(replayed[1], inst),
                f"K5 or K6 after CUDA-graph replay {i + 1} is not bit-equal "
                f"({label})")
    del graph, replayed
    counts = em.count_emission(*k5_args[:7], tile_w, tile_h)
    sync()
    require(torch.equal(counts, em.count_emission_plain(
        *k5_args[:7], tile_w, tile_h)), f"K5's counting launch differs from "
        f"its plain version ({label})")
    n_rows, total = table.counts.tolist()
    require(row_cap < n_rows or torch.equal(counts, table.counts),
            f"K5's counting launch {counts.tolist()} differs from its table's "
            f"counts {[n_rows, total]} ({label})")
    log(f"{label}: K5 bit-equal ({n_rows} rows for a table of {row_cap}, "
        f"{total} instances for {capacity} slots), K6 bit-equal "
        f"{tuple(inst.shape)}, both rerun and graph replay bit-equal; K5 "
        f"counting {counts.tolist()} bit-equal")
    return table, inst


def check_kernels(inp, label, timed):
    """Hold K5, K6 (:func:`check_expand`) and K1 against their plain
    versions on ``inp``; when ``timed``, time them and return each
    kernel's line, its launch count left to the caller, with the emission
    front against the parent's (:func:`compare_fronts`) on K5's line."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt

    def run(fn, args):
        out = fn(*args)
        sync()          # a fault during the launch surfaces here
        return out

    rows, ioffs, counts, capacity, n_tiles = inp["k6"]
    table, _ = check_expand(inp["k5"], n_tiles, label)
    require(same((rows, ioffs, counts),
                 (table.rows, table.ioffs, table.counts)),
            f"the path's K5 table differs from K5 called again ({label})")
    k1_k, k1_p = run(rt.run_forward, inp["k1"]), run(rt.run_forward_plain,
                                                     inp["k1"])
    err, bad = compare_images(k1_k, k1_p)
    if bad > MAX_FLIP_FRACTION or not torch.isfinite(k1_k).all():
        raise AssertionError(f"K1 differs from its plain version ({label}): "
                             f"max abs {err}, {bad:.2e} of outputs beyond "
                             "tolerance")
    log(f"{label}: K1 max abs err {err:.3e}, beyond tolerance {bad:.2e}")
    if not timed:
        return {}
    inst, ts, tc, n_tiles = inp["k1"]
    k5_moved = k5_bytes(inp["k5"])
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
            "library_ms": None, "check": "bit-equal, rerun and CUDA-graph "
            "replay bit-equal" if tag != "K1" else
            f"max abs err {e:.3e}, beyond tolerance {bad:.2e}"}
        extra = ""
        if tag != "K1":
            extra = device_times(results[name], lambda: kern(*args))
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms (host-paced), "
            f"plain {plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({by})"
            f"{extra} [{SMI}]")
    results["expand_gauss_rows"]["front"] = compare_fronts(
        inp["k5"], label)

    def k1_check(got, ref):
        e_, bad_ = compare_images(got, ref)
        require(bad_ <= MAX_FLIP_FRACTION, f"the parent's K1 differs from "
                f"the plain version ({label}): {bad_:.2e} beyond tolerance")
    k1 = results["tile_forward"]
    k1["tiles"] = tile_stats(tc)
    k1["attrs"] = kernel_attributes("rasterize_fwd",
                                    "gs_tile_forward_attributes")
    k1.update(time_against_parent("rasterize_fwd", rt.run_forward,
                                  inp["k1"], 20, k1["ms"], k1_p, k1_check))
    log(f"K1 at {label}: tiles {k1['tiles']}, attributes {k1['attrs']}, "
        f"parent {k1.get('parent_ms')} ms, new in turns "
        f"{k1.get('new_ms_turns')} [{SMI}]")
    log(f"K1 pairs {work}, float32 operations {k1_flops} "
        f"({k1_flops / F32_OPS_PER_S * 1e3:.4f} ms), exponentials "
        f"{work['exp'] / EX2_PER_S * 1e3:.4f} ms on the special-function "
        f"pipe, bytes {k1_moved} ({k1_bytes_s * 1e3:.4f} ms); K5 bytes "
        f"{k5_moved}, K6 bytes {k6_moved}")
    return results


# ---------------------------------------------------------------------------
# the emission front (rect heights to instance slots and offsets): this
# tree's K5 and K6 against the parent's (``--parent DIR``) with the torch
# ops the parent ran around them

PARENT_EMISSION = {}


def parent_emission_build(root):
    """Start ``nvcc`` on ``root``'s ``emission.cu`` with the port's flags
    for it; :func:`parent_emission_load` finishes."""
    from gscream_tpu_torch.ops import cuda_build as cb
    src = os.path.join(root, "gscream_tpu_torch", "csrc", "emission.cu")
    so = cb.BUILD / "libparent_emission.so"
    return src, so, nvcc_start(src, so, cb.SOURCES["emission"][1])


def parent_emission_load(src, so, proc):
    """The parent's K5 and K6 C entries, which take the row prefix
    (``row_offs``) and a (4, row_cap) table, and K6 the w_row prefix."""
    import ctypes
    import re
    out, _ = proc.communicate()
    require(proc.returncode == 0, f"nvcc of {src} failed:\n{out}")
    text = open(src).read()
    require(re.search(r"gs_expand_gauss_rows\(\s*const int\* row_offs",
                      text) is not None, f"{src}: K5 is not the first design "
            "(it does not take row_offs); --parent needs the tree before K5 "
            "took the splats")
    lib = ctypes.CDLL(str(so))
    for key, symbol, sig in (("k5", "gs_expand_gauss_rows",
                              "pppppppiiiiipp"),
                             ("k6", "gs_expand_rows", "ppiiipp")):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int if c == "i" else ctypes.c_void_p
                       for c in sig]
        fn.restype = ctypes.c_int
        PARENT_EMISSION[key] = fn
    PARENT_EMISSION["ptxas"] = {k: ptxas_stats(out, k) for k in (
        "expand_gauss_rows_kernel", "expand_rows_kernel")}
    log(f"parent emission built from {src}: ptxas "
        f"{PARENT_EMISSION['ptxas']}")


def parent_k5(fields, row_offs, row_cap):
    """The parent's K5: its row prefix and the splat fields → the (4,
    row_cap) row table."""
    import torch
    from gscream_tpu_torch.ops import cuda_build as cb
    radius, rmin, rmax, mean2d, conic, t_iso, depth = fields
    rows = torch.empty((4, row_cap), dtype=torch.int32, device=depth.device)
    cb.raise_on_error(PARENT_EMISSION["k5"](
        cb.ptr(row_offs), cb.ptr(rmin), cb.ptr(rmax), cb.ptr(mean2d),
        cb.ptr(conic), cb.ptr(t_iso), cb.ptr(depth), depth.shape[0], row_cap,
        32, 32, -(-WIDTH // 32), cb.ptr(rows), cb.stream_of(depth)),
        "the parent's K5")
    return rows


def parent_k6(rows, ioffs, capacity):
    """The parent's K6: its row table and w_row prefix → the (3, capacity)
    instance slots."""
    import torch
    from gscream_tpu_torch.ops import cuda_build as cb
    inst = torch.empty((3, capacity), dtype=torch.int32, device=rows.device)
    cb.raise_on_error(PARENT_EMISSION["k6"](
        cb.ptr(ioffs), cb.ptr(rows), rows.shape[1], capacity,
        -(-WIDTH // 32) * -(-HEIGHT // 32), cb.ptr(inst),
        cb.stream_of(rows)), "the parent's K6")
    return inst


def parent_rows(fields, row_cap):
    """The parent's row prefix and K5: the rect heights and their prefix
    (~9 torch launches), then its K5."""
    import torch
    radius, rmin, rmax = fields[:3]
    rect_h = torch.where((radius > 0) & (rmax[:, 0] > rmin[:, 0]),
                         rmax[:, 1] - rmin[:, 1], torch.zeros_like(rmin[:, 1]))
    row_offs = torch.zeros(radius.shape[0] + 1, dtype=torch.int32,
                           device=radius.device)
    row_offs[1:] = torch.cumsum(rect_h, 0, dtype=torch.int32)
    return row_offs, parent_k5(fields, row_offs, row_cap)


def parent_front(fields, capacity):
    """The parent's emission front as its ``bin_instances`` ran it: the
    row prefix and K5 (:func:`parent_rows`), the w_row prefix and total
    (~5 launches), its K6, and the offsets block (~7).  Returns (instance
    slots, offsets, total, row demand)."""
    import torch
    row_cap = capacity // 2
    row_offs, rows = parent_rows(fields, row_cap)
    w_row = rows[3]
    ioffs = (torch.cumsum(w_row, 0) - w_row).to(torch.int32)
    total = (ioffs[-1] + w_row[-1]).to(torch.int32)
    inst = parent_k6(rows, ioffs, capacity)
    ioffs_ext = torch.cat([ioffs, total.reshape(1)])
    goffs = ioffs_ext[torch.clamp_max(row_offs[:-1], row_cap).long()]
    offsets = torch.clamp_max(torch.cat([goffs, total.reshape(1)]), capacity)
    return inst, offsets, total, row_offs[-1]


def parent_count(fields):
    """The parent's counting pass (``instance_demand`` and
    ``emission_counts`` before K5 took the splats): the row demand read
    back to the host, then the row prefix and K5 at a table of that size
    and the w_row total.  Returns (instances, row demand)."""
    import torch
    radius, rmin, rmax = fields[:3]
    rect_h = torch.where((radius > 0) & (rmax[:, 0] > rmin[:, 0]),
                         rmax[:, 1] - rmin[:, 1], torch.zeros_like(rmin[:, 1]))
    row_offs = torch.zeros(radius.shape[0] + 1, dtype=torch.int32,
                           device=radius.device)
    row_offs[1:] = torch.cumsum(rect_h, 0, dtype=torch.int32)
    row_offs, rows = parent_rows(fields, max(int(row_offs[-1]), 1))
    w_row = rows[3]
    total = ((torch.cumsum(w_row, 0) - w_row)[-1] + w_row[-1]).to(torch.int32)
    return total, row_offs[-1]


def new_front(fields, capacity):
    """This tree's emission front: K5 and K6."""
    from gscream_tpu_torch.ops import emission as em
    gx = -(-WIDTH // 32)
    t = em.expand_gauss_rows(*fields, capacity // 2, capacity, 32, 32, gx)
    inst = em.expand_rows(t.rows, t.ioffs, t.counts, capacity,
                          gx * -(-HEIGHT // 32))
    return inst, t.offsets, t.counts[1], t.counts[0]


def binning_of(front, fields, capacity):
    """``bin_instances`` on top of ``front``: its sort and gathers."""
    import torch
    from gscream_tpu_torch.ops.binning import sort_instances
    inst, offsets, total, n_rows = front(fields, capacity)
    _, order, tile_start, tile_count = sort_instances(
        inst[0], inst[2], -(-WIDTH // 32) * -(-HEIGHT // 32))
    return inst[1][order], order.to(torch.int32), tile_start, tile_count


def compare_fronts(k5_args, label):
    """The emission front and the whole ``bin_instances`` call at K5's
    arguments ``k5_args`` (full width): device time per call from CUDA
    graphs (in turns with the parent's: new, parent, parent, new), host
    wall time per call to a sync, and the profiler's device time and
    launches per call; with ``--parent``, the parent's front held
    bit-equal to this tree's first."""
    import torch
    from gscream_tpu_torch.ops import emission as em
    fields, capacity = k5_args[:7], k5_args[8]
    fronts = {"new": new_front}
    if PARENT_EMISSION:
        fronts["parent"] = parent_front
        got, ref = new_front(fields, capacity), parent_front(fields, capacity)
        sync()
        for what, a, b in zip(("slots", "offsets", "total", "row demand"),
                              got, ref):
            require(torch.equal(a, b), f"the parent's emission front differs "
                    f"from this tree's in its {what} ({label})")
    out = {}
    order = ["new", "parent", "parent", "new"] if PARENT_EMISSION else \
        ["new", "new"]
    for tag in order:
        rec = out.setdefault(tag, {"graph_ms": []})
        rec["graph_ms"].append(graph_ms(lambda: fronts[tag](fields,
                                                            capacity)))
    counts = {"new": lambda: em.count_emission(*fields, 32, 32)}
    if PARENT_EMISSION:
        counts["parent"] = lambda: parent_count(fields)
        require([int(x) for x in counts["parent"]()]
                == counts["new"]().tolist()[::-1], f"the parent's counting "
                f"pass differs from this tree's ({label})")
        # each kernel alone on its own inputs, in turns
        row_offs, rows = parent_rows(fields, capacity // 2)
        ioffs = (torch.cumsum(rows[3], 0) - rows[3]).to(torch.int32)
        table = em.expand_gauss_rows(*k5_args)
        alone = {"K5": {"new": lambda: em.expand_gauss_rows(*k5_args),
                        "parent": lambda: parent_k5(fields, row_offs,
                                                    capacity // 2)},
                 "K6": {"new": lambda: em.expand_rows(
                            table.rows, table.ioffs, table.counts, capacity,
                            k5_args[11] * -(-HEIGHT // 32)),
                        "parent": lambda: parent_k6(rows, ioffs, capacity)}}
        out["kernels_alone_graph_ms"] = {}
        for kern, calls in alone.items():
            turns = out["kernels_alone_graph_ms"][kern] = {"new": [],
                                                           "parent": []}
            for tag in ("new", "parent", "parent", "new"):
                turns[tag].append(graph_ms(calls[tag]))
    for tag, front in fronts.items():
        rec = out[tag]
        rec["wall_ms"] = wall_ms_per_call(lambda: front(fields, capacity),
                                          20)
        rec["device_ms"], rec["launches"], rec["kernels"] = device_ms(
            lambda: front(fields, capacity))
        rec["bin_instances_graph_ms"] = graph_ms(
            lambda: binning_of(front, fields, capacity))
        rec["bin_instances_device_ms"], rec["bin_instances_launches"], _ = \
            device_ms(lambda: binning_of(front, fields, capacity))
        rec["count_device_ms"], rec["count_launches"], _ = device_ms(
            counts[tag])
        rec["count_wall_ms"] = wall_ms_per_call(counts[tag], 20)
    if PARENT_EMISSION:
        saved = (out["parent"]["bin_instances_launches"]
                 - out["new"]["bin_instances_launches"])
        out["launches_saved_per_bin_instances"] = saved
        require(saved >= 15, f"bin_instances launches only {saved} fewer "
                f"kernels than the parent's ({label})")
    else:
        out["parent"] = "not measured (no --parent)"
    log(f"emission front at {label}: {json.dumps(out)} [{SMI}]")
    return out


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
            (rt, "segment_reduce_rows", rt.segment_reduce_rows_plain),
            (rt, "run_forward_raw", rt.run_forward_raw_plain),
            (rt, "run_backward_raw", rt.run_backward_raw_plain)]


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
    """{kernel name: its wrapper}, in the order of the kernels line (the
    spawned ranks of phase (h) count with the same table)."""
    from gscream_tpu_torch.parallel.workers import kernel_wrappers
    return kernel_wrappers()


def require_attention(launches, want, label):
    """Each of the dual softmax pair launched ``want`` times in
    ``launches`` (on the card; the CPU's plain versions count nothing)."""
    import torch
    if not torch.cuda.is_available():
        return
    for name in ATTN_KERNELS:
        require(launches[name] == want, f"kernel {name} launched "
                f"{launches[name]} times {label}, not {want}")


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
        extra = ""
        if tag != "K2":
            extra = device_times(results[name], kern)
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", bound {bound_s * 1e3:.4f} ms ({by}){extra}"
            + (f", runs {runs}" if tag == "K3" else "") + f" [{SMI}]")

    def k2_check(got, ref):
        for lane in range(16):
            grad_close(got[:n, lane], ref[:n, lane],
                       f"the parent's K2 lane {lane} ({label})")
    k2_line = results["tile_backward"]
    k2_line["tiles"] = tile_stats(tc)
    k2_line["attrs"] = kernel_attributes("rasterize_bwd",
                                         "gs_tile_backward_attributes")
    k2_line.update(time_against_parent("rasterize_bwd", rt.run_backward, k2,
                                       10, k2_line["ms"], rows_p, k2_check))
    log(f"K2 at {label}: tiles {k2_line['tiles']}, attributes "
        f"{k2_line['attrs']}, parent {k2_line.get('parent_ms')} ms, new in "
        f"turns {k2_line.get('new_ms_turns')} [{SMI}]")
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
    alone (the counting passes between them left out); the card's peak
    memory is counted from here."""
    import torch
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.step import train_step
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
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


def kernel_symbol(name):
    """The function's own name in a profiler's kernel name
    (``void (anonymous namespace)::tile_forward_kernel<false>(...)`` →
    ``tile_forward_kernel``)."""
    return name.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("(")[0].split("<")[0].split("::")[-1]


def own_kernel_names():
    """The names of the ``__global__`` functions in the port's CUDA
    sources (a template's profiler name adds its arguments)."""
    import re
    from gscream_tpu_torch.ops import cuda_build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)")
    return {name for src in cuda_build.CSRC.glob("*.cu*")
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
        f"over the steps {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{SMI}]")
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
        if kernel_symbol(name) in mine:
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
    from gscream_tpu_torch.ops import rasterize_tiled as rt
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
    with torch.no_grad():
        checked, ratio, n_equal = check_agreement(
            *args["run_forward"], rt.run_forward, rt.run_backward, label)
        nocull = check_without_cull(args["run_forward"],
                                    args["run_backward"], label)
    log(f"{label}: K1 and K2 blend the same pairs: at {checked} (tile, "
        f"pixel) pairs K1's Σw is bit-equal to K2's weights summed in K1's "
        f"order at {n_equal}, and within {ratio:.3g} of the float32 rounding "
        "limit of their float64 sum")
    results["tile_backward"]["agreement"] = {
        "pairs": checked, "bit_equal": n_equal, "worst_of_limit": ratio}
    results["tile_forward"]["nocull_ms"] = nocull["rasterize_fwd"]
    results["tile_backward"]["nocull_ms"] = nocull["rasterize_bwd"]
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
        extra = device_times(results[name], lambda: kern(*a))
        log(f"{tag} {name} at {label}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms (bytes: {moved[name]}){extra}"
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


# ---------------------------------------------------------------------------
# phase (f): the training loop

def states_equal(a, b):
    """Every parameter, moment, statistic, ``alive``, the step counts and
    the token generator of two train states bit-equal: (equal, the first
    field that differs)."""
    import torch
    from gscream_tpu_torch.train.state import named_params
    pa, pb = named_params(a.scaffold), named_params(b.scaffold)
    pairs = [(f"param {k}", pa[k], pb[k]) for k in pa]
    pairs += [(f"m {k}", a.m[k], b.m[k]) for k in pa]
    pairs += [(f"v {k}", a.v[k], b.v[k]) for k in pa]
    pairs += [(f"stats {f}", x, y)
              for f, x, y in zip(a.stats._fields, a.stats, b.stats)]
    pairs += [("alive", a.scaffold.alive, b.scaffold.alive),
              ("generator", a.generator.get_state(),
               b.generator.get_state())]
    if (a.step, a.step_c) != (b.step, b.step_c):
        return False, f"step counts {(a.step, a.step_c)} != " \
            f"{(b.step, b.step_c)}"
    for name, x, y in pairs:
        if not torch.equal(x, y):
            return False, name
    return True, ""


def loop_walls(stamps):
    """(phase-1 and phase-2 wall ms per iteration, all by iteration) from
    the callbacks' times: an iteration's is the time since the callback
    before it; phase 2 starts after LOOP_CHECKPOINT."""
    per_it = {it: (stamps[it] - stamps[it - 1]) * 1e3
              for it in stamps if it - 1 in stamps}
    p1 = [t for it, t in per_it.items() if it <= LOOP_CHECKPOINT]
    p2 = [t for it, t in per_it.items() if it > LOOP_CHECKPOINT + 1]
    return p1, p2, per_it


def sync_calls(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (the
    synchronizing calls it made, each as the file:line of the innermost
    frame of this repo that led to it, then the frame that made it where
    that lies outside the repo, and what ``fn`` returned)."""
    import traceback
    import warnings
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    calls = []

    def where(frames):
        frames = [f for f in frames if f.name != "show"
                  and not f.filename.endswith("warnings.py")]
        inside = [f for f in frames
                  if not os.path.relpath(f.filename, root).startswith("..")]
        at = [f"{os.path.relpath(f.filename, root)}:{f.lineno}"
              for f in inside[-1:]]
        last = frames[-1]
        if not inside or last is not inside[-1]:
            at.append(f"{os.path.basename(last.filename)}:{last.lineno} "
                      f"{last.name}")
        return " -> ".join(at)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            calls.append(where(traceback.extract_stack()[:-1]))
    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return calls, out


def loop_phase(dev, cfg, scaffold, cams, targets):
    """Phase (f): ``train_scene`` on the benchmark model (warm-started from
    its anchors, written as a PLY; decoders from the loop's own seeded
    init) over the four training views with their teacher targets, view
    0 the reference, on the compressed schedule LOOP_OPTIM, from an
    instance capacity below the demand; then a second run restored from
    the checkpoint at LOOP_CHECKPOINT, which must end bit-equal; then the
    costs of densification, checkpoints and one phase-2 step.  Returns
    each kernel's launches over the first run and that run's final
    ``TrainState``."""
    import shutil
    import torch
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.data.synthetic import SyntheticView
    from gscream_tpu_torch.model.densify import adjust_anchors
    from gscream_tpu_torch.model.io import (load_checkpoint,
                                            save_anchors_ply,
                                            save_checkpoint)
    from gscream_tpu_torch.train.loop import (capacity_tier,
                                              densify_generator, train_scene)
    from gscream_tpu_torch.train.state import StatePool
    from gscream_tpu_torch.train.step import aux_values, train_step
    t_start = time.perf_counter()
    opt = OptimConfig(**LOOP_OPTIM)
    run = RunConfig(model=ModelConfig(
        feat_dim=cfg.feat_dim, n_offsets=cfg.n_offsets,
        voxel_size=cfg.voxel_size, anchor_capacity=cfg.capacity),
        optim=opt, seed=0)
    points = np.random.default_rng(0).normal(
        0, 0.6, (N_ANCHORS, 3)).astype(np.float32)   # bench_scene's cloud
    views = [SyntheticView(cams[i], *targets[i][:3], f"view_{i}")
             for i in range(N_TRAIN_VIEWS)]
    demand = instance_demand(scaffold, cfg, cams[0])
    start_cap = capacity_tier(demand // 2)
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "bench.ply")
        save_anchors_ply(ply, scaffold, cfg)
        stamps, saved = {}, {}

        def callback(it, ts, aux):
            stamps[it] = time.perf_counter()
            if opt.update_from < it < opt.update_until and \
                    it % opt.update_interval == 0:
                # what the densification after this step sees
                st = ts.stats
                seen = st.offset_denom > opt.update_interval * \
                    opt.success_threshold * 0.5
                require(bool(seen.any()), f"no offset was seen often "
                        f"enough to densify at {it}")
                mean = st.offset_grad_accum / st.offset_denom.clamp_min(1)
                over = [int((seen & (mean >= opt.densify_grad_threshold
                                     * 2 ** lv)).sum())
                        for lv in range(cfg.update_depth)]
                log(f"  before the densification at {it}: {int(seen.sum())} "
                    f"offsets seen often enough, of which {over} reach "
                    f"each level's gradient threshold; mean gradient "
                    f"median {float(mean[seen].median()):.3e}, max "
                    f"{float(mean[seen].max()):.3e}")
            if it == LOOP_CHECKPOINT + 1:
                # the loop rewrites ckpt at every interval: keep this one
                for suffix in ("", "_meta.json"):
                    shutil.copy(os.path.join(tmp, "a", "ckpt" + suffix),
                                os.path.join(tmp, "ckpt24" + suffix))
                saved["it"] = it - 1

        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        with environ(GSCREAM_PIPELINE=str(LOOP_DEPTHS[-1])):
            ts_a, log_a = train_scene(
                views, 0, points, run, out_dir=os.path.join(tmp, "a"),
                capacity=start_cap, callback=callback, pretrained_ply=ply,
                checkpoint_interval=LOOP_CHECKPOINT, device=dev)
        sync()
        run_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        log(f"training loop: {LOOP_ITERS} iterations at pipeline depth "
            f"{LOOP_DEPTHS[-1]} in {run_s:.2f} s (first calls included), "
            f"starting capacity {start_cap} (view 0 demand {demand}); "
            f"launches {launches} [{SMI}]")

        # what the run must show
        require(all(math.isfinite(x) for x in log_a.losses),
                f"a loss is not finite: {log_a.losses}")
        require(len(log_a.losses) == LOOP_ITERS, "iterations missing")
        dens = [e for e in log_a.events if e["event"] == "densify"]
        grows = [e for e in dens if e["alive_after"] > e["alive_before"]]
        overflows = [e for e in log_a.events if e["event"] == "overflow"]
        for e in log_a.events:
            log(f"  loop event {e}")
        require(len(dens) >= 2, f"{len(dens)} densifications")
        require(grows, "no densification grew the anchors")
        require(overflows, "no step overflowed its starting capacity")
        for st in log_a.steps:
            require(st["instances"] <= st["capacity"],
                    f"iteration {st['it']} trained past its capacity: {st}")
        ok_views = {st["is_ref"] for st in log_a.steps
                    if st["use_cross"] and st["cross_ok"]}
        require(ok_views == {True, False}, "phase 2 ran with cross_ok on "
                f"{ok_views} views only (reference view: True)")
        for name in DEFAULT_ROUTE:
            require(launches[name] > 0, f"kernel {name} was not launched "
                    "by the training loop")
        # once a phase-2 launch, and again for each phase-2 step the loop
        # launched anew after an overflow (never in phase 1: counted apart
        # below, one launched step of each phase)
        n_p2 = sum(1 for st in log_a.steps if st["use_cross"])
        attn_n = [launches[k] for k in ATTN_KERNELS]
        require(dev.type != "cuda" or attn_n[0] == attn_n[1] >= n_p2 > 0,
                f"the dual softmax pair launched {attn_n} times over "
                f"{n_p2} phase-2 iterations of the loop")
        log(f"dual softmax pair launches over the loop: {attn_n} "
            f"(forward, backward) for its {n_p2} phase-2 iterations")
        for st, loss in zip(log_a.steps, log_a.losses):
            log(f"  loop it {st['it']:2d} view {st['view']} "
                f"{'phase 2' if st['use_cross'] else 'phase 1'}"
                f"{' cross_ok' if st['cross_ok'] else ''}: loss "
                f"{loss:.6f}, instances {st['instances']} of capacity "
                f"{st['capacity']}")

        # the same schedule at each depth of LOOP_DEPTHS, in turns after
        # the counted run: every state tensor, the losses, the steps and
        # the events equal to the counted run's
        walls = {}
        for d in LOOP_DEPTHS + LOOP_DEPTHS[::-1]:
            st_d = {}
            with environ(GSCREAM_PIPELINE=str(d)):
                ts_d, log_d = train_scene(
                    views, 0, points, run,
                    out_dir=os.path.join(tmp, f"depth{d}"),
                    capacity=start_cap, pretrained_ply=ply,
                    callback=lambda it, ts, aux: st_d.__setitem__(
                        it, time.perf_counter()),
                    checkpoint_interval=LOOP_CHECKPOINT, device=dev)
            same, where = states_equal(ts_a, ts_d)
            require(same, f"the loop at pipeline depth {d} ends other than "
                    f"at depth {LOOP_DEPTHS[-1]}: {where}")
            require(log_d.losses == log_a.losses and log_d.steps ==
                    log_a.steps and log_d.events == log_a.events,
                    f"the loop at depth {d}: losses, steps or events differ")
            walls.setdefault(d, []).append(
                (loop_walls(st_d), log_d.iter_times))
        log(f"pipeline depths {LOOP_DEPTHS}: every parameter, moment, "
            f"statistic, alive, the step counts and the generator "
            f"bit-equal, the losses, steps and events (overflow re-run "
            f"at {[e['it'] for e in overflows]}, densifications at "
            f"{[e['it'] for e in dens]}) equal")
        # wall ms per iteration: between consecutive callbacks (a commit,
        # depth iterations after its launch)
        p1, p2, per_it = loop_walls(stamps)
        log(f"training loop wall ms per iteration (counted run, depth "
            f"{LOOP_DEPTHS[-1]}): phase 1 median {np.median(p1):.3f} "
            f"({len(p1)} iterations), phase 2 median {np.median(p2):.3f} "
            f"({len(p2)} iterations); all "
            f"{[round(per_it[i], 2) for i in sorted(per_it)]} [{SMI}]")
        for d, runs in walls.items():
            for k, ((q1, q2, _), disp) in enumerate(runs):
                log(f"  depth {d} run {k + 1}: wall ms per iteration, "
                    f"phase 1 median {np.median(q1):.3f}, phase 2 median "
                    f"{np.median(q2):.3f}; host ms to launch a step, "
                    f"median {1e3 * np.median(disp[1:]):.3f} [{SMI}]")

        # the resume: restored at LOOP_CHECKPOINT, run to the end
        require(saved.get("it") == LOOP_CHECKPOINT, "no checkpoint kept")
        ts_b, log_b = train_scene(
            views, 0, points, run, out_dir=os.path.join(tmp, "b"),
            pretrained_ply=ply, start_checkpoint=os.path.join(tmp, "ckpt24"),
            device=dev)
        require(log_b.steps[0]["it"] == LOOP_CHECKPOINT + 1,
                f"the resumed run started at {log_b.steps[0]['it']}")
        same, where = states_equal(ts_a, ts_b)
        require(same, f"the run resumed at {LOOP_CHECKPOINT} differs from "
                f"the uninterrupted run at {LOOP_ITERS}: {where}")
        require(log_b.losses == log_a.losses[LOOP_CHECKPOINT:],
                "the resumed run's losses differ")
        log(f"resume from the checkpoint at {LOOP_CHECKPOINT}: every "
            f"parameter, moment, statistic, alive and the generator "
            f"bit-equal to the uninterrupted run at {LOOP_ITERS}; losses "
            f"{LOOP_CHECKPOINT + 1}-{LOOP_ITERS} equal")

        # the costs around the steps
        def densify():
            return adjust_anchors(
                ts_a.scaffold, ts_a.stats, ts_a.m, ts_a.v,
                densify_generator(0, LOOP_ITERS, dev), cfg,
                check_interval=opt.update_interval,
                success_threshold=opt.success_threshold,
                grad_threshold=opt.densify_grad_threshold,
                min_opacity=opt.min_opacity)
        dens_ms = wall_ms_per_call(densify, 3)
        path = os.path.join(tmp, "timed_ckpt")
        save_ms = wall_ms_per_call(lambda: save_checkpoint(path, ts_a), 3)
        load_ms = wall_ms_per_call(lambda: load_checkpoint(path, ts_b), 3)
        log(f"adjust_anchors {dens_ms:.3f} ms, save_checkpoint "
            f"{save_ms:.3f} ms ({os.path.getsize(path)} bytes), "
            f"load_checkpoint {load_ms:.3f} ms (means of 3, each to a "
            f"sync) [{SMI}]")

    # the synchronizing calls of one launched step of each phase (the
    # loop's launch: the snapshot, then train_step), warm
    state = [ts_b]
    cap = max(st["capacity"] for st in log_a.steps)
    box = torch.tensor([0, HEIGHT, 0, WIDTH], dtype=torch.int32, device=dev)
    pool = StatePool()

    def launched(phase2):
        def fn():
            pool.release(pool.snapshot(state[0]))
            state[0], aux = train_step(
                state[0], cams[0], *targets[0], box, cfg=cfg, opt=opt,
                is_ref=True, use_crossattn=phase2, capacity=cap,
                width=WIDTH, height=HEIGHT, accumulate=True,
                feat_frozen=phase2)
            return aux
        return fn
    # the first switch of the mode reports one call of its own (PR 11's
    # chip runs): counted around nothing first, apart from the steps
    base, _ = sync_calls(lambda: None)
    log(f"sync debug mode switched on and off around nothing: "
        f"{len(base)} {base}")
    counters = launch_counters()
    for phase2 in (False, True):
        fn = launched(phase2)
        fn()
        for c in counters.values():
            c.launches = 0
        calls, aux = sync_calls(fn)
        vals = aux_values(aux)
        require(math.isfinite(vals[0]) and vals[2] <= cap,
                f"the step counted for synchronizing calls: {vals}")
        step_launches = {k: c.launches for k, c in counters.items()}
        require_attention(step_launches, int(phase2),
                          f"in one launched phase-{1 + phase2} step")
        log(f"synchronizing calls in one launched phase-{1 + phase2} step "
            f"(StatePool.snapshot + train_step, sync debug mode 'warn'): "
            f"{len(calls)} {calls}; dual softmax pair launches "
            f"{[step_launches[k] for k in ATTN_KERNELS]}")

    # one phase-2 step on the reference view, under the profiler

    def one_step():
        state[0], aux = train_step(
            state[0], cams[0], *targets[0], box, cfg=cfg, opt=opt,
            is_ref=True, use_crossattn=True, capacity=cap, width=WIDTH,
            height=HEIGHT, accumulate=True, feat_frozen=True)
        vals = aux_values(aux)
        require(bool(vals[4]) and vals[2] <= cap,
                f"the profiled phase-2 step: {vals}")
    kernels, layers, busy_ms, wall_ms = profile_calls(one_step, ("step/",))
    log(f"profile of one phase-2 step (reference view, cross_ok): device "
        f"busy {busy_ms:.3f} ms in {sum(k[1] for k in kernels)} kernel "
        f"launches; wall {wall_ms:.3f} ms under the profiler (idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}); idle share against the "
        f"loop's phase-2 median {max(0.0, 1 - busy_ms / np.median(p2)):.3f}"
        f"; cross-attention (range step/crossattn) "
        f"{layers.get('step/crossattn', 0.0):.4f} ms device, token "
        f"sampling {layers.get('step/tokens', 0.0):.4f} ms [{SMI}]")
    for name, dev_ms in sorted(layers.items()):
        log(f"  range {name}: {dev_ms:.4f} ms device")
    for dev_ms, calls, name in kernels[:10]:
        log(f"  {dev_ms:9.4f} ms  x{calls:<3d} {name[:90]}")
    log(f"phase (f) took {time.perf_counter() - t_start:.1f} s")
    return launches, ts_a



# ---------------------------------------------------------------------------
# phase (g): evaluation and the spiral split

def random_lpips_weights(path, seed=11):
    """Seeded random LPIPS weights in the export ``.npz`` format
    (``tests/test_lpips_parity.py``'s draw): the metric's pipeline runs,
    but its values are not the published LPIPS."""
    from gscream_tpu_torch.metrics.lpips import _TAP_AFTER, _VGG_PLAN
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, (cout, _) in enumerate(_VGG_PLAN):
        out[f"conv{i}_w"] = rng.normal(
            0, 0.1 / np.sqrt(cin * 9), (cout, cin, 3, 3)).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        cin = cout
    for j, tap in enumerate(_TAP_AFTER):
        out[f"lin{j}_w"] = np.abs(
            rng.normal(0, 0.01, (_VGG_PLAN[tap][0],))).astype(np.float32)
    np.savez(path, **out)


OPTIONAL = ("cv2", "imageio", "matplotlib", "PIL", "tensorboard", "wandb")


def importable(name):
    import importlib.util
    return importlib.util.find_spec(name) is not None


def check_scores(got, ref, psnr_atol, ssim_atol, lpips_rtol, label):
    """Two ``per_view`` rows within the stated tolerances, key for key;
    returns the largest differences."""
    require(set(got) == set(ref), f"{label}: keys {sorted(got)} != "
            f"{sorted(ref)}")
    worst = {}
    for k in ref:
        d = abs(got[k] - ref[k])
        if k.startswith("LPIPS"):
            d /= max(abs(ref[k]), 1e-12)
            tol = lpips_rtol
        else:
            tol = psnr_atol if k.startswith("PSNR") else ssim_atol
        require(d <= tol, f"{label}: {k} {got[k]!r} against {ref[k]!r} "
                f"(difference {d:.3e} > {tol:.1e})")
        worst[k] = d
    return worst


def avi_frame_count(path):
    """The frame count of an AVI's main header and its ``00dc`` chunks."""
    import struct
    from gscream_tpu_torch.utils.video import avi_frames
    with open(path, "rb") as f:
        head = f.read(64)
    at = head.index(b"avih") + 8
    return struct.unpack("<I", head[at + 16:at + 20])[0], len(
        avi_frames(path))


def eval_phase(dev, cfg, ts, cams):
    """Phase (g): the test split (views N_TRAIN_VIEWS..N_VIEWS-1) of the
    model phase (f) trained, rendered by ``render_set`` and scored by
    ``evaluate_pairs`` on the card with seeded random LPIPS weights,
    against the CPU on the same renders and against a render through the
    plain twins; the spiral split over N_SPIRAL poses; the CLIs at a small
    size.  Returns each kernel's launches over the test render and over
    the spiral render."""
    from gscream_tpu_torch.train.loop import capacity_tier
    t_start = time.perf_counter()
    scaffold = ts.scaffold
    test_cams = cams[N_TRAIN_VIEWS:]
    n_test = len(test_cams)
    targets = training_targets(dev, cfg, test_cams)
    gts = [t[0].cpu().numpy() for t in targets]
    masks = [t[1].cpu().numpy() for t in targets]
    names = [f"{i:05d}" for i in range(n_test)]
    capacity = capacity_tier(max(instance_demand(scaffold, cfg, c)
                                 for c in test_cams))
    counters = launch_counters()
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, SMOKE_DIR), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, SMOKE_DIR)) \
            as tmp:
        weights = os.path.join(tmp, "lpips_random.npz")
        random_lpips_weights(weights)
        with environ(GSCREAM_LPIPS_WEIGHTS=weights):
            log(f"LPIPS runs on seeded RANDOM weights ({weights}): its "
                "values exercise the metric's pipeline, they are not the "
                "published LPIPS; optional packages that import here: "
                f"{[m for m in OPTIONAL if importable(m)]} of {OPTIONAL}")
            launches = eval_test_split(dev, cfg, scaffold, test_cams, gts,
                                       masks, names, capacity, counters, tmp)
            launches_spiral = eval_spiral(dev, cfg, scaffold, cams,
                                          counters, tmp)

            eval_clis(dev, tmp)
    log(f"phase (g) took {time.perf_counter() - t_start:.1f} s")
    return launches, launches_spiral


def eval_clis(dev, tmp):
    """Phase (g)'s CLIs at a small size on the card: ``train_torch.py
    --synthetic`` at 128x128 with the evaluation callback at 10 and 20
    and the final evaluation, then ``render_torch.py --eval`` and
    ``evaluate_torch.py`` on the model directory it wrote."""
    import evaluate_torch
    import render_torch
    import train_torch
    t0 = time.perf_counter()
    model = os.path.join(tmp, "cli")
    on = ["--device", str(dev)]
    train_torch.main(["--synthetic", "--synthetic_size", "128",
                      "--iterations", "20", "--test_iterations", "10", "20",
                      "--model_path", model] + on)
    with open(os.path.join(model, "results.json")) as f:
        summary = json.load(f)["ours"]
    require(set(summary) == set(RESULT_KEYS) and all(
        math.isfinite(v) for v in summary.values()),
        f"train_torch.py results.json: {summary}")
    with open(os.path.join(model, "metrics.jsonl")) as f:
        fired = [r["step"] for r in map(json.loads, f) if "test_psnr" in r]
    require(fired == [10, 20], f"the evaluation callback fired at {fired}, "
            "not at 10 and 20")
    render_torch.main(["--model_path", model, "--synthetic", "--eval"] + on)
    evaluate_torch.main(["--model_path", model] + on)
    with open(os.path.join(model, "test", "results.json")) as f:
        again = json.load(f)["ours"]
    require(set(again) == {"PSNR", "SSIM", "LPIPS"} and all(
        math.isfinite(v) for v in again.values()),
        f"evaluate_torch.py results.json: {again}")
    log(f"CLIs on the card: train_torch.py --synthetic (128x128, 20 "
        f"iterations, the evaluation callback at {fired}) wrote results.json "
        f"{summary}; render_torch.py --eval and evaluate_torch.py on the "
        f"model directory wrote {again} (from the 8-bit PNGs, no masks); "
        f"{time.perf_counter() - t0:.1f} s")


def eval_test_split(dev, cfg, scaffold, test_cams, gts, masks, names,
                    capacity, counters, tmp):
    """Phase (g)'s test split: rendered with K1, K5 and K6 counted, scored
    on the card, on the CPU and through the plain twins, each metric
    timed.  Returns the launches over the render."""
    import torch
    from gscream_tpu_torch.metrics.lpips import lpips
    from gscream_tpu_torch.ops.losses import psnr
    from gscream_tpu_torch.ops.ssim import my_ssim
    from gscream_tpu_torch.train.evaluate import evaluate_pairs, \
        write_results
    from gscream_tpu_torch.train.render_sets import make_render_fn, \
        render_set
    n_test = len(test_cams)
    for fn in counters.values():
        fn.launches = 0
    sync()
    res = render_set(tmp, "test", test_cams, scaffold, cfg,
                     capacity=capacity, gt_images=gts)
    sync()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"test split: {n_test} views at {WIDTH}x{HEIGHT}, FPS "
        f"{res['fps']:.2f}, instance demand {res['overflow_demand']} "
        f"(capacity {capacity}); launches {launches} [{SMI}]")
    for name in ("tile_forward", "expand_gauss_rows", "expand_rows"):
        require(launches[name] == n_test, f"kernel {name} launched "
                f"{launches[name]} times over {n_test} test renders")
    require_attention(launches, 0, f"over {n_test} test renders")
    for d in res["overflow_demand"]:
        require(d <= capacity, f"overflow: demand {d} > capacity {capacity}")
    for img in res["renders"]:
        require(img.shape == (3, HEIGHT, WIDTH) and np.isfinite(img).all(),
                "a test render is not a finite (3, H, W) image")

    # scored on the card; the files carry every key JAX writes
    sync()
    t0 = time.perf_counter()
    card = evaluate_pairs(res["renders"], gts, masks, names, device=dev)
    card_s = time.perf_counter() - t0
    write_results(tmp, card)
    with open(os.path.join(tmp, "results.json")) as f:
        summary = json.load(f)["ours"]
    with open(os.path.join(tmp, "per_view.json")) as f:
        per_view = json.load(f)["ours"]
    require(set(summary) == set(RESULT_KEYS), f"results.json keys "
            f"{sorted(summary)}")
    require(sorted(per_view) == names and all(
        set(r) == set(RESULT_KEYS) for r in per_view.values()),
        f"per_view.json: {per_view}")
    require(all(math.isfinite(v) for r in per_view.values()
                for v in r.values()), f"a score is not finite: {per_view}")
    log(f"evaluate_pairs on the card over {n_test} views in {card_s:.2f} s "
        f"(first calls included): {summary} [{SMI}]")

    # the same renders scored on the CPU
    cpu = evaluate_pairs(res["renders"][:EVAL_CPU_VIEWS],
                         gts[:EVAL_CPU_VIEWS], masks[:EVAL_CPU_VIEWS],
                         names[:EVAL_CPU_VIEWS], device="cpu")
    for name in names[:EVAL_CPU_VIEWS]:
        worst = check_scores(card["per_view"][name], cpu["per_view"][name],
                             EVAL_PSNR_ATOL, EVAL_SSIM_ATOL,
                             EVAL_LPIPS_RTOL, f"view {name} card vs CPU")
        log(f"view {name}: card scores equal the CPU's on the same render "
            f"(PSNR within {EVAL_PSNR_ATOL} dB, SSIM within "
            f"{EVAL_SSIM_ATOL}, LPIPS within rtol {EVAL_LPIPS_RTOL}); "
            f"largest differences {worst}")

    # one view rendered through the plain twins, scored on the card
    render = make_render_fn(scaffold, cfg, WIDTH, HEIGHT, capacity)
    with torch.no_grad(), plain_kernels():
        out_p, _, _ = render(scaffold.params, scaffold.mlps, test_cams[0])
    plain = evaluate_pairs([out_p.color.permute(2, 0, 1).cpu().numpy()],
                           gts[:1], masks[:1], names[:1], device=dev)
    worst = check_scores(plain["per_view"][names[0]],
                         card["per_view"][names[0]], PLAIN_PSNR_ATOL,
                         PLAIN_SSIM_ATOL, PLAIN_LPIPS_RTOL,
                         "plain render vs kernel render")
    log(f"view {names[0]} rendered through the plain twins scores within "
        f"PSNR {PLAIN_PSNR_ATOL} dB, SSIM {PLAIN_SSIM_ATOL}, LPIPS rtol "
        f"{PLAIN_LPIPS_RTOL} of the kernels' render: {worst}")

    # the card's ms per view for each metric
    r = torch.as_tensor(res["renders"][0], device=dev)
    g = torch.as_tensor(gts[0], device=dev)
    m = torch.as_tensor(masks[0], device=dev)
    with torch.no_grad():
        ms = {"PSNR": cuda_ms(lambda: psnr(r, g), 10, 3),
              "SSIM": cuda_ms(lambda: my_ssim(r, g), 10, 3),
              "LPIPS": cuda_ms(lambda: lpips(r, g), 3, 3),
              "LPIPS_masked": cuda_ms(lambda: lpips(r, g, m[0]), 3, 3)}
    log(f"card ms per view at {WIDTH}x{HEIGHT} (CUDA events, median of 3 "
        f"rounds): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f" [{SMI}]")
    return launches


def eval_spiral(dev, cfg, scaffold, cams, counters, tmp):
    """Phase (g)'s spiral split over N_SPIRAL ``get_spiral`` poses of the
    training orbit: its files, one frame's normals on the card against
    the CPU, the normals' and the video's costs.  Returns the launches
    over the render."""
    import torch
    from gscream_tpu_torch.cameras import make_camera_from_c2w
    from gscream_tpu_torch.data.spiral import get_spiral
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.render_sets import (camera_c2w_K,
                                                     make_render_fn,
                                                     normals_from_depth,
                                                     render_set)
    from gscream_tpu_torch.utils.png import decode_png
    from gscream_tpu_torch.utils.video import (avi_frames, write_png_avi,
                                               write_video)
    c2ws = np.stack([np.linalg.inv(c.w2c.cpu().numpy().astype(np.float64))
                     for c in cams[:N_TRAIN_VIEWS]])[:, :3, :4]
    # the orbit's bounds: distance 3 less and more the cloud's 3σ (1.8)
    near_fars = np.tile([[1.2, 4.8]], (N_TRAIN_VIEWS, 1))
    poses = get_spiral(c2ws, near_fars, rads_scale=0.4, n_views=N_SPIRAL)
    spiral = [make_camera_from_c2w(c2w, 1.0, 1.0 * HEIGHT / WIDTH, WIDTH,
                                   HEIGHT, device=dev) for c2w in poses]
    capacity = capacity_tier(max(instance_demand(scaffold, cfg, c)
                                 for c in spiral))
    for fn in counters.values():
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    res = render_set(tmp, "spiral", spiral, scaffold, cfg, capacity=capacity)
    sync()
    total_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in ("tile_forward", "expand_gauss_rows", "expand_rows"):
        require(launches[name] == N_SPIRAL, f"kernel {name} launched "
                f"{launches[name]} times over {N_SPIRAL} spiral renders")
    require_attention(launches, 0, f"over {N_SPIRAL} spiral renders")
    for d in res["overflow_demand"]:
        require(d <= capacity, f"overflow: demand {d} > capacity {capacity}")
    base = os.path.join(tmp, "spiral")
    for sub in ("renders", "depth", "normal"):
        n = len([f for f in os.listdir(os.path.join(base, sub))
                 if f.endswith(".png")])
        require(n == N_SPIRAL, f"spiral/{sub}: {n} PNGs, not {N_SPIRAL}")
    videos = [f for f in ("video.mp4", "video.avi")
              if os.path.exists(os.path.join(base, f))]
    require(len(videos) == 1 and os.path.getsize(
        os.path.join(base, videos[0])) > 0, f"spiral videos {videos}")
    if videos[0] == "video.avi":
        require(avi_frame_count(os.path.join(base, "video.avi"))
                == (N_SPIRAL, N_SPIRAL), "video.avi does not hold "
                f"{N_SPIRAL} frames")
    # the PNG-in-AVI fallback, whatever this machine has: N_SPIRAL frames,
    # each decoding to its render bit for bit
    frames = [r.transpose(1, 2, 0) for r in res["renders"]]
    png_avi = os.path.join(tmp, "png_video.avi")
    t0 = time.perf_counter()
    write_png_avi(png_avi, frames, fps=30)
    png_avi_ms = (time.perf_counter() - t0) * 1e3
    header, chunks = avi_frame_count(png_avi)
    require(header == chunks == N_SPIRAL, f"png_video.avi: {header} frames "
            f"in its header, {chunks} chunks, not {N_SPIRAL}")
    for raw, f in zip(avi_frames(png_avi), frames):
        require(np.array_equal(decode_png(raw), (np.clip(f, 0, 1) * 255)
                               .astype(np.uint8)),
                "a PNG frame of the AVI is not its render")
    video = (f"{videos[0]} of {os.path.getsize(os.path.join(base, videos[0]))}"
             f" bytes; the PNG-in-AVI of {chunks} frames, each bit-equal to "
             f"its render, {os.path.getsize(png_avi)} bytes in "
             f"{png_avi_ms:.1f} ms")
    log(f"spiral: {N_SPIRAL} poses at {WIDTH}x{HEIGHT}, FPS {res['fps']:.2f} "
        f"(skip-5 protocol, renders alone), {total_s:.2f} s with the PNGs, "
        f"normals and video; renders, inferno depths and normal maps "
        f"{N_SPIRAL} each, {video}; instance demand "
        f"{res['overflow_demand']} (capacity {capacity}); launches "
        f"{launches} [{SMI}]")

    # one frame's normals: the card against the same function on the CPU
    render = make_render_fn(scaffold, cfg, WIDTH, HEIGHT, capacity)
    with torch.no_grad():
        out, _, _ = render(scaffold.params, scaffold.mlps, spiral[0])
    c2w, K = camera_c2w_K(spiral[0])
    n_card = normals_from_depth(out.depth, c2w, K)
    n_cpu = normals_from_depth(out.depth.cpu(), c2w, K)
    differ = int((n_card.cpu() != n_cpu).any(0).sum())
    require(bool(torch.isfinite(n_card).all()), "normals not finite")
    require(differ == 0, f"normals card vs CPU: {differ} pixels differ "
            f"(max abs {float((n_card.cpu() - n_cpu).abs().max()):.3e})")
    normals_ms = wall_ms_per_call(
        lambda: normals_from_depth(out.depth, c2w, K), 3)
    t0 = time.perf_counter()
    written = write_video(os.path.join(tmp, "timed_video"), frames, fps=30)
    video_ms = (time.perf_counter() - t0) * 1e3
    log(f"spiral view 0 normals: the card's bit-equal to the CPU's at all "
        f"{WIDTH * HEIGHT} pixels; {normals_ms:.3f} ms per frame on the "
        f"card (wall, mean of 3, each to a sync); write_video of "
        f"{N_SPIRAL} frames ({os.path.basename(written)}) {video_ms:.1f} ms "
        f"[{SMI}]")
    return launches

# ---------------------------------------------------------------------------
# phase (h): multi-GPU training over a (data, tiles) mesh

SHARD_BANDS = (2, 4)    # band counts of the one-process band check
SHARD_STEPS = 4         # sharded steps per mesh
SHARD_MESHES = ((1, 2), (2, 1))
# the per-band K4+K3 sums added over the bands against the full frame's,
# per lane: |Σ_b − full| ≤ BAND_SUM_ATOL·scale + BAND_SUM_RTOL·|full|
# (scale = max |full|).  Only a gaussian whose run crosses a band
# boundary is summed in another order (its chunk partials regrouped), a
# float32 reassociation of a few ulps of its terms
BAND_SUM_ATOL = 1e-5
BAND_SUM_RTOL = 1e-5
# the sharded trajectory against the single-device one.  The first
# step's gradients (the first moments, 0.1·g, both from the same state)
# within GRAD_*: the band split only reassociates the sums.  Over
# SHARD_STEPS steps: the losses within TRAJ_LOSS_RTOL; every moment and
# statistic within TRAJ_FLIP_REL·s and every parameter within TRAJ_ATOL +
# TRAJ_RTOL·|ref| + 2·Σ lr (the learning rates of its group over the
# steps), and all but max(n/200, 8) of a leaf's elements within the tight
# bound (TRAJ_TIGHT_ATOL·s + TRAJ_TIGHT_RTOL·|ref|; s = 1 for parameters,
# max |ref| for the rest; JAX's population bound, tests/test_sharded.py::
# test_trajectory_matches_single_device).  Where a gradient is as small
# as the reassociation noise, Adam's m/√v turns the noise into a step of
# either sign, so a few parameters walk apart by up to their learning
# rate per step, and their moments with them; a gaussian whose neural
# opacity or radius sits at 0 can then flip between active and not, and
# move a visibility count by 1 in a step (their loose bound is the number
# of steps)
TRAJ_LOSS_RTOL = 5e-3
TRAJ_ATOL = 5e-3
TRAJ_RTOL = 5e-2
TRAJ_FLIP_REL = 5e-2
TRAJ_TIGHT_ATOL = 5e-4
TRAJ_TIGHT_RTOL = 5e-3
# (2, 1)'s first loss against the mean of its two views' losses, each
# taken alone on this card by the band losses at one band
# (make_sharded_loss at mesh (1, 1)): the same sums, so only the mean's
# rounding differs
DP_LOSS_RTOL = 1e-6
# the CLI's 2-rank loop against the single-device one
CLI_ITERS = 12
CLI_FLAGS = ["--synthetic", "--synthetic_size", "128", "--iterations",
             str(CLI_ITERS), "--start_crossattn_from", "10", "--start_stat",
             "1", "--update_from", "4", "--update_interval", "4",
             "--update_until", "9", "--skip_render", "--skip_eval"]


def trajectory_close(got, ref, label, moment, lr_sum=0.0, loose=None):
    """Hold ``got`` to ``ref`` with the TRAJ_* bounds (``lr_sum``: the
    parameter's learning rates summed over the steps; ``loose``: the loose
    bound, where it is not TRAJ_*'s); returns (max abs error, elements
    beyond the tight bound)."""
    import torch
    got, ref = got.double(), ref.double()
    require(bool(torch.isfinite(got).all()), f"{label}: not finite")
    s = max(float(ref.abs().max()), 1e-30) if moment else 1.0
    err = (got - ref).abs()
    if loose is None:
        loose = (TRAJ_FLIP_REL * s if moment else
                 TRAJ_ATOL + TRAJ_RTOL * ref.abs() + 2.0 * lr_sum)
    tight = TRAJ_TIGHT_ATOL * s + TRAJ_TIGHT_RTOL * ref.abs()
    n_bad = int((err > tight).sum())
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= loose).all()),
            f"{label}: max abs {worst:.3e} beyond the loose bound "
            f"({n_bad} of {err.numel()} beyond the tight one)")
    require(n_bad <= max(err.numel() // 200, 8),
            f"{label}: {n_bad} of {err.numel()} beyond the tight bound "
            f"(max abs {worst:.3e})")
    return worst, n_bad


def band_kernels(dev, cfg, scaffold, cams, targets):
    """Part 1: at view 0 of the default route (the arguments one
    ``loss_and_grads`` call gave K1 and K2), K1 and K2 per band for each
    band count: the stitched band images bit-equal to the full frame's
    K1 (the pad tiles empty), each band's K2 rows bit-equal to the full
    frame's in the band's slots and zero outside them, within the GRAD_*
    bounds of the plain twin, and the per-band K4+K3 sums added over the
    bands within BAND_SUM_* of the full frame's."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.parallel.shard import (_band_geometry,
                                                  _band_slices, pad_tiles)
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.step import loss_and_grads, phase1_masks
    cap = capacity_tier(instance_demand(scaffold, cfg, cams[0]))
    g, args = recorded_kernel_args(lambda: loss_and_grads(
        scaffold, cams[0], *targets[0], cfg=cfg, opt=OptimConfig(),
        is_ref=True, capacity=cap, masks=phase1_masks(False)))
    inst, ts_full, tc_full, n_tiles = args["run_forward"]
    pix = args["run_backward"][1]
    binning = g.binning
    full_k1 = rt.run_forward(inst, ts_full, tc_full, n_tiles)
    full_k2 = rt.run_backward(inst, pix, ts_full, tc_full, n_tiles)
    full_pg = rt.per_gaussian_sums(full_k2, binning)
    sync()
    n_live = min(int(binning.num_instances), inst.shape[0])
    for n in SHARD_BANDS:
        gx, gy, gy_pad, rows = _band_geometry(WIDTH, HEIGHT, n)
        bb = pad_tiles(binning, WIDTH, HEIGHT, n)
        pix_pad = torch.cat([pix, pix.new_zeros(((gy_pad - gy) * gx,)
                                                + pix.shape[1:])])
        k1_parts, pg_sum, k2_err = [], None, 0.0
        for b in range(n):
            ts_b, tc_b, nl = _band_slices(bb, gx, rows, b)
            pix_b = pix_pad[b * nl:(b + 1) * nl]
            k1_parts.append(rt.run_forward(inst, ts_b, tc_b, nl))
            rows_b = rt.run_backward(inst, pix_b, ts_b, tc_b, nl)
            sync()
            lo, hi = int(ts_b[0]), int(ts_b[-1] + tc_b[-1])
            require(torch.equal(rows_b[lo:hi], full_k2[lo:hi]),
                    f"{n} bands, band {b}: K2 rows in the band's slots "
                    f"[{lo}, {hi}) differ from the full frame's")
            require(bool((rows_b[:lo] == 0).all())
                    and bool((rows_b[hi:] == 0).all()),
                    f"{n} bands, band {b}: K2 left a slot outside "
                    f"[{lo}, {hi}) non-zero")
            plain_b = rt.run_backward_plain(inst, pix_b, ts_b, tc_b, nl)
            for lane in range(16 if hi > lo else 0):   # a band of pad tiles
                e, _ = grad_close(rows_b[lo:hi, lane], plain_b[lo:hi, lane],
                                  f"{n} bands, band {b}: K2 lane {lane}")
                k2_err = max(k2_err, e)
            pg_b = rt.per_gaussian_sums(rows_b, bb)
            pg_sum = pg_b if pg_sum is None else pg_sum + pg_b
        tiles = torch.cat(k1_parts)
        require(torch.equal(tiles[:n_tiles], full_k1),
                f"{n} bands: the stitched K1 bands differ from the full "
                "frame's K1")
        pad = tiles[n_tiles:]
        require(bool((pad[:, 6] == 1).all()) and not bool(pad[:, :6].any()),
                f"{n} bands: a pad tile is not empty")
        err = (pg_sum - full_pg).abs()
        scale = full_pg.abs().amax(0, keepdim=True)
        require(bool((err <= BAND_SUM_ATOL * scale
                      + BAND_SUM_RTOL * full_pg.abs()).all()),
                f"{n} bands: the band sums differ from the full frame's by "
                f"{float((err / scale.clamp_min(1e-30)).max()):.3e} of a "
                "lane's scale")
        log(f"{n} bands ({rows} tile rows each, {(gy_pad - gy) * gx} pad "
            f"tiles, {n_live} instances): K1 stitched bit-equal to the full "
            f"frame, pad tiles empty; K2 per band bit-equal in the band's "
            f"slots and zero outside, against its plain twin max abs err "
            f"{k2_err:.3e} within GRAD_*; K4+K3 band sums added over the "
            f"bands vs the full frame: max {float(err.max()):.3e}, "
            f"{float((err / scale.clamp_min(1e-30)).max()):.3e} of a lane's "
            "scale")


def compare_with_one_device(dev, cfg, opt, cams, targets, cap, state, plan,
                            rank0):
    """Mesh (1, 2)'s run (rank 0's result) against ``train_step`` on one
    process over the same views from the same state: the first step's
    gradients within GRAD_*, the losses, parameters, moments and
    statistics within TRAJ_*."""
    import torch
    from gscream_tpu_torch.parallel import workers
    from gscream_tpu_torch.train.state import group_of, lr_tree, named_params
    from gscream_tpu_torch.train.step import train_step
    ref = workers.load_state(state, cfg, dev)
    losses, first = [], None
    for vs in plan:
        v = vs[0]
        ref, aux = train_step(ref, cams[v], *targets[v], cfg=cfg, opt=opt,
                              is_ref=v == 0, capacity=cap, width=WIDTH,
                              height=HEIGHT, accumulate=True)
        losses.append(aux.packed[0].item())
        if first is None:
            first = {k: t.detach().to("cpu", copy=True)
                     for k, t in ref.m.items()}
    g_err = 0.0
    for name, want in first.items():
        got = rank0["states"][0]["m"][name]
        if not want.any():
            require(not got.any(), f"mesh (1, 2): step 1 gave {name} a "
                    "gradient one device does not")
            continue
        g_err = max(g_err, grad_close(got, want, f"mesh (1, 2) step 1 "
                                      f"gradient of {name}")[0] / max(
            float(want.abs().max()), 1e-30))
    got = rank0["packed"][:, 0].double()
    want = torch.tensor(losses, dtype=torch.float64)
    require(bool(((got - want).abs() <= TRAJ_LOSS_RTOL * want.abs()).all()),
            f"mesh (1, 2) losses {got.tolist()} vs one device {losses}")
    lr_sum = {}
    for t in range(1, len(plan) + 1):
        for group, lr in lr_tree(t, opt, 1.0).items():
            lr_sum[group] = lr_sum.get(group, 0.0) + lr
    st = rank0["state"]
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    flips = {"params": 0, "m": 0, "v": 0}
    for name, t in named_params(ref.scaffold).items():
        for what, a, b in (("params", st["params"][name], t),
                           ("m", st["m"][name], ref.m[name]),
                           ("v", st["v"][name], ref.v[name])):
            e, nb = trajectory_close(a, b.detach().cpu(),
                                     f"mesh (1, 2) {what} {name}",
                                     what != "params",
                                     lr_sum[group_of(name)])
            worst[what] = max(worst[what], e)
            flips[what] += nb
    stat_flips = {}
    for f in ("anchor_demon", "offset_denom", "opacity_accum",
              "offset_grad_accum"):
        # a visibility count moves by at most 1 a step
        counts = f in ("anchor_demon", "offset_denom")
        stat_flips[f] = trajectory_close(
            st["stats"][f], getattr(ref.stats, f).cpu(), f"mesh (1, 2) {f}",
            True, loose=float(len(plan)) if counts else None)[1]
    log(f"mesh (1, 2) vs one device: step 1 gradients within GRAD_* "
        f"(worst {g_err:.3e} of a leaf's scale); over {len(plan)} steps "
        f"losses {losses} (max rel "
        f"{float(((got - want).abs() / want.abs()).max()):.3e}); max abs "
        f"err params {worst['params']:.3e}, m {worst['m']:.3e}, v "
        f"{worst['v']:.3e}; elements beyond the tight bound {flips}; "
        f"statistics within TRAJ_*, elements beyond the tight bound "
        f"{stat_flips}")


def sharded_runs(dev, cfg, scaffold, cams, targets, tmp):
    """Part 2: ``SHARD_STEPS`` steps of ``make_sharded_train_step`` at
    each mesh of SHARD_MESHES in a spawned world of two ranks (NCCL, one
    card each, where the machine has two cards; gloo sharing the one
    card otherwise), and at (2, 2) in four ranks where it has four;
    (1, 2) against the single-device ``train_step``, (2, 1)'s first loss
    against the mean of its views' losses, (2, 2)'s losses against (2,
    1)'s (TRAJ_LOSS_RTOL), the replicas bit-equal.  Returns each kernel's launches summed over the
    ranks and meshes, and the wall ms per step of each mesh."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.io import save_checkpoint
    from gscream_tpu_torch.parallel import distributed as dist_
    from gscream_tpu_torch.parallel import workers
    from gscream_tpu_torch.parallel.mesh import Mesh
    from gscream_tpu_torch.parallel.shard import (make_sharded_loss,
                                                  sharded_view_batch)
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.state import init_train_state
    opt = OptimConfig()
    state = os.path.join(tmp, "state.pt")
    save_checkpoint(state, init_train_state(scaffold, cfg))
    demand = max(instance_demand(scaffold, cfg, c) for c in cams)
    cap = capacity_tier(demand + demand // 4)
    host = [tuple(t.cpu() for t in tg) for tg in targets]
    cpu_cams = [workers.camera_to(c, "cpu") for c in cams]

    def batch(views):
        return sharded_view_batch(
            [dict(camera=cpu_cams[v], image=host[v][0], mask=host[v][1],
                  depth=host[v][2]) for v in views],
            fg_boxes=[host[v][3] if v == 0 else torch.zeros_like(host[v][3])
                      for v in views],
            is_ref=[v == 0 for v in views], device="cpu")
    plans = {(1, 2): [[i % len(cams)] for i in range(SHARD_STEPS)],
             (2, 1): [[(2 * i) % len(cams), (2 * i + 1) % len(cams)]
                      for i in range(SHARD_STEPS)]}
    plans[(2, 2)] = plans[(2, 1)]
    # on a host with four cards the (2, 2) mesh too, a card per rank
    meshes = SHARD_MESHES + (((2, 2),) if cards(dev) >= 4 else ())
    backend = rank_backend(dev)
    log(f"sharded runs: backend {backend} over {cards(dev)} card(s) ("
        + ("one card per rank" if backend == "nccl" else
           "two ranks sharing the card, collectives staged through host "
           "memory") + f"), capacity {cap}, {SHARD_STEPS} steps per mesh")
    launches, wall, losses_of = {}, {}, {}
    for shape in meshes:
        steps = [dict(batch=batch(vs), accumulate=True)
                 for vs in plans[shape]]
        t0 = time.perf_counter()
        res = dist_.spawn(workers.steps_worker, shape[0] * shape[1], shape,
                          cfg, opt, cap, WIDTH, HEIGHT, state, steps,
                          int(shape == (1, 2)), backend=backend,
                          device=dev.type, timeout_s=600)
        took = time.perf_counter() - t0
        digests = {r["digest"] for r in res}
        require(len(digests) == 1, f"mesh {shape}: replicas differ")
        for r in res:
            require(torch.equal(r["packed"], res[0]["packed"]),
                    f"mesh {shape}: ranks report different steps")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        packed = res[0]["packed"]
        losses_of[shape] = packed[:, 0]
        require(bool((packed[:, 2] <= cap).all()), f"mesh {shape}: "
                f"overflow, demand {packed[:, 2].tolist()} > {cap}")
        require(bool(torch.isfinite(packed[:, :2]).all()),
                f"mesh {shape}: a loss is not finite")
        per_rank = {k: n / SHARD_STEPS for k, n in res[0]["launches"].items()
                    if n}
        # (the wrappers count launches on the card only: a CPU rehearsal
        # runs the plain twins)
        for k in ("tile_forward", "tile_backward", "segment_reduce",
                  "unpack_columns", "expand_gauss_rows", "expand_rows"
                  ) if dev.type == "cuda" else ():
            require(all(r["launches"][k] == SHARD_STEPS for r in res),
                    f"mesh {shape}: {k} launched "
                    f"{[r['launches'][k] for r in res]} times in "
                    f"{SHARD_STEPS} steps per rank")
        for r in res:
            require_attention(r["launches"], 0, f"in mesh {shape}'s "
                              f"{SHARD_STEPS} phase-1 steps")
        wall[shape] = [r["wall_ms"] for r in res]
        med = float(np.median(res[0]["wall_ms"][1:]))
        staged = [r.get("staged") for r in res]
        log(f"mesh {shape} ({backend}): losses {packed[:, 0].tolist()}, "
            f"instances {packed[:, 2].int().tolist()}; wall ms per step "
            f"(rank 0) {[round(x, 3) for x in res[0]['wall_ms']]}, median "
            f"of steps 2-{SHARD_STEPS} {med:.3f}; launches per rank-step "
            f"{per_rank}; host-staged collectives per rank {staged}; "
            f"replicas bit-equal (sha256 {res[0]['digest'][:16]}); spawn + "
            f"run {took:.1f} s [{SMI}]")
        if shape == (1, 2):
            compare_with_one_device(dev, cfg, opt, cams, targets, cap, state,
                                    plans[shape], res[0])
        elif shape == (2, 2):
            dp = losses_of[(2, 1)]
            require(bool(((packed[:, 0] - dp).abs() <= TRAJ_LOSS_RTOL
                          * dp.abs()).all()),
                    f"mesh (2, 2) losses {packed[:, 0].tolist()} vs (2, 1)'s "
                    f"{dp.tolist()}")
            log(f"mesh (2, 2): losses within "
                f"{float(((packed[:, 0] - dp).abs() / dp.abs()).max()):.2e} "
                "of (2, 1)'s")
        else:
            ref = workers.load_state(state, cfg, dev)
            one = make_sharded_loss(Mesh(), cfg, opt, cap, WIDTH, HEIGHT)
            view_losses = [one(ref.scaffold, workers.batch_to(
                batch([v]), dev))[0].item() for v in plans[shape][0]]
            mean = 0.5 * (view_losses[0] + view_losses[1])
            require(abs(packed[0, 0].item() - mean)
                    <= DP_LOSS_RTOL * abs(mean),
                    f"mesh (2, 1) first loss {packed[0, 0].item()} vs the "
                    f"mean of its views' {view_losses}")
            log(f"mesh (2, 1): first loss {packed[0, 0].item():.7f} = mean "
                f"of its views' losses {view_losses} within "
                f"{abs(packed[0, 0].item() - mean):.2e}")
    return launches, wall


def cards(dev) -> int:
    import torch
    return torch.cuda.device_count() if dev.type == "cuda" else 0


def rank_backend(dev) -> str:
    """NCCL with a card per rank where there are two; gloo otherwise."""
    return "nccl" if cards(dev) >= 2 else "gloo"


def sharded_cli(dev, tmp):
    """Part 3: ``train_torch.py --synthetic --mesh_tiles 2`` as two ranks
    (``--dist_*``; gloo when the machine has one card) for CLI_ITERS
    iterations with densifications and phase-2 steps, against the same
    command on one process: the losses of ``train_log.json`` within
    TRAJ_LOSS_RTOL and the same events."""
    import socket
    port_s = socket.socket()
    port_s.bind(("127.0.0.1", 0))
    port = port_s.getsockname()[1]
    port_s.close()
    backend = rank_backend(dev)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "train_torch.py")] + CLI_FLAGS
        + ["--model_path", os.path.join(tmp, "mesh"), "--mesh_tiles", "2",
           "--dist_coordinator", f"127.0.0.1:{port}", "--dist_nprocs", "2",
           "--dist_pid", str(r), "--dist_backend", backend,
           "--device", dev.type],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        finally:
            if p.poll() is None:
                p.kill()
    mesh_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"train_torch.py rank {r} exited "
                f"{p.returncode}:\n{out[-4000:]}")
    t0 = time.perf_counter()
    single = subprocess.run(
        [sys.executable, os.path.join(root, "train_torch.py")] + CLI_FLAGS
        + ["--model_path", os.path.join(tmp, "single"), "--device",
           dev.type], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    single_s = time.perf_counter() - t0
    require(single.returncode == 0, f"train_torch.py exited "
            f"{single.returncode}:\n{single.stdout[-2000:]}"
            f"{single.stderr[-2000:]}")
    logs = {}
    for name in ("mesh", "single"):
        with open(os.path.join(tmp, name, "train_log.json")) as f:
            logs[name] = json.load(f)
    a, b = logs["mesh"], logs["single"]
    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    require(la.shape == lb.shape == (CLI_ITERS,), f"losses {la} {lb}")
    require(bool(np.all(np.abs(la - lb) <= TRAJ_LOSS_RTOL * np.abs(lb))),
            f"the 2-rank CLI's losses {la.tolist()} vs one process's "
            f"{lb.tolist()}")
    ev = [e["event"] for e in a["events"]]
    require(ev == [e["event"] for e in b["events"]] and "densify" in ev,
            f"events {a['events']} vs {b['events']}")
    phase2 = [s["it"] for s in a["steps"] if s["use_cross"]]
    require(phase2, "the CLI ran no phase-2 step")
    log(f"CLI: train_torch.py --synthetic --mesh_tiles 2 on 2 ranks "
        f"({backend}) for {CLI_ITERS} iterations (phase 2 at {phase2}, "
        f"events {a['events']}) in {mesh_s:.1f} s, one process in "
        f"{single_s:.1f} s; losses max rel diff "
        f"{float(np.max(np.abs(la - lb) / np.abs(lb))):.3e} [{SMI}]")


def sharded_pipeline(dev, cfg, scaffold, cams, targets, tmp):
    """Part 4: ``train_scene`` at mesh (1, 2) in two spawned ranks over
    the training views, warm-started from the benchmark model's anchors
    (SHARD_PIPE_OPTIM, from half the first view's demand), at each
    pipeline depth of LOOP_DEPTHS: the same digest on every rank and
    depth, the losses, steps and events equal."""
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.data.synthetic import SyntheticView
    from gscream_tpu_torch.model.io import save_anchors_ply
    from gscream_tpu_torch.parallel import distributed as dist_
    from gscream_tpu_torch.parallel import workers
    from gscream_tpu_torch.train.loop import capacity_tier
    run = RunConfig(model=ModelConfig(
        feat_dim=cfg.feat_dim, n_offsets=cfg.n_offsets,
        voxel_size=cfg.voxel_size, anchor_capacity=cfg.capacity),
        optim=OptimConfig(**SHARD_PIPE_OPTIM), seed=0)
    points = np.random.default_rng(0).normal(
        0, 0.6, (N_ANCHORS, 3)).astype(np.float32)   # bench_scene's cloud
    ply = os.path.join(tmp, "pipeline.ply")
    save_anchors_ply(ply, scaffold, cfg)
    views = [SyntheticView(workers.camera_to(cams[i], "cpu"),
                           *(t.cpu() for t in targets[i][:3]), f"view_{i}")
             for i in range(len(cams))]
    cap = capacity_tier(instance_demand(scaffold, cfg, cams[0]) // 2)
    t0 = time.perf_counter()
    res = dist_.spawn(workers.pipeline_worker, 2, (1, 2), views, 0, points,
                      run, os.path.join(tmp, "pipeline"),
                      dict(capacity=cap, pretrained_ply=ply), LOOP_DEPTHS,
                      backend=rank_backend(dev), device=dev.type,
                      timeout_s=600)
    took = time.perf_counter() - t0
    digests = {r["digest"] for rank in res for r in rank}
    require(len(digests) == 1, f"mesh (1, 2) at depths {LOOP_DEPTHS}: "
            "the ranks or the depths end on other states")
    first = res[0][0]
    for d, r in zip(LOOP_DEPTHS, res[0]):
        require(r["losses"] == first["losses"] and r["steps"] ==
                first["steps"] and r["events"] == first["events"],
                f"mesh (1, 2) at depth {d}: losses, steps or events differ")
    over = [e["it"] for e in first["events"] if e["event"] == "overflow"]
    require(over[:1] == [1], f"mesh (1, 2): no overflow re-run at the first "
            f"step: {first['events']}")
    require(all(math.isfinite(x) for x in first["losses"]),
            f"mesh (1, 2): a loss is not finite: {first['losses']}")
    n_p2 = sum(1 for s in first["steps"] if s["use_cross"])
    attn_n = [[r["launches"][k] for k in ATTN_KERNELS]
              for rank in res for r in rank]
    require(dev.type != "cuda" or all(a == b >= n_p2 > 0
                                      for a, b in attn_n),
            f"mesh (1, 2) loop: the dual softmax pair launched {attn_n} "
            f"times (per rank and depth) over {n_p2} phase-2 iterations")
    log(f"mesh (1, 2) loop at pipeline depths {LOOP_DEPTHS}: bit-equal "
        f"(sha256 {first['digest'][:16]}) on both ranks, losses "
        f"{first['losses']}, events {first['events']}, phase 2 at "
        f"{[s['it'] for s in first['steps'] if s['use_cross']]}; dual "
        f"softmax pair launches per rank and depth {attn_n}; spawn + "
        f"runs {took:.1f} s [{SMI}]")
    total = {}
    for rank in res:
        for r in rank:
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    return total


def sharded_phase(dev, cams, targets):
    """Phase (h): multi-GPU training over a (data, tiles) mesh on a fresh
    copy of the benchmark model.  Returns each kernel's launches over the
    sharded steps, summed over ranks and meshes, and over the mesh (1, 2)
    loop, summed over ranks and pipeline depths."""
    t_start = time.perf_counter()
    cfg, scaffold = bench_scene(dev)
    cams = cams[:N_TRAIN_VIEWS]
    band_kernels(dev, cfg, scaffold, cams, targets)
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = sharded_runs(dev, cfg, scaffold, cams, targets, tmp)
        sharded_cli(dev, tmp)
        loop_launches = sharded_pipeline(dev, cfg, scaffold, cams, targets,
                                         tmp)
    log(f"phase (h) took {time.perf_counter() - t_start:.1f} s")
    return launches, loop_launches


# ---------------------------------------------------------------------------
# phase (i): the JAX package's other configurations on the card

# the kernels each mode's step launches once (by their names in
# launch_counters); the others must not launch in it
RAW_ROUTE = ("tile_forward_raw", "tile_backward_raw", "segment_reduce",
             "unpack_columns", "expand_gauss_rows", "expand_rows")
FULL_RECT_ROUTE = ("tile_forward", "tile_backward", "segment_reduce",
                   "unpack_columns")
SCATTER_ROUTE = ("tile_forward", "tile_backward", "expand_gauss_rows",
                 "expand_rows")
# (label, environment, OptimConfig fields, train_step keywords, route)
MODES = (
    ("default", {}, {}, {}, DEFAULT_ROUTE),
    ("GSCREAM_KERNEL_COEFF=1", {"GSCREAM_KERNEL_COEFF": "1"}, {}, {},
     RAW_ROUTE),
    ("GSCREAM_ROW_TIGHT=0", {"GSCREAM_ROW_TIGHT": "0"}, {}, {},
     FULL_RECT_ROUTE),
    ("GSCREAM_TIGHT_CULL=0", {"GSCREAM_TIGHT_CULL": "0"}, {}, {},
     FULL_RECT_ROUTE),
    ("precise_sort=False", {}, {}, {"precise_sort": False}, DEFAULT_ROUTE),
    ("GSCREAM_SORT_FUSED=1", {"GSCREAM_SORT_FUSED": "1"}, {}, {},
     DEFAULT_ROUTE),
    ('loss_dtype="bfloat16"', {}, {"loss_dtype": "bfloat16"}, {},
     DEFAULT_ROUTE),
    ("GSCREAM_SCATTER_REDUCE=1", {"GSCREAM_SCATTER_REDUCE": "1"}, {}, {},
     SCATTER_ROUTE),
)
MODE_STEPS = 3          # phase (i): train_step calls per mode
# the modes whose binning or records differ from the default's: their
# render is also held to the render through the plain twins
PLAIN_CHECKED = ("GSCREAM_KERNEL_COEFF=1", "GSCREAM_ROW_TIGHT=0",
                 "GSCREAM_TIGHT_CULL=0", "precise_sort=False")
# raw K1 and K2 turn each staged record into the legacy one: per (record,
# tile) 2 subtractions for the tile-local centre, 12 float32 operations for
# k0..k2, 2 for k3 and k5 (k4 is a negation), 2 roundings and 2
# subtractions for the shifts
RAW_OPS_RECORD = 20
# the bfloat16 loss head against float32 (tests/test_bf16_losses.py): the
# loss within 2%, the gradients to the rendered colour and depth each at a
# cosine above 0.995 and within 5% of their norm
BF16_LOSS_RTOL = 2e-2
BF16_COS = 0.995
BF16_NORM_REL = 5e-2


def raw_kernel_lines(g, args, label):
    """Raw K1 and K2 at view 0 on the arguments one ``loss_and_grads`` call
    under GSCREAM_KERNEL_COEFF=1 gave them: against their plain twins
    (K1 within ATOL and MAX_FLIP_FRACTION, K2 per lane within GRAD_*),
    against legacy K1 and K2 on the legacy records of the same binning
    (bit-equal by design; reported), a rerun bit-equal; timed in turns
    with legacy K1 and K2.  Returns their kernel lines."""
    import torch
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    k1 = args["run_forward_raw"]
    k2 = args["run_backward_raw"]
    raw, ts, tc, n_tiles, gx, base = k1
    pix = k2[1]
    require(base == 0 and gx == -(-WIDTH // 32),
            f"raw K1 got tile_base {base}, grid_x {gx}")
    sp, dec, b = g.splats, g.dec, g.binning
    with torch.no_grad():
        legacy = rt.pack_instance_data(sp.mean2d, sp.conic, dec.opacity,
                                       dec.color, sp.depth, dec.uncertainty,
                                       b, gx)
    n = min(int(b.num_instances), raw.shape[0])
    out1 = rt.run_forward_raw(*k1)
    out2 = rt.run_backward_raw(*k2)
    sync()
    require(torch.equal(out1, rt.run_forward_raw(*k1)) and torch.equal(
        out2, rt.run_backward_raw(*k2)), f"raw K1/K2 rerun differs ({label})")
    eq1 = torch.equal(out1, rt.run_forward(legacy, ts, tc, n_tiles))
    eq2 = torch.equal(out2, rt.run_backward(legacy, pix, ts, tc, n_tiles))
    p1 = rt.run_forward_raw_plain(*k1)
    p2 = rt.run_backward_raw_plain(*k2)
    sync()
    err1, bad1 = compare_images(out1, p1)
    require(bad1 <= MAX_FLIP_FRACTION and bool(torch.isfinite(out1).all()),
            f"raw K1 differs from its plain twin ({label}): max abs "
            f"{err1}, {bad1:.2e} beyond tolerance")
    require(not bool(out2[n:].any()), "raw K2 left slots past the live "
            "instances non-zero")
    err2, share2 = 0.0, 0.0
    for lane in range(16):
        e, sh_ = grad_close(out2[:n, lane], p2[:n, lane],
                            f"raw K2 lane {lane} ({label})")
        err2, share2 = max(err2, e), max(share2, sh_)
    log(f"{label}: raw K1 vs plain twin max abs err {err1:.3e}, beyond "
        f"tolerance {bad1:.2e}; raw K2 vs plain twin max abs err "
        f"{err2:.3e}, worst lane beyond tolerance {share2:.2e}; both "
        f"rerun bit-equal; vs legacy K1/K2 on the same binning: K1 "
        f"{'bit-equal' if eq1 else 'NOT bit-equal'}, K2 "
        f"{'bit-equal' if eq2 else 'NOT bit-equal'}")
    if not (eq1 and eq2):
        e, bad = compare_images(out1, rt.run_forward(legacy, ts, tc,
                                                     n_tiles))
        require(bad <= MAX_FLIP_FRACTION, f"raw K1 vs legacy K1: {bad:.2e}")
        leg2 = rt.run_backward(legacy, pix, ts, tc, n_tiles)
        for lane in range(16):
            grad_close(out2[:n, lane], leg2[:n, lane],
                       f"raw K2 vs legacy K2 lane {lane}")
        log(f"  raw vs legacy K1 max abs err {e:.3e}")

    work = k1_work(legacy, ts, tc)
    derive = RAW_OPS_RECORD * work["records"]
    f1 = (K1_OPS_EVAL * work["eval"] + K1_OPS_EXP * work["exp"]
          + K1_OPS_ALPHA * work["alpha"] + K1_OPS_BLEND * work["blend"]
          + derive)
    f2 = (K1_OPS_EVAL * work["eval"] + K1_OPS_EXP * work["exp"]
          + K1_OPS_ALPHA * work["alpha"] + K2_OPS_APPLIED * work["blend"]
          + derive)
    cap = raw.shape[0]
    b1 = (work["records"] * K1_RECORD_BYTES + n_tiles * 2 * 4
          + n_tiles * K1_OUT_ROWS * 1024 * 4)
    b2 = (work["records"] * K1_RECORD_BYTES + n_tiles * 2 * 4
          + n_tiles * K2_PIX_ROWS * 1024 * 4 + cap * 64)
    specs = (
        ("tile_forward_raw", "K1 raw", lambda: rt.run_forward_raw(*k1),
         lambda: rt.run_forward_raw_plain(*k1),
         lambda: rt.run_forward(legacy, ts, tc, n_tiles), "rasterize_fwd.cu",
         "gscream_tpu/ops/rasterize_tiled.py:378", err1, f1, b1,
         f"max abs err {err1:.3e}, beyond tolerance {bad1:.2e}", eq1,
         "gs_tile_forward_raw_attributes", "rasterize_fwd", 20),
        ("tile_backward_raw", "K2 raw", lambda: rt.run_backward_raw(*k2),
         lambda: rt.run_backward_raw_plain(*k2),
         lambda: rt.run_backward(legacy, pix, ts, tc, n_tiles),
         "rasterize_bwd.cu", "gscream_tpu/ops/rasterize_tiled.py:546", err2,
         f2, b2, f"max abs err {err2:.3e}, worst lane beyond tolerance "
         f"{share2:.2e}", eq2, "gs_tile_backward_raw_attributes",
         "rasterize_bwd", 10),
    )
    results = {}
    for (name, tag, kern, plain, leg, src, repl, e, flops, moved, check, eq,
         attrs, lib, reps) in specs:
        ops_s = max(flops / F32_OPS_PER_S, work["exp"] / EX2_PER_S)
        bytes_s = moved / HBM_BYTES_PER_S
        # raw and legacy in turns: raw, legacy, legacy, raw
        turns = [cuda_ms(fn, reps=reps, warmup=2)
                 for fn in (kern, leg, leg, kern)]
        plain_ms = cuda_ms(plain, reps=1, rounds=1)
        rec = {
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"gscream_tpu_torch/csrc/{src}", "replaces": repl,
            "shapes": label, "max_abs_err": e,
            "ms": float(np.median([turns[0], turns[3]])),
            "legacy_ms": float(np.median([turns[1], turns[2]])),
            "turns_ms": turns, "plain_ms": plain_ms,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s > bytes_s else "bytes",
            "library_ms": None, "check": check,
            "bit_equal_to_legacy": eq, "flops": flops, "bytes": moved,
            "derive_flops": derive,
            "attrs": kernel_attributes(lib, attrs)}
        extra = device_times(rec, kern)
        results[name] = rec
        log(f"{tag} {name} at {label}: kernel {rec['ms']:.4f} ms, legacy "
            f"{rec['legacy_ms']:.4f} ms (in turns {[round(t, 4) for t in turns]}"
            f"), plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {flops} float32 operations, "
            f"{derive} of them deriving the records; {moved} bytes)"
            f"{extra}; attributes {rec['attrs']} [{SMI}]")
    return results, (raw, ts, tc, n_tiles, pix, out1, out2, b)


def raw_bands(raw_args, label):
    """Raw K1 and K2 per band for 2 and 4 bands, each band's first global
    tile as ``tile_base``: the stitched K1 bands bit-equal to the whole
    frame's raw K1 (pad tiles empty), each band's K2 rows bit-equal to the
    whole frame's in the band's slots and zero outside them."""
    import torch
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.parallel.shard import (_band_geometry,
                                                  _band_slices, pad_tiles)
    raw, ts, tc, n_tiles, pix, full1, full2, b = raw_args
    for nb in SHARD_BANDS:
        gx, gy, gy_pad, rows = _band_geometry(WIDTH, HEIGHT, nb)
        bb = pad_tiles(b, WIDTH, HEIGHT, nb)
        pix_pad = torch.cat([pix, pix.new_zeros(((gy_pad - gy) * gx,)
                                                + pix.shape[1:])])
        parts = []
        for band in range(nb):
            ts_b, tc_b, nl = _band_slices(bb, gx, rows, band)
            parts.append(rt.run_forward_raw(raw, ts_b, tc_b, nl, gx,
                                            band * nl))
            rows_b = rt.run_backward_raw(raw, pix_pad[band * nl:
                                                      (band + 1) * nl],
                                         ts_b, tc_b, nl, gx, band * nl)
            sync()
            lo, hi = int(ts_b[0]), int(ts_b[-1] + tc_b[-1])
            require(torch.equal(rows_b[lo:hi], full2[lo:hi]),
                    f"{nb} bands, band {band}: raw K2 rows differ from the "
                    "whole frame's")
            require(not bool(rows_b[:lo].any()) and not bool(
                rows_b[hi:].any()), f"{nb} bands, band {band}: raw K2 left "
                "a slot outside the band non-zero")
        tiles = torch.cat(parts)
        require(torch.equal(tiles[:n_tiles], full1), f"{nb} bands: the "
                "stitched raw K1 bands differ from the whole frame")
        pad = tiles[n_tiles:]
        require(bool((pad[:, 6] == 1).all()) and not bool(pad[:, :6].any()),
                f"{nb} bands: a pad tile is not empty")
        log(f"{label}, {nb} bands ({rows} tile rows each, "
            f"{(gy_pad - gy) * gx} pad tiles): raw K1 with tile_base "
            "stitched bit-equal to the whole frame, pad tiles empty; raw K2 "
            "per band bit-equal in the band's slots and zero outside")


def mode_view(scaffold, cfg, cam, target, env, opt_kw, step_kw,
              plain=False):
    """Under one mode: the capacity a counting pass sizes at ``cam`` (and
    the demand), the render (with ``plain``, held to the render through
    the plain twins on the card within ATOL and MAX_FLIP_FRACTION) and one
    ``loss_and_grads`` call there."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.step import (loss_and_grads, phase1_masks,
                                              render_from_params)
    with environ(**env):
        demand = instance_demand(scaffold, cfg, cam)
        cap = capacity_tier(demand)
        with torch.no_grad():
            bg = torch.zeros(3, device=scaffold.alive.device)
            zero = torch.zeros((cfg.capacity * cfg.n_offsets, 2),
                               device=bg.device)

            def render():
                return render_from_params(scaffold.params, scaffold.mlps,
                                          scaffold, cam, bg, zero, cfg, cap,
                                          **step_kw)[0]
            out = render()
            if plain:
                with plain_kernels():
                    out_plain = render()
        g = loss_and_grads(scaffold, cam, *target, cfg=cfg,
                           opt=OptimConfig(**opt_kw), is_ref=True,
                           capacity=cap, masks=phase1_masks(False),
                           **step_kw)
    if not plain:
        return demand, cap, out, g, ""
    err, bad = compare_images(out.color, out_plain.color)
    require(bad <= MAX_FLIP_FRACTION, f"{step_kw or env}: the render vs the "
            f"plain twins' {bad:.2e} beyond tolerance")
    return demand, cap, out, g, (f"; render vs the plain twins max abs err "
                                 f"{err:.3e}, beyond tolerance {bad:.2e}")


def bf16_terms(out, target, is_ref=True):
    """``loss_terms`` of ``out`` at float32 and at bfloat16: {dtype: (loss,
    its gradients to the colour and the depth)}."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.train.step import loss_terms
    res = {}
    for dt in ("float32", "bfloat16"):
        c = out.color.detach().clone().requires_grad_()
        d = out.depth.detach().clone().requires_grad_()
        loss, _ = loss_terms(out._replace(color=c, depth=d), *target,
                             OptimConfig(loss_dtype=dt), is_ref)
        res[dt] = (loss.item(), torch.autograd.grad(loss, (c, d)))
    return res


def bf16_agreement(res):
    """(loss rel, [(cosine, norm error) for colour, depth]) of bfloat16
    against float32 in :func:`bf16_terms`' result."""
    l32, g32 = res["float32"]
    l16, g16 = res["bfloat16"]
    out = []
    for a, b in zip(g16, g32):
        a, b = a.double(), b.double()
        out.append((float((a * b).sum() / (a.norm() * b.norm())),
                    float((a - b).norm() / b.norm())))
    return abs(l16 - l32) / abs(l32), out


def bf16_head(out, target):
    """The bfloat16 loss head on the card.  ``tests/test_bf16_losses.py``'s
    check on its own inputs (seeded uniform images at 128×96, both view
    kinds): the loss within BF16_LOSS_RTOL, the gradients to the colour
    and the depth within BF16_COS and BF16_NORM_REL.  Then the full-width
    render ``out``: the loss within BF16_LOSS_RTOL, the gradients'
    agreement reported — on a smooth render the SSIM's E[x²] − μ² cancels
    in bfloat16, in the JAX package as in the port, and its gradient
    keeps little of its direction.  Returns a phrase for the log."""
    import torch
    from gscream_tpu_torch.ops.rasterize_tiled import TiledOut
    rng = np.random.default_rng(0)
    h, w = 96, 128
    dev = out.color.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    color = t(rng.uniform(0, 1, (h, w, 3)))
    depth = t(rng.uniform(2, 8, (h, w)))
    gt = t(rng.uniform(0, 1, (3, h, w)))
    mask = torch.zeros((1, h, w), device=dev)
    mask[0, 20:60, 30:90] = 1.0
    midas = t(rng.uniform(0, 1, (1, h, w)))
    small = TiledOut(color, depth, torch.zeros_like(depth),
                     torch.zeros_like(depth))
    phrases = []
    for is_ref in (True, False):
        rel, grads = bf16_agreement(bf16_terms(
            small, (gt, mask, midas, mask[0]), is_ref))
        require(rel <= BF16_LOSS_RTOL and all(
            c > BF16_COS and n <= BF16_NORM_REL for c, n in grads),
            f"bfloat16 loss head on tests/test_bf16_losses.py's inputs "
            f"(is_ref {is_ref}): loss rel {rel}, gradients {grads}")
        phrases.append(f"is_ref {is_ref} loss rel {rel:.2e}, colour/depth "
                       "(cosine, norm error) "
                       f"{[(round(c, 6), round(n, 4)) for c, n in grads]}")
    rel, grads = bf16_agreement(bf16_terms(out, target))
    require(rel <= BF16_LOSS_RTOL, f"bfloat16 loss head at full width: "
            f"loss rel {rel}")
    return ("bfloat16 vs float32 on tests/test_bf16_losses.py's inputs: "
            + "; ".join(phrases) + f"; on the full-width render: loss rel "
            f"{rel:.2e}, colour/depth (cosine, norm error) "
            f"{[(round(c, 6), round(n, 4)) for c, n in grads]}")


def check_mode(label, g, out, g0, out0, target):
    """Hold one mode's view-0 render and gradients to the default's, as
    each mode allows; returns a phrase for the log."""
    import torch
    err, bad = compare_images(out.color, out0.color)
    same_img = all(torch.equal(getattr(out, f), getattr(out0, f))
                   for f in out._fields)
    loss, loss0 = float(g.loss.detach()), float(g0.loss.detach())
    rel = abs(loss - loss0) / abs(loss0)
    what = (f"image {'bit-equal' if same_img else f'max abs err {err:.3e}, '
            f'beyond tolerance {bad:.2e}'}, loss {loss:.7f} vs "
            f"{loss0:.7f} (rel {rel:.2e})")
    if label == "precise_sort=False":
        # the quantized key blends instances whose depths agree in their
        # top 20 bits in emission order: another image, held to the plain
        # twins on its own binning (mode_view); the difference reported
        mse = float(((out.color - out0.color) ** 2).mean())
        return what + (f", PSNR against the precise sort's image "
                       f"{10 * math.log10(1 / max(mse, 1e-30)):.2f} dB")
    require(bad <= MAX_FLIP_FRACTION, f"{label}: image vs default "
            f"{bad:.2e} beyond tolerance")
    if label == "GSCREAM_SORT_FUSED=1":
        require(same_img and loss == loss0 and all(
            torch.equal(g.grads[k], g0.grads[k]) for k in g0.grads)
            and torch.equal(g.screen, g0.screen),
            f"{label}: not bit-equal to the default step")
        return what + ", every gradient bit-equal"
    if label == 'loss_dtype="bfloat16"':
        require(same_img, f"{label}: the render changed")
        require(rel <= BF16_LOSS_RTOL, f"{label}: loss rel {rel}")
        # the parameter leaves, reported: the sign of a bfloat16 difference
        # near 0 flips, and sums over the pixels can cancel
        leaves = []
        for k, r in g0.grads.items():
            if bool(r.any()):
                a, b = g.grads[k].double(), r.double()
                leaves.append(
                    (float((a * b).sum() / (a.norm() * b.norm())),
                     float((a - b).norm() / b.norm()), k))
        return (what + f"; {bf16_head(out0, target)}; parameter leaves: "
                f"lowest cosine {min(leaves)[0]:.6f} ({min(leaves)[2]}), "
                f"largest norm error {max(x[1] for x in leaves):.2e}")
    compare_grads(g, g0, f"{label} vs default step gradients",
                  loss_rtol=1e-5)
    n_eq = sum(torch.equal(g.grads[k], g0.grads[k]) for k in g0.grads)
    return what + (f", gradients within GRAD_* ({n_eq} of {len(g0.grads)} "
                   "leaves bit-equal)")


def raw_sharded(dev, cfg, scaffold, cams, targets, tmp):
    """One step of ``make_sharded_train_step`` at mesh (1, 2) in two spawned
    ranks under GSCREAM_KERNEL_COEFF=1 against the same step with legacy
    records: the losses and the first moments (0.1 x the gradients)
    bit-equal or within GRAD_*.  Returns the raw run's launches summed
    over the ranks."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.io import save_checkpoint
    from gscream_tpu_torch.parallel import distributed as dist_
    from gscream_tpu_torch.parallel import workers
    from gscream_tpu_torch.parallel.shard import sharded_view_batch
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.state import init_train_state
    opt = OptimConfig()
    state = os.path.join(tmp, "raw_state.pt")
    save_checkpoint(state, init_train_state(scaffold, cfg))
    d = instance_demand(scaffold, cfg, cams[0])
    cap = capacity_tier(d + d // 4)
    host = [t.cpu() for t in targets[0]]
    batch = sharded_view_batch(
        [dict(camera=workers.camera_to(cams[0], "cpu"), image=host[0],
              mask=host[1], depth=host[2])], fg_boxes=[host[3]],
        is_ref=[True], device="cpu")
    res = {}
    for tag, env in (("raw", {"GSCREAM_KERNEL_COEFF": "1"}),
                     ("legacy", {"GSCREAM_KERNEL_COEFF": "0"})):
        t0 = time.perf_counter()
        with environ(**env):
            res[tag] = dist_.spawn(
                workers.steps_worker, 2, (1, 2), cfg, opt, cap, WIDTH,
                HEIGHT, state, [dict(batch=batch, accumulate=True)], 0,
                backend=rank_backend(dev), device=dev.type, timeout_s=600)
        log(f"sharded step at (1, 2) with {tag} records: loss "
            f"{res[tag][0]['packed'][0, 0].item():.7f}, wall ms "
            f"{res[tag][0]['wall_ms']}, launches per rank "
            f"{ {k: n for k, n in res[tag][0]['launches'].items() if n} }, "
            f"spawn + run {time.perf_counter() - t0:.1f} s [{SMI}]")
    raw, leg = res["raw"][0], res["legacy"][0]
    require(len({r["digest"] for r in res["raw"]}) == 1,
            "raw sharded step: replicas differ")
    if dev.type == "cuda":
        for r in res["raw"]:
            require(r["launches"]["tile_forward_raw"] == 1 and r["launches"][
                "tile_backward_raw"] == 1 and r["launches"][
                "tile_forward"] == 0, f"raw sharded step launched "
                f"{r['launches']}")
    require(abs(raw["packed"][0, 0].item() - leg["packed"][0, 0].item())
            <= 1e-6 * abs(leg["packed"][0, 0].item()),
            "raw sharded loss differs from the legacy one")
    n_eq, n_all = 0, 0
    for name, want in leg["state"]["m"].items():
        got = raw["state"]["m"][name]
        if not bool(want.any()):
            continue
        n_all += 1
        n_eq += bool(torch.equal(got, want))
        grad_close(got, want, f"raw vs legacy sharded step, m {name}")
    log(f"sharded step at (1, 2): raw vs legacy records, loss within 1e-6, "
        f"first moments within GRAD_* ({n_eq} of {n_all} leaves bit-equal)")
    launches = {}
    for r in res["raw"]:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches


def modes_phase(dev, cams, targets):
    """Phase (i): on a fresh copy of the benchmark model at view 0 of the
    training targets, raw K1 and K2 against their plain twins and legacy
    K1 and K2 on the whole frame and on 2 and 4 bands; every mode of
    MODES (the render and one ``loss_and_grads`` call) against the
    default; one sharded step at (1, 2) with raw records against legacy;
    MODE_STEPS ``train_step`` calls per mode, each sized by a counting
    pass, with the launch counters reset just before each and read just
    after.  Returns
    raw K1's and K2's lines and each kernel's launches over the modes'
    steps and the raw sharded step."""
    import torch
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.ops.binning import emission_counts
    from gscream_tpu_torch.train.loop import capacity_tier
    from gscream_tpu_torch.train.state import init_train_state
    from gscream_tpu_torch.train.step import loss_and_grads, phase1_masks
    from gscream_tpu_torch.train.step import train_step
    t_start = time.perf_counter()
    cfg, scaffold = bench_scene(dev)
    cam, target = cams[0], targets[0]

    with environ(GSCREAM_KERNEL_COEFF="1"):
        cap = capacity_tier(instance_demand(scaffold, cfg, cam))
        g, args = recorded_kernel_args(lambda: loss_and_grads(
            scaffold, cam, *target, cfg=cfg, opt=OptimConfig(),
            is_ref=True, capacity=cap, masks=phase1_masks(False)))
    route = sorted(args)
    require(route == sorted(["run_forward_raw", "run_backward_raw",
                             "expand_gauss_rows", "expand_rows",
                             "unpack_columns", "segment_reduce_cm"]),
            f"the raw-record step called {route}")
    label = (f"raw records, training view 0, capacity {cap}, "
             f"{int(g.binning.num_instances)} instances")
    with torch.no_grad():
        results, raw_args = raw_kernel_lines(g, args, label)
        raw_bands(raw_args, label)
    del g, args, raw_args

    with torch.no_grad():
        _, sp = splats_of(scaffold, cfg, cam)
        tight = emission_counts(sp, 32, 32)
        with environ(GSCREAM_ROW_TIGHT="0"):
            rect = emission_counts(sp, 32, 32)
    log(f"view 0 counting passes: row-tight {int(tight[0])} instances in "
        f"{int(tight[1])} rows; full-rect {int(rect[0])} instances")
    _, _, out0, g0, _ = mode_view(scaffold, cfg, cam, target, {}, {}, {})
    for label, env, opt_kw, step_kw, _ in MODES[1:]:
        demand, cap_m, out, g, plain = mode_view(
            scaffold, cfg, cam, target, env, opt_kw, step_kw,
            plain=label in PLAIN_CHECKED)
        what = check_mode(label, g, out, g0, out0, target)
        log(f"mode {label} at view 0: demand {demand}, capacity {cap_m}, "
            f"{int(g.binning.num_instances)} instances{plain}; vs default: "
            f"{what}")
        del g, out
    del g0, out0

    with tempfile.TemporaryDirectory() as tmp:
        sharded = raw_sharded(dev, cfg, scaffold, cams, targets, tmp)

    ts = init_train_state(scaffold, cfg)
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)
    for label, env, opt_kw, step_kw, want in MODES:
        got, wall, steps = dict.fromkeys(counters, 0), [], []
        with environ(**env):
            for _ in range(MODE_STEPS):
                cap_m = capacity_tier(instance_demand(ts.scaffold, cfg, cam))
                for fn in counters.values():
                    fn.launches = 0
                sync()
                t0 = time.perf_counter()
                ts, aux = train_step(ts, cam, *target, cfg=cfg,
                                     opt=OptimConfig(**opt_kw), is_ref=True,
                                     capacity=cap_m, width=WIDTH,
                                     height=HEIGHT, accumulate=True,
                                     **step_kw)
                sync()
                wall.append((time.perf_counter() - t0) * 1e3)
                for name, fn in counters.items():
                    got[name] += fn.launches
                loss, l1, demand, _, _ = aux.packed.tolist()
                require(math.isfinite(loss) and math.isfinite(l1),
                        f"mode {label}: loss {loss}")
                require(demand <= cap_m, f"mode {label}: overflow {demand} "
                        f"> {cap_m}")
                steps.append((round(loss, 6), int(demand), cap_m))
        if dev.type == "cuda":
            for name, n in got.items():
                require(n == (MODE_STEPS if name in want else 0),
                        f"mode {label}: kernel {name} launched {n} times "
                        f"in {MODE_STEPS} steps")
        for name, n in got.items():
            launches[name] += n
        for name in ("tile_forward_raw", "tile_backward_raw"):
            if name in want:
                results[name]["launches"] = got[name]
        log(f"mode {label}: {MODE_STEPS} train_step calls on view 0, (loss, "
            f"instances, capacity) {steps}, wall ms {[round(w, 2) for w in wall]}"
            f" (each to a sync, counting passes outside; median "
            f"{float(np.median(wall)):.2f}), launches "
            f"{ {k: n for k, n in got.items() if n} } [{SMI}]")
    for name, n in sharded.items():
        launches[name] += n
    for name in ("tile_forward_raw", "tile_backward_raw"):
        results[name]["launches_sharded_raw"] = sharded.get(name, 0)
        require(dev.type != "cuda" or results[name].get("launches", 0) > 0,
                f"kernel {name} was not launched by the raw-record step")
    log(f"phase (i) took {time.perf_counter() - t_start:.1f} s")
    return results, launches


SMI = ""


# ---------------------------------------------------------------------------
# phase (j): the port's bench

def run_script(args, env, label):
    """``python3 <script> <args...>`` from the checkout's root in a
    subprocess; fails unless it exits 0.  Returns its standard output's
    lines and its standard error."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable] + args, cwd=root, env=env,
                       capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    require(r.returncode == 0, f"{args[0]} ({label}) exited {r.returncode}:"
            f"\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout.splitlines(), r.stderr


def run_bench(env, label):
    """``python3 bench_torch.py`` in a subprocess: its JSON line, checked
    (every key of ``bench.py``'s line, a finite positive value, no
    overflow), and its wall seconds."""
    t0 = time.perf_counter()
    lines, _ = run_script(["bench_torch.py"], env, label)
    took = time.perf_counter() - t0
    require(len(lines) == 1, f"bench_torch.py ({label}) printed "
            f"{len(lines)} lines: {lines[:4]}")
    rec = json.loads(lines[0])
    import bench_torch
    missing = [k for k in bench_torch.KEYS if k not in rec]
    require(not missing, f"bench_torch.py ({label}): keys {missing} missing")
    require(isinstance(rec["value"], float) and math.isfinite(rec["value"])
            and rec["value"] > 0, f"bench_torch.py ({label}): value "
            f"{rec['value']}")
    require(rec["overflow_demand"] <= rec["capacity"], f"bench_torch.py "
            f"({label}): demand {rec['overflow_demand']} > capacity "
            f"{rec['capacity']}")
    return rec, took


def bench_phase(dev, tdir):
    """Phase (j): ``bench_torch.py`` in a subprocess, plain and with the
    ``GSCREAM_TRACE`` hook on, writing under ``tdir`` (which must not
    stay empty), then its workload in this process with the launch
    counters reset just before one timed-loop call and read just after.
    Returns each kernel's launches per bench iteration, and the plain
    and the traced run's lines."""
    import bench_torch
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GSCREAM_TRACE", None)
    rec, took = run_bench(env, "plain")
    log(f"bench_torch.py line: {json.dumps(rec)} ({took:.1f} s) [{SMI}]")
    traced, took_t = run_bench(dict(env, GSCREAM_TRACE=tdir), "traced")
    files = [os.path.join(d, f) for d, _, fs in os.walk(tdir) for f in fs]
    size = sum(os.path.getsize(f) for f in files)
    require(files and size > 0, "GSCREAM_TRACE wrote no trace")
    log(f"bench_torch.py with GSCREAM_TRACE: {len(files)} trace "
        f"file(s), {size} bytes ({[os.path.relpath(f, tdir) for f in files]}"
        f"); under the profiler value {traced['value']:.6g} rays/s, "
        f"iter_ms {traced['iter_ms']:.3f} ({took_t:.1f} s) [{SMI}]")
    w, h = WIDTH, HEIGHT
    cfg, sc, cam = bench_torch._bench_scene(w, h, N_ANCHORS, 10, 0, dev)
    cap = bench_torch._capacity(*bench_torch._count_instances(cfg, sc, cam,
                                                               w, h))
    grad_fn = bench_torch._build_workload(cfg, sc, cam, w, h, cap)
    grad_fn()
    sync()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = grad_fn()
    sync()
    launches = {name: fn.launches for name, fn in counters.items()}
    require(int(out[2][1]) <= cap, "the bench workload overflowed")
    for name in DEFAULT_ROUTE if dev.type == "cuda" else ():
        require(launches[name] == 1, f"kernel {name} launched "
                f"{launches[name]} times in one bench iteration")
    require_attention(launches, 0, "in one bench iteration")
    log(f"bench iteration launches {launches} (capacity {cap}); phase (j) "
        f"took {time.perf_counter() - t_start:.1f} s")
    return launches, rec, traced


# ---------------------------------------------------------------------------
# phase (k): the profiling scripts

def trace_summary(path, iters, env):
    """``trace_summary_torch.py`` on ``path`` (it must exit 0 and name K1
    and K2), and the trace's device totals by name at full precision
    from the same functions: (device ms per call over the ``iters`` calls
    the trace holds, the script's inferred iteration count, rows as (ms
    per call, count, name), largest first)."""
    import re
    from gscream_tpu_torch.utils.trace import (device_totals,
                                               find_trace_json, load_events)
    lines, _ = run_script(["trace_summary_torch.py", path, "100000"], env,
                          path)
    m = re.fullmatch(r"# device total ([\d.]+) ms over capture, inferred "
                     r"iters=(\d+) -> [\d.]+ ms/iter", lines[1])
    require(m is not None, f"summary header of {path}: {lines[:3]}")
    named = {kernel_symbol(line.split(None, 2)[2]) for line in lines[4:-1]}
    for k in ("tile_forward_kernel", "tile_backward_kernel"):
        require(k in named, f"the summary of {path} does not name {k}")
    tot, cnt = device_totals(load_events(find_trace_json(path)))
    total_ms = sum(tot.values()) / 1e3
    require(abs(total_ms - float(m[1])) <= 0.05 + 1e-9, f"{path}: the "
            f"summary's total {m[1]} ms, the trace's {total_ms} ms")
    rows = sorted(((us / 1e3 / iters, cnt[name], name)
                   for name, us in tot.items()), reverse=True)
    return total_ms / iters, int(m[2]), rows


def split_line(what, wall_ms, wall_traced_ms, summary, iters):
    """Log a block's device busy ms per call from its trace against its
    wall (and the traced run's), the idle share, the five largest device
    entries, the hand-written kernels' ms per call and the default
    route's kernels per call in the trace."""
    dev_ms, inferred, rows = summary
    log(f"{what}: wall {wall_ms:.3f} ms per call, device busy {dev_ms:.4f} "
        f"ms per call (the trace's total over its {iters} calls; "
        f"trace_summary_torch.py inferred {inferred} iterations), idle "
        f"share {max(0.0, 1 - dev_ms / wall_ms):.3f}; under the profiler "
        f"wall {wall_traced_ms:.3f} ms (idle share "
        f"{max(0.0, 1 - dev_ms / wall_traced_ms):.3f}) [{SMI}]")
    for ms, count, name in rows[:5]:
        log(f"  {ms:9.4f} ms per call  x{count:<4d} {name[:90]}")
    mine = own_kernel_names()
    own = {}
    for ms, _, name in rows:
        if kernel_symbol(name) in mine:
            own[kernel_symbol(name)] = own.get(kernel_symbol(name), 0) + ms
    log("  hand-written kernels (device ms per call): " + ", ".join(
        f"{k} {v:.4f}" for k, v in own.items()))
    per_call = {k: sum(c for _, c, n in rows if kernel_symbol(n) == sym)
                / iters for k, sym in ROUTE_SYMBOLS.items()}
    log(f"  default route's kernels per call in the trace: {per_call}")


def profile_phase(dev, tdir, bench):
    """Phase (k): ``profile_train_step_torch.py`` on ``bench_torch.py``'s
    scene at 1008×567 (the script's fallback without a trained model) in
    a subprocess, plain and with ``GSCREAM_TRACE``, its lines checked;
    ``trace_summary_torch.py`` on each variant's trace and on phase (j)'s
    bench trace (``tdir/bench``); each block's device busy ms per call
    against its wall and the idle share; then one ``train_step`` of each
    variant in this process with the launch counters reset just before
    and read just after (K1-K6 once a step).  Returns each kernel's
    launches summed over those steps."""
    import re
    import bench_torch
    import profile_train_step_torch as prof
    from gscream_tpu_torch.train.state import StatePool, init_train_state
    from gscream_tpu_torch.train.step import aux_values
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GSCREAM_TRACE", None)
    no_model = os.path.join(tdir, "no_model")
    args = ["profile_train_step_torch.py", no_model, str(PROFILE_ITERS),
            "--device", dev.type]
    size = f"{prof.SYNTHETIC['width']}x{prof.SYNTHETIC['height']}"
    walls = {}
    for label, run_env in (("plain", env), ("traced", dict(
            env, GSCREAM_TRACE=os.path.join(tdir, "profile")))):
        lines, err = run_script(args, run_env, label)
        for line in lines + [ln for ln in err.splitlines()
                             if ln.startswith("# train_step")]:
            log(f"profile_train_step_torch.py ({label}): {line}")
        require(lines[0].startswith("(no trained model at ")
                and lines[1].startswith(f"model iter 0  {size}  "),
                f"profile_train_step_torch.py ({label}): {lines[:2]}")
        times = {}
        for line in lines[2:]:
            m = re.fullmatch(r"(.+?) +([\d.]+) ms(  \(.*\))?", line)
            require(m is not None and float(m[2]) > 0,
                    f"profile_train_step_torch.py ({label}): {line!r}")
            times[m[1]] = float(m[2])
        want = [v for v, _ in prof.VARIANTS] + [
            f"loss_terms is_ref={r} {nm}" for r in (False, True)
            for nm in ("fwd", "fwd+bwd")]
        require(list(times) == want, f"profile_train_step_torch.py "
                f"({label}) printed {list(times)}")
        walls[label] = times
    log(f"loss head alone at {size} (ms per call, plain run): "
        + ", ".join(f"{k[len('loss_terms '):]} {v:.2f}"
                    for k, v in walls["plain"].items()
                    if k.startswith("loss_terms")) + f" [{SMI}]")

    for label, _ in prof.VARIANTS:
        summary = trace_summary(os.path.join(tdir, "profile", label),
                                PROFILE_ITERS, env)
        split_line(label, walls["plain"][label], walls["traced"][label],
                   summary, PROFILE_ITERS)
    rec, traced = bench
    split_line(f"bench_torch.py at {WIDTH}x{HEIGHT}", rec["iter_ms"],
               traced["iter_ms"], trace_summary(os.path.join(tdir, "bench"),
                                                BENCH_ITERS, env),
               BENCH_ITERS)

    # the launches of one step of each variant, in this process
    with contextlib.redirect_stdout(sys.stderr):
        cfg, scaffold, cam, w, h, opt, _ = prof.load_model(no_model, dev)
    cap = bench_torch._capacity(*bench_torch._count_instances(
        cfg, scaffold, cam, w, h))
    step = prof.step_fn(cfg, opt, cam, prof.step_inputs(
        np.random.default_rng(0), w, h, dev), w, h)
    ts = init_train_state(scaffold, cfg, 0)
    pool = StatePool()
    start = pool.snapshot(ts)
    counters = launch_counters()
    total = dict.fromkeys(counters, 0)
    for label, kw in prof.VARIANTS:
        # the tier that fits the warm-up and the next step, then those
        # two steps again with the second counted
        ts, cap, _ = prof.time_variant(step, pool, start, ts, cap, label,
                                       kw, 1, sync)
        ts = pool.restore(start, ts)
        ts, _ = step(ts, cap, **kw)
        sync()
        for fn in counters.values():
            fn.launches = 0
        ts, aux = step(ts, cap, **kw)
        sync()
        launches = {name: fn.launches for name, fn in counters.items()}
        loss, _, demand, _, cross_ok = aux_values(aux)
        require(math.isfinite(loss) and demand <= cap, f"{label}: loss "
                f"{loss}, demand {demand} for capacity {cap}")
        for name in DEFAULT_ROUTE if dev.type == "cuda" else ():
            require(launches[name] == 1, f"kernel {name} launched "
                    f"{launches[name]} times in one {label} step")
        require_attention(launches, int(kw["use_crossattn"]),
                          f"in one {label} step")
        log(f"{label} step launches "
            f"{ {k: launches[k] for k in DEFAULT_ROUTE + ATTN_KERNELS} } "
            f"(loss {loss:.6f}, "
            f"demand {int(demand)} of {cap}, cross_ok {int(cross_ok)})")
        for name, n in launches.items():
            total[name] += n
    log(f"phase (k) took {time.perf_counter() - t_start:.1f} s")
    return total


def build_kernels(parent):
    """Phase (a): the card, the versions, and the parallel nvcc build (the
    parent's K1 and K2 beside the port's when ``parent`` names a tree)."""
    import torch
    from gscream_tpu_torch.ops import cuda_build
    log(f"card: {SMI}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    procs = variant_build(parent, "parent") if parent else {}
    emission = parent_emission_build(parent) if parent else None
    nocull = variant_build(os.path.dirname(os.path.abspath(__file__)),
                           "nocull", ["-DGS_NO_CULL"])
    took = cuda_build.build()
    variant_load(procs, PARENT, "parent")
    if emission:
        parent_emission_load(*emission)
    variant_load(nocull, NOCULL, "nocull")
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
        # K5 and K6 where the row table overflows (ROW_RATIO slots per row
        # of demand halve it) and where only the instance slots do
        n_rows = int(inp["binning"].num_rows)
        n_inst = int(inp["binning"].num_instances)
        require(ROW_RATIO * n_rows < n_inst, "no capacity overflows only "
                "the instance slots at view 0")
        for cap, what in ((n_rows, "the row table"),
                          (ROW_RATIO * n_rows, "the instance slots")):
            check_expand(inp["k5"][:7] + (row_table_size(cap), cap)
                         + inp["k5"][9:], inp["k6"][4],
                         f"render view 0 at capacity {cap}, which overflows "
                         f"{what} ({n_rows} rows, {n_inst} instances)")
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
        require_attention({k: counters[k].launches for k in ATTN_KERNELS},
                          0, "by the render path")
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


def kernels_line(render, train, train_launches, pallas, pallas_launches,
                 loop_launches, eval_launches, spiral_launches,
                 sharded_launches, sharded_loop_launches, modes,
                 modes_launches, bench_launches, profile_launches,
                 attention):
    """The ``{"kernels": [...]}`` record: each kernel's line from the
    training route that runs it (K7-K9 from phase (e), raw K1 and K2 from
    phase (i), the dual softmax pair from phase (l) at ATTN_SHAPE with the
    training loop's counts, the others from phase (d)), timed at its view 0
    and holding that route's launch count; beside it both training routes'
    counts, the training loop's (phase (f)), the render path's, the
    evaluated test split's and the spiral's (phase (g)), the sharded steps'
    (phase (h), summed over the ranks and meshes) and the mesh (1, 2)
    loop's (summed over ranks and depths), the modes' steps' and the raw
    sharded step's (phase (i)), one bench iteration's (phase (j)), one
    ``train_step`` of each profiled variant's (phase (k)), and,
    for the kernels the render path runs, its own line."""
    out = []
    for name in launch_counters():
        if name in pallas:
            rec = dict(pallas[name])
            rec["launches"] = pallas_launches[name]
        elif name in ATTN_KERNELS:
            tag, part, outputs = (("A1", "fwd", ("attn", "ctx_attn"))
                                  if name == "dual_softmax_fwd" else
                                  ("A2", "bwd", ("grad",)))
            rec = {"name": f"{tag} {name}", "route": "cuda",
                   "shape": attention["shape"], "valid": attention["valid"],
                   "tolerance": attention["tolerance"],
                   "errors": {k: attention["errors"][k] for k in outputs},
                   **attention[part], "launches": loop_launches[name]}
        elif name in modes:
            rec = dict(modes[name])
        else:
            rec = dict(train[name])
        rec["launches_train"] = train_launches[name]
        rec["launches_emit_pallas"] = pallas_launches[name]
        rec["launches_loop"] = loop_launches[name]
        rec["launches_eval"] = eval_launches[name]
        rec["launches_spiral"] = spiral_launches[name]
        rec["launches_sharded"] = sharded_launches[name]
        rec["launches_sharded_loop"] = sharded_loop_launches[name]
        rec["launches_modes"] = modes_launches[name]
        rec["launches_bench"] = bench_launches[name]
        rec["launches_profile"] = profile_launches[name]
        r = render.get(name)
        rec["launches_render"] = r["launches"] if r else 0
        if r:
            rec["render"] = {k: r[k] for k in (
                "shapes", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "graph_ms",
                "device_ms", "launches_per_call", "front") if k in r}
        out.append(rec)
    return {"kernels": out}


def attention_phase(dev):
    """Phase (l): the dual softmax's two kernels (``ops/attention.py``) at
    ATTN_SHAPE against their plain versions: each element within the
    module's KERNEL_RTOL of the plain one plus KERNEL_ATOL of the largest
    plain element (the worst error and the worst beyond KERNEL_RTOL, over
    that element, are reported); a rerun bit-equal; then each timed beside
    its plain version and the library's (autograd through the plain
    forward, the lines the kernels replaced).  Returns the line."""
    import torch
    from gscream_tpu_torch.ops import attention as at
    h, n, m = ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    sim = torch.randn(ATTN_SHAPE, device=dev, generator=gen) * 4.0
    g_attn = torch.randn(ATTN_SHAPE, device=dev, generator=gen)
    # the layout autograd hands from the output einsum: (h, M, N) storage
    g_ctx = torch.randn((h, m, n), device=dev, generator=gen).transpose(1, 2)
    mask = torch.arange(n, device=dev) < ATTN_VALID
    cmask = torch.arange(m, device=dev) < ATTN_VALID
    fwd_args = (sim, ATTN_SCALE, mask, cmask)
    attn, ctx = at.dual_softmax_fwd(*fwd_args)
    bwd_args = (attn, ctx, g_attn, g_ctx, ATTN_SCALE, mask, cmask)
    grad = at.dual_softmax_bwd(*bwd_args)
    plain = at.dual_softmax_plain(*fwd_args) + (
        at.dual_softmax_bwd_plain(*bwd_args),)

    def errors(got, ref, label):
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        beyond = float((err - at.KERNEL_RTOL * ref.abs()).max()) / scale
        require(bool(torch.isfinite(got).all()) and beyond <= at.KERNEL_ATOL,
                f"dual softmax {label}: {beyond:.3e} of the largest plain "
                f"element beyond rtol {at.KERNEL_RTOL}, more than "
                f"{at.KERNEL_ATOL}")
        return {"over_max": float(err.max()) / scale,
                "beyond_rtol_over_max": beyond}
    rec = {"name": "dual_softmax", "shape": list(ATTN_SHAPE),
           "valid": ATTN_VALID,
           "tolerance": {"rtol": at.KERNEL_RTOL, "atol_of_max":
                         at.KERNEL_ATOL},
           "errors": {k: errors(got, ref, k) for k, got, ref in zip(
               ("attn", "ctx_attn", "grad"), (attn, ctx, grad), plain)}}
    again = at.dual_softmax_fwd(*fwd_args)
    require(torch.equal(again[0], attn) and torch.equal(again[1], ctx)
            and torch.equal(at.dual_softmax_bwd(*bwd_args), grad),
            "dual softmax: a rerun is not bit-equal")
    raw = sim.clone().requires_grad_()
    lib_out = at.dual_softmax_plain(raw, ATTN_SCALE, mask, cmask)

    def library_bwd():
        torch.autograd.grad(lib_out, raw, (g_attn, g_ctx), retain_graph=True)
    size = 4 * h * n * m
    for tag, kern, plain_fn, lib, need, moved in (
            ("fwd", lambda: at.dual_softmax_fwd(*fwd_args),
             lambda: at.dual_softmax_plain(*fwd_args), None, 3 * size,
             4 * size),
            ("bwd", lambda: at.dual_softmax_bwd(*bwd_args),
             lambda: at.dual_softmax_bwd_plain(*bwd_args), library_bwd,
             5 * size, 9 * size)):
        r = {"kernel_ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain_fn, 5),
             "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes_needed": need,
             "bytes_moved": moved}
        if lib is not None:
            r["library_ms"] = cuda_ms(lib, 5)
        device_times(r, kern)
        r["share"] = r["bound_ms"] / r["graph_ms"]
        rec[tag] = r
        log(f"dual softmax {tag}: {r}")
    log(f"dual softmax at {ATTN_SHAPE}: errors {rec['errors']}")
    return rec


def main():
    global SMI
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="GPU smoke test of the "
                                 "PyTorch/CUDA port")
    ap.add_argument("--parent", metavar="DIR", help="a checkout of an "
                    "earlier tree: time its K1 and K2 beside the port's")
    ap.add_argument("--phase", choices=("f", "h", "i", "j", "k", "l"),
                    help="build the kernels and run this phase alone (k "
                    "after j, whose trace it reads; on a host with several "
                    "cards, phase (h)'s ranks take one card each)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "False; this check needs a CUDA card")
    import gscream_tpu_torch  # noqa: F401  (fails outside a checkout)
    SMI = smi_line()
    build_kernels(opts.parent)
    dev = torch.device("cuda")
    if opts.phase == "l":
        print(json.dumps(attention_phase(dev)))
        print(SMI)
        return
    if opts.phase in ("j", "k"):
        with tempfile.TemporaryDirectory() as tdir:
            bench_launches, *bench = bench_phase(dev, os.path.join(tdir,
                                                                   "bench"))
            rec = {"launches_bench": bench_launches}
            if opts.phase == "k":
                rec["launches_profile"] = profile_phase(dev, tdir, bench)
        print(json.dumps(rec))
        print(SMI)
        return
    if opts.phase:
        cfg, scaffold = bench_scene(dev)
        cams = orbit_cameras(dev)
        targets = training_targets(dev, cfg, cams[:N_TRAIN_VIEWS])
        if opts.phase == "f":
            print(json.dumps({"launches_loop": loop_phase(
                dev, cfg, scaffold, cams, targets)[0]}))
        elif opts.phase == "h":
            launches, loop_launches = sharded_phase(dev, cams, targets)
            print(json.dumps({"launches_sharded": launches,
                              "launches_sharded_loop": loop_launches}))
        else:
            lines, launches = modes_phase(dev, cams, targets)
            print(json.dumps({"kernels": list(lines.values()),
                              "launches_modes": launches}))
        print(SMI)
        return
    render, cfg, scaffold, cams = render_phase(dev)
    targets = training_targets(dev, cfg, cams[:N_TRAIN_VIEWS])
    train, train_launches = train_phase(dev, cfg, scaffold, cams, targets)
    pallas, pallas_launches = pallas_phase(dev, cfg, scaffold, cams,
                                           targets)
    loop_launches, trained = loop_phase(dev, cfg, scaffold, cams, targets)
    eval_launches, spiral_launches = eval_phase(dev, cfg, trained, cams)
    sharded_launches, sharded_loop_launches = sharded_phase(dev, cams,
                                                            targets)
    modes, modes_launches = modes_phase(dev, cams, targets)
    attention = attention_phase(dev)
    print(json.dumps(attention))
    with tempfile.TemporaryDirectory() as tdir:
        bench_launches, *bench = bench_phase(dev, os.path.join(tdir, "bench"))
        profile_launches = profile_phase(dev, tdir, bench)
    # the kernels line, the card, the result
    print(json.dumps(kernels_line(render, train, train_launches, pallas,
                                  pallas_launches, loop_launches,
                                  eval_launches, spiral_launches,
                                  sharded_launches, sharded_loop_launches,
                                  modes, modes_launches, bench_launches,
                                  profile_launches, attention)))
    print(SMI)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
