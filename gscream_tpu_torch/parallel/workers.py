"""Rank functions for :func:`~.distributed.spawn`: the sharded path run in
a local world by the tests (gloo on the CPU) and by ``chip_smoke.py``
(on the card).  They live in the package, which imports torch only, so a
spawned child never imports a test module, JAX or ``gscream_tpu``.

Each takes ``(rank, world_size, device, ...)``; a state comes as a
checkpoint file (``model.io.save_checkpoint``), views and batches as CPU
tensors, and each returns what the caller compares, as CPU tensors and
numbers: every rank returns its own, so the caller also sees that the
replicas agree.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..cameras import Camera
from ..model.scaffold import ScaffoldConfig, init_scaffold
from ..train.state import TrainState, init_train_state, named_params
from ..train.step import aux_values
from .distributed import all_gather
from .mesh import make_mesh
from .shard import (ViewBatch, check_replicas, make_sharded_loss,
                    make_sharded_train_step)


def camera_to(cam: Camera, device) -> Camera:
    return Camera(*(x.to(device) if isinstance(x, torch.Tensor) else x
                    for x in cam))


def batch_to(batch: ViewBatch, device) -> ViewBatch:
    return batch._replace(
        cameras=[camera_to(c, device) for c in batch.cameras],
        image=batch.image.to(device), mask=batch.mask.to(device),
        depth=batch.depth.to(device), fg_box=batch.fg_box.to(device),
        cross_box=batch.cross_box.to(device))


def load_state(path: str, cfg: ScaffoldConfig, device) -> TrainState:
    """A ``TrainState`` of ``cfg`` on ``device`` filled from the checkpoint
    at ``path``."""
    from ..model.io import load_checkpoint
    grid = np.arange(4, dtype=np.float32)[:, None] * np.float32(
        4 * cfg.voxel_size)
    template = init_train_state(
        init_scaffold(np.repeat(grid, 3, axis=1), cfg, device=device), cfg)
    return load_checkpoint(path, template)


def host_state(ts: TrainState) -> Dict:
    """Every parameter, moment and statistic as CPU tensors (copies: the
    step updates the state's own in place)."""
    def host(d):
        return {k: t.detach().to("cpu", copy=True) for k, t in d.items()}
    return {"params": host(named_params(ts.scaffold)), "m": host(ts.m),
            "v": host(ts.v), "stats": host(ts.stats._asdict()),
            "step": ts.step, "step_c": int(ts.step_c)}


def loss_worker(rank: int, world: int, device, cfg, opt, capacity: int,
                width: int, height: int, state_path: str, cases):
    """``make_sharded_loss`` on the state's scaffold for each ``(mesh
    shape, ViewBatch)`` of ``cases``, in turn in one world: a (loss,
    gradients by ``named_params`` key) per case."""
    ts = load_state(state_path, cfg, device)
    out = []
    for shape, batch in cases:
        loss_fn = make_sharded_loss(make_mesh(*shape), cfg, opt, capacity,
                                    width, height)
        loss, grads = loss_fn(ts.scaffold, batch_to(batch, device))
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    return out


def steps_worker(rank: int, world: int, device, shape: Sequence[int], cfg,
                 opt, capacity: int, width: int, height: int,
                 state_path: str, steps: List[Dict],
                 keep_states: int = 0):
    """``make_sharded_train_step`` at mesh ``shape`` over ``steps`` (each
    a dict with ``batch`` and the step's flags), from the checkpoint:
    the packed aux of each step, the wall ms of each (to a
    synchronisation), each kernel's launches over the steps (the counts
    set to 0 just before them), the collectives staged through host
    memory, the final state (and the state after each of the first
    ``keep_states`` steps) and its digest, checked equal on every
    rank."""
    mesh = make_mesh(*shape)
    ts = load_state(state_path, cfg, device)
    step = make_sharded_train_step(mesh, cfg, opt, capacity, width, height)
    packed, wall, states = [], [], []
    counters = kernel_wrappers()
    for fn in counters.values():
        fn.launches = 0
    for s in steps:
        batch = batch_to(s["batch"], device)
        flags = {k: v for k, v in s.items() if k != "batch"}
        sync(device)
        t0 = time.perf_counter()
        ts, aux = step(ts, batch, **flags)
        sync(device)
        wall.append(1e3 * (time.perf_counter() - t0))
        packed.append(torch.tensor(aux_values(aux)))
        if len(states) < keep_states:
            states.append(host_state(ts))
    launches = {k: fn.launches for k, fn in counters.items()}
    return {"packed": torch.stack(packed), "wall_ms": wall,
            "launches": launches, "staged": dict(all_gather.staged),
            "state": host_state(ts), "states": states,
            "digest": check_replicas(ts, mesh)}


def kernel_wrappers() -> Dict:
    """The kernel wrappers by name (the ten kernels', raw K1's and K2's,
    and the cross-attention's dual softmax pair), looked up on their
    modules now; each counts its launches in its ``launches`` attribute
    (never on the CPU, where the wrappers take their plain versions)."""
    from ..ops import attention, emission, rasterize_tiled, shuffle
    return {"tile_forward": rasterize_tiled.run_forward,
           "tile_backward": rasterize_tiled.run_backward,
           "tile_forward_raw": rasterize_tiled.run_forward_raw,
           "tile_backward_raw": rasterize_tiled.run_backward_raw,
           "segment_reduce": rasterize_tiled.segment_reduce_cm,
           "unpack_columns": shuffle.unpack_columns,
           "expand_gauss_rows": emission.expand_gauss_rows,
           "expand_rows": emission.expand_rows,
           "segment_reduce_rows": rasterize_tiled.segment_reduce_rows,
           "pack_columns": shuffle.pack_columns,
           "expand1": emission.expand1, "expand2": emission.expand2,
           "dual_softmax_fwd": attention.dual_softmax_fwd,
           "dual_softmax_bwd": attention.dual_softmax_bwd}


def train_scene_worker(rank: int, world: int, device, shape: Sequence[int],
                       views, ref_index: int, points, run, out_dir: str,
                       kwargs: Dict):
    """``train_scene(mesh=...)`` on the views (``NamedTuple``s with a
    ``camera``, which is moved to ``device``): its
    losses, steps and events, each kernel's launches over the run (the
    counts set to 0 just before it), the final state and its digest (the
    loop checks the replicas itself)."""
    from ..train.loop import train_scene

    mesh = make_mesh(*shape)
    views = [v._replace(camera=camera_to(v.camera, device)) for v in views]
    counters = kernel_wrappers()
    for fn in counters.values():
        fn.launches = 0
    ts, log = train_scene(views, ref_index, points, run,
                          out_dir=out_dir, mesh=mesh, device=device,
                          **kwargs)
    return {"losses": log.losses, "steps": log.steps, "events": log.events,
            "iter_times": log.iter_times,
            "launches": {k: fn.launches for k, fn in counters.items()},
            "state": host_state(ts), "digest": check_replicas(ts, mesh)}


def pipeline_worker(rank: int, world: int, device, shape: Sequence[int],
                    views, ref_index: int, points, run, out_dir: str,
                    kwargs: Dict, depths: Sequence[int]):
    """:func:`train_scene_worker` once per pipeline depth of ``depths``
    (``GSCREAM_PIPELINE`` set for each run, restored after): a list of
    its results, one per depth, in order."""
    import os
    saved = os.environ.get("GSCREAM_PIPELINE")
    out = []
    try:
        for depth in depths:
            os.environ["GSCREAM_PIPELINE"] = str(depth)
            out.append(train_scene_worker(
                rank, world, device, shape, views, ref_index, points, run,
                os.path.join(out_dir, f"depth{depth}"), kwargs))
    finally:
        if saved is None:
            os.environ.pop("GSCREAM_PIPELINE", None)
        else:
            os.environ["GSCREAM_PIPELINE"] = saved
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
