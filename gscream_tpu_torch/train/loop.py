"""Training orchestration: the host loop around the train step
(counterpart of ``gscream_tpu/train/loop.py``).

The reference ``training()`` loop (train.py:333-620): a camera order
reshuffled each epoch, the reference view's inpainted image and depth
substituted, phase 2 (cross-attention) from ``start_crossattn_from``,
densification every ``update_interval`` between ``update_from`` and
``update_until``, periodic checkpoints, logging.

Host randomness (camera order, patch boxes) is a pure function of the
iteration, drawn from ``(seed, it)`` exactly as the JAX loop draws it, so
a restored checkpoint replays the stream of an uninterrupted run; the
densification's keep draws come from a generator seeded with ``(seed + 2,
it)``; the phase-2 token draws from the state's generator, which the
checkpoint carries.

The loop keeps ``GSCREAM_PIPELINE`` steps in flight (default 3, at
least 1; JAX loop.py:482-516): each iteration launches its step, which
reads nothing to the host, and the oldest launched step is resolved
(its five scalars read) and committed once more than that many wait.
A step whose instance demand exceeds its capacity tier writes nothing
(``train.step``); resolving it, the loop raises the tier, re-runs it
from the state it started from and re-launches the steps queued behind
it from the corrected state, so no step trains on a truncated instance
list and every depth ends with the states of depth 1.  The pipeline
drains before each densification, before each checkpoint and at the
last iteration.  The steps update the parameters and moments in place,
so the state before each step is kept by a snapshot taken at its launch
(``train.state.StatePool``): the re-run starts from it, and the commit
of step k hands the callback, the log and the non-finite dump the state
after step k (the snapshot taken before step k+1, or the live state
when no step is queued behind it), not the live tensors that later
steps have already been enqueued to change.
"""
from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..device import resolve_device
from ..model.densify import adjust_anchors
from ..model.scaffold import ScaffoldConfig, init_scaffold, n_alive
from ..precision import ensure_fp32_matmuls
from ..parallel.shard import (check_replicas, make_sharded_train_step,
                              sharded_view_batch)
from .state import StatePool, init_train_state
from .step import aux_values, train_step


def capacity_tier(n: int) -> int:
    """Smallest fixed instance capacity holding ``n``, on a 12.5%
    (pow2/8) granularity grid of multiples of 1024 (loop.py:36-48)."""
    n = max(int(n), 1)
    g = max(1024, 1 << max(int(n - 1).bit_length() - 3, 0))
    return -(-n // g) * g


def overflow_tier(demand: int, capacity: int) -> int:
    """The tier a step whose instance demand overflowed ``capacity`` is
    re-run at: 25% headroom above the observed demand (densification
    keeps emission growing between tier checks), and above ``capacity``
    (loop.py:429-430)."""
    return max(capacity_tier(demand + demand // 4),
               capacity_tier(capacity + 1))


def get_logger(out_dir: str) -> logging.Logger:
    """Reference get_logger (train.py:994-1010): file + console."""
    logger = logging.getLogger("gscream_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    os.makedirs(out_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(out_dir, "outputs.log"))
    ch = logging.StreamHandler()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (fh, ch):
        h.setLevel(logging.INFO)
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def mask_bbox(mask: np.ndarray):
    """Bounding box of a binary mask (train.py:56-64 cal_box)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return 0, 0, mask.shape[0], mask.shape[1]
    return ys.min(), xs.min(), ys.max() + 1, xs.max() + 1


def sample_patch_in_mask_region(rng, mask: np.ndarray, patch_size: int,
                                small_ratio: float, max_h: int, max_w: int):
    """train.py:173-190: random patch_size box overlapping the mask bbox."""
    y0, x0, y1, x1 = mask_bbox(mask)
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    ny0 = max(0, cy - patch_size / 2)
    nx0 = max(0, cx - patch_size / 2)
    sw = small_ratio * (x1 - x0)
    sh = small_ratio * (y1 - y0)
    off_y = rng.uniform(0, max(patch_size - sh, 0))
    off_x = rng.uniform(0, max(patch_size - sw, 0))
    min_y = max(0, int(ny0 + off_y))
    min_x = max(0, int(nx0 + off_x))
    max_y = min(int(min_y + patch_size), max_h - 1)
    max_x = min(int(min_x + patch_size), max_w - 1)
    return min_y, max_y, min_x, max_x


def random_box_mask(rng, mask: np.ndarray, enlarge_ratio: float,
                    small_ratio: float, h: int, w: int) -> np.ndarray:
    """train.py:103-126 get_random_mask: random sub-box of the enlarged
    mask bbox, as a dense (H,W) {0,1} map (ref-view fg depth term)."""
    y0, x0, y1, x1 = mask_bbox(mask)
    bh, bw = y1 - y0, x1 - x0
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    nh, nw = enlarge_ratio * bh, enlarge_ratio * bw
    ny0 = max(0, cy - nh / 2)
    nx0 = max(0, cx - nw / 2)
    sh, sw = small_ratio * bh, small_ratio * bw
    off_y = rng.uniform(0, max(nh - sh, 0))
    off_x = rng.uniform(0, max(nw - sw, 0))
    min_y = max(0, int(ny0 + off_y))
    min_x = max(0, int(nx0 + off_x))
    max_y = min(int(min_y + sh), h - 1)
    max_x = min(int(min_x + sw), w - 1)
    out = np.zeros((h, w), np.float32)
    out[min_y:max_y, min_x:max_x] = 1.0
    return out


@dataclass
class TrainLog:
    losses: List[float] = field(default_factory=list)
    iter_times: List[float] = field(default_factory=list)
    # overflow re-runs and densifications, as dicts with an "event" key
    events: List[Dict] = field(default_factory=list)
    # per committed step: it, view, is_ref, use_cross, cross_ok,
    # instances (the overflow demand) and the capacity it ran at
    steps: List[Dict] = field(default_factory=list)


class NonFiniteLossError(RuntimeError):
    pass


def dump_nonfinite(out_dir: str, rec: Dict, logger) -> None:
    """Post-mortem for a NaN/inf loss: checkpoint the pre-step state (the
    step wrote nothing) and the step's host-side inputs, then abort (the
    reference's analogue is the CUDA snapshot dump, dgr/__init__.py:87-95)."""
    it = rec["it"]
    path = os.path.join(out_dir, f"nonfinite_it{it}")
    try:
        from ..model.io import save_checkpoint
        save_checkpoint(path + "_ckpt", rec["ts_prev"])

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
        np.savez(path + "_inputs.npz",
                 it=it, view=rec["vi"], fg_box=host(rec["fg_box"]),
                 cross_box=host(rec["cross_box"]),
                 use_cross=rec["use_cross"],
                 num_instances=int(rec["aux"].num_instances),
                 n_active=int(rec["aux"].n_active))
    except Exception as e:    # the dump must never mask the real error
        logger.warning("non-finite dump failed: %s", e)
    logger.error("non-finite loss at iter %d (view %d) — state dumped "
                 "to %s_*", it, rec["vi"], path)
    raise NonFiniteLossError(f"loss became non-finite at iteration {it}")


def densify_generator(seed: int, it: int, device) -> torch.Generator:
    """The keep draws of the densification at iteration ``it``: a
    generator seeded from ``(seed + 2, it)`` alone (JAX: ``fold_in(
    PRNGKey(seed + 2), it)``), so a resumed run draws what the
    uninterrupted one drew."""
    s = np.random.SeedSequence([seed + 2, it]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]) >> 1)


def _tensor(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def train_scene(views, ref_index: int, points: np.ndarray, run: RunConfig,
                out_dir: str = "",
                ref_image: Optional[np.ndarray] = None,
                ref_depth: Optional[np.ndarray] = None,
                spatial_lr_scale: float = 1.0,
                capacity: int = 1 << 20,
                iterations: Optional[int] = None,
                callback: Optional[Callable] = None,
                logger: Optional[logging.Logger] = None,
                pretrained_ply: str = "",
                start_checkpoint: str = "",
                checkpoint_interval: int = 0,
                device="cuda", mesh=None):
    """Train one scene on one device, or on this rank of a ``mesh``
    (``parallel.mesh.Mesh``).  ``views`` is a list of objects with
    ``.camera`` (on ``device``) and ``.image/.mask/.depth/.name`` (numpy
    arrays or tensors); the reference view's image and depth are replaced
    by ``ref_image``/``ref_depth`` when given (train.py:354-365, 425-430).
    ``capacity`` is the starting instance capacity tier; ``callback(it,
    ts, aux)`` runs after each committed step.  Returns (TrainState,
    TrainLog).

    With a mesh every rank runs this loop on its own card and holds the
    whole state: an iteration is one sharded step over ``B = mesh.data``
    views (stream positions ``(it-1)·B + j + 1``, the phase windows read
    at ``it``; JAX loop.py:276-288, :359-411); the overflow decision is
    collective and the densification draws the same keeps on every rank;
    only rank 0 logs, writes metrics and checkpoints and calls
    ``callback``; at the end the replicas are checked bit-equal."""
    ensure_fp32_matmuls()
    dev = resolve_device(device)
    m, opt = run.model, run.optim
    cfg = ScaffoldConfig(
        feat_dim=m.feat_dim, n_offsets=m.n_offsets,
        voxel_size=m.voxel_size, update_depth=m.update_depth,
        update_init_factor=m.update_init_factor,
        update_hierachy_factor=m.update_hierachy_factor,
        capacity=m.anchor_capacity,
        attn_heads=opt.attn_head_num, attn_head_dim=opt.attn_head_dim,
        use_feat_bank=m.use_feat_bank)
    iters = iterations if iterations is not None else opt.iterations
    main_rank = mesh is None or mesh.rank == 0
    if logger is None:
        logger = (get_logger(out_dir or ".") if main_rank
                  else logging.getLogger(f"gscream_tpu_torch.rank{mesh.rank}"))

    scaffold = init_scaffold(points, cfg,
                             torch.Generator().manual_seed(run.seed),
                             device=dev)
    if pretrained_ply:
        # two-phase retrain from a saved anchor cloud (the reference's
        # --warmup path, train.py:1077-1080)
        from ..model.io import load_anchors_ply
        params, alive = load_anchors_ply(pretrained_ply, cfg, dev)
        scaffold = scaffold._replace(params=params, alive=alive)
        logger.info("warm-started %d anchors from %s", int(alive.sum()),
                    pretrained_ply)
    ts = init_train_state(scaffold, cfg, seed=run.seed + 1)
    log = TrainLog()
    from .metrics_log import MetricsLogger
    mlog = MetricsLogger(out_dir or ".",
                         wandb_project=os.environ.get(
                             "GSCREAM_WANDB_PROJECT", "")) \
        if main_rank else None

    start_it = 1
    if start_checkpoint:
        # full-state restore: parameters, moments, statistics, step counts
        # and the token generator
        from ..model.io import load_checkpoint
        ts = load_checkpoint(start_checkpoint, ts)
        start_it = ts.step + 1
        meta_path = start_checkpoint + "_meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                capacity = int(json.load(f).get("capacity", capacity))
        logger.info("resumed from %s at iteration %d (capacity %d)",
                    start_checkpoint, start_it, capacity)

    h, w = views[ref_index].camera.height, views[ref_index].camera.width
    zero_hw = np.zeros((1, h, w), np.float32)
    dev_views = []
    for i, v in enumerate(views):
        img, dep = v.image, v.depth
        if i == ref_index:
            img = ref_image if ref_image is not None else img
            dep = ref_depth if ref_depth is not None else dep
        mask = v.mask if v.mask is not None else zero_hw
        dev_views.append(dict(
            camera=v.camera, image=_tensor(img, dev), mask=_tensor(mask, dev),
            depth=_tensor(dep if dep is not None else zero_hw, dev),
            mask_np=_numpy(mask)[0], is_ref=(i == ref_index)))

    callback_wants_mlog = False
    if callback is not None:
        import inspect
        callback_wants_mlog = (
            len(inspect.signature(callback).parameters) >= 4)

    zero_box = torch.zeros(4, dtype=torch.int32, device=dev)
    zero_fg = torch.zeros((h, w), device=dev)   # the non-ref views' fg box
    t_start = time.time()
    cap = capacity
    phase2_any = (opt.enable_crossattn_refview > 0
                  or opt.enable_crossattn_otherview > 0)
    n_views = len(dev_views)
    order_cache: Dict[int, List[int]] = {}

    def view_for(it: int) -> int:
        """Camera order: a per-epoch permutation from (seed, 77, epoch)."""
        epoch, pos = divmod(it - 1, n_views)
        if epoch not in order_cache:
            order_cache.clear()
            r = np.random.default_rng(
                np.random.SeedSequence([run.seed, 77, epoch]))
            order_cache[epoch] = list(r.permutation(n_views))
        return order_cache[epoch][pos]

    def sample_slot(p: int, phase_it: Optional[int] = None) -> Dict:
        """Host-side sampling for stream position ``p``, from (seed, p);
        the phase windows are read at ``phase_it`` (the optimizer step; a
        sharded batch's B slots share it), by default ``p``."""
        it_ = p if phase_it is None else phase_it
        rng = np.random.default_rng(np.random.SeedSequence([run.seed, p]))
        vi = view_for(p)
        v = dev_views[vi]
        # per-view cross-attention gating (train.py:445-447)
        use_cross = (it_ > opt.start_crossattn_from
                     and (opt.enable_crossattn_refview > 0 if v["is_ref"]
                          else opt.enable_crossattn_otherview > 0))
        # after the first run_crossattn the reference's _anchor_feat is
        # detached for good (gaussian_model.py:556): the main Adam stops
        # updating feat on every view
        feat_frozen = it_ > opt.start_crossattn_from and phase2_any
        fg_box = zero_fg
        if v["is_ref"]:
            fg_box = _tensor(random_box_mask(rng, v["mask_np"], 1.5, 0.8,
                                             h, w), dev)
        cross_box = zero_box
        if use_cross and opt.enable_edge_samping > 0:
            box = sample_patch_in_mask_region(
                rng, v["mask_np"], 256, opt.sampling_2D_small_ratio, h, w)
            cross_box = torch.tensor(box, dtype=torch.int32, device=dev)
        return dict(it=p, vi=vi, fg_box=fg_box, cross_box=cross_box,
                    use_cross=use_cross, feat_frozen=feat_frozen,
                    accumulate=opt.start_stat < it_ < opt.update_until)

    def prepare(it: int) -> Dict:
        """Iteration ``it``'s inputs: one slot, or on a mesh the B slots
        ``(it-1)·B + j + 1`` as one ``ViewBatch`` (loop.py:359-385)."""
        if mesh is None:
            return sample_slot(it)
        slots = [sample_slot((it - 1) * mesh.data + j + 1, phase_it=it)
                 for j in range(mesh.data)]
        vs = [dev_views[s_["vi"]] for s_ in slots]
        batch = sharded_view_batch(
            vs, fg_boxes=[s_["fg_box"] for s_ in slots],
            is_ref=[v_["is_ref"] for v_ in vs],
            cross_boxes=[s_["cross_box"] for s_ in slots],
            cross_enable=[s_["use_cross"] for s_ in slots], device=dev)
        return dict(slots[0], it=it, vis=[s_["vi"] for s_ in slots],
                    batch=batch,
                    use_cross=any(s_["use_cross"] for s_ in slots))

    sharded_steps: Dict[int, Callable] = {}
    pool = StatePool()

    def enqueue(rec: Dict, state):
        """Enqueue ``rec``'s step on ``state`` at the current tier."""
        t0 = time.time()
        if mesh is None:
            v = dev_views[rec["vi"]]
            rec["ts_new"], rec["aux"] = train_step(
                state, v["camera"], v["image"], v["mask"], v["depth"],
                rec["fg_box"], rec["cross_box"], cfg=cfg, opt=opt,
                is_ref=v["is_ref"], use_crossattn=rec["use_cross"],
                capacity=cap, width=w, height=h,
                accumulate=rec["accumulate"], white_bg=m.white_background,
                spatial_lr_scale=spatial_lr_scale,
                feat_frozen=rec["feat_frozen"])
        else:
            if cap not in sharded_steps:
                sharded_steps[cap] = make_sharded_train_step(
                    mesh, cfg, opt, cap, w, h, white_bg=m.white_background,
                    spatial_lr_scale=spatial_lr_scale)
            rec["ts_new"], rec["aux"] = sharded_steps[cap](
                state, rec["batch"], use_crossattn=rec["use_cross"],
                feat_frozen=rec["feat_frozen"],
                accumulate=rec["accumulate"])
        rec["dispatch_s"] = time.time() - t0
        rec["capacity"] = cap
        return rec

    def launch(rec: Dict, state) -> Dict:
        """``rec``'s step on ``state``, the chain's tip (the live
        tensors), after a snapshot of that state (JAX loop.py:387)."""
        rec["ts_prev"] = pool.snapshot(state)
        return enqueue(rec, state)

    def resolve(rec: Dict) -> Dict:
        """The step's scalars, read once; while its instance demand
        overflows its tier, the tier is raised and the step re-run from
        its snapshot (JAX loop.py:413; the reference's resize-and-rerun
        contract, rasterize_points.cu:27-33)."""
        nonlocal cap
        vals = aux_values(rec["aux"])
        n_inst = int(vals[2])
        while n_inst > rec["capacity"]:
            new_cap = overflow_tier(n_inst, cap)
            logger.warning(
                "iter %d: instance overflow %d > %d — re-running this "
                "step at capacity tier %d", rec["it"], n_inst, cap, new_cap)
            log.events.append(dict(event="overflow", it=rec["it"],
                                   demand=n_inst, capacity=cap,
                                   new_capacity=new_cap))
            cap = new_cap
            enqueue(rec, pool.restore(rec["ts_prev"], rec["ts_new"]))
            vals = aux_values(rec["aux"])
            n_inst = int(vals[2])
        rec.update(vals=vals, n_inst=n_inst)
        return rec

    def commit(rec: Dict, after):
        """Log step ``rec`` and hand ``after``, the state after it, to the
        callback (JAX loop.py:442)."""
        it, aux, vals = rec["it"], rec["aux"], rec["vals"]
        loss = float(vals[0])
        if not np.isfinite(loss):
            if not main_rank:
                raise NonFiniteLossError(
                    f"loss became non-finite at iteration {it}")
            dump_nonfinite(out_dir or ".", rec, logger)
        log.losses.append(loss)
        log.iter_times.append(rec["dispatch_s"])
        log.steps.append(dict(
            it=it, view=rec["vi"], is_ref=dev_views[rec["vi"]]["is_ref"],
            use_cross=rec["use_cross"], cross_ok=bool(vals[4]),
            instances=rec["n_inst"], capacity=rec["capacity"],
            views=rec.get("vis", [rec["vi"]])))
        if not main_rank:
            return after
        if it % 100 == 0 or it == iters:
            anchors = int(n_alive(after.scaffold))
            logger.info(
                "iter %d/%d loss %.5f anchors %d instances %d "
                "(%.1f it/s)", it, iters, loss, anchors, rec["n_inst"],
                (it - start_it + 1) / max(time.time() - t_start, 1e-9))
            mlog.log(it, {"loss": loss, "l1": float(vals[1]),
                          "iter_time": rec["dispatch_s"],
                          "total_points": anchors,
                          "instances": rec["n_inst"]})
        if callback is not None:
            if callback_wants_mlog:
                callback(it, after, aux, mlog)
            else:
                callback(it, after, aux)
        return after

    def save_ckpt(it: int):
        from ..model.io import save_checkpoint
        path = os.path.join(out_dir or ".", "ckpt")
        save_checkpoint(path, ts)
        with open(path + "_meta.json", "w") as f:
            json.dump({"iteration": it, "capacity": cap}, f)
        logger.info("checkpoint saved at iter %d -> %s", it, path)

    # pipeline depth: launched steps kept unresolved (JAX loop.py:482)
    depth = max(int(os.environ.get("GSCREAM_PIPELINE", "3")), 1)
    pending: List[Dict] = []

    def drain_one():
        nonlocal ts
        rec = pending.pop(0)
        first = rec["ts_new"]
        resolve(rec)
        if rec["ts_new"] is not first:
            # re-run at a higher tier: the queued successors ran from a
            # discarded state — re-launch the chain in order from the
            # corrected one
            chain = rec["ts_new"]
            for r in pending:
                pool.release(r["ts_prev"])
                chain = launch(r, chain)["ts_new"]
        ts = commit(rec, pending[0]["ts_prev"] if pending else rec["ts_new"])
        pool.release(rec["ts_prev"])

    def drain_all():
        while pending:
            drain_one()

    for it in range(start_it, iters + 1):
        pending.append(launch(prepare(it),
                              pending[-1]["ts_new"] if pending else ts))
        while len(pending) > depth:
            drain_one()
        # densification boundary (train.py:599-606; strictly below
        # update_until — the reference nests adjust_anchor under
        # ``iteration < opt.update_until``): drained, so that it sees the
        # committed state
        densify_now = (opt.update_from < it < opt.update_until
                       and it % opt.update_interval == 0)
        if densify_now or it == iters:
            drain_all()
        if densify_now:
            before = int(ts.scaffold.alive.sum())
            sc, stats, m_, v_ = adjust_anchors(
                ts.scaffold, ts.stats, ts.m, ts.v,
                densify_generator(run.seed, it, dev), cfg,
                check_interval=opt.update_interval,
                success_threshold=opt.success_threshold,
                grad_threshold=opt.densify_grad_threshold,
                min_opacity=opt.min_opacity)
            ts = ts._replace(scaffold=sc, stats=stats, m=m_, v=v_)
            log.events.append(dict(
                event="densify", it=it, alive_before=before,
                alive_after=int(sc.alive.sum()),
                grow_overflow=int(stats.grow_overflow)))
        # periodic autosave at a committed iteration boundary
        if checkpoint_interval and it % checkpoint_interval == 0:
            drain_all()
            if main_rank:
                save_ckpt(it)
    if checkpoint_interval and iters % checkpoint_interval != 0 \
            and iters >= start_it and main_rank:
        save_ckpt(iters)
    if mlog is not None:
        mlog.close()
    if mesh is not None:
        check_replicas(ts, mesh)
    return ts, log
