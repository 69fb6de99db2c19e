"""The training cell runner: one ``train_scene`` call on the cell's scene.

Set-up builds the scene from the run's seed and hands it to
``train.loop.train_scene`` with the configuration's ``run_seed``, which
builds the model and optimiser state and runs its first iterations: the
first three are the ones the reference follows.  The loop's callback
marks each committed iteration; once the warm-up is over (the traffic's
least iteration count, one densification where the schedule has them,
and the capacity tier unchanged for ``settle`` iterations) it opens the
window, and closes it at the first callback ``seconds`` later.  An
untraced run keeps the card's busy time over the whole window
(:class:`harness.trace.DeviceBusy`, in sessions of ``SESSION_ITERATIONS``;
one short session in set-up starts the profiler's machinery); a traced
run leaves the window alone and then records ``trace_iterations`` more
iterations under the full profiler.
The loop is left by an exception from the callback; what it had launched
beyond the window is dropped.

The loop's ``TrainLog`` (per-iteration dispatch times, overflow re-runs,
densifications) is read from the calling frame of the callback, where
the loop keeps it: ``train_scene`` returns it only when it ends.

Two observers sit in the program's module namespaces during set-up and
leave before the window: one keeps the images that ``loss_terms`` is
handed until iteration 1 commits (the one whose loss the loop committed
is the first iteration's render), the other keeps the input and the
outcome of the first densification.
"""
from __future__ import annotations

import gc
import logging
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from reference import densify as ref_densify
from reference import model as ref_model
from reference import step as ref_step

from . import compare, scene as scene_mod


class WindowClosed(Exception):
    pass


# iterations per profiler session in the measured window: some 2,500
# device events an iteration, well inside the profiler's bounded buffers
SESSION_ITERATIONS = 40


def _train_log(frame):
    """The loop's ``TrainLog``: the ``log`` of the nearest calling frame
    that holds one (the loop's ``commit``)."""
    while frame is not None:
        log = frame.f_locals.get("log")
        if hasattr(log, "iter_times"):
            return log
        frame = frame.f_back
    return None


def _norms(tensors, scale=1.0):
    return {k: float(torch.linalg.vector_norm(t.detach().double())) * scale
            for k, t in tensors.items()}


STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_grad_accum",
               "offset_denom")


def first_densify(schedule):
    """The first iteration that densifies under ``schedule``, or None."""
    every = schedule["update_interval"]
    it = (schedule["update_from"] // every + 1) * every
    return it if it < schedule["update_until"] else None


def gathers_stats(schedule):
    """Whether the first iterations gather densification statistics."""
    return schedule["start_stat"] < 1 < schedule["update_until"]


class Observers:
    """The first iteration's images and the first densification, taken
    where the program makes them; each observer puts the program's own
    function back once it has what it needs."""

    def __init__(self):
        import gscream_tpu_torch.train.loop as loop
        import gscream_tpu_torch.train.step as step
        self.saved = [(step, "loss_terms", step.loss_terms),
                      (loop, "adjust_anchors", loop.adjust_anchors)]
        self.images, self.image1, self.densify = [], None, None
        inner_loss, inner_dens = step.loss_terms, loop.adjust_anchors

        def loss_terms(out, *a, **k):
            loss, l1 = inner_loss(out, *a, **k)
            self.images.append((loss.detach(), out.color.detach().clone(),
                                out.depth.detach().clone()))
            return loss, l1

        def adjust_anchors(state, stats, *a, **k):
            loop.adjust_anchors = inner_dens
            before = (state.alive.clone(),
                      {f: getattr(state.params, f).clone()
                       for f in ("anchor", "offset", "scaling", "feat")},
                      {f: getattr(stats, f).clone() for f in STAT_FIELDS})
            out = inner_dens(state, stats, *a, **k)
            after = out[0]
            self.densify = before + (after.alive.clone(),
                                     after.params.anchor.clone(),
                                     after.params.feat.clone())
            return out
        step.loss_terms = loss_terms
        loop.adjust_anchors = adjust_anchors

    def first_committed(self, loss: float):
        """At iteration 1's commit: its image, the last one handed to
        ``loss_terms`` with the committed loss (a re-run at a larger tier
        follows the truncated run)."""
        step, name, inner = self.saved[0]
        setattr(step, name, inner)
        match = [x for x in self.images if float(x[0]) == loss]
        if match:
            self.image1 = match[-1][1:]
        self.images = []

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def program_run(cfg, tr):
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    m = cfg["model"]
    model = ModelConfig(
        feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
        voxel_size=m["voxel_size"], update_depth=m["update_depth"],
        update_init_factor=m["update_init_factor"],
        update_hierachy_factor=m["update_hierachy_factor"],
        anchor_capacity=m["anchor_capacity"])
    optim = dict(cfg["optim"], **tr["schedule"])
    return RunConfig(model=model, optim=OptimConfig(**optim),
                     seed=scene_mod.run_seed(cfg))


def build_inputs(cfg, seed, dev, tmp):
    """The scene: camera poses, the anchors' PLY, the targets."""
    sc = scene_mod.cameras(cfg)
    cols = scene_mod.anchor_columns(cfg, seed, dev)
    ply = os.path.join(tmp, "anchors.ply")
    ref_model.write_anchor_ply(ply, cols)
    tg, ref_img, ref_depth = scene_mod.targets(sc, seed, dev)
    points = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    return sc, ply, tg, ref_img, ref_depth, points


def run(cell, seed: int, seconds: float, trace: bool, dev, tmp, t_start,
        capture_cls=None, steps_only=False, busy_cls=None):
    """One run; with ``steps_only`` the loop runs the three iterations the
    reference follows and no window (the readings of ``readings.py``).
    ``busy_cls`` (:class:`harness.trace.DeviceBusy` on a card) keeps
    an untraced window's busy time."""
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.model.scaffold import (AnchorParams,
                                                  ScaffoldConfig,
                                                  ScaffoldState, init_mlps)
    from gscream_tpu_torch.train.loop import train_scene
    from gscream_tpu_torch.train.state import named_params
    from gscream_tpu_torch.train.step import aux_values

    cfg, tr = cell["config"], cell["traffic"]
    m = cfg["model"]
    sc, ply, tg, ref_img, ref_depth, points = build_inputs(cfg, seed, dev,
                                                           tmp)
    views = [SimpleNamespace(
        camera=make_camera(p.R, p.T, sc.fov_x, sc.fov_y, sc.width,
                           sc.height, device=dev),
        image=img, mask=mask, depth=mono, name=f"train_{i:03d}")
        for i, (p, (img, mask, mono)) in enumerate(zip(sc.train, tg))]
    ref_index = 0
    run_cfg = program_run(cfg, tr)
    rseed = scene_mod.run_seed(cfg)

    # the program's state before step 1: the anchors both read from the
    # PLY, and the decoders as the program initialises them from the seed
    anchors0, alive0 = ref_model.anchors_from_ply(
        ref_model.read_anchor_ply(ply), m["anchor_capacity"],
        m["n_offsets"], dev)
    scfg = ScaffoldConfig(feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
                          voxel_size=m["voxel_size"],
                          capacity=m["anchor_capacity"],
                          attn_heads=cfg["optim"]["attn_head_num"],
                          attn_head_dim=cfg["optim"]["attn_head_dim"])
    mlps0 = init_mlps(scfg, torch.Generator().manual_seed(rseed), dev)
    p0 = {k: v.detach().clone() for k, v in named_params(ScaffoldState(
        params=AnchorParams(*(anchors0["params/" + f]
                              for f in AnchorParams._fields)),
        mlps=mlps0, alive=alive0, xyz_max=None)).items()}
    del mlps0

    st = SimpleNamespace(phase="warm", log=None, t0=None, it0=None, t1=None,
                         it1=None, losses={}, g1=None, d3=None, stats3=None,
                         after=None,
                         peak=None, capture=None, trace_t=(0.0, 0.0),
                         trace_its=(0, 0), setup_s=None, busy_at=None)
    busy = (busy_cls() if busy_cls is not None and not trace
            and not steps_only else None)
    settle = tr["settle_iterations"]
    warm_min = tr["warmup_iterations"]
    dens_it = first_densify(tr["schedule"])
    obs = Observers()

    def callback(it, ts, aux):
        now = time.perf_counter()
        if st.log is None:
            st.log = _train_log(sys._getframe(1))
        if it <= 3:
            st.losses[it] = aux_values(aux)[:2]
            if it == 1:
                st.g1 = _norms(ts.m, 1.0 / 0.1)
                obs.first_committed(st.losses[1][0])
            if it == 3:
                st.d3 = _norms({k: t - p0[k] for k, t in
                                named_params(ts.scaffold).items()})
                if gathers_stats(tr["schedule"]):
                    st.stats3 = {f: getattr(ts.stats, f).clone()
                                 for f in STAT_FIELDS}
        if steps_only:
            return
        if st.phase == "warm":
            if busy is not None and it > 3 and st.busy_at is None:
                busy.start()
                st.busy_at = it
            elif busy is not None and st.busy_at is not None and \
                    not busy.sessions:
                busy.stop(it - st.busy_at)
            ev = st.log.events if st.log is not None else []
            last_over = max([e["it"] for e in ev
                             if e["event"] == "overflow"] + [0])
            densified = any(e["event"] == "densify" for e in ev)
            if it >= tr["warmup_max"] or (
                    it >= warm_min and it - last_over >= settle
                    and (densified or dens_it is None)):
                st.phase, st.t0, st.it0 = "window", now, it
                st.setup_s = now - t_start
                if busy is not None:
                    if busy.prof is not None:
                        busy.stop()
                    busy.reset()
                    busy.start()
                    st.busy_at = it
        elif st.phase == "window" and now - st.t0 >= seconds:
            st.t1, st.it1 = now, it
            if busy is not None:
                busy.stop(it - st.busy_at)
            if dev.type == "cuda":
                st.peak = torch.cuda.max_memory_allocated(dev)
            if not trace:
                st.after = ts
                raise WindowClosed
            st.phase = "trace"
            st.capture = capture_cls()
            st.trace_t = (time.perf_counter(), 0.0)
            st.trace_its = (it, 0)
            st.capture.start()
        elif st.phase == "window" and busy is not None and \
                it - st.busy_at >= SESSION_ITERATIONS:
            busy.stop(it - st.busy_at)
            busy.start()
            st.busy_at = it
        elif st.phase == "trace" and it - st.trace_its[0] >= tr[
                "trace_iterations"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            st.trace_t = (st.trace_t[0], time.perf_counter())
            st.capture.stop()
            st.trace_its = (st.trace_its[0], it)
            st.after = ts
            raise WindowClosed

    logger = logging.getLogger("perfbench.train_scene")
    logger.propagate = False
    logger.addHandler(logging.NullHandler())
    try:
        train_scene(views, ref_index, points, run_cfg,
                    out_dir=os.path.join(tmp, "out"),
                    ref_image=ref_img, ref_depth=ref_depth,
                    capacity=cfg["scene"]["start_capacity"],
                    iterations=(dens_it or 3) if steps_only else 10 ** 9,
                    callback=callback, logger=logger,
                    pretrained_ply=ply, device=dev)
    except WindowClosed:
        pass
    finally:
        obs.close()
        if busy is not None and busy.prof is not None:
            busy.prof.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    log = st.log
    prog = {"loss": [st.losses[i][0] for i in (1, 2, 3)],
            "l1": [st.losses[i][1] for i in (1, 2, 3)], "g1": st.g1,
            "d3": st.d3, "image1": obs.image1, "stats3": st.stats3}
    if steps_only:
        st.log = log = None
        del views
        gc.collect()
        return SimpleNamespace(kind="train", prog=prog, numbers=None,
                               densify=obs.densify, densify_it=dens_it,
                               inputs=(ply, sc, tg, ref_img, ref_depth))
    w_its = st.it1 - st.it0
    res = SimpleNamespace(
        kind="train", setup_s=st.setup_s, window_s=st.t1 - st.t0,
        units=w_its, rate=w_its / (st.t1 - st.t0), peak=st.peak,
        attempted=w_its, failed=0,
        dispatch_s=log.iter_times[st.it0:st.it1],
        overflows=sum(1 for e in log.events if e["event"] == "overflow"
                      and st.it0 < e["it"] <= st.it1),
        capture=st.capture, trace_t=st.trace_t, trace_its=st.trace_its,
        trace_units=st.trace_its[1] - st.trace_its[0],
        phase2_units=sum(1 for s in log.steps[st.trace_its[0]:
                                              st.trace_its[1]]
                         if s["use_cross"]),
        busy_s=busy.seconds if busy is not None else None,
        busy_sessions=busy.sessions if busy is not None else [],
        work=None, numbers=None)
    if trace:
        its = range(st.trace_its[0] + 1, st.trace_its[1] + 1)
        res.work = trace_work(cell, st.after, views, sc,
                              [log.steps[i - 1] for i in its], dev)
    # free the program's state before the reference runs
    st.after = st.log = log = None
    del views
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res.numbers = numbers(cell, prog, obs.densify, dens_it,
                          (ply, sc, tg, ref_img, ref_depth), dev)
    return res


def numbers(cell, prog, dens, dens_it, inputs, dev):
    """The comparison's numbers: the first three iterations against the
    reference's, and the first densification against the reference's on
    the same input."""
    out = compare.train_numbers(prog, reference_steps(cell, *inputs, dev))
    if dens_it is not None:
        out["densify_gap"] = (reference_densify(cell, dens, dens_it, dev)
                              if dens is not None else 1.0)
    return out


def reference_densify(cell, dens, it, dev):
    """The reference's densification at iteration ``it`` on the program's
    state and statistics just before it, held against the program's."""
    cfg, tr = cell["config"], cell["traffic"]
    alive, params, stats, after_alive, after_anchor, after_feat = dens
    m = cfg["model"]
    o = dict(cfg["optim"], **tr["schedule"])
    draws = ref_densify.keep_draws(scene_mod.run_seed(cfg), it,
                                   alive.shape[0] * m["n_offsets"],
                                   m["update_depth"], dev)
    new_xyz, new_feat, pruned = ref_densify.adjust_anchors(
        params, alive, stats, draws, m, o)
    return compare.densify_gap(alive, after_alive, after_anchor, after_feat,
                               new_xyz, new_feat, pruned)


def reference_views(sc, tg, ref_img, ref_depth, dev):
    out = []
    for i, (p, (img, mask, mono)) in enumerate(zip(sc.train, tg)):
        if i == 0:
            img, mono = ref_img, ref_depth
        out.append(ref_step.View(p.R, p.T, sc.fov_x, sc.fov_y, sc.width,
                                 sc.height, dev, image=img, mask=mask,
                                 mono=mono,
                                 mask_np=mask[0].cpu().numpy()))
    return out


def reference_steps(cell, ply, sc, tg, ref_img, ref_depth, dev,
                    n_steps=3):
    """The reference's first ``n_steps`` iterations from the same inputs:
    losses and their L1 colour terms, the first gradient's norm per leaf
    as Adam's first moment holds it, the first iteration's image and
    depth, and after the last each leaf's change and, where the schedule
    gathers them, the densification statistics."""
    cfg, tr = cell["config"], cell["traffic"]
    m = cfg["model"]
    o = dict(cfg["optim"], **tr["schedule"])
    params, alive = ref_model.anchors_from_ply(
        ref_model.read_anchor_ply(ply), m["anchor_capacity"],
        m["n_offsets"], dev)
    seed = scene_mod.run_seed(cfg)
    params.update(ref_model.init_mlps(seed, m["feat_dim"], m["n_offsets"],
                                      o["attn_head_num"], o["attn_head_dim"],
                                      dev))
    trainer = ref_step.Trainer(params, alive, {"model": m, "optim": o},
                               seed, dev)
    views = reference_views(sc, tg, ref_img, ref_depth, dev)
    losses, l1s, g1, image1 = [], [], None, None
    for i in range(n_steps):
        loss, l1, _ = trainer.iteration(views, 0)
        losses.append(loss)
        l1s.append(l1)
        if i == 0:
            g1 = _norms(trainer.m, 1.0 / 0.1)
            image1 = trainer.last_render
    d3 = _norms({k: trainer.p[k] - params[k] for k in params})
    return {"loss": losses, "l1": l1s, "g1": g1, "d3": d3, "image1": image1,
            "stats3": trainer.stats if gathers_stats(o) else None}


def trace_work(cell, ts, views, sc, steps, dev):
    """The work each traced iteration's view asks of the state the traced
    stretch ended with: the blended work, the visible anchors and, in
    phase 2, the tokens; one entry per iteration, so that its mean is
    taken over the iterations whose launches the trace averages."""
    from gscream_tpu_torch.train.state import named_params

    from reference import attention, blend, draws
    cfg, tr = cell["config"], cell["traffic"]
    m = cfg["model"]
    o = dict(cfg["optim"], **tr["schedule"])
    p = {k: t.detach() for k, t in named_params(ts.scaffold).items()}
    alive = ts.scaffold.alive
    rviews = reference_views(sc, [(v.image, v.mask, v.depth) for v in views],
                             views[0].image, views[0].depth, dev)
    per_view, out = {}, []
    for s in steps:
        v = rviews[s["view"]]
        with torch.no_grad():
            if s["view"] not in per_view:
                g, bins = ref_step.splat(p, alive, v, m["n_offsets"])[:2]
                visible, pos = ref_step.prefilter(p, alive, v)
                per_view[s["view"]] = (blend.blended_work(g, bins), visible,
                                       pos)
                del g, bins
            w, visible, pos = per_view[s["view"]]
            w = dict(w, anchors=int(visible.sum()), tokens=0)
            if s["use_cross"]:
                _, pt = draws.iteration_draws(
                    scene_mod.run_seed(cfg), s["it"], v.mask_np, s["is_ref"],
                    True, v.height,
                    v.width, small=o["sampling_2D_small_ratio"])
                C = alive.shape[0]
                tok = attention.tokens(
                    torch.zeros(C, device=dev), torch.zeros(C, device=dev),
                    pos, visible, alive, v.mask[0],
                    torch.as_tensor(pt, device=dev), v.width, v.height,
                    min(o["crossattn_max_tokens"], C))
                w["tokens"] = int(tok[2].sum())
        out.append(w)
    return out
