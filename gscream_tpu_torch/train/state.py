"""Train state: Adam with per-group exponential LR schedules (counterpart
of ``gscream_tpu/train/state.py``).

The reference optimizer setup (``training_setup``,
gaussian_model.py:348-458): one Adam (ε=1e-15 after the square root,
β=(0.9, 0.999), bias-corrected — torch.optim.Adam's form) over the anchor
arrays and the decoder MLPs with per-group learning rates from
``get_expon_lr_func`` (utils/general_utils.py:104-137).

The moments are plain tensors beside the parameters, keyed by the
parameter's path in the JAX ``(AnchorParams, MLPParams)`` tree
(:func:`named_params`), not hidden in a ``torch.optim.Adam``:
densification edits them per anchor, and the parity tests compare them.
A group whose mask is False keeps its parameters *and* moments (torch's
grad-is-None behaviour); a group whose mask is a device flag is updated
where the flag is True and kept where it is False (JAX's traced mask),
so that a step can gate its writes without reading the flag to the host.
:func:`apply_adam` updates in place, which saves a copy of every
parameter and moment per step; the pipelined loop keeps the states it
may have to go back to in a :class:`StatePool`.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import OptimConfig
from ..device import resolve_device
from ..model.densify import PER_ANCHOR_STATS, DensifyStats, init_stats
from ..model.scaffold import (AnchorParams, ScaffoldConfig, ScaffoldState,
                              scaffold_from_numpy)

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15   # gaussian_model.py:409

F32 = np.float32


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """utils/general_utils.py:104-137: log-linear interpolation with an
    optional sine delay ramp, zero when both ends are zero; evaluated in
    float32 as the JAX package evaluates it."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = F32(step)
    if lr_delay_steps > 0:
        delay = F32(lr_delay_mult) + F32(1 - lr_delay_mult) * np.sin(
            F32(0.5 * math.pi) * np.clip(step / F32(lr_delay_steps),
                                         F32(0), F32(1)))
    else:
        delay = F32(1.0)
    t = np.clip(step / F32(max_steps), F32(0), F32(1))
    log_lerp = np.exp(F32(math.log(max(lr_init, 1e-30))) * (F32(1) - t)
                      + F32(math.log(max(lr_final, 1e-30))) * t)
    return float(F32(delay * log_lerp))


def lr_tree(step, opt: OptimConfig, spatial_lr_scale: float
            ) -> Dict[str, float]:
    """Per-group learning rates (update_learning_rate,
    gaussian_model.py:460-499), keyed ``params/<field>`` and
    ``mlps/<decoder>``."""
    sls = spatial_lr_scale

    def sched(prefix, scale=1.0):
        return expon_lr(
            step, getattr(opt, prefix + "_lr_init") * scale,
            getattr(opt, prefix + "_lr_final") * scale,
            lr_delay_mult=getattr(opt, prefix + "_lr_delay_mult"),
            max_steps=getattr(opt, prefix + "_lr_max_steps"))
    return {
        "params/anchor": sched("position", sls),
        "params/offset": sched("offset", sls),
        "params/feat": float(F32(opt.feature_lr)),
        "params/scaling": float(F32(opt.scaling_lr)),
        "params/rotation": 0.0,       # frozen (gaussian_model.py:342)
        "params/opacity": 0.0,        # frozen
        "params/uncertainty": 0.0,    # frozen
        "mlps/opacity": sched("mlp_opacity"),
        "mlps/uncertainty": sched("mlp_uncertainty"),
        "mlps/cov": sched("mlp_cov"),
        "mlps/color": sched("mlp_color"),
        "mlps/crossattn": sched("crossattn"),
        "mlps/feat_bank": sched("mlp_featurebank"),
    }


def named_params(scaffold: ScaffoldState) -> Dict[str, torch.Tensor]:
    """Every trainable array, keyed by its path in the JAX tree:
    ``params/<field>``, ``mlps/<decoder>/<layer>/<w|b>`` (``w`` in
    ``nn.Linear``'s (fan_out, fan_in) layout) and ``mlps/crossattn/<name>``.
    The values are the scaffold's own tensors, not copies."""
    out = {f"params/{f}": getattr(scaffold.params, f)
           for f in AnchorParams._fields}
    for name, mlp in scaffold.mlps.decoders():
        for i, lin in enumerate(mlp.layers()):
            out[f"mlps/{name}/{i}/w"] = lin.weight
            out[f"mlps/{name}/{i}/b"] = lin.bias
    for name, t in scaffold.mlps.crossattn.arrays():
        out[f"mlps/crossattn/{name}"] = t
    return out


def group_of(name: str) -> str:
    """``params/<field>`` or ``mlps/<decoder>``: the optimizer group."""
    return "/".join(name.split("/")[:2])


class TrainState(NamedTuple):
    scaffold: ScaffoldState
    m: Dict[str, torch.Tensor]   # Adam first moments, by named_params key
    v: Dict[str, torch.Tensor]   # Adam second moments
    step: int                    # main optimizer step count (host)
    step_c: torch.Tensor         # () int32 cross-attention optimizer step
                                 # count, on the state's device (JAX's)
    stats: DensifyStats
    # the phase-2 token draws (the JAX state's PRNG key), on the state's
    # device; checkpoints carry its state
    generator: torch.Generator = None
    # the anchor span: a step runs over the first ``span`` anchor slots
    # (:func:`anchor_span`; set by the constructors below)
    span: Optional[int] = None


def capacity_tier(n: int) -> int:
    """Smallest fixed instance capacity holding ``n``, on a 12.5%
    (pow2/8) granularity grid of multiples of 1024 (JAX loop.py:36-48)."""
    n = max(int(n), 1)
    g = max(1024, 1 << max(int(n - 1).bit_length() - 3, 0))
    return -(-n // g) * g


@torch.no_grad()
def anchor_span(ts: TrainState) -> int:
    """The anchor span of ``ts``: the rows a step has to run over.

    ``h`` is one past the highest slot that is alive or holds a nonzero
    ``params/*`` first or second moment; the span is ``capacity_tier(h)``,
    at most the capacity.  A slot at or beyond it is dead and its moments
    are zero, so a step over the whole capacity gives it a zero gradient,
    adds nothing to its statistics and leaves its parameters and moments
    as they are (Adam's update of a zero moment is 0): the step over the
    first ``span`` rows is the same step.  One host read."""
    alive = ts.scaffold.alive
    C = alive.shape[0]
    used = alive.clone()
    for f in AnchorParams._fields:
        for mom in (ts.m, ts.v):
            used |= (mom[f"params/{f}"].reshape(C, -1) != 0).any(dim=1)
    slot = torch.arange(1, C + 1, device=alive.device)
    h = int(torch.max(torch.where(used, slot, 0)))
    return min(C, capacity_tier(h))


def anchor_rows(ts: TrainState, rows: int) -> TrainState:
    """``ts`` with every per-anchor tensor cut to its first ``rows`` rows:
    the parameters, ``alive``, the ``params/*`` moments and the
    statistics, as views of the same storage (an in-place write to them
    writes ``ts``'s tensors).  The decoders, the cross-attention arrays
    and their moments stay whole."""
    sc, st = ts.scaffold, ts.stats

    def cut(moments):
        return {k: t[:rows] if k.startswith("params/") else t
                for k, t in moments.items()}
    return ts._replace(
        scaffold=sc._replace(
            params=type(sc.params)(*(t[:rows] for t in sc.params)),
            alive=sc.alive[:rows]),
        m=cut(ts.m), v=cut(ts.v),
        stats=st._replace(**{f: getattr(st, f)[:rows]
                             for f in PER_ANCHOR_STATS}))


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def init_train_state(scaffold: ScaffoldState, cfg: ScaffoldConfig,
                     seed: int = 0) -> TrainState:
    """Zero moments and statistics at step 0; the token generator seeded
    with ``seed`` (the JAX loop keys its state with ``seed + 1``); the
    span of the alive slots (:func:`anchor_span`)."""
    params = named_params(scaffold)
    dev = scaffold.alive.device
    ts = TrainState(
        scaffold=scaffold,
        m={k: torch.zeros_like(t.detach()) for k, t in params.items()},
        v={k: torch.zeros_like(t.detach()) for k, t in params.items()},
        step=0, step_c=torch.zeros((), dtype=torch.int32, device=dev),
        stats=init_stats(cfg, dev),
        generator=make_generator(seed, dev))
    return ts._replace(span=anchor_span(ts))


def train_state_from_numpy(ts: Any, cfg: ScaffoldConfig,
                           device="cuda") -> TrainState:
    """A JAX ``TrainState`` whose leaves are numpy arrays → the port's.

    ``ts.scaffold`` carries ``params``, ``mlps``, ``alive`` and
    ``xyz_max`` as :func:`~..model.scaffold.scaffold_from_numpy` takes
    them; ``ts.m`` and ``ts.v`` are ``(AnchorParams, MLPParams)`` trees of
    the same shapes, the cross-attention moments among them; ``ts.step``,
    ``ts.step_c`` and ``ts.stats`` (the five ``DensifyStats`` fields) come
    across as they are; the anchor span is computed.  The PRNG key is not carried (a JAX key cannot
    seed a torch.Generator to the same draws): the state gets a generator
    seeded with 0, and the parity tests feed JAX's draws in place of the
    port's (``train.step.token_priorities``)."""
    dev = resolve_device(device)
    sc = ts.scaffold
    scaffold = scaffold_from_numpy(sc.params, sc.mlps, sc.alive, cfg,
                                   sc.xyz_max, device=dev)

    def moments(tree):
        st = scaffold_from_numpy(tree[0], tree[1], sc.alive, cfg, sc.xyz_max,
                                 device=dev)
        return {k: t.detach() for k, t in named_params(st).items()}

    stats = DensifyStats(*(torch.as_tensor(np.array(x)).to(dev)
                           for x in ts.stats))
    out = TrainState(scaffold=scaffold, m=moments(ts.m), v=moments(ts.v),
                     step=int(ts.step),
                     step_c=torch.tensor(int(ts.step_c), dtype=torch.int32,
                                         device=dev),
                     stats=stats, generator=make_generator(0, dev))
    return out._replace(span=anchor_span(out))


def bias_correction(step: int) -> Tuple[float, float]:
    """Adam's bias corrections (1 − β1^t, 1 − β2^t) at step ``t``, in
    float32 as the JAX package takes them."""
    t = F32(step)
    return (float(F32(1) - F32(BETA1) ** t), float(F32(1) - F32(BETA2) ** t))


_BIAS_TABLES: Dict[str, torch.Tensor] = {}


def device_bias(step: torch.Tensor, bound: int):
    """The bias corrections at a device step count ``step`` (a () int
    tensor no larger than ``bound``) without a host read: looked up in a
    table of :func:`bias_correction` values kept on the device, grown
    (by a non-blocking copy) past ``bound``.  On the card the table holds
    the reciprocals: a CUDA division by a Python scalar multiplies by the
    scalar's float32 reciprocal, and :func:`adam_update` multiplies by
    these, so either form of the step count gives the same bits."""
    dev = step.device
    key = str(dev)
    table = _BIAS_TABLES.get(key)
    if table is None or table.shape[1] <= bound:
        size = max(4096, 2 * (bound + 1))
        host = torch.tensor([bias_correction(t) for t in range(size)],
                            dtype=torch.float32).T.contiguous()
        if dev.type == "cuda":
            host = (1.0 / host).pin_memory()
        table = host.to(dev, non_blocking=True)
        _BIAS_TABLES[key] = table
    pick = torch.index_select(table, 1, step.reshape(1).long())
    return pick[0], pick[1]


def _unbias(x: torch.Tensor, c) -> torch.Tensor:
    """``x`` over its bias correction ``c``: a float, or one of
    :func:`device_bias`'s tensors (a reciprocal on the card)."""
    if isinstance(c, torch.Tensor) and c.is_cuda:
        return x * c
    return x / c


@torch.no_grad()
def adam_update(param, grad, m, v, lr: float, step, ok=None) -> None:
    """One torch-style Adam step (bias-corrected, ε after the square
    root), in place on ``param``, ``m`` and ``v``; the bias corrections
    are float32, as in the JAX package.  ``step`` is the step count or
    its two bias corrections (:func:`device_bias`).  With ``ok`` (a ()
    bool tensor) the three are written where it is True and kept where it
    is False; where it is True the values are the unmasked form's, bit
    for bit."""
    bc1, bc2 = step if isinstance(step, tuple) else bias_correction(step)
    m_new = BETA1 * m + (1 - BETA1) * grad
    v_new = BETA2 * v + (1 - BETA2) * grad * grad
    p_new = param - lr * _unbias(m_new, bc1) / (
        torch.sqrt(_unbias(v_new, bc2)) + EPS)
    if ok is None:
        m.copy_(m_new)
        v.copy_(v_new)
        param.copy_(p_new)
    else:
        torch.where(ok, m_new, m, out=m)
        torch.where(ok, v_new, v, out=v)
        torch.where(ok, p_new, param, out=param)


def apply_adam(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], m, v,
               lrs: Dict[str, float], step,
               masks: Dict[str, Any], ok=None) -> None:
    """Adam over every parameter whose group's mask is not False, in
    place; the others keep their values and moments.  A mask may be a ()
    bool device tensor, and ``ok`` gates every group as one more such
    flag (:func:`adam_update`).  ``step`` as in :func:`adam_update`."""
    if not isinstance(step, tuple):
        step = bias_correction(step)
    gates: Dict[str, Any] = {}
    for name, p in params.items():
        group = group_of(name)
        if group not in gates:
            flag = masks[group]
            if not isinstance(flag, torch.Tensor):
                flag = ok if flag else False
            elif ok is not None:
                flag = flag & ok
            gates[group] = flag
        if gates[group] is False:
            continue
        adam_update(p, grads[name], m[name], v[name], lrs[group], step,
                    gates[group])


def written_tensors(ts: TrainState) -> List[torch.Tensor]:
    """The tensors a step writes in place: every parameter, then its
    first and second moments (``named_params`` order)."""
    params = named_params(ts.scaffold)
    return (list(params.values()) + [ts.m[k] for k in params]
            + [ts.v[k] for k in params])


class StatePool:
    """Copies of a state's in-place tensors, for the pipelined loop.

    A step writes the parameters and moments in place; everything else
    it returns anew (statistics, step counts), and the generator's state
    is host data.  So the state before a step is kept whole by a
    :meth:`snapshot` taken as the step is launched: one
    ``torch._foreach_copy_`` of the written tensors into a slot (ordered
    on the stream after every step launched before), plus the
    generator's state.  A slot goes back to the pool with :meth:`release`
    and is reused by a later snapshot, whose copy the stream orders after
    every read of the slot enqueued before it."""

    def __init__(self):
        self._free: List[TrainState] = []

    def snapshot(self, ts: TrainState) -> TrainState:
        """``ts`` with its written tensors and its generator copied."""
        if self._free:
            slot = self._free.pop()
        else:
            with torch.no_grad():
                sc = ts.scaffold
                slot = ts._replace(
                    scaffold=sc._replace(
                        params=type(sc.params)(*(torch.empty_like(t)
                                                 for t in sc.params)),
                        mlps=copy.deepcopy(sc.mlps)),
                    m={k: torch.empty_like(t) for k, t in ts.m.items()},
                    v={k: torch.empty_like(t) for k, t in ts.v.items()},
                    generator=torch.Generator(ts.generator.device))
        with torch.no_grad():
            torch._foreach_copy_(written_tensors(slot), written_tensors(ts))
        slot.generator.set_state(ts.generator.get_state())
        return ts._replace(
            scaffold=ts.scaffold._replace(params=slot.scaffold.params,
                                          mlps=slot.scaffold.mlps),
            m=slot.m, v=slot.v, generator=slot.generator)

    def restore(self, snap: TrainState, live: TrainState) -> TrainState:
        """The live tensors (and generator) of ``live`` set back to
        ``snap``'s: returns ``snap`` over the live tensors."""
        with torch.no_grad():
            torch._foreach_copy_(written_tensors(live), written_tensors(snap))
        live.generator.set_state(snap.generator.get_state())
        return snap._replace(
            scaffold=snap.scaffold._replace(params=live.scaffold.params,
                                            mlps=live.scaffold.mlps),
            m=live.m, v=live.v, generator=live.generator)

    def release(self, snap: TrainState) -> None:
        self._free.append(snap)
