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
grad-is-None behaviour).  :func:`apply_adam` updates in place, which
saves a copy of every parameter and moment per step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..config import OptimConfig
from ..device import resolve_device
from ..model.densify import DensifyStats, init_stats
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
    step: int                    # main optimizer step count
    step_c: int                  # cross-attention optimizer step count
    stats: DensifyStats


def init_train_state(scaffold: ScaffoldState,
                     cfg: ScaffoldConfig) -> TrainState:
    params = named_params(scaffold)
    return TrainState(
        scaffold=scaffold,
        m={k: torch.zeros_like(t.detach()) for k, t in params.items()},
        v={k: torch.zeros_like(t.detach()) for k, t in params.items()},
        step=0, step_c=0,
        stats=init_stats(cfg, scaffold.alive.device))


def train_state_from_numpy(ts: Any, cfg: ScaffoldConfig,
                           device="cuda") -> TrainState:
    """A JAX ``TrainState`` whose leaves are numpy arrays → the port's.

    ``ts.scaffold`` carries ``params``, ``mlps``, ``alive`` and
    ``xyz_max`` as :func:`~..model.scaffold.scaffold_from_numpy` takes
    them; ``ts.m`` and ``ts.v`` are ``(AnchorParams, MLPParams)`` trees of
    the same shapes; ``ts.step``, ``ts.step_c`` and ``ts.stats`` (the five
    ``DensifyStats`` fields) come across as they are.  The PRNG key is not
    carried: phase 1 draws no random numbers."""
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
    return TrainState(scaffold=scaffold, m=moments(ts.m), v=moments(ts.v),
                      step=int(ts.step), step_c=int(ts.step_c),
                      stats=stats)


@torch.no_grad()
def adam_update(param, grad, m, v, lr: float, step: int) -> None:
    """One torch-style Adam step (bias-corrected, ε after the square
    root), in place on ``param``, ``m`` and ``v``; the bias corrections
    are float32, as in the JAX package."""
    m.copy_(BETA1 * m + (1 - BETA1) * grad)
    v.copy_(BETA2 * v + (1 - BETA2) * grad * grad)
    t = F32(step)
    mhat = m / float(F32(1) - F32(BETA1) ** t)
    vhat = v / float(F32(1) - F32(BETA2) ** t)
    param.copy_(param - lr * mhat / (torch.sqrt(vhat) + EPS))


def apply_adam(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], m, v,
               lrs: Dict[str, float], step: int,
               masks: Dict[str, bool]) -> None:
    """Adam over every parameter whose group's mask is True, in place;
    the others keep their values and moments."""
    for name, p in params.items():
        group = group_of(name)
        if masks[group]:
            adam_update(p, grads[name], m[name], v[name], lrs[group], step)
