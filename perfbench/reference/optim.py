"""Adam with GScream's per-group learning rates (``training_setup`` and
``update_learning_rate`` of Scaffold-GS's ``gaussian_model.py``;
``get_expon_lr_func`` of ``utils/general_utils.py``): β = (0.9, 0.999),
ε = 1e-15 added after the square root, bias-corrected (torch.optim.Adam's
form).  The rotation, opacity and uncertainty arrays are frozen.

Phase 1 updates the anchors, offsets, features, scalings and the four
decoders.  Phase 2 (cross-attention) updates the anchors, offsets,
scalings and decoders with the main Adam, writes the attention's output
into the features, and updates the cross-attention with an Adam of its
own whose step count advances only on the steps it runs; a step whose
token draw found too few anchors updates nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
F32 = np.float32


def expon_lr(step, lr_init, lr_final, max_steps):
    """Log-linear from ``lr_init`` to ``lr_final`` over ``max_steps``, in
    float32 (no delay: GScream's schedules set no delay steps)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = np.clip(F32(step) / F32(max_steps), F32(0), F32(1))
    v = np.exp(F32(math.log(max(lr_init, 1e-30))) * (F32(1) - t)
               + F32(math.log(max(lr_final, 1e-30))) * t)
    return float(F32(v))


def group_of(name: str) -> str:
    return "/".join(name.split("/")[:2])


def learning_rates(step, o, spatial_lr_scale=1.0):
    """{group: lr} at ``step`` from the run's optimiser settings ``o``."""
    def sched(prefix, scale=1.0):
        return expon_lr(step, o[prefix + "_lr_init"] * scale,
                        o[prefix + "_lr_final"] * scale,
                        o[prefix + "_lr_max_steps"])
    return {
        "params/anchor": sched("position", spatial_lr_scale),
        "params/offset": sched("offset", spatial_lr_scale),
        "params/feat": float(F32(o["feature_lr"])),
        "params/scaling": float(F32(o["scaling_lr"])),
        "params/rotation": 0.0, "params/opacity": 0.0,
        "params/uncertainty": 0.0,
        "mlps/opacity": sched("mlp_opacity"),
        "mlps/uncertainty": sched("mlp_uncertainty"),
        "mlps/cov": sched("mlp_cov"), "mlps/color": sched("mlp_color"),
        "mlps/crossattn": sched("crossattn")}


PHASE1 = {"params/anchor", "params/offset", "params/feat", "params/scaling",
          "mlps/opacity", "mlps/uncertainty", "mlps/cov", "mlps/color"}
PHASE2_MAIN = PHASE1 - {"params/feat"}


def _bias(t):
    t = F32(t)
    return float(F32(1) - F32(BETA1) ** t), float(F32(1) - F32(BETA2) ** t)


@torch.no_grad()
def adam(params, grads, m, v, lrs, step, groups):
    """One Adam step, in place, over the leaves of ``groups``."""
    bc1, bc2 = _bias(step)
    for name, p in params.items():
        if group_of(name) not in groups:
            continue
        g = grads[name]
        m[name].mul_(BETA1).add_((1 - BETA1) * g)
        v[name].mul_(BETA2).add_((1 - BETA2) * g * g)
        p.sub_(lrs[group_of(name)] * (m[name] / bc1)
               / (torch.sqrt(v[name] / bc2) + EPS))
