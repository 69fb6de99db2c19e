"""Scaffold-GS anchor model (counterpart of ``gscream_tpu/model/scaffold.py``).

* anchor arrays are padded to a fixed ``capacity`` with an ``alive`` mask;
* the four 2-layer MLP decoders (opacity/tanh, uncertainty/sigmoid, cov,
  color/sigmoid — gaussian_model.py:118-144) are ``nn.Linear`` pairs in an
  ``nn.Module``; their products stay ``nn.Linear``/``torch.matmul``, as the
  JAX package leaves them to XLA;
* activations: scaling=exp, opacity/uncertainty=sigmoid,
  rotation=normalize (gaussian_model.py:36-54).

Parameter shapes match the reference: anchor (C,3) · offset (C,k,3) ·
feat (C,F) · scaling (C,6) log-space · rotation (C,4) · opacity and
uncertainty (C,1) logits.

The JAX package stores a linear layer's weight as ``(fan_in, fan_out)``;
``nn.Linear.weight`` is ``(fan_out, fan_in)``.  :func:`scaffold_from_numpy`
and ``model/io.py`` transpose at that boundary and nowhere else.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import device_constant, resolve_device
from ..ops.attention import FIELDS as CROSSATTN_FIELDS
from ..ops.attention import attn_shapes, init_bidirectional_attn
from ..ops.knn import mean_knn_sq_dist


def inverse_sigmoid(x):
    return float(np.log(x / (1.0 - x)))


class ScaffoldConfig(NamedTuple):
    feat_dim: int = 32          # arguments/__init__.py:49
    n_offsets: int = 10         # scripts/run.py config (arguments :50)
    voxel_size: float = 0.001   # arguments/__init__.py:51
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    capacity: int = 2 ** 17     # fixed anchor capacity (padded)
    attn_heads: int = 8         # crossattn heads (run.py --attn_head_num)
    attn_head_dim: int = 64
    use_feat_bank: bool = False  # view-adaptive multi-res feature mix
                                 # (gaussian_model.py:109-115, default off)


class AnchorParams(NamedTuple):
    """Per-anchor tensors, capacity-padded."""
    anchor: torch.Tensor       # (C,3)
    offset: torch.Tensor       # (C,k,3)
    feat: torch.Tensor         # (C,F)
    scaling: torch.Tensor      # (C,6) log-space
    rotation: torch.Tensor     # (C,4)
    opacity: torch.Tensor      # (C,1) logit
    uncertainty: torch.Tensor  # (C,1) logit


class MLP(nn.Module):
    """Two ``nn.Linear`` layers with a ReLU between, as the reference
    decoders; ``final_act`` is applied by the caller."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.fc0 = nn.Linear(d_in, d_hidden)
        self.fc1 = nn.Linear(d_hidden, d_out)

    def layers(self):
        return (self.fc0, self.fc1)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


class CrossAttnArrays(nn.Module):
    """The JAX ``BidirAttnParams`` arrays as plain buffers, JAX layout
    (``(fan_in, fan_out)`` weights).  Phase 2 hands detached copies of
    them to autograd as leaves (``train/step.py``) and its own Adam
    updates the buffers in place."""

    def __init__(self, cfg: ScaffoldConfig):
        super().__init__()
        shapes = attn_shapes(cfg.feat_dim, cfg.attn_heads,
                             cfg.attn_head_dim)
        for name in CROSSATTN_FIELDS:
            self.register_buffer(name, torch.zeros(shapes[name]))

    def arrays(self):
        """(name, tensor) in the JAX field order."""
        return [(name, getattr(self, name)) for name in CROSSATTN_FIELDS]


class ScaffoldMLPs(nn.Module):
    """The decoder MLPs plus the cross-attention arrays.

    ``crossattn`` holds the JAX ``BidirAttnParams`` arrays as plain
    tensors in their JAX layout, so the model IO round trip keeps them.
    """

    def __init__(self, cfg: ScaffoldConfig):
        super().__init__()
        F, k = cfg.feat_dim, cfg.n_offsets
        d_in = F + 3 + 1
        self.opacity = MLP(d_in, F, k)
        self.uncertainty = MLP(d_in, F, k)
        self.cov = MLP(d_in, F, 7 * k)
        self.color = MLP(d_in, F, 3 * k)
        self.feat_bank = MLP(3 + 1, F, 3) if cfg.use_feat_bank else None
        self.crossattn = CrossAttnArrays(cfg)

    def decoders(self):
        """(name, MLP) in the JAX ``MLPParams`` field order."""
        out = [("opacity", self.opacity), ("uncertainty", self.uncertainty),
               ("cov", self.cov), ("color", self.color)]
        if self.feat_bank is not None:
            out.append(("feat_bank", self.feat_bank))
        return out


class ScaffoldState(NamedTuple):
    params: AnchorParams
    mlps: ScaffoldMLPs
    alive: torch.Tensor        # (C,) bool
    xyz_max: torch.Tensor      # (3,) from the init cloud


def voxelize(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Unique voxel centers: round(p/v)·v (gaussian_model.py:295-299)."""
    coords = np.unique(np.round(points / voxel_size), axis=0)
    return (coords * voxel_size).astype(np.float32)


def _uniform(shape, bound, gen):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def init_mlps(cfg: ScaffoldConfig, generator: torch.Generator,
              device="cuda") -> ScaffoldMLPs:
    """torch ``nn.Linear`` default init — U(±1/√fan_in) for W and b —
    drawn from ``generator`` (the JAX package draws the same
    distribution from ``jax.random``; the two streams differ)."""
    dev = resolve_device(device)
    mlps = ScaffoldMLPs(cfg)
    with torch.no_grad():
        for _, mlp in mlps.decoders():
            for lin in mlp.layers():
                bound = 1.0 / np.sqrt(lin.in_features)
                lin.weight.copy_(_uniform(lin.weight.shape, bound,
                                          generator))
                lin.bias.copy_(_uniform(lin.bias.shape, bound, generator))
        ca = init_bidirectional_attn(generator, cfg.feat_dim,
                                     cfg.attn_heads, cfg.attn_head_dim)
        for name, p in mlps.crossattn.arrays():
            p.copy_(ca[name])
    return mlps.to(dev)


def init_scaffold(points: np.ndarray, cfg: ScaffoldConfig,
                  generator: Optional[torch.Generator] = None,
                  voxel_size: float | None = None,
                  device="cuda") -> ScaffoldState:
    """create_from_pcd (gaussian_model.py:301-345): anchors are unique
    voxel centers, scales from the mean-3NN distance, offsets and
    features zero, opacity/uncertainty logits at σ⁻¹(0.1)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = cfg.voxel_size if voxel_size is None else voxel_size
    anchors = voxelize(np.asarray(points, np.float32), v)
    n = anchors.shape[0]
    if n > cfg.capacity:
        raise ValueError(f"{n} anchors exceed capacity {cfg.capacity}")
    C, k, F = cfg.capacity, cfg.n_offsets, cfg.feat_dim
    a = torch.as_tensor(anchors, device=dev)
    dist2 = mean_knn_sq_dist(a).clamp_min(1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 6)

    def pad(x, fill=0.0):
        out = torch.full((C,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    params = AnchorParams(
        anchor=pad(a),
        offset=torch.zeros((C, k, 3), device=dev),
        feat=torch.zeros((C, F), device=dev),
        scaling=pad(log_scale, fill=float(np.log(1e-3))),
        rotation=torch.tensor([1.0, 0, 0, 0], device=dev).repeat(C, 1),
        opacity=torch.full((C, 1), inverse_sigmoid(0.1), device=dev),
        uncertainty=torch.full((C, 1), inverse_sigmoid(0.1), device=dev),
    )
    alive = torch.arange(C, device=dev) < n
    return ScaffoldState(params=params, mlps=init_mlps(cfg, generator, dev),
                         alive=alive, xyz_max=a.max(0).values)


def scaffold_from_numpy(anchor_params, mlp_params, alive,
                        cfg: ScaffoldConfig, xyz_max=None,
                        device="cuda") -> ScaffoldState:
    """The JAX package's parameters, as numpy arrays, → the port's state.

    ``anchor_params``: a mapping (or NamedTuple) with the
    :class:`AnchorParams` fields.  ``mlp_params``: a mapping (or
    NamedTuple) with ``opacity``/``uncertainty``/``cov``/``color`` (and
    ``feat_bank`` when ``cfg.use_feat_bank``), each a 2-list of
    ``{"w": (fan_in, fan_out), "b": (fan_out,)}``, plus ``crossattn``: the
    8 ``BidirAttnParams`` arrays in their field order.
    """
    dev = resolve_device(device)
    ap = _as_dict(anchor_params)
    mp = _as_dict(mlp_params)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32))

    params = AnchorParams(**{f: t(ap[f]).to(dev)
                             for f in AnchorParams._fields})
    mlps = ScaffoldMLPs(cfg)
    with torch.no_grad():
        for name, mlp in mlps.decoders():
            for lin, layer in zip(mlp.layers(), mp[name]):
                lin.weight.copy_(t(layer["w"]).T)
                lin.bias.copy_(t(layer["b"]))
        ca = mp["crossattn"]
        ca = [ca[f] for f in CROSSATTN_FIELDS] if isinstance(ca, dict) \
            else list(ca)[:len(CROSSATTN_FIELDS)]
        for (_, buf), arr in zip(mlps.crossattn.arrays(), ca):
            buf.copy_(t(arr))
    alive_t = torch.as_tensor(np.array(alive, bool)).to(dev)
    if xyz_max is None:
        xyz_max = params.anchor[alive_t].max(0).values if bool(
            alive_t.any()) else torch.zeros(3, device=dev)
    else:
        xyz_max = t(xyz_max).to(dev)
    return ScaffoldState(params=params, mlps=mlps.to(dev), alive=alive_t,
                         xyz_max=xyz_max)


def n_alive(state: ScaffoldState) -> torch.Tensor:
    """The live anchors' count, a () int32 tensor (scaffold.py:267)."""
    return torch.sum(state.alive.to(torch.int32), dtype=torch.int32)


def _as_dict(x) -> Dict[str, Any]:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


class Decoded(NamedTuple):
    """Neural gaussians, one block of k per anchor, flattened to (C·k, ·)."""
    xyz: torch.Tensor          # (C·k,3)
    color: torch.Tensor        # (C·k,3)
    opacity: torch.Tensor      # (C·k,)
    uncertainty: torch.Tensor  # (C·k,)
    scale: torch.Tensor        # (C·k,3)
    rot: torch.Tensor          # (C·k,4)
    neural_opacity: torch.Tensor  # (C,k) raw tanh output
    active: torch.Tensor       # (C·k,) bool
    anchor_visible: torch.Tensor  # (C,) bool — alive ∧ visible


def decode(state: ScaffoldState, cam_center: torch.Tensor,
           visible_mask: Optional[torch.Tensor],
           cfg: ScaffoldConfig) -> Decoded:
    """generate_neural_gaussians (gaussian_renderer/__init__.py:18-102).

    Per anchor: view direction and distance condition four MLPs; each
    anchor spawns k gaussians at ``anchor + offset·scaling[:,:3]`` with
    scale ``scaling[:,3:]·σ(cov[:3])`` and rotation ``normalize(cov[3:7])``.
    C is the row count of ``state.params``: the capacity, or the training
    step's anchor span.
    """
    p = state.params
    C, k = p.anchor.shape[0], cfg.n_offsets
    alive = state.alive if visible_mask is None else (
        state.alive & visible_mask)

    ob_view = p.anchor - cam_center[None, :]
    # dead/coincident anchors would hit ‖0‖ — substitute a unit view there
    degenerate = torch.sum(ob_view * ob_view, dim=1, keepdim=True) < 1e-18
    safe_view = torch.where(
        degenerate, device_constant((0.0, 0.0, 1.0), ob_view.device),
        ob_view)
    ob_dist = torch.linalg.vector_norm(safe_view, dim=1, keepdim=True)
    ob_dir = safe_view / ob_dist
    feat = p.feat
    if cfg.use_feat_bank:
        # view-adaptive multi-resolution feature mix
        # (gaussian_renderer/__init__.py:39-50); torch ``repeat`` tiles
        cat_view = torch.cat([ob_dir, ob_dist], dim=1)            # (C,4)
        bw = torch.softmax(state.mlps.feat_bank(cat_view), dim=1)  # (C,3)
        feat = (feat[:, ::4].repeat(1, 4) * bw[:, 0:1]
                + feat[:, ::2].repeat(1, 2) * bw[:, 1:2]
                + feat * bw[:, 2:3])
    x = torch.cat([feat, ob_dir, ob_dist], dim=1)           # (C,F+4)

    m = state.mlps
    neural_op = torch.tanh(m.opacity(x))                    # (C,k)
    unc = torch.sigmoid(m.uncertainty(x))                   # (C,k)
    color = torch.sigmoid(m.color(x))                       # (C,3k)
    scale_rot = m.cov(x)                                    # (C,7k)

    color = color.reshape(C * k, 3)
    scale_rot = scale_rot.reshape(C * k, 7)
    grid_scale = torch.exp(p.scaling)                       # (C,6)
    offset_extent = grid_scale[:, :3]
    scale_base = grid_scale[:, 3:]

    scale = (scale_base.repeat_interleave(k, dim=0)
             * torch.sigmoid(scale_rot[:, :3]))             # (C·k,3)
    rotq = scale_rot[:, 3:7]
    rot = rotq / torch.clamp_min(
        torch.linalg.vector_norm(rotq, dim=1, keepdim=True), 1e-12)

    xyz = (p.anchor.repeat_interleave(k, dim=0)
           + p.offset.reshape(C * k, 3)
           * offset_extent.repeat_interleave(k, dim=0))

    op_flat = neural_op.reshape(C * k)
    active = alive.repeat_interleave(k) & (op_flat > 0.0)
    opacity = torch.where(active, op_flat, torch.zeros_like(op_flat))

    return Decoded(xyz=xyz, color=color, opacity=opacity,
                   uncertainty=unc.reshape(C * k), scale=scale, rot=rot,
                   neural_opacity=neural_op, active=active,
                   anchor_visible=alive)
