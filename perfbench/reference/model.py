"""Scaffold-GS anchors and decoders (Lu et al. 2023, ``scene/
gaussian_model.py`` and ``gaussian_renderer/__init__.py`` of the
Scaffold-GS code that GScream builds on).

Parameters are keyed as ``params/<field>`` for the per-anchor arrays and
``mlps/<decoder>/<layer>/<w|b>`` (``w`` as ``(fan_out, fan_in)``) and
``mlps/crossattn/<name>`` for the cross-attention, so that a comparison
pairs each leaf with the program's leaf of the same name.

Departures from the published code: the anchors are padded to a fixed
capacity with an ``alive`` mask (dead slots decode to inactive
gaussians); a degenerate view direction (camera at an anchor) is replaced
by +z.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

ANCHOR_FIELDS = ("anchor", "offset", "feat", "scaling", "rotation",
                 "opacity", "uncertainty")
DECODERS = ("opacity", "uncertainty", "cov", "color")
CROSSATTN = ("to_qk", "ctx_to_qk", "to_v", "ctx_to_v", "to_out_w",
             "to_out_b", "ctx_out_w", "ctx_out_b")


def read_anchor_ply(path: str) -> Dict[str, np.ndarray]:
    """A binary little-endian PLY of float32 vertex columns."""
    with open(path, "rb") as f:
        names, n = [], 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[2])
            elif line.startswith("property float"):
                names.append(line.split()[2])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * len(names) * n), "<f4")
    data = data.reshape(n, len(names))
    return {name: data[:, i] for i, name in enumerate(names)}


def write_anchor_ply(path: str, columns: Dict[str, np.ndarray]) -> None:
    names = list(columns)
    n = len(columns[names[0]])
    hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    hdr += [f"property float {name}" for name in names] + ["end_header"]
    arr = np.stack([np.asarray(columns[c], np.float32) for c in names], 1)
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        f.write(arr.astype("<f4").tobytes())


def anchors_from_ply(cols: Dict[str, np.ndarray], capacity: int,
                     n_offsets: int, device) -> Dict[str, torch.Tensor]:
    """The per-anchor arrays padded to ``capacity``, and ``alive``.  The
    offsets are stored transposed, ``(N, 3, k)`` flattened, as the
    Scaffold-GS PLY stores them."""
    n = len(cols["x"])

    def block(prefix):
        names = sorted((c for c in cols if c.startswith(prefix)),
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        return np.stack([cols[c] for c in names], 1)

    arrays = {
        "anchor": np.stack([cols["x"], cols["y"], cols["z"]], 1),
        "offset": block("f_offset_").reshape(n, 3, n_offsets)
        .transpose(0, 2, 1),
        "feat": block("f_anchor_feat_"), "scaling": block("scale_"),
        "rotation": block("rot_"), "opacity": cols["opacity"][:, None],
        "uncertainty": cols["uncertainty"][:, None]}
    out = {}
    for name in ANCHOR_FIELDS:
        a = np.asarray(arrays[name], np.float32)
        pad = np.zeros((capacity,) + a.shape[1:], np.float32)
        pad[:n] = a
        out["params/" + name] = torch.as_tensor(pad).to(device)
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[:n] = True
    return out, alive.to(device)


def init_mlps(seed: int, feat_dim: int, n_offsets: int, heads: int,
              dim_head: int, device) -> Dict[str, torch.Tensor]:
    """The decoders and the cross-attention as GScream initialises them:
    ``nn.Linear``'s U(±1/√fan_in) for weights and biases, drawn from one
    CPU ``torch.Generator`` seeded with ``seed``, decoder by decoder
    (opacity, uncertainty, cov, color; each layer's weight then bias),
    then the six cross-attention weights (``(fan_in, fan_out)``) with zero
    biases."""
    g = torch.Generator().manual_seed(int(seed))
    F, k = feat_dim, n_offsets
    outs = {"opacity": k, "uncertainty": k, "cov": 7 * k, "color": 3 * k}
    p = {}
    for name in DECODERS:
        for layer, (d_in, d_out) in enumerate(((F + 4, F), (F, outs[name]))):
            bound = 1.0 / math.sqrt(d_in)
            p[f"mlps/{name}/{layer}/w"] = torch.empty(
                (d_out, d_in)).uniform_(-bound, bound, generator=g)
            p[f"mlps/{name}/{layer}/b"] = torch.empty(
                (d_out,)).uniform_(-bound, bound, generator=g)
    inner = heads * dim_head
    shapes = {"to_qk": (F, inner), "ctx_to_qk": (F, inner),
              "to_v": (F, inner), "ctx_to_v": (F, inner),
              "to_out_w": (inner, F), "to_out_b": (F,),
              "ctx_out_w": (inner, F), "ctx_out_b": (F,)}
    for name in CROSSATTN:
        shape = shapes[name]
        if name.endswith("_b"):
            t = torch.zeros(shape)
        else:
            bound = 1.0 / math.sqrt(shape[0])
            t = torch.empty(shape).uniform_(-bound, bound, generator=g)
        p["mlps/crossattn/" + name] = t
    return {k_: v.to(device) for k_, v in p.items()}


def _mlp(p, name, x):
    h = torch.relu(x @ p[f"mlps/{name}/0/w"].T + p[f"mlps/{name}/0/b"])
    return h @ p[f"mlps/{name}/1/w"].T + p[f"mlps/{name}/1/b"]


def decode(p: Dict[str, torch.Tensor], alive: torch.Tensor,
           cam_center: torch.Tensor, n_offsets: int):
    """Neural gaussians of every anchor slot, flattened to ``(C·k, ·)``:
    (xyz, colour, opacity, uncertainty, scale, rotation, active,
    neural_opacity).  Opacity is the tanh decoder's output, and a gaussian
    is active where its anchor is alive and that output is positive."""
    anchor = p["params/anchor"]
    C, k = anchor.shape[0], n_offsets
    view = anchor - cam_center[None, :]
    degenerate = (view * view).sum(1, keepdim=True) < 1e-18
    view = torch.where(degenerate, torch.tensor(
        [0.0, 0.0, 1.0], device=view.device), view)
    dist = torch.linalg.vector_norm(view, dim=1, keepdim=True)
    x = torch.cat([p["params/feat"], view / dist, dist], 1)
    neural_op = torch.tanh(_mlp(p, "opacity", x))
    unc = torch.sigmoid(_mlp(p, "uncertainty", x)).reshape(C * k)
    color = torch.sigmoid(_mlp(p, "color", x)).reshape(C * k, 3)
    cov = _mlp(p, "cov", x).reshape(C * k, 7)
    grid = torch.exp(p["params/scaling"])
    scale = grid[:, 3:].repeat_interleave(k, 0) * torch.sigmoid(cov[:, :3])
    q = cov[:, 3:7]
    rot = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1,
                                                       keepdim=True), 1e-12)
    xyz = (anchor.repeat_interleave(k, 0)
           + p["params/offset"].reshape(C * k, 3)
           * grid[:, :3].repeat_interleave(k, 0))
    op = neural_op.reshape(C * k)
    active = alive.repeat_interleave(k) & (op > 0.0)
    opacity = torch.where(active, op, torch.zeros_like(op))
    return xyz, color, opacity, unc, scale, rot, active, neural_op
