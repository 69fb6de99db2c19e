"""Model IO (counterpart of ``gscream_tpu/model/io.py``): the anchor PLY
and the per-MLP ``.npz`` checkpoint, byte-compatible with the JAX package
so each package loads the other's models; the full training checkpoint;
the scene's load-time artifacts.

* :func:`save_anchors_ply` / :func:`load_anchors_ply` — the reference
  PLY anchor layout (gaussian_model.py:620-686): alive anchors only,
  re-padded to the capacity on load;
* :func:`save_mlps_npz` / :func:`load_mlps_npz` — one ``.npz`` whose keys
  are the JAX package's flattened pytree paths.  Those key strings are
  what ``jax.tree_util.tree_flatten_with_path`` prints: ``<mlp>/<layer>/
  ['b']`` and ``['w']`` for the decoders (weights stored ``(fan_in,
  fan_out)``), ``crossattn/[<flat index i>]`` for the eight cross-attention
  arrays.  They are written in the same order, so the archives' members
  are identical;
* :func:`save_checkpoint` / :func:`load_checkpoint` — the whole train
  state (parameters, both moment dicts, statistics, step counts,
  ``alive``, ``xyz_max`` and the token generator's state) as one
  ``torch.save`` file, from which a run resumes bit for bit (the JAX
  package writes an orbax directory instead; the two do not read each
  other's);
* :func:`write_scene_artifacts` — ``input.ply`` and ``cameras.json``.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..data.ply import read_ply, write_ply
from ..device import resolve_device
from .scaffold import AnchorParams, ScaffoldConfig, ScaffoldMLPs, \
    ScaffoldState


def save_anchors_ply(path: str, state: ScaffoldState,
                     cfg: ScaffoldConfig) -> None:
    alive = state.alive.cpu().numpy()
    p = AnchorParams(*(x.detach().cpu().numpy()[alive] for x in state.params))
    n = p.offset.shape[0]
    cols = {"x": p.anchor[:, 0], "y": p.anchor[:, 1], "z": p.anchor[:, 2],
            "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    # reference stores offsets transposed: (N,k,3)→(N,3,k) flat
    off = p.offset.transpose(0, 2, 1).reshape(n, -1)
    for i in range(off.shape[1]):
        cols[f"f_offset_{i}"] = off[:, i]
    for i in range(p.feat.shape[1]):
        cols[f"f_anchor_feat_{i}"] = p.feat[:, i]
    cols["opacity"] = p.opacity[:, 0]
    cols["uncertainty"] = p.uncertainty[:, 0]
    for i in range(6):
        cols[f"scale_{i}"] = p.scaling[:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p.rotation[:, i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_ply(path, cols)


def load_anchors_ply(path: str, cfg: ScaffoldConfig,
                     device="cuda") -> Tuple[AnchorParams, torch.Tensor]:
    """Returns (capacity-padded AnchorParams, alive mask)."""
    dev = resolve_device(device)
    d = read_ply(path)
    n = len(d["x"])
    C, k = cfg.capacity, cfg.n_offsets
    if n > C:
        raise ValueError(f"{n} anchors exceed capacity {C}")

    def col_block(prefix):
        names = sorted((name for name in d if name.startswith(prefix)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([d[name] for name in names], 1).astype(np.float32)

    anchor = np.stack([d["x"], d["y"], d["z"]], 1).astype(np.float32)
    off = col_block("f_offset_").reshape(n, 3, k).transpose(0, 2, 1)

    def pad(x):
        out = np.zeros((C,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.as_tensor(out).to(dev)

    params = AnchorParams(
        anchor=pad(anchor), offset=pad(off),
        feat=pad(col_block("f_anchor_feat_")),
        scaling=pad(col_block("scale_")), rotation=pad(col_block("rot_")),
        opacity=pad(np.asarray(d["opacity"], np.float32)[:, None]),
        uncertainty=pad(np.asarray(d["uncertainty"], np.float32)[:, None]),
    )
    alive = torch.zeros(C, dtype=torch.bool)
    alive[:n] = True
    return params, alive.to(dev)


def _npz_items(mlps: ScaffoldMLPs):
    """(key, module tensor, stored-as-transpose) in the JAX key order."""
    for name, mlp in mlps.decoders()[:4]:
        for i, lin in enumerate(mlp.layers()):
            yield f"{name}/{i}/['b']", lin.bias, False
            yield f"{name}/{i}/['w']", lin.weight, True
    for i, (_, buf) in enumerate(mlps.crossattn.arrays()):
        yield f"crossattn/[<flat index {i}>]", buf, False
    if mlps.feat_bank is not None:
        for i, lin in enumerate(mlps.feat_bank.layers()):
            yield f"feat_bank/{i}/['b']", lin.bias, False
            yield f"feat_bank/{i}/['w']", lin.weight, True


def save_mlps_npz(path: str, mlps: ScaffoldMLPs) -> None:
    """The decoder checkpoint beside the point cloud (reference
    ``save_mlp_checkpoints``, gaussian_model.py:975-988)."""
    flat = {}
    for key, t, transposed in _npz_items(mlps):
        a = t.detach().cpu().numpy()
        flat[key] = np.ascontiguousarray(a.T if transposed else a)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_mlps_npz(path: str, cfg: ScaffoldConfig,
                  device="cuda") -> ScaffoldMLPs:
    """Inverse of :func:`save_mlps_npz` (shape-checked)."""
    dev = resolve_device(device)
    z = np.load(path)
    mlps = ScaffoldMLPs(cfg)
    with torch.no_grad():
        for key, t, transposed in _npz_items(mlps):
            arr = z[key]
            arr = arr.T if transposed else arr
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {arr.shape} in {path}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(torch.as_tensor(np.ascontiguousarray(arr)))
    return mlps.to(dev)


def load_trained_scaffold(model_path: str, iteration: int = -1,
                          device="cuda"):
    """``<model>/cfg.json`` + ``point_cloud/iteration_<N>/{point_cloud.ply,
    mlp_checkpoints.npz}`` → (ScaffoldState, ScaffoldConfig, N), as the
    reference Scene's ``load_iteration`` path (scene/__init__.py:141-149).
    Without the npz the decoders keep a seeded random init."""
    from ..config import ModelConfig, RunConfig, load_config

    dev = resolve_device(device)
    cfg_path = os.path.join(model_path, "cfg.json")
    run = load_config(cfg_path) if os.path.exists(cfg_path) else RunConfig(
        model=ModelConfig())
    m = run.model
    cfg = ScaffoldConfig(
        feat_dim=m.feat_dim, n_offsets=m.n_offsets,
        voxel_size=m.voxel_size, capacity=m.anchor_capacity,
        attn_heads=run.optim.attn_head_num,
        attn_head_dim=run.optim.attn_head_dim,
        use_feat_bank=m.use_feat_bank)

    base = os.path.join(model_path, "point_cloud")
    its = [int(d.split("_")[-1]) for d in os.listdir(base)
           if d.startswith("iteration_")]
    if not its:
        raise FileNotFoundError(f"no point_cloud/iteration_* under "
                                f"{model_path}")
    it = max(its) if iteration < 0 else iteration
    ply_dir = os.path.join(base, f"iteration_{it}")
    params, alive = load_anchors_ply(
        os.path.join(ply_dir, "point_cloud.ply"), cfg, dev)
    mlp_path = os.path.join(ply_dir, "mlp_checkpoints.npz")
    if os.path.exists(mlp_path):
        mlps = load_mlps_npz(mlp_path, cfg, dev)
    else:
        from .scaffold import init_mlps
        mlps = init_mlps(cfg, torch.Generator().manual_seed(0), dev)
    xyz_max = params.anchor[alive].max(0).values if bool(alive.any()) \
        else torch.zeros(3, device=dev)
    state = ScaffoldState(params=params, mlps=mlps, alive=alive,
                          xyz_max=xyz_max)
    return state, cfg, it


CHECKPOINT_FORMAT = "gscream_tpu_torch.train_state.v1"


def save_checkpoint(path: str, ts) -> None:
    """The full ``TrainState`` to ``path`` (one file, written beside and
    renamed over, so a reader never sees half of it); tensors are stored
    on the CPU."""
    from ..train.state import named_params

    def host(d):
        return {k: t.detach().cpu() for k, t in d.items()}
    sc = ts.scaffold
    blob = {
        "format": CHECKPOINT_FORMAT,
        "params": host(named_params(sc)), "m": host(ts.m), "v": host(ts.v),
        "stats": host(ts.stats._asdict()),
        "step": int(ts.step), "step_c": int(ts.step_c),
        "alive": sc.alive.cpu(), "xyz_max": sc.xyz_max.cpu(),
        "generator": ts.generator.get_state(),
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template):
    """Inverse of :func:`save_checkpoint`: the checkpoint's values copied
    into ``template`` (a ``TrainState`` of the same configuration, on the
    device to restore to): parameters in place, moments, statistics,
    ``alive`` and ``xyz_max`` as new tensors, the generator's state set.
    Returns the restored ``TrainState``."""
    from ..model.densify import DensifyStats
    from ..train.state import named_params
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} checkpoint")
    sc = template.scaffold
    dev = sc.alive.device

    def same_keys(got, want, what):
        if set(got) != set(want):
            raise ValueError(f"{path}: {what} keys differ from the "
                             f"template's: {sorted(set(got) ^ set(want))}")
    params = named_params(sc)
    same_keys(blob["params"], params, "parameter")
    with torch.no_grad():
        for k, t in params.items():
            if tuple(blob["params"][k].shape) != tuple(t.shape):
                raise ValueError(f"{path}: {k} has shape "
                                 f"{tuple(blob['params'][k].shape)}, the "
                                 f"template {tuple(t.shape)}")
            t.copy_(blob["params"][k])

    def moments(d):
        same_keys(d, params, "moment")
        return {k: d[k].to(dev) for k in params}
    template.generator.set_state(blob["generator"])
    return template._replace(
        scaffold=sc._replace(alive=blob["alive"].to(dev),
                             xyz_max=blob["xyz_max"].to(dev)),
        m=moments(blob["m"]), v=moments(blob["v"]),
        step=int(blob["step"]),
        step_c=torch.tensor(int(blob["step_c"]), dtype=torch.int32,
                            device=dev),
        stats=DensifyStats(**{k: t.to(dev)
                              for k, t in blob["stats"].items()}))


def write_scene_artifacts(model_path: str, views, points) -> None:
    """The reference Scene's load-time artifacts (scene/__init__.py:62-78):
    ``input.ply`` (the initial cloud) and ``cameras.json`` (the given
    views in order — test cams then train cams — with camera_to_JSON's
    fields: c2w position and rotation, fx/fy)."""
    import json
    os.makedirs(model_path, exist_ok=True)
    pts = np.asarray(points, np.float32)
    write_ply(os.path.join(model_path, "input.ply"),
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    cams = []
    for i, v in enumerate(views):
        c = v.camera
        w2c = c.w2c.detach().cpu().numpy().astype(np.float64)
        c2w = np.linalg.inv(w2c)
        cams.append({
            "id": i,
            "img_name": getattr(v, "name", f"{i:05d}"),
            "width": int(c.width),
            "height": int(c.height),
            "position": c2w[:3, 3].tolist(),
            "rotation": [r.tolist() for r in c2w[:3, :3]],
            "fy": float(c.height / (2.0 * float(c.tan_fovy))),
            "fx": float(c.width / (2.0 * float(c.tan_fovx))),
        })
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(cams, f)
