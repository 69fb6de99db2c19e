"""One GScream training iteration from the reference's parts, and the
render of one view.

:class:`Trainer` holds the parameters, Adam's moments and step counts,
and the token generator, and runs iteration after iteration as the loop
does: draws, the anchor prefilter, in phase 2 the token draw and the
cross-attention, decode, EWA projection, blend, losses, the gradient (the
blend's vector-Jacobian product tile group by tile group, then autograd
through projection and decode), the densification statistics
(``training_statis``) and Adam.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import attention, blend, draws, losses, model, optim, project


class View:
    """A camera (float32 device matrices and tangents) and its targets:
    ``image`` (3,H,W), ``mask`` (1,H,W), ``mono`` (1,H,W) on the device,
    ``mask_np`` the mask's (H,W) host copy."""

    def __init__(self, R, T, fov_x, fov_y, width, height, device,
                 image=None, mask=None, mono=None, mask_np=None):
        w2c, full, center, tx, ty = project.camera_matrices(R, T, fov_x,
                                                            fov_y)

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)
        self.w2c, self.full, self.center = t(w2c), t(full), t(center)
        self.tan_x, self.tan_y = t(tx), t(ty)
        self.width, self.height = width, height
        self.image, self.mask, self.mono, self.mask_np = \
            image, mask, mono, mask_np


def splat(p, alive, view: View, n_offsets):
    """(blend inputs, tile bins, active, projection, the opacity decoder's
    raw (C, k) output)."""
    xyz, color, opacity, unc, scale, rot, active, neural_op = model.decode(
        p, alive, view.center, n_offsets)
    s = project.preprocess(xyz, scale, rot, view.w2c, view.full, view.width,
                           view.height, view.tan_x, view.tan_y,
                           active=active)
    g = (s.mean2d, s.conic, opacity, color, s.depth, unc)
    with torch.no_grad():
        bins = blend.bin_tiles(s.mean2d, s.cov2d, opacity, s.depth,
                               s.radius, view.width, view.height)
    return g, bins, active, s, neural_op


def render_view(p, alive, view: View, n_offsets, bg):
    """(colour (H,W,3), depth, uncertainty) of one view."""
    with torch.no_grad():
        g, bins = splat(p, alive, view, n_offsets)[:2]
        c, d, u, _ = blend.render(g, bins, view.width, view.height, bg)
    return c, d, u


def prefilter(p, alive, view: View):
    """The anchors projected as gaussians of their own first three
    scales: visibility and screen position (GScream's
    ``position2D_filter``)."""
    rot = p["params/rotation"]
    rot = rot / torch.clamp_min(torch.linalg.vector_norm(
        rot, dim=1, keepdim=True), 1e-12)
    s = project.preprocess(p["params/anchor"],
                           torch.exp(p["params/scaling"][:, :3]), rot,
                           view.w2c, view.full, view.width, view.height,
                           view.tan_x, view.tan_y, active=alive)
    return s.radius > 0, s.mean2d


class Trainer:
    def __init__(self, params: Dict[str, torch.Tensor], alive, run: Dict,
                 seed: int, device):
        """``params`` the leaves (``model`` keys) at step 0; ``run`` the
        configuration's ``model`` and ``optim`` settings and the cell's
        schedule (``start_crossattn_from``); ``seed`` the run's seed."""
        self.p = {k: v.clone() for k, v in params.items()}
        self.alive = alive
        self.run = run
        self.seed = seed
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        C = alive.shape[0]
        k = run["model"]["n_offsets"]
        self.stats = {
            "opacity_accum": torch.zeros((C, 1), device=device),
            "anchor_demon": torch.zeros((C, 1), device=device),
            "offset_grad_accum": torch.zeros((C, k), device=device),
            "offset_denom": torch.zeros((C, k), device=device)}
        self.last_render = None
        self.step = 0
        self.step_c = 0
        # the phase-2 token priorities: two uniform vectors a step from a
        # device generator seeded with seed + 1
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.device = device

    @torch.no_grad()
    def accumulate(self, visible, neural_op, d_mean2d, valid, W, H):
        """``training_statis``: over the visible anchors, the sum of the
        decoder's positive opacities and a visit; over their gaussians
        that were active and on screen, the norm of the projected mean's
        gradient in normalised device units (×W/2, ×H/2) and a count."""
        C, k = neural_op.shape
        st = self.stats
        vis = visible[:, None]
        st["opacity_accum"] += torch.where(
            vis, torch.clamp_min(neural_op, 0.0).sum(1, keepdim=True), 0.0)
        st["anchor_demon"] += vis.float()
        ndc = d_mean2d * torch.tensor([0.5 * W, 0.5 * H],
                                      device=d_mean2d.device)
        norm = torch.linalg.vector_norm(ndc, dim=1).reshape(C, k)
        upd = valid.reshape(C, k) & vis
        st["offset_grad_accum"] += torch.where(upd, norm, 0.0)
        st["offset_denom"] += upd.float()

    def iteration(self, views, ref_index):
        """Run the next iteration; returns its loss, its L1 colour term and
        (view, whether it is the reference view, whether the token draw
        found enough anchors).  ``last_render`` keeps its (colour (H,W,3),
        depth (H,W))."""
        o, mdl = self.run["optim"], self.run["model"]
        k = mdl["n_offsets"]
        it = self.step + 1
        vi = draws.view_of(self.seed, it, len(views))
        view = views[vi]
        is_ref = vi == ref_index
        phase2 = it > o["start_crossattn_from"] and (
            o["enable_crossattn_refview"] > 0
            or o["enable_crossattn_otherview"] > 0)
        cross = it > o["start_crossattn_from"] and (
            o["enable_crossattn_refview"] if is_ref
            else o["enable_crossattn_otherview"]) > 0
        H, W = view.height, view.width
        box, pt = draws.iteration_draws(
            self.seed, it, view.mask_np, is_ref,
            cross and o["enable_edge_samping"] > 0, H, W,
            small=o["sampling_2D_small_ratio"])
        dev = self.device
        box = torch.as_tensor(box, device=dev) if box is not None else \
            torch.zeros((H, W), device=dev)

        leaves = {n: t.detach().requires_grad_() for n, t in self.p.items()}
        with torch.no_grad():
            visible, pos = prefilter(self.p, self.alive, view)
        feat = leaves["params/feat"]
        tok_ok = False
        if cross:
            C = self.alive.shape[0]
            n_tok = min(o["crossattn_max_tokens"], C)
            pri = (torch.rand(C, generator=self.gen, device=dev),
                   torch.rand(C, generator=self.gen, device=dev))
            ptt = torch.as_tensor(pt if pt is not None else (0, 0, 0, 0),
                                  device=dev)
            tok = attention.tokens(pri[0], pri[1], pos, visible, self.alive,
                                   view.mask[0], ptt, W, H, n_tok)
            tok_ok = tok[4]
            feat = attention.mixed_features(
                leaves, leaves["params/feat"], tok,
                o["crossattn_feat_update_ema"], is_ref, o["attn_head_num"],
                o["attn_head_dim"])
        rp = dict(leaves, **{"params/feat": feat})
        g, bins, active, s, neural_op = splat(rp, self.alive, view, k)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            color, depth, _, _ = blend.render(g, bins, W, H, bg)
        self.last_render = (color, depth)
        img = color.permute(2, 0, 1).detach().requires_grad_()
        dep = depth.detach().requires_grad_()
        loss, l1 = losses.view_loss(img, dep, view.image, view.mask,
                                    view.mono[0], box, o, is_ref)
        d_img, d_dep = torch.autograd.grad(loss, [img, dep])
        d_g = blend.render_vjp(g, bins, d_img.permute(1, 2, 0), d_dep)
        if o["start_stat"] < it < o["update_until"]:
            self.accumulate(visible & self.alive, neural_op.detach(),
                            d_g[0], active & (s.radius > 0), W, H)

        if cross:
            groups = optim.PHASE2_MAIN | {"mlps/crossattn"}
        else:
            groups = optim.PHASE1 - ({"params/feat"} if phase2 else set())
        names = [n for n in leaves if optim.group_of(n) in groups]
        grads = torch.autograd.grad(list(g), [leaves[n] for n in names],
                                    d_g, allow_unused=True)
        grads = {n: (gr if gr is not None else torch.zeros_like(leaves[n]))
                 for n, gr in zip(names, grads)}
        self.step = it
        lrs = optim.learning_rates(it, o)
        if not cross:
            optim.adam(self.p, grads, self.m, self.v, lrs, it, groups)
        elif tok_ok:
            optim.adam(self.p, grads, self.m, self.v, lrs, it,
                       optim.PHASE2_MAIN)
            with torch.no_grad():
                self.p["params/feat"].copy_(feat.detach())
            self.step_c += 1
            optim.adam(self.p, grads, self.m, self.v, lrs, self.step_c,
                       {"mlps/crossattn"})
        return float(loss.detach()), float(l1.detach()), {
            "view": vi, "is_ref": is_ref, "tokens_ok": tok_ok}
