"""The reference against itself at a tiny size: the tiled blend against
a dense per-pixel blend over every gaussian, its vector-Jacobian product
against autograd through that dense form, a training iteration run twice
from the same state, and the renders of the tiny scenes finite."""
import torch

from reference import blend, model, step


def dense_blend(g, radius, width, height):
    """Every pixel against every gaussian whose 3σ tile rectangle holds
    the pixel's tile, sorted by depth: the prefix-product form, no
    lists."""
    mean2d, conic, op, color, depth, unc = g
    order = torch.argsort(depth, stable=True)
    m, c, o, r = mean2d[order], conic[order], op[order], radius[order]
    ys, xs = torch.meshgrid(torch.arange(height).float(),
                            torch.arange(width).float(), indexing="ij")
    px, py = xs.reshape(-1, 1), ys.reshape(-1, 1)
    dx, dy = m[None, :, 0] - px, m[None, :, 1] - py
    power = -0.5 * (c[None, :, 0] * dx * dx + c[None, :, 2] * dy * dy) \
        - c[None, :, 1] * dx * dy
    a = blend.clamp_alpha(o[None] * torch.exp(torch.clamp_max(power, 0)))
    t = blend.TILE
    tx, ty = torch.floor(px / t), torch.floor(py / t)
    inside = ((torch.floor((m[None, :, 0] - r) / t) <= tx)
              & (tx < torch.floor((m[None, :, 0] + r + t - 1) / t))
              & (torch.floor((m[None, :, 1] - r) / t) <= ty)
              & (ty < torch.floor((m[None, :, 1] + r + t - 1) / t)))
    ok = inside & (power <= 0) & (a >= blend.ALPHA_MIN)
    a = torch.where(ok, a, torch.zeros_like(a))
    p = torch.cumprod(1 - a, 1)
    pe = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], 1)
    w = torch.where(ok & (p >= blend.T_STOP), a * pe, torch.zeros_like(a))
    return (w @ color[order]).reshape(height, width, 3), \
        (w @ depth[order]).reshape(height, width)


def scene(n=60, width=70, height=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    mean2d = torch.rand((n, 2), generator=g) * torch.tensor([width, height])
    s = 1 + 4 * torch.rand((n, 2), generator=g)
    cov = torch.stack([s[:, 0] ** 2, torch.zeros(n), s[:, 1] ** 2], 1)
    conic = torch.stack([1 / cov[:, 0], torch.zeros(n), 1 / cov[:, 2]], 1)
    op = 0.1 + 0.89 * torch.rand(n, generator=g)
    depth = torch.rand(n, generator=g) + 1
    color, unc = torch.rand((n, 3), generator=g), torch.rand(n, generator=g)
    radius = torch.ceil(3 * s.max(1).values)
    return (mean2d, conic, op, color, depth, unc), cov, radius


def test_tiled_blend_equals_the_dense_blend():
    g, cov, radius = scene()
    bins = blend.bin_tiles(g[0], cov, g[2], g[4], radius, 70, 40)
    c, d, _, _ = blend.render(g, bins, 70, 40, torch.zeros(3))
    cd, dd = dense_blend(g, radius, 70, 40)
    assert torch.allclose(c, cd, atol=1e-5) and torch.allclose(d, dd,
                                                               atol=1e-5)


def test_vjp_equals_autograd_of_the_dense_blend():
    g, cov, radius = scene(seed=1)
    bins = blend.bin_tiles(g[0], cov, g[2], g[4], radius, 70, 40)
    gc, gd = torch.randn(40, 70, 3), torch.randn(40, 70)
    got = blend.render_vjp(g, bins, gc, gd)
    leaves = [x.clone().requires_grad_() for x in g]
    cd, dd = dense_blend(leaves, radius, 70, 40)
    want = torch.autograd.grad([cd, dd], leaves, [gc, gd],
                               allow_unused=True)
    for a, b in zip(got[:5], want[:5]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)


def test_small_groups_change_nothing(monkeypatch):
    g, cov, radius = scene(seed=2)
    bins = blend.bin_tiles(g[0], cov, g[2], g[4], radius, 70, 40)
    c1 = blend.render(g, bins, 70, 40, torch.zeros(3))[0]
    monkeypatch.setattr(blend, "PAIR_BUDGET", 1)
    bins = blend.bin_tiles(g[0], cov, g[2], g[4], radius, 70, 40)
    assert len(bins.groups) == int((bins.count > 0).sum())
    c2 = blend.render(g, bins, 70, 40, torch.zeros(3))[0]
    assert torch.equal(c1, c2)


def test_iteration_is_deterministic(tiny):
    from harness import scene as sc_mod
    from harness import train_cell
    cell = tiny("spinnerf", "train_p1")
    dev = torch.device("cpu")
    sc = sc_mod.cameras(cell["config"])
    tg, ri, rd = sc_mod.targets(sc, 3, dev)
    cols = sc_mod.anchor_columns(cell["config"], 3, dev)
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ply = os.path.join(d, "a.ply")
        model.write_anchor_ply(ply, cols)
        a = train_cell.reference_steps(cell, ply, sc, tg, ri, rd, dev, 2)
        b = train_cell.reference_steps(cell, ply, sc, tg, ri, rd, dev, 2)
    for key in ("loss", "l1", "g1", "d3"):
        assert a[key] == b[key], key
    for x, y in zip(a["image1"], b["image1"]):
        assert torch.equal(x, y)
    for name, x in a["stats3"].items():
        assert torch.equal(x, b["stats3"][name]), name
    assert float(a["stats3"]["anchor_demon"].sum()) > 0
    assert all(x == x and x > 0 for x in a["loss"])


def test_render_is_finite(tiny):
    from harness import render_cell, scene as sc_mod
    import os
    import tempfile
    cell = tiny("garden", "render_loop")
    dev = torch.device("cpu")
    sc = sc_mod.cameras(cell["config"])
    with tempfile.TemporaryDirectory() as d:
        ply = os.path.join(d, "a.ply")
        model.write_anchor_ply(ply, sc_mod.anchor_columns(cell["config"], 4,
                                                          dev))
        frames = render_cell.reference_frames(cell["config"], ply, sc,
                                              sc.test[:2], dev)
    for c, d_, u in frames:
        assert torch.isfinite(c).all() and float(c.mean()) > 0.01
