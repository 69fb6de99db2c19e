"""The port's CUDA kernels against their plain PyTorch versions on the
card: K5, K6, K4, K3, K7, K8, K9a and K9b bit-equal (K3 and K7 also on
a rerun, to each other, and on runs up to 2,000 long; K5 and K6 also on
a rerun and a CUDA-graph replay, on chunks that emit nothing or hold
one gaussian of 27 x 41 tiles, on 2^21 gaussians and at capacities that
overflow the row table or the instance slots), K1 within
1e-4·max(1, |plain|) except
where the T < 1e-4 stop moves by one instance (≤ 0.1% of the outputs),
K2 per output lane within 1e-3·scale + 1e-2·|plain| (scale = max |plain|)
except ≤ 0.5% of the rows, all within 5e-2·scale (the sums run in other
orders, and Total − prefix cancels digits), and bit-equal on a rerun.
Raw K1 and K2 (``GSCREAM_KERNEL_COEFF=1``) within the same tolerances of
their plain twins and bit-equal to legacy K1 and K2 on the same binning,
on the whole frame and per band.
K1 and K2 also on a tile of ≥ 4,096 instances, on opacities near 0.99
and on a sparse scene with empty tiles, where they must blend the same
pairs: at every pixel, K1's Σw is bit-equal to the weights K2 gives the
instances there summed in K1's order (``chip_smoke.blend_agreement``).
On those scenes and on records planted at the edge of the cull (peak α
just above and below 1/255 over a 16×8 block, the vertex inside the
block, beside it or far off the tile, wide and narrow gaussians), K1 and
K2 equal their builds with -DGS_NO_CULL bit for bit: the cull changes
no output.  One phase-2 ``train_step`` and one ``adjust_anchors`` on the
card match the same calls on the CPU from the same state and draws
(counts, ``alive``, anchors and integer statistics bit-equal, floats
within ``tests/test_torch_train_step.py``'s tolerance).  ``evaluate_pairs``
on the card scores the same renders as on the CPU within
``chip_smoke.py``'s phase-(g) tolerances.

These need a CUDA card and ``nvcc``; without one they skip.  This file
imports neither JAX nor the JAX package, so on a machine with a card it
runs on its own: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the repo's
conftest configures JAX).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _splats(dev, seed, n=800, w=160, h=96, spread=2.0, log_op=(-3, -0.02),
            log_scale=-2.5):
    """``n`` seeded gaussians in front of the camera at ``w``×``h``:
    centres uniform in ±``spread`` (x, y) at depth 0.5-6, opacities
    log-uniform in 10^``log_op``, scales log-normal about ``log_scale``."""
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops.projection import preprocess
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-spread, spread, n),
                      rng.uniform(-spread, spread, n),
                      rng.uniform(0.5, 6.0, n)], -1)
    scales = np.exp(rng.normal(log_scale, 1.0, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = 10.0 ** rng.uniform(*log_op, n)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, w, h, device=dev)
    s = preprocess(t(means), t(scales), t(q), cam.w2c, cam.full_proj, w, h,
                   cam.tan_fovx, cam.tan_fovy, tile_w=32, tile_h=32,
                   opacity=t(op))
    extra = (t(rng.uniform(0, 1, (n, 3))), t(op), t(rng.uniform(0, 1, n)))
    return s, extra, w, h


def _k5_args(s, row_cap, capacity, w):
    return (s.radius, s.rect_min.contiguous(), s.rect_max.contiguous(),
            s.mean2d.contiguous(), s.conic.contiguous(),
            s.t_iso.contiguous(), s.depth.contiguous(), row_cap, capacity,
            32, 32, -(-w // 32))


def _same_table(got, ref):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _expand_both(args, n_tiles):
    """K5 and K6 on ``args`` against their plain versions, bit for bit, and
    against themselves on a second call and on a CUDA-graph replay (the
    look-back scratch is zeroed inside the captured call); returns K5's
    table."""
    from gscream_tpu_torch.ops import emission as em
    capacity = args[8]
    table = em.expand_gauss_rows(*args)
    torch.cuda.synchronize()
    _same_table(table, em.expand_gauss_rows_plain(*args))
    k6_args = (table.rows, table.ioffs, table.counts, capacity, n_tiles)
    inst = em.expand_rows(*k6_args)
    torch.cuda.synchronize()
    assert torch.equal(inst, em.expand_rows_plain(*k6_args))
    _same_table(em.expand_gauss_rows(*args), table)
    assert torch.equal(em.expand_rows(*k6_args), inst)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t_g = em.expand_gauss_rows(*args)
        i_g = em.expand_rows(t_g.rows, t_g.ioffs, t_g.counts, capacity,
                             n_tiles)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        _same_table(t_g, table)
        assert torch.equal(i_g, inst)
    return table


@pytest.mark.parametrize("seed,capacity", [(0, 1 << 14), (1, 512)])
def test_expand_kernels_bit_equal(dev, seed, capacity):
    s, _, w, h = _splats(dev, seed)
    _expand_both(_k5_args(s, capacity // 2, capacity, w),
                 -(-w // 32) * -(-h // 32))


def _synthetic_fields(dev, n, seed, culled=0.3, gx=41, gy=27):
    """``n`` random splats on a ``gx`` x ``gy`` grid of 32-pixel tiles, as
    K5 reads them: centres anywhere on and around the image, 2D standard
    deviations log-uniform in 0.5-300 px with a random correlation, t_iso
    in 0-6 (a tenth 0, which keeps the whole rect), ``culled`` of them
    with radius 0, the tile rect of the 3-sigma circle."""
    rng = np.random.default_rng(seed)
    wpx, hpx = 32 * gx, 32 * gy
    mx = rng.uniform(-64, wpx + 64, n)
    my = rng.uniform(-64, hpx + 64, n)
    sx, sy = np.exp(rng.uniform(np.log(0.5), np.log(300), (2, n)))
    rho = rng.uniform(-0.95, 0.95, n)
    a, b, c = sx * sx, rho * sx * sy, sy * sy
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], -1)
    t_iso = np.where(rng.uniform(size=n) < 0.1, 0.0, rng.uniform(0, 6, n))
    r = np.ceil(3 * np.maximum(sx, sy))
    radius = np.where(rng.uniform(size=n) < culled, 0, r)
    rmin = np.stack([np.clip(np.floor((mx - r) / 32), 0, gx),
                     np.clip(np.floor((my - r) / 32), 0, gy)], -1)
    rmax = np.stack([np.clip(np.ceil((mx + r) / 32), 0, gx),
                     np.clip(np.ceil((my + r) / 32), 0, gy)], -1)
    depth = rng.uniform(0.2, 10, n)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return [i32(radius), i32(rmin), i32(rmax),
            f32(np.stack([mx, my], -1)), f32(conic), f32(t_iso), f32(depth)]


def test_expand_chunks_and_lookback(dev):
    """K5's chunking on a synthetic scene of 5 chunks and 77 gaussians
    (not a multiple of the chunk): chunk 1 emits nothing, chunk 3 holds one
    gaussian of 27 rows x 41 tiles and nothing else; at a capacity that
    fits, one that overflows the row table and one that overflows only
    the instance slots."""
    from gscream_tpu_torch.ops import emission as em
    n = 5 * em.K5_CHUNK + 77
    f = _synthetic_fields(dev, n, 3)
    f[0][em.K5_CHUNK:2 * em.K5_CHUNK] = 0
    big = 3 * em.K5_CHUNK + 100
    f[0][3 * em.K5_CHUNK:4 * em.K5_CHUNK] = 0
    f[0][big] = 2000
    f[1][big] = torch.tensor([0, 0], dtype=torch.int32)
    f[2][big] = torch.tensor([41, 27], dtype=torch.int32)
    f[3][big] = torch.tensor([656.0, 432.0])
    f[4][big] = torch.tensor([1e-5, 0.0, 1e-5])
    f[5][big] = 5.0
    fields = [x.contiguous() for x in f]
    counts = em.count_emission(*fields, 32, 32)
    n_rows, n_inst = counts.tolist()
    assert torch.equal(counts, em.count_emission_plain(*fields, 32, 32))
    for row_cap, capacity in ((n_rows + 100, 2 * n_inst),
                              (n_rows // 2, 2 * n_inst),
                              (n_rows, n_inst // 2)):
        table = _expand_both(fields + [row_cap, capacity, 32, 32, 41],
                             41 * 27)
        assert table.counts[0] == n_rows
        big_rows = (table.rows[1] == big) & (
            torch.arange(row_cap, device=dev) < min(n_rows, row_cap))
        if row_cap > n_rows:
            assert int(big_rows.sum()) == 27
            assert int(table.rows[3][big_rows].max()) == 41
            assert table.counts[1] == n_inst


def test_expand_lookback_chain_of_4096_chunks(dev):
    """2^21 synthetic gaussians, so that 4,096 CTAs of 512 chain their two
    look-backs (over several waves), at a capacity that fits and one that
    overflows."""
    fields = _synthetic_fields(dev, 1 << 21, 5, culled=0.5)
    from gscream_tpu_torch.ops import emission as em
    n_rows, n_inst = em.count_emission(*fields, 32, 32).tolist()
    for row_cap, capacity in ((n_rows, n_inst + 1000),
                              (n_rows // 3, n_inst // 5)):
        _expand_both(fields + [row_cap, capacity, 32, 32, 41], 41 * 27)


@pytest.mark.parametrize("seed", [0, 2])
def test_tile_forward_close(dev, seed):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops.binning import bin_instances
    s, (colors, op, unc), w, h = _splats(dev, seed)
    b = bin_instances(s, 1 << 14, w, h, 32, 32)
    inst = rt.pack_instance_data(s.mean2d, s.conic, op, colors, s.depth,
                                 unc, b, -(-w // 32))
    args = (inst, b.tile_start, b.tile_count, b.tile_start.shape[0])
    got = rt.run_forward(*args)
    torch.cuda.synchronize()
    ref = rt.run_forward_plain(*args)
    bad = (got - ref).abs() > 1e-4 * ref.abs().clamp_min(1.0)
    assert torch.isfinite(got).all()
    assert bad.float().mean() <= 1e-3
    assert float(ref[:, 6].mean()) < 0.99            # the tiles are covered


def test_wrappers_check_their_inputs(dev):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    inst = torch.zeros((8, 16), device=dev)
    ts = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        rt.run_forward(inst, ts.long(), ts, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rt.run_forward(torch.zeros((16, 8), device=dev).T, ts, ts, 2)


def _backward_inputs(dev, seed, capacity=1 << 14, **scene):
    """K2's inputs as the backward builds them: the K1 records, and the
    pixel rows from K1's outputs and seeded cotangents."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops.binning import bin_instances
    s, (colors, op, unc), w, h = _splats(dev, seed, **scene)
    b = bin_instances(s, capacity, w, h, 32, 32)
    assert int(b.num_instances) <= capacity
    inst = rt.pack_instance_data(s.mean2d, s.conic, op, colors, s.depth,
                                 unc, b, -(-w // 32))
    n_tiles = b.tile_start.shape[0]
    img = rt.tiles_to_image(rt.run_forward_plain(
        inst, b.tile_start, b.tile_count, n_tiles), w, h)
    rng = np.random.default_rng(seed + 10)
    g = torch.as_tensor(rng.normal(size=(6, h, w)).astype(np.float32),
                        device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    pix = rt.pixel_rows(img[1:4], img[4], img[5], img[6], bg, g[0:3], g[3],
                        g[4], g[5], w, h)
    return (inst, pix, b.tile_start, b.tile_count, n_tiles), b


def _rows_close(got, ref):
    """K2's tolerance per output lane (module docstring)."""
    for lane in range(16):
        a, r = got[:, lane].double(), ref[:, lane].double()
        scale = max(float(r.abs().max()), 1e-30)
        err = (a - r).abs()
        assert float((err > 1e-3 * scale + 1e-2 * r.abs()).double().mean()
                     ) <= 5e-3, lane
        assert float(err.max()) <= 5e-2 * scale, lane


@pytest.mark.parametrize("seed", [0, 2])
def test_tile_backward_close(dev, seed):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    args, b = _backward_inputs(dev, seed)
    got = rt.run_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, rt.run_backward(*args))      # deterministic
    ref = rt.run_backward_plain(*args)
    n = int(b.num_instances)
    assert not got[n:].any()
    assert float(ref[:n, 6].abs().max()) > 0
    _rows_close(got[:n], ref[:n])


@pytest.mark.parametrize("n_bands", [2, 3])
def test_tile_backward_band_zero_fills_head(dev, n_bands):
    """A band's K2 (the tile ranges of its tile rows, which start past
    slot 0, the last band extended by pad tiles) zero-fills the slots
    before its first range as it does those past its last: the output,
    first filled with NaN, equals the plain twin's zeros outside the band
    and the full frame's K2 rows inside it, bit for bit."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.parallel.shard import (_band_geometry,
                                                  _band_slices, pad_tiles)
    (inst, pix, ts, tc, n_tiles), b = _backward_inputs(dev, 0)
    full = rt.run_backward(inst, pix, ts, tc, n_tiles)
    gx, gy, gy_pad, rows = _band_geometry(160, 96, n_bands)
    bb = pad_tiles(b, 160, 96, n_bands)
    pix = torch.cat([pix, pix.new_zeros(((gy_pad - gy) * gx,)
                                        + pix.shape[1:])])
    torch.cuda.synchronize()
    for band in range(n_bands):
        ts_b, tc_b, nl = _band_slices(bb, gx, rows, band)
        pix_b = pix[band * nl:(band + 1) * nl]
        junk = torch.full_like(inst, float("nan"))
        del junk        # the allocator hands this block to K2's output
        got = rt.run_backward(inst, pix_b, ts_b, tc_b, nl)
        torch.cuda.synchronize()
        ref = rt.run_backward_plain(inst, pix_b, ts_b, tc_b, nl)
        lo, hi = int(ts_b[0]), int(ts_b[-1] + tc_b[-1])
        assert band == 0 or lo > 0
        assert torch.equal(got[:lo], ref[:lo]) and not got[:lo].any()
        assert torch.equal(got[hi:], ref[hi:]) and not got[hi:].any()
        assert torch.equal(got[lo:hi], full[lo:hi])
        if hi > lo:
            _rows_close(got[lo:hi], ref[lo:hi])


@pytest.mark.parametrize("seed", [0, 2])
def test_raw_tile_kernels(dev, seed):
    """Raw K1 and K2 (``GSCREAM_KERNEL_COEFF=1``) on the raw records of
    the same binning: within K1's and K2's tolerances of their plain
    twins, bit-equal on a rerun, and bit-equal to legacy K1 and K2 on the
    legacy records (both derive the coefficients one rounding per
    operation, in the same order)."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    (inst, pix, ts, tc, n_tiles), b = _backward_inputs(dev, seed)
    s, (colors, op, unc), w, _ = _splats(dev, seed)
    gx = -(-w // 32)
    raw = rt.pack_instance_data(s.mean2d, s.conic, op, colors, s.depth, unc,
                                b, gx, raw=True)
    k1 = rt.run_forward_raw(raw, ts, tc, n_tiles, gx)
    k2 = rt.run_backward_raw(raw, pix, ts, tc, n_tiles, gx)
    torch.cuda.synchronize()
    assert torch.equal(k1, rt.run_forward(inst, ts, tc, n_tiles))
    assert torch.equal(k2, rt.run_backward(inst, pix, ts, tc, n_tiles))
    assert torch.equal(k2, rt.run_backward_raw(raw, pix, ts, tc, n_tiles,
                                               gx))
    ref1 = rt.run_forward_raw_plain(raw, ts, tc, n_tiles, gx)
    bad = (k1 - ref1).abs() > 1e-4 * ref1.abs().clamp_min(1.0)
    assert bad.float().mean() <= 1e-3
    n = int(b.num_instances)
    ref2 = rt.run_backward_raw_plain(raw, pix, ts, tc, n_tiles, gx)
    assert not k2[n:].any() and float(ref2[:n, 6].abs().max()) > 0
    _rows_close(k2[:n], ref2[:n])


@pytest.mark.parametrize("n_bands", [2, 3])
def test_raw_tile_kernels_on_bands(dev, n_bands):
    """Raw K1 and K2 per band with the band's first global tile as
    ``tile_base``: the stitched K1 bands bit-equal to the whole frame,
    each band's K2 rows bit-equal to the whole frame's in its slots and
    zero outside them."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.parallel.shard import (_band_geometry,
                                                  _band_slices, pad_tiles)
    (_, pix, ts, tc, n_tiles), b = _backward_inputs(dev, 0)
    s, (colors, op, unc), w, h = _splats(dev, 0)
    gx, gy, gy_pad, rows = _band_geometry(w, h, n_bands)
    raw = rt.pack_instance_data(s.mean2d, s.conic, op, colors, s.depth, unc,
                                b, gx, raw=True)
    full1 = rt.run_forward_raw(raw, ts, tc, n_tiles, gx)
    full2 = rt.run_backward_raw(raw, pix, ts, tc, n_tiles, gx)
    bb = pad_tiles(b, w, h, n_bands)
    pix = torch.cat([pix, pix.new_zeros(((gy_pad - gy) * gx,)
                                        + pix.shape[1:])])
    parts = []
    for band in range(n_bands):
        ts_b, tc_b, nl = _band_slices(bb, gx, rows, band)
        parts.append(rt.run_forward_raw(raw, ts_b, tc_b, nl, gx, band * nl))
        got = rt.run_backward_raw(raw, pix[band * nl:(band + 1) * nl],
                                  ts_b, tc_b, nl, gx, band * nl)
        torch.cuda.synchronize()
        lo, hi = int(ts_b[0]), int(ts_b[-1] + tc_b[-1])
        assert torch.equal(got[lo:hi], full2[lo:hi])
        assert not got[:lo].any() and not got[hi:].any()
    tiles = torch.cat(parts)
    assert torch.equal(tiles[:n_tiles], full1)


# scenes for the schedule, the batching and the early stops of K1 and K2:
# one tile under 5,000 faint gaussians (>= 4,096 instances: many batches,
# the heaviest tile first), opacities near 0.99 (pixels, warps and whole
# tiles stop after a few instances) and 40 small gaussians at 320×192
# (empty tiles, most of the capacity past the last tile)
BLEND_CASES = {
    "heavy_tile": dict(n=5000, spread=0.04, log_op=(-2.5, -1.5),
                       log_scale=-3.5, capacity=1 << 15),
    "opaque": dict(n=800, log_op=(-0.0044, -0.0044), log_scale=-2.0),
    "sparse": dict(n=40, w=320, h=192, log_scale=-4.0, capacity=1 << 13),
}


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_tile_kernels_schedule_and_stops(dev, nocull, case):
    """K1 and K2 against their plain versions, a bit-equal rerun of each,
    zero rows past every tile's last blended instance and past the last
    tile, the two kernels blending the same pairs, and both equal to
    their builds without the cull."""
    from chip_smoke import check_agreement
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    kw = dict(BLEND_CASES[case])
    args, b = _backward_inputs(dev, 7, **kw)
    inst, pix, ts, tc, n_tiles = args
    counts = tc.tolist()
    n = int(b.num_instances)
    if case == "heavy_tile":
        assert max(counts) >= 4096
    if case == "sparse":
        assert 0 in counts and n < inst.shape[0] // 4
    fwd_args = (inst, ts, tc, n_tiles)
    got = rt.run_forward(*fwd_args)
    torch.cuda.synchronize()
    assert torch.equal(got, rt.run_forward(*fwd_args))
    ref = rt.run_forward_plain(*fwd_args)
    assert torch.isfinite(got).all()
    bad = (got - ref).abs() > 1e-4 * ref.abs().clamp_min(1.0)
    assert float(bad.float().mean()) <= 1e-3
    if case == "opaque":
        assert float((ref[:, 6] < 1e-3).float().mean()) > 0.1

    rows = rt.run_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(rows, rt.run_backward(*args))
    rows_p = rt.run_backward_plain(*args)
    assert not rows[n:].any()
    _rows_close(rows[:n], rows_p[:n])
    # past each tile's last instance the plain version blends, allowing
    # one instance for a stop that moves, the kernel's rows are zero
    live = rows_p.abs().sum(1) > 0
    past = 0
    for s, c in zip(ts.tolist(), counts):
        hit = torch.nonzero(live[s:s + c])
        last = int(hit.max()) if hit.numel() else -1
        tail = rows[s + last + 2:s + c]
        assert not tail.any()
        past += tail.shape[0]
    if case in ("heavy_tile", "opaque"):
        assert past > 0
    check_agreement(*fwd_args, rt.run_forward, rt.run_backward, case)
    _equal_without_cull(nocull, args)


@pytest.fixture(scope="module")
def nocull():
    """K1 and K2 built with -DGS_NO_CULL: every (instance, block) pair
    evaluated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import os
    from chip_smoke import NOCULL, variant_build, variant_load
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    variant_load(variant_build(root, "nocull", ["-DGS_NO_CULL"]), NOCULL,
                 "nocull")
    return {kind: call for kind, (call, _) in NOCULL.items()}


# the peak α of a planted record over its block is e^δ / 255
PLANT_DELTAS = (2e-4, 1e-3, 1e-2, -2e-4, -1e-2)


def _planted(dev, seed=11, n=320):
    """One 32×32 tile of ``n`` records, each with its power's largest
    value over the tile's pixels at ln(1/(255·op)) + δ, so that it passes
    α ≥ 1/255 in one 16×8 block at most: the vertex inside one of the 8
    blocks, within 2 pixels of its side, inside the tile or up to 64
    pixels off it; curvatures 1e-3-30
    (wide to narrow), anisotropic and tilted.  Returns K2's arguments
    (records, seeded pixel rows, tile ranges), δ and the scale of the
    power's terms per record."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    rng = np.random.default_rng(seed)
    rec = np.zeros((n, 16))
    delta = np.array([PLANT_DELTAS[k % len(PLANT_DELTAS)]
                      for k in range(n)])
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float64)
    scale = np.zeros(n)
    for k in range(n):
        b = k % 8
        xa, ya = 16.0 * (b & 1), 8.0 * (b >> 1)
        family = (k // 8) % 4
        if family == 0:
            cx, cy = xa + rng.uniform(0, 15), ya + rng.uniform(0, 7)
        elif family == 1:
            cx = rng.choice([xa - rng.uniform(0, 2), xa + 15 +
                             rng.uniform(0, 2)])
            cy = ya + rng.uniform(-2, 9)
        elif family == 2:
            cx, cy = rng.uniform(-8, 40, 2)
        else:
            cx, cy = rng.uniform(-64, 96, 2)
        a = 10.0 ** rng.uniform(-3, 1.5)
        r = 10.0 ** rng.uniform(-0.5, 0.5)
        rho = rng.uniform(-0.9, 0.9)
        k3, k5, k4 = -a, -a * r, -2.0 * rho * a * np.sqrt(r)
        dx, dy = xx - cx, yy - cy
        top = float((k3 * dx * dx + k4 * dx * dy + k5 * dy * dy).max())
        op = 10.0 ** rng.uniform(-1.7, -0.01)
        peak = -np.log(255.0 * op) + delta[k] - top
        k1 = -(2 * k3 * cx + k4 * cy)
        k2 = -(k4 * cx + 2 * k5 * cy)
        k0 = peak + k3 * cx * cx + k4 * cx * cy + k5 * cy * cy
        rec[k, :14] = [op, *rng.uniform(0, 1, 3), k + 1.0,
                       rng.uniform(0, 1), k0, k1, k2, k3, k4, k5,
                       -np.round(cx), -np.round(cy)]
        scale[k] = (abs(k0) + 32 * (abs(k1) + abs(k2)) +
                    1024 * (abs(k3) + abs(k4) + abs(k5)))
    inst = torch.as_tensor(rec.astype(np.float32), device=dev)
    ts = torch.zeros(1, dtype=torch.int32, device=dev)
    tc = torch.full((1,), n, dtype=torch.int32, device=dev)
    img = rt.tiles_to_image(rt.run_forward_plain(inst, ts, tc, 1), 32, 32)
    g = torch.as_tensor(rng.normal(size=(6, 32, 32)).astype(np.float32),
                        device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    pix = rt.pixel_rows(img[1:4], img[4], img[5], img[6], bg, g[0:3], g[3],
                        g[4], g[5], 32, 32)
    return (inst, pix, ts, tc, 1), delta, scale


def _equal_without_cull(nocull, args):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    inst, pix, ts, tc, n_tiles = args
    for kind, kern, a in (("rasterize_fwd", rt.run_forward,
                           (inst, ts, tc, n_tiles)),
                          ("rasterize_bwd", rt.run_backward, args)):
        got, ref = kern(*a), nocull[kind](*a)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (kind, int((got != ref).sum()))


def test_cull_keeps_pairs_at_the_threshold(dev, nocull):
    """Planted records whose peak α over their block sits just above or
    just below 1/255: K1 and K2 equal their no-cull builds bit for bit,
    blend the same pairs, and where the power's rounding (~1e-7 of its
    terms' scale) is far below |δ| give a record a gradient row exactly
    where the plain version does: nonzero above the threshold, zero
    below."""
    from chip_smoke import check_agreement
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    args, delta, scale = _planted(dev)
    _equal_without_cull(nocull, args)
    inst, pix, ts, tc, n_tiles = args
    check_agreement(inst, ts, tc, n_tiles, rt.run_forward, rt.run_backward,
                    "planted")
    rows = rt.run_backward(*args)
    rows_p = rt.run_backward_plain(*args)
    clear = torch.as_tensor(scale * 1e-6 < np.abs(delta) / 10, device=dev)
    above = torch.as_tensor(delta > 0, device=dev)
    live, live_p = rows.abs().sum(1) > 0, rows_p.abs().sum(1) > 0
    assert int((clear & above).sum()) >= 40
    assert int((clear & ~above).sum()) >= 20
    assert bool(live[clear & above].all() and live_p[clear & above].all())
    assert not bool(live[clear & ~above].any() or
                    live_p[clear & ~above].any())


def _long_runs(dev, seed=5):
    """Emission-order (cap, 16) rows and int32 offsets of 600 gaussians:
    runs of 0-39 instances, every 7th empty, 12 of 100-2,000 that cross
    many 32-instance chunks; a capacity that is not a multiple of 32, with
    the last runs clamped or clamped away."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 40, 600)
    runs[rng.choice(590, 12, replace=False)] = rng.integers(100, 2001, 12)
    runs[::7] = 0
    offs = np.concatenate([[0], np.cumsum(runs)]).astype(np.int32)
    cap = int(offs[-1]) - 1237
    cap -= cap % 32 == 0
    assert (np.minimum(offs[1:], cap) - np.minimum(offs[:-1], cap)).max() \
        > 1000
    rows = rng.normal(size=(cap, 16)).astype(np.float32)
    return (torch.as_tensor(rows, device=dev),
            torch.as_tensor(offs, device=dev))


def _segment_reduce_cases(kern, plain, other, values, offs):
    """``kern`` (K3 or K7) bit-equal to its plain version, to a rerun and
    to ``other`` (the other layout's kernel) on the transposed values."""
    got = kern(values, offs)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(values, offs))
    assert torch.equal(got, kern(values, offs))
    assert torch.equal(got, other(values.T.contiguous(), offs))
    return got


def test_unpack_and_segment_reduce_bit_equal(dev):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh
    args, b = _backward_inputs(dev, 1)
    rows = rt.run_backward(*args)
    cols = sh.unpack_columns(rows)
    torch.cuda.synchronize()
    assert torch.equal(cols, sh.unpack_columns_plain(rows))
    ge = rt.emission_columns(rows, b)
    got = _segment_reduce_cases(rt.segment_reduce_cm,
                                rt.segment_reduce_cm_plain,
                                rt.segment_reduce_rows, ge, b.offsets)
    assert float(got[:, 6].abs().max()) > 0
    # runs up to 2,000 long, a ragged capacity and offsets past it
    long_rows, long_offs = _long_runs(dev)
    _segment_reduce_cases(rt.segment_reduce_cm, rt.segment_reduce_cm_plain,
                          rt.segment_reduce_rows,
                          long_rows.T.contiguous(), long_offs)
    # a ragged width, non-finite values (zeroed) and offsets past the
    # capacity (clamped)
    odd = torch.randn((1000, 16), device=dev)
    odd[5, 3], odd[17, 7] = float("nan"), float("inf")
    odd[999, 15] = -float("inf")
    assert torch.equal(sh.unpack_columns(odd), sh.unpack_columns_plain(odd))
    assert not sh.unpack_columns(odd)[[3, 7, 15], [5, 17, 999]].any()
    offs = torch.tensor([0, 3, 3, 700, 1500], dtype=torch.int32, device=dev)
    cols = sh.unpack_columns(odd)
    assert torch.equal(rt.segment_reduce_cm(cols, offs),
                       rt.segment_reduce_cm_plain(cols, offs))


@pytest.mark.parametrize("seed,capacity", [(0, 1 << 14), (1, 1024)])
def test_pallas_emission_kernels_bit_equal(dev, monkeypatch, seed,
                                           capacity):
    """K9a, K9b and K8 on the arguments ``bin_instances_pallas`` gives
    them (at 1024 the row table overflows), and its binning equal to the
    XLA build's with records equal to ``pack_instance_data``'s."""
    from gscream_tpu_torch.ops import binning as bn
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh
    s, (colors, op, unc), w, h = _splats(dev, seed)
    args = {}
    for name in ("expand1", "expand2"):
        def record(*a, _name=name, _fn=getattr(bn, name)):
            args[_name] = a
            return _fn(*a)
        monkeypatch.setattr(bn, name, record)
    b = bn.bin_instances_pallas(s, op, colors, unc, capacity, w, h, 32, 32)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for name, plain in (("expand1", em.expand1_plain),
                        ("expand2", em.expand2_plain)):
        got = getattr(em, name)(*args[name])
        torch.cuda.synchronize()
        for g, p in zip(got, plain(*args[name])):
            assert torch.equal(g, p), name
    rec = sh.pack_columns(b.cols16)
    torch.cuda.synchronize()
    assert torch.equal(rec, sh.pack_columns_plain(b.cols16))
    a = bn.bin_instances(s, capacity, w, h, 32, 32)
    n = min(int(a.num_instances), capacity)
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.gauss_id[:n], b.gauss_id[:n])
    ref = rt.pack_instance_data(s.mean2d, s.conic, op, colors, s.depth, unc,
                                a, -(-w // 32))
    assert torch.equal(rec[:n], ref[:n])
    odd = torch.randn((16, 1000), device=dev)
    assert torch.equal(sh.pack_columns(odd), sh.pack_columns_plain(odd))


def test_expand2_rounds_half_to_even(dev):
    """sx, sy of centres at x.5: the kernel's ``rintf`` against
    ``torch.round`` (both half to even)."""
    from gscream_tpu_torch.ops import emission as em
    rf = torch.zeros((11, 4), device=dev)
    rf[0] = torch.tensor([40.5, 41.5, -2.5, 33.25])
    rf[1] = torch.tensor([7.5, 8.5, 0.5, 64.75])
    rf[2] = rf[4] = 0.5
    io = torch.arange(5, dtype=torch.int32, device=dev)
    ri = torch.tensor([[0, 1, 2, 3], [1, 2, 0, 1], [1, 0, 2, 3]],
                      dtype=torch.int32, device=dev)
    got = em.expand2(io, ri, rf, 256, 32, 32, 4, 12)
    torch.cuda.synchronize()
    want = em.expand2_plain(io, ri, rf, 256, 32, 32, 4, 12)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    assert got[0][12, :4].tolist() == [32 - 40, 0 - 42, 64 + 2, 96 - 33]


def test_segment_reduce_rows_bit_equal(dev, monkeypatch):
    """K7 on K2's rows in emission order, the row modes and the cm flow
    equal to it; K7 on runs up to 2,000 long and at a ragged width, with
    offsets past the capacity (clamped); a NaN, +inf and -inf in one
    instance stay in its gaussian's sum."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    args, b = _backward_inputs(dev, 1)
    rows = rt.run_backward(*args)
    ge = rows[torch.sort(b.emit_slot.long(), stable=True).indices]
    got = _segment_reduce_cases(rt.segment_reduce_rows,
                                rt.segment_reduce_rows_plain,
                                rt.segment_reduce_cm, ge, b.offsets)
    assert float(got[:, 6].abs().max()) > 0
    long_rows, long_offs = _long_runs(dev)
    clean = _segment_reduce_cases(rt.segment_reduce_rows,
                                  rt.segment_reduce_rows_plain,
                                  rt.segment_reduce_cm, long_rows, long_offs)
    offs = long_offs.tolist()
    g = next(g for g in range(5, len(offs) - 1)
             if offs[g + 1] - offs[g] >= 3 and offs[g] % 32 > 0
             and offs[g + 1] < long_rows.shape[0])
    bad = long_rows.clone()
    bad[offs[g] + 1, 3], bad[offs[g] + 1, 7] = float("nan"), float("inf")
    bad[offs[g] + 1, 10] = -float("inf")
    dirty = rt.segment_reduce_rows(bad, long_offs)
    torch.cuda.synchronize()
    torch.testing.assert_close(dirty, rt.segment_reduce_rows_plain(
        bad, long_offs), rtol=0, atol=0, equal_nan=True)
    others = torch.arange(len(offs) - 1, device=dev) != g
    torch.testing.assert_close(dirty[others], clean[others], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(dirty[g, 3]) and float(dirty[g, 7]) == float("inf")
    assert float(dirty[g, 10]) == -float("inf")
    for mode in ("gather", "scatter", "sort"):
        monkeypatch.setenv("GSCREAM_REORDER", mode)
        assert torch.equal(rt.segment_reduce_grads(rows, b), got), mode
    cm = rt.segment_reduce_cm(rt.emission_columns(rows, b), b.offsets)
    assert torch.equal(cm, got)
    odd = torch.randn((1000, 16), device=dev)
    offs = torch.tensor([0, 3, 3, 700, 1500], dtype=torch.int32, device=dev)
    assert torch.equal(rt.segment_reduce_rows(odd, offs),
                       rt.segment_reduce_rows_plain(odd, offs))


def _close_to_cpu(got, ref, name, atol=5e-3, rtol=2e-2, flip_rel=5e-2,
                  flip_share=5e-3):
    """``tests/test_torch_train_step.py``'s tolerance: within ``atol·scale
    + rtol·|ref|`` (scale = max |ref|) except ≤ 0.5% of the elements,
    which must lie within ``flip_rel·scale``."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all()), name
    if ref.numel() == 0:
        return
    scale = max(float(ref.abs().max()), 1e-30)
    err = (got - ref).abs()
    bad = err > atol * scale + rtol * ref.abs()
    assert int(bad.sum()) <= max(2, flip_share * ref.numel()), name
    assert float(err.max()) <= flip_rel * scale, name


def _training_state(device, seed=81):
    """A seeded port state (200 anchors of capacity 256, feat_dim 8, 2
    offsets, random features, offsets and statistics that densify)."""
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, \
        init_scaffold
    from gscream_tpu_torch.train.state import init_train_state
    cfg = ScaffoldConfig(feat_dim=8, n_offsets=2, voxel_size=0.01,
                         capacity=256)
    rng = np.random.default_rng(seed)
    st = init_scaffold(rng.normal(0, 0.6, (200, 3)).astype(np.float32), cfg,
                       torch.Generator().manual_seed(seed), device=device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    C, k = cfg.capacity, cfg.n_offsets
    st = st._replace(params=st.params._replace(
        feat=t(rng.normal(0, 0.3, (C, 8))),
        offset=t(rng.normal(0, 0.5, (C, k, 3)))))
    ts = init_train_state(st, cfg)
    denom = rng.integers(0, 100, (C, k))
    ts = ts._replace(stats=ts.stats._replace(
        offset_denom=t(denom),
        offset_grad_accum=t(denom * 10.0 ** rng.uniform(-5, -2.5, (C, k))),
        anchor_demon=t(rng.integers(0, 100, (C, 1))),
        opacity_accum=t(rng.uniform(0, 30, (C, 1)))))
    return cfg, ts


def test_phase2_step_and_densify_match_cpu(dev, monkeypatch):
    """One phase-2 ``train_step`` (reference view, tokens sampled) and one
    ``adjust_anchors`` on the card against the same calls on the CPU,
    from the same state and the same draws: counts, ``cross_ok``,
    ``alive``, the anchors and the integer statistics bit-equal; the
    loss at rtol 1e-5; moments, parameters and the other statistics
    within ``train_step``'s tolerance."""
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model import densify
    from gscream_tpu_torch.train import step as port_step
    from gscream_tpu_torch.train.state import named_params
    w, h = 160, 96
    rng = np.random.default_rng(82)
    gt = rng.uniform(0.2, 0.8, (3, h, w)).astype(np.float32)
    mask = np.zeros((1, h, w), np.float32)
    mask[:, h // 4:3 * h // 4, w // 3:2 * w // 3] = 1.0
    midas = (0.1 + 0.8 * np.linspace(0, 1, w, dtype=np.float32)[None, None]
             + 0.02 * rng.normal(size=(1, h, w))).astype(np.float32)
    fg = np.zeros((h, w), np.float32)
    fg[h // 8:7 * h // 8, w // 4:3 * w // 4] = 1.0
    pri = (rng.uniform(size=256), rng.uniform(size=256))
    keep = [rng.uniform(size=512) for _ in range(3)]
    out = []
    for device in ("cpu", dev):
        def t(x, dt=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        monkeypatch.setattr(port_step, "token_priorities",
                            lambda ts, n: (t(pri[0]), t(pri[1])))
        monkeypatch.setattr(densify, "keep_draw",
                            lambda gen, n, level, d: t(keep[level]))
        cfg, ts = _training_state(device)
        dens = densify.adjust_anchors(ts.scaffold, ts.stats, ts.m, ts.v,
                                      None, cfg, check_interval=100)
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                          1.0 * h / w, w, h, device=device)
        ts1, aux = port_step.train_step(
            ts, cam, t(gt), t(mask), t(midas), t(fg),
            t([0, h, 0, w], torch.int32), cfg=cfg, opt=OptimConfig(),
            is_ref=True, use_crossattn=True, capacity=1 << 14, width=w,
            height=h, accumulate=True)
        out.append((ts1, aux, dens))
    (c_ts, c_aux, c_dens), (g_ts, g_aux, g_dens) = out
    assert bool(c_aux.cross_ok) and bool(g_aux.cross_ok)
    g_vals, c_vals = (port_step.aux_values(a) for a in (g_aux, c_aux))
    assert g_vals[2:] == c_vals[2:]
    np.testing.assert_allclose(g_vals[:2], c_vals[:2], rtol=1e-5)
    assert g_ts.step == c_ts.step == 1 and g_ts.step_c == c_ts.step_c == 1
    for f in ("anchor_demon", "offset_denom"):
        assert torch.equal(getattr(g_ts.stats, f).cpu(),
                           getattr(c_ts.stats, f)), f
    _close_to_cpu(g_ts.stats.offset_grad_accum, c_ts.stats.offset_grad_accum,
                  "offset_grad_accum")
    pg, pc = named_params(g_ts.scaffold), named_params(c_ts.scaffold)
    for name in pc:
        _close_to_cpu(g_ts.m[name], c_ts.m[name], f"m {name}")
        _close_to_cpu(g_ts.v[name], c_ts.v[name], f"v {name}")
        _close_to_cpu(pg[name], pc[name], name)
    (gsc, gst, gm, gv), (csc, cst, cm, cv) = g_dens, c_dens
    assert torch.equal(gsc.alive.cpu(), csc.alive)
    assert int((csc.alive & ~c_ts.scaffold.alive).sum()) > 0
    assert torch.equal(gsc.params.anchor.cpu(), csc.params.anchor)
    for f, x, y in zip(gst._fields, gst, cst):
        assert torch.equal(x.cpu(), y), f
    for f, x, y in zip(gsc.params._fields, gsc.params, csc.params):
        _close_to_cpu(x, y, f, atol=1e-6, rtol=1e-6)


def test_evaluate_pairs_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """``evaluate_pairs`` on the card equals the CPU's on the same renders
    (the synthetic scene's oracle renders against noisy copies, seeded
    random LPIPS weights), every key present, within ``chip_smoke.py``'s
    phase-(g) tolerances: PSNR 1e-4 dB, SSIM 1e-6, LPIPS rtol 1e-4."""
    import chip_smoke as cs
    from gscream_tpu_torch.data.synthetic import make_scene
    from gscream_tpu_torch.train.evaluate import evaluate_pairs
    weights = tmp_path / "lpips_random.npz"
    cs.random_lpips_weights(str(weights))
    monkeypatch.setenv("GSCREAM_LPIPS_WEIGHTS", str(weights))
    views = make_scene(n_views=3, n_gauss=300, width=96, height=80,
                       device="cpu").views
    rng = np.random.default_rng(4)
    gts = [v.image for v in views]
    renders = [np.clip(g + rng.normal(0, 0.05, g.shape), 0, 1)
               .astype(np.float32) for g in gts]
    masks = [v.mask for v in views]
    card = evaluate_pairs(renders, gts, masks, device=dev)
    cpu = evaluate_pairs(renders, gts, masks, device="cpu")
    assert set(cpu["summary"]) == set(cs.RESULT_KEYS)
    for name, row in cpu["per_view"].items():
        cs.check_scores(card["per_view"][name], row, cs.EVAL_PSNR_ATOL,
                        cs.EVAL_SSIM_ATOL, cs.EVAL_LPIPS_RTOL, name)
