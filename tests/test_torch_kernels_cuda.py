"""The port's CUDA kernels against their plain PyTorch versions on the
card: K5, K6, K4, K3, K7, K8, K9a and K9b bit-equal, K1 within
1e-4·max(1, |plain|) except
where the T < 1e-4 stop moves by one instance (≤ 0.1% of the outputs),
K2 per output lane within 1e-3·scale + 1e-2·|plain| (scale = max |plain|)
except ≤ 0.5% of the rows, all within 5e-2·scale (the sums run in other
orders, and Total − prefix cancels digits), and bit-equal on a rerun.

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


def _splats(dev, seed, n=800, w=160, h=96):
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops.projection import preprocess
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 6.0, n)], -1)
    scales = np.exp(rng.normal(-2.5, 1.0, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = 10.0 ** rng.uniform(-3, -0.02, n)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, w, h, device=dev)
    s = preprocess(t(means), t(scales), t(q), cam.w2c, cam.full_proj, w, h,
                   cam.tan_fovx, cam.tan_fovy, tile_w=32, tile_h=32,
                   opacity=t(op))
    extra = (t(rng.uniform(0, 1, (n, 3))), t(op), t(rng.uniform(0, 1, n)))
    return s, extra, w, h


def _k5_args(s, row_cap, w):
    from gscream_tpu_torch.ops.binning import _row_offsets
    return (_row_offsets(s), s.rect_min.contiguous(),
            s.rect_max.contiguous(), s.mean2d.contiguous(),
            s.conic.contiguous(), s.t_iso.contiguous(), s.depth.contiguous(),
            row_cap, 32, 32, -(-w // 32))


@pytest.mark.parametrize("seed,capacity", [(0, 1 << 14), (1, 512)])
def test_expand_kernels_bit_equal(dev, seed, capacity):
    from gscream_tpu_torch.ops import emission as em
    s, _, w, h = _splats(dev, seed)
    args = _k5_args(s, capacity // 2, w)
    rows = em.expand_gauss_rows(*args)
    torch.cuda.synchronize()
    assert torch.equal(rows, em.expand_gauss_rows_plain(*args))
    ioffs = (rows[3].cumsum(0) - rows[3]).int()
    n_tiles = -(-w // 32) * -(-h // 32)
    inst = em.expand_rows(rows, ioffs, capacity, n_tiles)
    torch.cuda.synchronize()
    assert torch.equal(inst, em.expand_rows_plain(rows, ioffs, capacity,
                                                  n_tiles))


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


def _backward_inputs(dev, seed):
    """K2's inputs as the backward builds them: the K1 records, and the
    pixel rows from K1's outputs and seeded cotangents."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops.binning import bin_instances
    s, (colors, op, unc), w, h = _splats(dev, seed)
    b = bin_instances(s, 1 << 14, w, h, 32, 32)
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
    for lane in range(16):
        a, r = got[:n, lane].double(), ref[:n, lane].double()
        scale = max(float(r.abs().max()), 1e-30)
        err = (a - r).abs()
        assert float((err > 1e-3 * scale + 1e-2 * r.abs()).double().mean()
                     ) <= 5e-3, lane
        assert float(err.max()) <= 5e-2 * scale, lane


def test_unpack_and_segment_reduce_bit_equal(dev):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops import shuffle as sh
    args, b = _backward_inputs(dev, 1)
    rows = rt.run_backward(*args)
    cols = sh.unpack_columns(rows)
    torch.cuda.synchronize()
    assert torch.equal(cols, sh.unpack_columns_plain(rows))
    ge = rt.emission_columns(rows, b)
    got = rt.segment_reduce_cm(ge, b.offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, rt.segment_reduce_cm_plain(ge, b.offsets))
    assert float(got[:, 6].abs().max()) > 0
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
    equal to it, and K7 at a ragged width with offsets past the capacity
    (clamped)."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    args, b = _backward_inputs(dev, 1)
    rows = rt.run_backward(*args)
    ge = rows[torch.sort(b.emit_slot.long(), stable=True).indices]
    got = rt.segment_reduce_rows(ge, b.offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, rt.segment_reduce_rows_plain(ge, b.offsets))
    assert float(got[:, 6].abs().max()) > 0
    for mode in ("gather", "scatter", "sort"):
        monkeypatch.setenv("GSCREAM_REORDER", mode)
        assert torch.equal(rt.segment_reduce_grads(rows, b), got), mode
    cm = rt.segment_reduce_cm(rt.emission_columns(rows, b), b.offsets)
    assert torch.equal(cm, got)
    odd = torch.randn((1000, 16), device=dev)
    offs = torch.tensor([0, 3, 3, 700, 1500], dtype=torch.int32, device=dev)
    assert torch.equal(rt.segment_reduce_rows(odd, offs),
                       rt.segment_reduce_rows_plain(odd, offs))
