"""The check that K1 and K2 blend the same (instance, pixel) pairs,
proved on the CPU with the kernels' plain versions (no JAX, no card).

With every record's five channels (r, g, b, depth, unc) set to 1, K1's
row 1 at a pixel is Σ w over the instances it blends there; K2's lane
c + 1 of an instance, under a pixel cotangent c that is 1 at one pixel
alone, is that instance's w there.  So per (tile, pixel) the two give one
sum (``chip_smoke.blend_agreement``), held within the float32 rounding
of its terms, and on the card K1 bit-equal to K2's weights summed in
K1's order (``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``).
A pair that one side blends and the other does not moves the sum by its
w; these tests show that a single such pair fails the check.
"""
import numpy as np
import pytest
import torch

import tests.test_torch_common  # noqa: F401  (one torch thread: see there)
from chip_smoke import F32_UNIT, blend_agreement, check_agreement
from gscream_tpu_torch.ops import rasterize_tiled as rt

PIXELS = range(0, 1024, 17)     # 61 pixels of each tile, 13 backward calls


def _records(opaque: bool):
    """K1's inputs for 500 seeded gaussians at 160×96 (15 tiles)."""
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops.binning import bin_instances
    from gscream_tpu_torch.ops.projection import preprocess
    rng = np.random.default_rng(3)
    n, w, h = 500, 160, 96
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 6.0, n)], -1)
    scales = np.exp(rng.normal(-2.5, 1.0, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = np.full(n, 0.99) if opaque else 10.0 ** rng.uniform(-3, -0.02, n)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, w, h,
                      device="cpu")
    s = preprocess(t(means), t(scales), t(q), cam.w2c, cam.full_proj, w, h,
                   cam.tan_fovx, cam.tan_fovy, tile_w=32, tile_h=32,
                   opacity=t(op))
    b = bin_instances(s, 1 << 13, w, h, 32, 32)
    inst = rt.pack_instance_data(s.mean2d, s.conic, t(op),
                                 t(rng.uniform(0, 1, (n, 3))), s.depth,
                                 t(rng.uniform(0, 1, n)), b, -(-w // 32))
    return inst, b.tile_start, b.tile_count, b.tile_start.shape[0]


def _agree(args, backward=rt.run_backward_plain):
    return check_agreement(*args, rt.run_forward_plain, backward, "plain",
                           pixels=PIXELS, sequential=False)


@pytest.mark.parametrize("opaque", [False, True])
def test_plain_twins_agree(opaque):
    """The plain K1 and K2 make one set of decisions: at every checked
    (tile, pixel), on faint gaussians and on opacities of 0.99 (where
    most pixels stop early), K1's Σw lies within the float32 rounding
    limit of K2's weights."""
    args = _records(opaque)
    k1, seq, s64, n = blend_agreement(*args, rt.run_forward_plain,
                                      rt.run_backward_plain, PIXELS)
    assert k1.shape == (args[3], len(PIXELS)) and float(n.max()) > 1
    assert float(k1.sum(1).min()) > 0
    checked, ratio, _ = _agree(args)
    assert checked == k1.numel() and ratio <= 1.0


def test_check_sees_a_moved_stop(monkeypatch):
    """A backward whose stop sits at T < 2e-4 instead of 1e-4 (it blends
    fewer pairs than the forward) fails the check."""
    args = _records(True)

    def backward(*a):
        with monkeypatch.context() as m:
            m.setattr(rt, "T_STOP", 2e-4)
            return rt.run_backward_plain(*a)
    with pytest.raises(AssertionError, match="blend different pairs"):
        _agree(args, backward)


def _t_after(inst, start, count):
    """T after each instance of one tile at its 1024 pixels, and α, as the
    plain versions compute them."""
    x, y = rt._pixel_coords("cpu")
    d = inst[start:start + count]
    k0, k1, k2 = d[:, 6:7], d[:, 7:8], d[:, 8:9]
    k3, k4, k5 = d[:, 9:10], d[:, 10:11], d[:, 11:12]
    power = k0 + (k1 + k3 * x + k4 * y) * x + (k2 + k5 * y) * y
    alpha = torch.clamp_max(d[:, 0:1] * torch.exp(power), rt.ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & (alpha >= rt.ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    return torch.cumprod(1.0 - alpha, dim=0), alpha


@pytest.mark.parametrize("later", [False, True])
def test_check_sees_one_moved_pair(monkeypatch, later):
    """A backward that moves the stop of one checked (tile, pixel) by one
    instance, earlier (its last blended pair is dropped) or later (the
    pair that stopped it is blended), and makes every other decision as
    the forward does, fails the check.  The pair is the median by w of
    the checked pixels that stop (opacities 0.99)."""
    args = _records(True)
    inst, ts, tc, n_tiles = args
    cands = []
    for t in range(n_tiles):
        s, c = int(ts[t]), int(tc[t])
        if c == 0:
            continue
        ta, alpha = _t_after(inst, s, c)
        for q in PIXELS:
            stop = torch.nonzero((alpha[:, q] > 0) & (ta[:, q] < rt.T_STOP))
            blended = torch.nonzero((alpha[:, q] > 0) &
                                    (ta[:, q] >= rt.T_STOP))
            if not stop.numel() or not blended.numel():
                continue
            i = int(stop[0]) if later else int(blended[-1])
            t_before = 1.0 if i == 0 else float(ta[i - 1, q])
            thr = (float(ta[i, q]) if later else
                   float(np.nextafter(np.float32(ta[i, q]), np.inf)))
            cands.append((float(alpha[i, q]) * t_before, t, q, thr))
    assert len(cands) > 20
    w, t, q, thr = sorted(cands)[len(cands) // 2]
    stop = torch.full((1, 1024), rt.T_STOP)
    stop[0, q] = thr

    def backward(inst_, pix_, ts_, tc_, n_):
        rows = rt.run_backward_plain(inst_, pix_, ts_, tc_, n_)
        with monkeypatch.context() as m:
            m.setattr(rt, "T_STOP", stop)
            one = rt.run_backward_plain(inst_, pix_[t:t + 1], ts_[t:t + 1],
                                        tc_[t:t + 1], 1)
        s, c = int(ts_[t]), int(tc_[t])
        rows[s:s + c] = one[s:s + c]
        return rows
    k1, _, s64, n = blend_agreement(*args, rt.run_forward_plain, backward,
                                    PIXELS)
    moved = (k1.double() - s64).abs()
    col = list(PIXELS).index(q)
    # the pair's w, beside the float32 rounding of a Σw of at most 1
    assert float(moved[t, col]) == pytest.approx(w, abs=1e-6)
    others = torch.ones_like(moved, dtype=torch.bool)
    others[t, col] = False
    assert float(moved[others].max()) <= 2 * F32_UNIT * float(
        (n * s64).max())
    with pytest.raises(AssertionError, match="blend different pairs"):
        _agree(args, backward)
