"""The summation order of the per-gaussian segment reductions K3 and K7
(``gscream_tpu_torch/ops/rasterize_tiled.py``'s module docstring), on
their plain versions: both against an independent scalar reference of
that order, bit for bit, and against each other.

The case is made with numpy from a seed: runs of length 0, 1, 31, 32, 33,
64 and 100, some starting mid-chunk, a capacity that is not a multiple of
32, and offsets past it (one run clamped, the last ones clamped away).
No JAX here: the parity of the sums with the JAX package is held by
``tests/test_torch_raster_bwd.py`` and ``tests/test_torch_reorder_modes.py``
(rtol 1e-5).
"""
import numpy as np
import pytest
import torch

from gscream_tpu_torch.ops import rasterize_tiled as rt

RUNS = (3, 0, 1, 31, 0, 32, 33, 5, 64, 100, 1, 0, 7, 40, 2, 6, 9)
CAP = 301                       # cuts the run of 40 and clamps the rest
CHUNK = 32


def _case(seed=0):
    offsets = np.concatenate([[0], np.cumsum(RUNS)]).astype(np.int32)
    assert CAP % CHUNK and offsets[-1] > CAP
    vals = np.random.default_rng(seed).normal(size=(CAP, 16))
    return vals.astype(np.float32), offsets


def _reference(vals, offsets):
    """The order written out, one chunk, slot and step at a time, in
    float32 (each numpy float32 addition rounds once)."""
    cap = vals.shape[0]
    n = len(offsets) - 1
    n_live = min(int(offsets[-1]), cap)
    gauss = [None] * n_live
    for g in range(n):
        for e in range(offsets[g], min(offsets[g + 1], n_live)):
            gauss[e] = g
    partial = {}
    for base in range(0, n_live, CHUNK):
        slots = range(base, min(base + CHUNK, n_live))
        v = [vals[e].copy() for e in slots]
        for d in (1, 2, 4, 8, 16):
            prev = [x.copy() for x in v]
            for i, e in enumerate(slots):
                s = max(int(offsets[gauss[e]]), base) - base
                if i - d >= s:
                    v[i] = v[i] + prev[i - d]
        for i, e in enumerate(slots):       # the last slot wins
            partial[(gauss[e], base // CHUNK)] = v[i]
    out = np.zeros((n, 16), np.float32)
    for g in range(n):
        lo, hi = min(offsets[g], cap), min(offsets[g + 1], cap)
        if hi <= lo:
            continue
        acc = partial[(g, lo // CHUNK)]
        for c in range(lo // CHUNK + 1, (hi - 1) // CHUNK + 1):
            acc = acc + partial[(g, c)]
        out[g] = acc
    return out


def _twins(vals, offsets):
    rows = torch.from_numpy(vals)
    offs = torch.from_numpy(offsets)
    return (rt.segment_reduce_cm_plain(rows.T.contiguous(), offs),
            rt.segment_reduce_rows_plain(rows, offs))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("seed", [0, 1])
def test_twins_follow_the_order(seed):
    """Both plain versions equal the scalar reference bit for bit, and
    each other; the CPU wrappers take them."""
    vals, offsets = _case(seed)
    ref = _reference(vals, offsets)
    cm, rows = _twins(vals, offsets)
    assert rt.SEG_CHUNK == CHUNK
    np.testing.assert_array_equal(cm.numpy(), ref)
    np.testing.assert_array_equal(rows.numpy(), ref)
    assert torch.equal(cm, rows)
    offs = torch.from_numpy(offsets)
    assert torch.equal(rt.segment_reduce_rows(torch.from_numpy(vals), offs),
                       rows)
    lens = np.minimum(offsets[1:], CAP) - np.minimum(offsets[:-1], CAP)
    assert not ref[lens <= 0].any() and ref[lens > 0].all()


@pytest.mark.timeout(120)
def test_order_differs_from_left_to_right():
    """The chunked order is a different order: on this case it differs
    from a left-to-right float32 sum in at least one gaussian."""
    vals, offsets = _case()
    got = _twins(vals, offsets)[1].numpy()
    seq = np.zeros_like(got)
    for g in range(len(offsets) - 1):
        for e in range(offsets[g], min(offsets[g + 1], CAP)):
            seq[g] = seq[g] + vals[e]
    assert (got != seq).any()
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(120)
def test_non_finite_stays_in_its_gaussian():
    """A NaN, +inf and -inf in one instance of the run of 5 (which shares
    its chunk with the runs of 33 and 64): every other gaussian's sum
    equals the clean one, and that gaussian's is non-finite in those
    lanes only."""
    vals, offsets = _case()
    clean = _twins(vals, offsets)
    g = RUNS.index(5)
    e = int(offsets[g]) + 2
    assert (offsets[g] - 1) // CHUNK == offsets[g + 1] // CHUNK
    bad = vals.copy()
    bad[e, 3], bad[e, 7], bad[e, 10] = np.nan, np.inf, -np.inf
    others = np.arange(len(RUNS)) != g
    for got, ref in zip(_twins(bad, offsets), clean):
        torch.testing.assert_close(got[others], ref[others], rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(got[g, 3]) and got[g, 7] == np.inf
        assert got[g, 10] == -np.inf
        keep = [k for k in range(16) if k not in (3, 7, 10)]
        assert torch.equal(got[g, keep], ref[g, keep])
