"""Port parity: the row-tight expansion, K5 and K6, through their plain
twins on the CPU, against the JAX package.

``bin_instances`` against JAX's ``bin_instances(..., expand="full")``,
whose K5 and K6 are the Pallas kernels (interpret mode on the CPU), and
K5's own outputs (per-gaussian offsets, row demand, truncated instance
total) against JAX's XLA build, at a capacity that fits, one that
overflows the row table (``capacity // 2`` rows for ~620) and one that
overflows only the instance slots.  Every index field must be bit-equal;
``gauss_id`` and ``emit_slot`` over the live prefix, past which JAX leaves
don't-care values.
"""
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, gaussian_scene, jax_splats,
                                     torch_splats)

W, H = 160, 96
# seed 0, thin=False: 1,440 instances in 618 rows at 160x96
CAPS = {"fits": 1 << 14, "rows_overflow": 512, "instances_overflow": 1280}


def _scene(kind):
    """numpy scene (``gaussian_scene``) of 400 gaussians: ``base`` as it
    is, ``culled`` with every mean behind the camera, ``cover`` with
    gaussian 200 made one that covers the whole image."""
    means, scales, q, colors, op, unc = gaussian_scene(0, thin=False)
    if kind == "culled":
        means = means.copy()
        means[:, 2] = -means[:, 2]
    elif kind == "cover":
        means, scales, op = means.copy(), scales.copy(), op.copy()
        means[200] = (0.0, 0.0, 3.0)
        scales[200] = (6.0, 6.0, 6.0)
        op[200] = 0.99
    return means, scales, q, colors, op, unc


@pytest.fixture(scope="module")
def full_refs():
    """The scene's splats in both packages and JAX's ``expand="full"``
    binning at each capacity."""
    from gscream_tpu.ops.binning import bin_instances as jbin
    s = jax_splats(_scene("base"), W, H)
    refs = {cap: jax.tree.map(np.asarray,
                              jbin(s, cap, W, H, TW, TH, expand="full"))
            for cap in CAPS.values()}
    return torch_splats(s), refs


@pytest.mark.parametrize("case", list(CAPS))
def test_bin_instances_matches_pallas_expansion(full_refs, case):
    from gscream_tpu_torch.ops.binning import (ROW_RATIO, bin_instances,
                                               overflow_demand)
    ts, refs = full_refs
    cap = CAPS[case]
    a, b = refs[cap], bin_instances(ts, cap, W, H, TW, TH)
    n = min(int(a.num_instances), cap)
    assert n > 0
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
        assert getattr(b, f).dtype == torch.int32, f
    for f in ("gauss_id", "emit_slot"):
        np.testing.assert_array_equal(getattr(b, f).numpy()[:n],
                                      np.asarray(getattr(a, f))[:n],
                                      err_msg=f)
    rows, inst = int(b.num_rows), int(b.num_instances)
    assert int(overflow_demand(b)) == max(inst, ROW_RATIO * rows)
    if case == "rows_overflow":
        assert cap // ROW_RATIO < rows
    if case == "instances_overflow":
        assert cap // ROW_RATIO >= rows and cap < inst


@pytest.fixture(scope="module")
def xla_refs():
    """Per scene kind: the port's splats and JAX's XLA binning at each
    capacity."""
    from gscream_tpu.ops.binning import bin_instances as jbin
    out = {}
    for kind in ("base", "culled", "cover"):
        s = jax_splats(_scene(kind), W, H)
        out[kind] = (torch_splats(s), {
            cap: jax.tree.map(np.asarray,
                              jbin(s, cap, W, H, TW, TH, expand="xla"))
            for cap in CAPS.values()})
    return out


def _fields(ts):
    return (ts.radius, ts.rect_min, ts.rect_max, ts.mean2d, ts.conic,
            ts.t_iso, ts.depth)


@pytest.mark.parametrize("kind", ["base", "culled", "cover"])
def test_k5_offsets_and_counts_match_xla(xla_refs, kind):
    from gscream_tpu_torch.ops import emission as em
    from gscream_tpu_torch.ops.binning import row_table_size
    ts, refs = xla_refs[kind]
    heights = em.rect_heights(ts.radius, ts.rect_min, ts.rect_max)
    if kind == "culled":
        assert not bool((heights > 0).any())
    if kind == "cover":
        assert int(heights[200]) == -(-H // TH)
        assert int(ts.rect_max[200, 0] - ts.rect_min[200, 0]) == -(-W // TW)
    for cap, a in refs.items():
        row_cap = row_table_size(cap)
        t = em.expand_gauss_rows_plain(*_fields(ts), row_cap, cap, TW, TH,
                                       -(-W // TW))
        np.testing.assert_array_equal(t.offsets.numpy(), a.offsets,
                                      err_msg=f"offsets at {cap}")
        assert t.counts.tolist() == [int(a.num_rows),
                                     int(a.num_instances)], cap
        # the table's own invariants: ioffs is the prefix of w_row over the
        # live rows, both are zero past them, the total is the sum of w_row
        w = t.rows[3].long()
        live = min(int(a.num_rows), row_cap)
        np.testing.assert_array_equal(
            t.ioffs[:live].numpy(), (torch.cumsum(w, 0) - w)[:live].numpy())
        assert not bool(t.rows[:, live:].any())
        assert not bool(t.ioffs[live:].any())
        assert int(t.counts[1]) == int(w.sum())
        if kind == "culled":
            assert t.counts.tolist() == [0, 0]
            assert not bool(t.offsets.any())


@pytest.mark.parametrize("kind", ["base", "culled", "cover"])
def test_count_emission_matches_full_table(xla_refs, kind):
    from gscream_tpu.ops.binning import emission_counts as jcounts
    from gscream_tpu_torch.ops.binning import emission_counts
    ts, refs = xla_refs[kind]
    a = refs[CAPS["fits"]]
    ni, nr = emission_counts(ts, TW, TH)
    full = emission_counts(ts, TW, TH, max(int(a.num_rows), 1))
    assert (int(ni), int(nr)) == (int(full[0]), int(full[1])) == (
        int(a.num_instances), int(a.num_rows))
    s = jax_splats(_scene(kind), W, H)
    ji, jr = jax.jit(lambda s_: jcounts(
        s_, TW, TH, max(-(-int(nr) // 8) * 8, 8)))(s)
    assert (int(ji), int(jr)) == (int(ni), int(nr))
