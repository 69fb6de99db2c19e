"""Port parity: the binning's sort modes and its row ratio against the
JAX package's XLA build, fed the same JAX ``Splats``:

* ``precise=False`` (binning.py:549-561): the quantized int32 key on a
  grid of fewer than 2,047 tiles, the precise sort on a larger one;
* ``GSCREAM_SORT_FUSED=1`` (binning.py:299-312): JAX sorts on (tile,
  per-scene depth rank), the port keeps its precise sort, which gives
  the same order (JAX's docstring, :252-261);
* ``GSCREAM_ROW_RATIO=4`` (binning.py:52): the row table's size and the
  overflow demand, at a capacity that fits and one whose row table
  overflows.

Every index field is bit-equal; ``gauss_id`` and ``emit_slot`` over the
live prefix, past which the JAX build leaves don't-care values
(``tests/test_torch_binning.py``).  Each JAX binning runs under a
``jax.jit`` of its own, with the mode as its static argument (JAX reads
``ROW_RATIO`` at import: the test patches it for the span of the trace).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, gaussian_scene, jax_splats,
                                     torch_splats)


def _jbin(s, cap, w, h, **static):
    from gscream_tpu.ops.binning import bin_instances as jbin
    fn = jax.jit(functools.partial(jbin.__wrapped__, capacity=cap, width=w,
                                   height=h, tile_w=TW, tile_h=TH,
                                   expand="xla", **static))
    return jax.tree.map(np.asarray, fn(s))


def _compare(a, b, cap):
    n = min(int(a.num_instances), cap)
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
        assert getattr(b, f).dtype == torch.int32, f
    for f in ("gauss_id", "emit_slot"):
        np.testing.assert_array_equal(getattr(b, f).numpy()[:n],
                                      np.asarray(getattr(a, f))[:n],
                                      err_msg=f)
    return n


def _order_changed(a, b, n):
    return not np.array_equal(np.asarray(a.emit_slot)[:n],
                              b.emit_slot.numpy()[:n])


@pytest.mark.timeout(120)
@pytest.mark.parametrize("w,h", [(160, 96), (1600, 1344)])
def test_quantized_sort_matches_jax(w, h):
    """``precise=False``: 15 tiles take the quantized key (which reorders
    instances whose depths agree in their top bits), 2,100 tiles the
    precise sort."""
    from gscream_tpu_torch.ops.binning import bin_instances, num_tiles
    scene = list(gaussian_scene(9, n=600))
    # gaussians 0-99 copy 100-199, a hair deeper: the precise sort puts
    # each behind its twin, the quantized key (2^-12 relative) beside it
    # in emission order, in front
    scene[0][:100] = scene[0][100:200] * np.float32([1, 1, 1 + 1e-5])
    s = jax_splats(tuple(scene), w, h)
    ts = torch_splats(s)
    cap = 1 << 15
    a = _jbin(s, cap, w, h, precise=False)
    b = bin_instances(ts, cap, w, h, TW, TH, precise=False)
    n = _compare(a, b, cap)
    assert 0 < n < cap
    exact = bin_instances(ts, cap, w, h, TW, TH)
    if num_tiles(w, h, TW, TH) < 2047:
        assert _order_changed(a, exact, n)
    else:
        assert torch.equal(exact.emit_slot, b.emit_slot)


@pytest.mark.timeout(120)
def test_fused_sort_matches_jax(monkeypatch):
    """``GSCREAM_SORT_FUSED=1`` through ``build_binning``: the port's
    binning is bit-equal to JAX's fused build."""
    from gscream_tpu_torch.ops.rasterize_tiled import build_binning
    w, h, cap = 160, 96, 1 << 14
    scene = gaussian_scene(10)
    _, _, _, colors, op, unc = scene
    s = jax_splats(scene, w, h)
    ts = torch_splats(s)
    a = _jbin(s, cap, w, h, sort_mode="fused")
    monkeypatch.setenv("GSCREAM_SORT_FUSED", "1")
    monkeypatch.setenv("GSCREAM_EMIT", "pallas")      # the Pallas route
    b = build_binning(ts, *(torch.as_tensor(x) for x in (op, colors, unc)),
                      cap, w, h)                       # is not taken
    assert b.cols16 is None
    assert _compare(a, b, cap) > 0


@pytest.mark.timeout(120)
def test_row_ratio_matches_jax(monkeypatch):
    """``GSCREAM_ROW_RATIO=4``: a quarter-capacity row table, the row
    demand counted four times in ``overflow_demand``."""
    from gscream_tpu.ops import binning as jbinning
    from gscream_tpu_torch.ops import binning as bn
    w, h = 160, 96
    s = jax_splats(gaussian_scene(11, thin=True), w, h)
    ts = torch_splats(s)
    monkeypatch.setenv("GSCREAM_ROW_RATIO", "4")
    monkeypatch.setattr(jbinning, "ROW_RATIO", 4)
    assert bn.row_ratio() == 4 and bn.row_table_size(1024) == 256
    full = bn.bin_instances(ts, 1 << 14, w, h, TW, TH)
    rows = int(full.num_rows)
    cap = 4 * rows - 8                       # the row table overflows
    assert int(full.num_instances) < cap
    overflowed = False
    for c in (1 << 14, cap):
        a = _jbin(s, c, w, h)
        b = bn.bin_instances(ts, c, w, h, TW, TH)
        assert _compare(a, b, c) > 0
        demand = int(bn.overflow_demand(b))
        assert demand == int(jbinning.overflow_demand(a))
        assert demand == max(int(b.num_instances), 4 * rows)
        overflowed |= demand > c
    assert overflowed
