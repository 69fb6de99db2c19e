"""Port parity: the rasterizer's backward — plain K2, K4, K3, the
per-gaussian chain and the whole ``rasterize_tiled`` VJP — against the
JAX package (Pallas in interpret mode), on one seeded scene of 300
overlapping gaussians at 64×32 with the JAX ``Binning``.

The JAX VJP is its custom_vjp's rule, ``_raster_fwd`` then
``_raster_bwd``'s steps written out, so one compiled program yields each
kernel's output and their composition without lowering a kernel twice.
``jax.value_and_grad`` through the custom_vjp itself is held against the
port's autograd end to end in ``tests/test_torch_train_step.py``.

Tolerances:
* K4 (unpack) copies values: bit-equal.
* K2 and the VJP: the flip-aware bound of ``tests/test_rasterize_tiled.py``
  (``atol 2e-4·scale + rtol 2e-3``, at most 2 elements outside it, all
  within ``2e-2·scale``).  The JAX kernel takes T as a log-domain scan
  and the suffix ``Total − prefix`` as matmuls; the port takes both
  sequentially, so a pixel's T < 1e-4 stop can move by one instance, and
  ``Total − prefix`` cancels digits where ``Total`` is large.
* K3: rtol 1e-5 + atol 1e-6·scale: the JAX kernel sums each run by an
  indicator matmul, the port in the chunked order of its module
  docstring.
* ``pergauss_chain``: the same float32 expressions, rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, assert_close_flip_aware,
                                     gaussian_scene, jax_splats, to_torch,
                                     torch_binning)

W, H = 64, 32
CAP = 1 << 13


@pytest.fixture(scope="module")
def case():
    """The JAX forward rule and ``_raster_bwd``'s steps on it: the
    kernels' outputs and the VJP they compose."""
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu.ops.binning import bin_instances as jbin
    from gscream_tpu.ops.shuffle import unpack_columns
    scene = gaussian_scene(3, n=300, thin=False)
    s = jax_splats(scene, W, H)
    b = jbin(s, CAP, W, H, TW, TH, expand="xla")
    assert int(b.num_instances) <= CAP
    _, _, _, colors, op, unc = scene
    args = (s.mean2d, s.conic, jnp.asarray(op), jnp.asarray(colors),
            s.depth, jnp.asarray(unc), jnp.asarray([0.1, 0.2, 0.3]))
    rng = np.random.default_rng(11)
    cot = jrt.TiledOut(*(jnp.asarray(rng.normal(size=sh), jnp.float32)
                         for sh in ((H, W, 3), (H, W), (H, W), (H, W))))
    n_tiles = (W // TW) * (H // TH)

    @jax.jit     # one compile for every reference below
    def reference(args, cot):
        # the custom_vjp's forward rule, then _raster_bwd (:1202-1250)
        # step by step, so that each kernel's output can be compared
        _, res = jrt._raster_fwd(*args[:6], b, args[6], W, H, True)
        inst, _, bg, raw_c, d_img, u_img, t_img, mean2d, conic, op = res
        gc = cot.color.transpose(2, 0, 1)
        gtt = (jnp.einsum('c,chw->hw', bg, gc) + cot.final_t) * t_img
        total = (jnp.einsum('chw,chw->hw', raw_c, gc) + d_img * cot.depth
                 + u_img * cot.uncertainty)
        pix = jnp.stack([gc[0], gc[1], gc[2], cot.depth, cot.uncertainty,
                         total, gtt, jnp.zeros_like(t_img)])
        pix_tiles = jrt.image_to_tiles(pix, W, H)
        raw = jrt._run_backward(inst, pix_tiles, b.tile_start, b.tile_count,
                                n_tiles, True, W // TW)
        # reduce_grads_cm (:1044-1084): rows past the capacity are never
        # written (its sanitize, :1073); the stable sort on the
        # permutation emit_slot is this scatter (:1097-1101)
        raw = jnp.where(jnp.isfinite(raw), raw, 0.0)
        cols = unpack_columns(raw, True)
        ge = jnp.zeros((16, CAP), jnp.float32).at[1:12, b.emit_slot].set(
            cols[1:12, :CAP])
        pg = jrt.segment_reduce_cm(ge, b.offsets, s.mean2d.shape[0], True)
        grads = jrt.pergauss_chain(pg, mean2d, conic, op) + (
            jnp.einsum('hw,chw->c', t_img, gc),)
        return grads, pix, pix_tiles, inst, raw, cols, ge, pg

    grads, *rest = reference(args, cot)
    pix, pix_tiles, inst, raw, cols, ge, pg = map(np.asarray, rest)
    return dict(args=args, b=b, cot=cot, grads=grads, pix=pix,
                pix_tiles=pix_tiles, inst=inst, raw=raw, cols=cols, ge=ge,
                pg=pg, n_tiles=n_tiles)


@pytest.mark.timeout(120)
def test_image_to_tiles_matches(case):
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    got = trt.image_to_tiles(to_torch(case["pix"]), W, H)
    np.testing.assert_array_equal(got.numpy(), case["pix_tiles"])


@pytest.mark.timeout(120)
def test_unpack_columns_bit_equal(case):
    """K4 plain against ``unpack_columns`` on the JAX K2's packed rows."""
    from gscream_tpu_torch.ops.shuffle import unpack_columns
    rec = to_torch(case["raw"].reshape(-1, 16))
    got = unpack_columns(rec)
    assert got.shape == (16, rec.shape[0])
    assert np.abs(case["cols"]).max() > 0
    np.testing.assert_array_equal(got.numpy(), case["cols"])


@pytest.mark.timeout(120)
def test_tile_backward_matches(case):
    """K2 plain against ``_run_backward`` on the same records and pixel
    rows; the slots past the live instances are zero in both."""
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    b = torch_binning(case["b"])
    inst = to_torch(case["inst"].reshape(-1, 16)[:CAP])
    got = trt.run_backward(inst, to_torch(case["pix_tiles"]), b.tile_start,
                           b.tile_count, case["n_tiles"]).numpy()
    ref = case["raw"].reshape(-1, 16)[:CAP]
    n = int(b.num_instances)
    assert np.abs(ref[:n, 6]).max() > 0           # moments were written
    worst = {lane: assert_close_flip_aware(got[:, lane], ref[:, lane],
                                           f"lane {lane}")
             for lane in range(1, 12)}
    assert not got[n:].any() and not ref[n:].any()
    assert not got[:, [0, 12, 13, 14, 15]].any()
    assert not ref[:, [0, 12, 13, 14, 15]].any()
    print("K2 worst |port - JAX| / max |JAX| per lane:", worst)


@pytest.mark.timeout(120)
def test_segment_reduce_matches(case):
    """K3 plain against ``segment_reduce_cm`` on the same emission-order
    columns."""
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    b = torch_binning(case["b"])
    got = trt.segment_reduce_cm(to_torch(case["ge"]), b.offsets).numpy()
    ref = case["pg"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.timeout(120)
def test_pergauss_chain_matches():
    from gscream_tpu.ops.rasterize_tiled import pergauss_chain as jchain
    from gscream_tpu_torch.ops.rasterize_tiled import pergauss_chain
    rng = np.random.default_rng(4)
    n = 500
    pg = rng.normal(size=(n, 16)).astype(np.float32)
    mean2d = rng.uniform(-50, 150, (n, 2)).astype(np.float32)
    conic = np.stack([rng.uniform(0.01, 2, n), rng.normal(0, 0.1, n),
                      rng.uniform(0.01, 2, n)], -1).astype(np.float32)
    op = rng.uniform(0, 1, n).astype(np.float32)
    ref = jchain(*(jnp.asarray(x) for x in (pg, mean2d, conic, op)))
    got = pergauss_chain(*(to_torch(x) for x in (pg, mean2d, conic, op)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(r)).max())


@pytest.mark.timeout(120)
def test_rasterize_vjp_matches_jax(case):
    """The port's autograd against the JAX ``rasterize_tiled`` VJP,
    cotangents on all four outputs, a non-zero background."""
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    leaves = [to_torch(a).requires_grad_() for a in case["args"]]
    out = trt.rasterize_tiled(*leaves[:6], torch_binning(case["b"]),
                              leaves[6], W, H)
    cot = [to_torch(c) for c in case["cot"]]
    torch.autograd.backward(list(out), cot)
    names = ("mean2d", "conic", "opacity", "colors", "depth", "unc", "bg")
    worst = {}
    for name, leaf, ref in zip(names, leaves, case["grads"]):
        worst[name] = assert_close_flip_aware(leaf.grad.numpy(),
                                              np.asarray(ref), name)
    assert np.abs(np.asarray(case["grads"][0])).max() > 0
    print("worst |port - JAX| / max |JAX| per gradient:", worst)
