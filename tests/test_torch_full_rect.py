"""Port parity: full-rect emission and ``render_tiled`` against the JAX
package on the CPU.

* ``GSCREAM_TIGHT_CULL=0``: the preprocess keeps the reference's 3σ
  rects and returns no ``t_iso`` (projection.py:331), in both packages.
* Full-rect binning (``GSCREAM_ROW_TIGHT=0`` on tight splats, or splats
  without ``t_iso``; binning.py:489-531): ``emission_counts``,
  ``overflow_demand`` and every ``Binning`` index field bit-equal to the
  JAX package's XLA build, at a capacity that fits and at one that
  overflows.  The port computes the slot → gaussian map as JAX does (a
  scatter-max and a running max), so the fields agree at every slot,
  past the live instances too.
* ``render_tiled`` (rasterize_tiled.py:1295): the image and the gradient
  of a random cotangent to the world-space means, by default and under
  ``GSCREAM_TIGHT_CULL=0``.  Tolerances: the image as in
  ``tests/test_torch_rasterize_fwd.py`` (1e-4, at most 0.1% of the
  pixels beyond it), the gradient by the flip-aware bound of
  ``tests/test_rasterize_tiled.py`` (its preprocess floats agree to rtol
  1e-5, ``tests/test_torch_scaffold_projection.py``).

The JAX binning runs under a ``jax.jit`` of its own with ``row_tight``
passed as the static argument that its environment variable sets, so no
trace of another test's mode is reused.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, assert_close_flip_aware,
                                     gaussian_scene, jax_splats, to_torch,
                                     torch_splats)

W, H = 128, 96
CAPS = (1 << 14, 1024)      # fits; overflows


def _cameras():
    from gscream_tpu_torch.cameras import make_camera
    from tests.utils import random_camera
    return (random_camera(width=W, height=H),
            make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, W, H,
                        device="cpu"))


def _jbin(s, cap, row_tight="auto"):
    from gscream_tpu.ops.binning import bin_instances as jbin
    fn = jax.jit(functools.partial(jbin.__wrapped__, capacity=cap, width=W,
                                   height=H, tile_w=TW, tile_h=TH,
                                   row_tight=row_tight, expand="xla"))
    return jax.tree.map(np.asarray, fn(s))


FIELDS = ("gauss_id", "tile_id", "tile_start", "tile_count",
          "num_instances", "emit_slot", "offsets", "num_rows")


@pytest.mark.timeout(120)
def test_tight_cull_off_matches_jax(monkeypatch):
    """Under ``GSCREAM_TIGHT_CULL=0`` the port's ``Splats`` equal JAX's:
    ``t_iso`` ``None`` on both, the rects the 3σ ones, bit-equal."""
    import gscream_tpu.ops.projection as jproj
    from gscream_tpu_torch.ops.projection import preprocess
    monkeypatch.setenv("GSCREAM_TIGHT_CULL", "0")
    m, sc, q, _, op, _ = gaussian_scene(4)
    jcam, tcam = _cameras()
    js = jproj.preprocess(jnp.asarray(m), jnp.asarray(sc), jnp.asarray(q),
                          jcam.w2c, jcam.full_proj, W, H, jcam.tan_fovx,
                          jcam.tan_fovy, tile_w=TW, tile_h=TH,
                          opacity=jnp.asarray(op))
    ts = preprocess(to_torch(m), to_torch(sc), to_torch(q), tcam.w2c,
                    tcam.full_proj, W, H, tcam.tan_fovx, tcam.tan_fovy,
                    tile_w=TW, tile_h=TH, opacity=to_torch(op))
    assert js.t_iso is None and ts.t_iso is None
    for f in ("radius", "rect_min", "rect_max"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("mean2d", "conic", "depth", "cov2d"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    # the rects are the reference's: wider than the tight ones
    monkeypatch.delenv("GSCREAM_TIGHT_CULL")
    tight = preprocess(to_torch(m), to_torch(sc), to_torch(q), tcam.w2c,
                       tcam.full_proj, W, H, tcam.tan_fovx, tcam.tan_fovy,
                       tile_w=TW, tile_h=TH, opacity=to_torch(op))
    assert tight.t_iso is not None
    area = (ts.rect_max - ts.rect_min).prod(1)
    assert int(area.sum()) > int((tight.rect_max - tight.rect_min)
                                 .prod(1).sum())


@pytest.fixture(scope="module")
def full_rect_splats():
    """Tight splats (``GSCREAM_ROW_TIGHT=0`` ignores their ``t_iso``) and
    splats without ``t_iso`` (a preprocess without ``opacity=``)."""
    import gscream_tpu.ops.projection as jproj
    from tests.utils import random_camera
    scene = gaussian_scene(6, thin=False)
    m, sc, q, _, op, _ = scene
    cam = random_camera(width=W, height=H)
    wide = jax.jit(lambda m, s, q: jproj.preprocess(
        m, s, q, cam.w2c, cam.full_proj, W, H, cam.tan_fovx, cam.tan_fovy,
        tile_w=TW, tile_h=TH))(jnp.asarray(m), jnp.asarray(sc),
                               jnp.asarray(q))
    assert wide.t_iso is None
    return {"row_tight_off": jax_splats(scene, W, H), "no_t_iso": wide}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("kind", ["row_tight_off", "no_t_iso"])
def test_full_rect_binning_bit_equal(full_rect_splats, monkeypatch, kind):
    from gscream_tpu.ops.binning import emission_counts as jcounts
    from gscream_tpu.ops.binning import overflow_demand as jdemand
    from gscream_tpu_torch.ops import binning as bn
    s = full_rect_splats[kind]
    ts = torch_splats(s)
    if kind == "row_tight_off":
        monkeypatch.setenv("GSCREAM_ROW_TIGHT", "0")
    assert bn.full_rect(ts)
    ni, nr = bn.emission_counts(ts, TW, TH)
    ji, jr = jcounts(s, TW, TH, 8)
    assert (int(ni), int(nr)) == (int(ji), int(jr)) and int(nr) == 0
    overflowed = False
    for cap in CAPS:
        a = _jbin(s, cap, row_tight=False)
        b = bn.bin_instances(ts, cap, W, H, TW, TH)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f"{f} at {cap}")
            assert getattr(b, f).dtype == torch.int32, f
        assert int(b.num_instances) == int(ni)
        demand = int(bn.overflow_demand(b))
        assert demand == int(jdemand(a)) == int(ni)
        overflowed |= demand > cap
    assert overflowed and int(ni) < CAPS[0]


@pytest.mark.timeout(180)
@pytest.mark.parametrize("tight_cull", ["1", "0"])
def test_render_tiled_matches_jax(monkeypatch, tight_cull):
    """``render_tiled`` end to end: the image, the aux counts and the
    gradient of a random cotangent on the colour to the means."""
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    monkeypatch.setenv("GSCREAM_TIGHT_CULL", tight_cull)
    m, sc, q, colors, op, unc = gaussian_scene(7, n=300, thin=False)
    jcam, tcam = _cameras()
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    cot = np.random.default_rng(8).normal(size=(H, W, 3)).astype(np.float32)
    cap = 1 << 13
    rest = (jnp.asarray(sc), jnp.asarray(q), jnp.asarray(colors),
            jnp.asarray(op), jnp.asarray(unc))

    def jloss(means):
        out, aux = jrt.render_tiled(means, *rest, jcam, jnp.asarray(bg),
                                    capacity=cap, interpret=True)
        return jnp.sum(out.color * cot), (out, aux)
    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(m))
    means = to_torch(m).requires_grad_()
    out, aux = rt.render_tiled(means, *(to_torch(x) for x in rest[:2]),
                               *(to_torch(x) for x in rest[2:]), tcam,
                               to_torch(bg), capacity=cap)
    torch.sum(out.color * to_torch(cot)).backward()
    assert (aux["splats"].t_iso is None) == (tight_cull == "0")
    assert int(aux["num_instances"]) == int(jaux["num_instances"]) <= cap
    assert aux["capacity"] == cap
    np.testing.assert_array_equal(aux["radius"].numpy(),
                                  np.asarray(jaux["radius"]))
    assert float(np.asarray(jout.final_t).mean()) < 0.9
    flips = np.zeros((H, W), bool)
    for f in ("color", "depth", "uncertainty", "final_t"):
        err = np.abs(getattr(out, f).detach().numpy()
                     - np.asarray(getattr(jout, f)))
        flips |= (err.max(-1) if err.ndim == 3 else err) > 1e-4
    assert flips.sum() <= 1e-3 * H * W
    assert np.abs(np.asarray(jg)).max() > 0
    assert_close_flip_aware(means.grad.numpy(), np.asarray(jg), "d means")
