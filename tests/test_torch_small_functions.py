"""Port parity: the JAX package's small public functions and their
counterparts in the port, on seeded inputs.

Tolerances: ``l2_loss`` and ``inverse_depth_smoothness`` rtol 1e-6 (one
float32 mean each, summed in other orders); ``visible_filter`` equal and
``position2d_filter``'s pixel coordinates rtol 1e-5 (the preprocess of
``tests/test_torch_scaffold_projection.py``); ``ndc2pix`` bit-equal (the
same three float32 operations); ``rotmat2qvec`` 1e-12 (the same float64
eigen-solve); ``estimate_voxel_size`` rtol 1e-4 (the KNN distances of
``tests/test_torch_scaffold_projection.py``); ``n_alive`` equal;
``ewa_cov2d`` within ``tests/test_projection.py``'s cov2d bounds (rtol
2e-4, atol 1e-4) and ``tile_rect`` equal, JAX's
``test_tile_rect_covers_center`` case among them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import gaussian_scene, to_torch

W, H = 96, 64


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match(masked):
    from gscream_tpu.ops import losses as jl
    from gscream_tpu_torch.ops import losses as tl
    rng = np.random.default_rng(31)
    a, b = (rng.uniform(0, 1, (3, H, W)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(float(tl.l2_loss(to_torch(a), to_torch(b))),
                               float(jl.l2_loss(jnp.asarray(a),
                                                jnp.asarray(b))), rtol=1e-6)
    idepth = rng.uniform(0.1, 1, (H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.4).astype(np.float32)
    m_t = to_torch(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    got = tl.inverse_depth_smoothness(to_torch(idepth), to_torch(a), m_t)
    ref = jl.inverse_depth_smoothness(jnp.asarray(idepth), jnp.asarray(a),
                                      m_j)
    assert float(ref) > 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_filters_match():
    from gscream_tpu.ops import projection as jp
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops import projection as tp
    from tests.utils import random_camera
    m, s, q, _, _, _ = gaussian_scene(12)
    m[:20, 2] = -1.0                            # behind the camera
    jcam = random_camera(width=W, height=H)
    tcam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, W, H,
                       device="cpu")
    jargs = [jnp.asarray(x) for x in (m, s, q)]
    targs = [to_torch(x) for x in (m, s, q)]
    vis = tp.visible_filter(*targs, tcam)
    np.testing.assert_array_equal(vis.numpy(),
                                  np.asarray(jp.visible_filter(*jargs,
                                                               jcam)))
    assert 0 < int(vis.sum()) < m.shape[0]
    got = tp.position2d_filter(*targs, tcam, 1.5)
    ref = jp.position2d_filter(*jargs, jcam, 1.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


def test_camera_helpers_match():
    from gscream_tpu import cameras as jc
    from gscream_tpu_torch import cameras as tc
    v = np.linspace(-1.3, 1.3, 101).astype(np.float32)
    np.testing.assert_array_equal(tc.ndc2pix(to_torch(v), W).numpy(),
                                  np.asarray(jc.ndc2pix(jnp.asarray(v), W)))
    rng = np.random.default_rng(32)
    for _ in range(5):
        qv = rng.normal(size=4)
        qv /= np.linalg.norm(qv)
        R = jc.qvec2rotmat(qv)
        got = tc.rotmat2qvec(R)
        np.testing.assert_allclose(got, jc.rotmat2qvec(R), atol=1e-12)
        np.testing.assert_allclose(got, qv * np.sign(qv[0]), atol=1e-9)


def test_voxel_size_and_alive_match():
    from gscream_tpu.model.scaffold import n_alive as jn
    from gscream_tpu.ops.knn import estimate_voxel_size as jv
    from gscream_tpu_torch.model.scaffold import n_alive
    from gscream_tpu_torch.ops.knn import estimate_voxel_size
    from tests.test_torch_common import scaffold_numpy
    rng = np.random.default_rng(33)
    for n in (300, 301):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_allclose(float(estimate_voxel_size(to_torch(pts))),
                                   float(jv(jnp.asarray(pts))), rtol=1e-4)
    _, st, _, _, alive = scaffold_numpy(
        34, 150, dict(feat_dim=8, n_offsets=2, voxel_size=0.05,
                      capacity=256))
    got = n_alive(st._replace(alive=to_torch(alive)))
    assert got.dtype == torch.int32
    assert int(got) == int(jn(st)) == int(alive.sum()) < 256


def test_ewa_cov2d_and_tile_rect_match():
    """``ewa_cov2d`` and ``tile_rect`` against JAX's on seeded gaussians
    (some outside the frustum clamp), and JAX's own
    ``test_tile_rect_covers_center`` case; ``preprocess``'s cov2d is the
    public function's on the gaussians in front of the near plane."""
    from gscream_tpu.ops import projection as jp
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.ops import projection as tp
    from tests.utils import random_camera, random_gaussians
    rng = np.random.default_rng(35)
    m, s, q, *_ = (np.array(x) for x in random_gaussians(rng, n=150))
    m[:10, :2] *= 6.0                           # past the 1.3·tan clamp
    jcam = random_camera(width=W, height=H)
    tcam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, W, H,
                       device="cpu")
    fx = W / (2.0 * float(jcam.tan_fovx))
    fy = H / (2.0 * float(jcam.tan_fovy))
    cov3d = np.asarray(jp.build_cov3d(jnp.asarray(s), jnp.asarray(q)))
    pv = np.asarray(jp.project_points(jnp.asarray(m), jcam.w2c,
                                      jcam.full_proj)[0])
    ref = jp.ewa_cov2d(jnp.asarray(m), jnp.asarray(pv), jnp.asarray(cov3d),
                       jcam.w2c, fx, fy, jcam.tan_fovx, jcam.tan_fovy)
    got = tp.ewa_cov2d(to_torch(m), to_torch(pv), to_torch(cov3d), tcam.w2c,
                       fx, fy, tcam.tan_fovx, tcam.tan_fovy)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=1e-4)
    sp = tp.preprocess(to_torch(m), to_torch(s), to_torch(q), tcam.w2c,
                       tcam.full_proj, W, H, tcam.tan_fovx, tcam.tan_fovy)
    np.testing.assert_allclose(sp.cov2d.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)

    mean2d = rng.uniform(-40, W + 40, (300, 2)).astype(np.float32)
    radius = rng.integers(0, 60, 300).astype(np.int32)
    for tw, th in ((16, 16), (32, 32)):
        want = jp.tile_rect(jnp.asarray(mean2d), jnp.asarray(radius), W, H,
                            tw, th)
        have = tp.tile_rect(to_torch(mean2d), to_torch(radius), W, H, tw, th)
        for g, r in zip(have, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    # JAX's test_tile_rect_covers_center, on the port
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 64, 64,
                      device="cpu")
    one = tp.preprocess(torch.tensor([[0.0, 0.0, 2.0]]),
                        torch.full((1, 3), 0.05),
                        torch.tensor([[1.0, 0.0, 0.0, 0.0]]), cam.w2c,
                        cam.full_proj, 64, 64, cam.tan_fovx, cam.tan_fovy,
                        tile_w=16, tile_h=16)
    rmin, rmax = tp.tile_rect(one.mean2d, one.radius, 64, 64, 16, 16)
    assert torch.equal(rmin, one.rect_min) and torch.equal(rmax,
                                                           one.rect_max)
    cx, cy = float(one.mean2d[0, 0]), float(one.mean2d[0, 1])
    assert rmin[0, 0] <= cx // 16 < rmax[0, 0]
    assert rmin[0, 1] <= cy // 16 < rmax[0, 1]
