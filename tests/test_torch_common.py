"""Shared helpers of the PyTorch-port parity tests (no tests of its own).

Inputs are made with numpy from a seed and handed both to the JAX
package, run on the CPU, and to the port with ``device="cpu"``, where
every kernel wrapper takes its plain PyTorch version.
"""
import functools

import numpy as np
import pytest
import torch

TW = TH = 32

# One intra-op thread per test process.  The tier-1 run puts six xdist
# workers on the machine's cores beside XLA's threads; torch's OpenMP
# pool of one thread per core in every worker oversubscribes them, and
# its threads spin while they wait: four concurrent runs of
# tests/test_torch_blend_agreement.py took over 40 minutes for four of
# their five tests at the default, 16 s in all at one thread each (7 s
# and 9 s alone).  Every worker imports this module when it collects.
torch.set_num_threads(1)


def to_torch(x):
    """numpy / JAX array → CPU tensor (a writable copy)."""
    return torch.as_tensor(np.array(x))


def torch_splats(s):
    """JAX ``Splats`` → the port's ``Splats``."""
    from gscream_tpu_torch.ops.projection import Splats
    return Splats(*(None if x is None else to_torch(x) for x in s))


def torch_binning(b):
    """JAX ``Binning`` → the port's ``Binning`` (dropping the JAX-only
    ``attrs`` field; ``cols16`` stays ``None`` where JAX's is)."""
    from gscream_tpu_torch.ops.binning import Binning
    fields = (getattr(b, f) for f in Binning._fields)
    return Binning(*(None if x is None else to_torch(x) for x in fields))


def assert_close_flip_aware(got, ref, name, atol=2e-4, rtol=2e-3,
                            max_flips=2, flip_rel=2e-2):
    """``tests/test_rasterize_tiled.py::_assert_close_flip_aware``: every
    element within ``atol·scale + rtol·|ref|`` (scale = max |ref|) except
    at most ``max_flips``, which must still lie within ``flip_rel·scale``.
    An instance whose α or transmittance sits within a few ulps of a
    threshold (1/255, power ≤ 0, T < 1e-4) can flip between two float32
    evaluations and change every gradient its chain touches by O(α).
    Returns the worst absolute error over the scale."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), name
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = np.abs(got - ref)
    nbad = int((err > atol * scale + rtol * np.abs(ref)).sum())
    assert nbad <= max_flips, (f"{name}: {nbad} elements outside the tight "
                               f"tolerance (worst {err.max():.3e}, scale "
                               f"{scale:.3e})")
    assert err.max() < flip_rel * scale, (f"{name}: worst {err.max():.3e} "
                                          f"beyond the flip envelope")
    return float(err.max() / scale)


def gaussian_scene(seed, n=400, thin=True):
    """World-space gaussians in front of a +z camera: (means, scales,
    quats, colors, opacity, unc) as float32 numpy.  ``thin`` spreads the
    scales log-normally (rows where row-tight emission bites) and the
    opacities across the 1/255 edge."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 6.0, n)], -1).astype(np.float32)
    if thin:
        scales = np.exp(rng.normal(-2.8, 1.2, (n, 3))).astype(np.float32)
        op = (10.0 ** rng.uniform(-4, -0.02, n)).astype(np.float32)
    else:
        scales = rng.uniform(0.05, 0.4, (n, 3)).astype(np.float32)
        op = rng.uniform(0.05, 0.95, n).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    unc = rng.uniform(0, 1, n).astype(np.float32)
    return means, scales, q, colors, op, unc


@functools.lru_cache(maxsize=None)
def _jax_preprocess(width, height):
    import jax
    import gscream_tpu.ops.projection as jproj
    from tests.utils import random_camera
    cam = random_camera(width=width, height=height)

    @jax.jit
    def run(m, s, q, o):
        return jproj.preprocess(m, s, q, cam.w2c, cam.full_proj, width,
                                height, cam.tan_fovx, cam.tan_fovy,
                                tile_w=TW, tile_h=TH, opacity=o)
    return run


def jax_splats(scene, width, height):
    """The jitted JAX preprocess (tight culling on) of ``gaussian_scene``
    — the splats both packages are then fed."""
    import jax.numpy as jnp
    means, scales, q, colors, op, unc = scene
    return _jax_preprocess(width, height)(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q),
        jnp.asarray(op))


def scaffold_numpy(seed, n_points, cfg_kwargs):
    """A seeded JAX ``ScaffoldState`` with randomized features, offsets
    and anchor scales (as ``bench.py::_bench_scene``, drawn with numpy),
    plus the same state as numpy arrays for ``scaffold_from_numpy``."""
    import jax
    import jax.numpy as jnp
    from gscream_tpu.model.scaffold import ScaffoldConfig, init_scaffold
    rng = np.random.default_rng(seed)
    cfg = ScaffoldConfig(**cfg_kwargs)
    pts = rng.normal(0, 0.6, (n_points, 3)).astype(np.float32)
    st = init_scaffold(jax.random.PRNGKey(seed), pts, cfg)
    p = st.params
    p = p._replace(
        feat=jnp.asarray(0.3 * rng.normal(size=p.feat.shape), jnp.float32),
        offset=jnp.asarray(0.5 * rng.normal(size=p.offset.shape),
                           jnp.float32))
    st = st._replace(params=p)
    mlps = st.mlps._asdict()
    np_mlps = {name: [{k: np.asarray(v) for k, v in layer.items()}
                      for layer in mlps[name]]
               for name in ("opacity", "uncertainty", "cov", "color")}
    np_mlps["crossattn"] = [np.asarray(a) for a in mlps["crossattn"][:8]]
    np_params = {f: np.asarray(getattr(p, f)) for f in p._fields}
    return cfg, st, np_params, np_mlps, np.asarray(st.alive)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the module's PyTorch work, restored after.
    The test workers share the machine's cores; two processes whose
    PyTorch each spins a thread per core slow the port's many small CPU
    ops down some thirtyfold, where two threads each cost nothing alone
    (a module imports this fixture to use it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
