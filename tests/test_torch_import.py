"""The port stands alone: with ``jax`` made unimportable, the package,
every submodule (the training loop, phase 2, densification, the
checkpoints, the synthetic data, the evaluation with LPIPS, the Blender
reader, the video, visualization and snapshot utilities, and the
sharded training's mesh, collectives, band losses, sharded step and
rank functions among them),
``chip_smoke.py``, ``render_torch.py``, ``train_torch.py`` and
``evaluate_torch.py`` import, and no module of the JAX package gets
loaded."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import gscream_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    gscream_tpu_torch.__path__, "gscream_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"gscream_tpu_torch.parallel." + m for m in (
    "mesh", "distributed", "band_loss", "shard", "workers")} <= set(names)
import chip_smoke, evaluate_torch, render_torch, train_torch
bad = sorted(m for m in sys.modules
             if m == "gscream_tpu" or m.startswith("gscream_tpu.")
             or m == "jax" and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 48
