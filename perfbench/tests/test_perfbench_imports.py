"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``gscream_tpu`` (the JAX package; ``gscream_tpu_torch``, the
port, is another name), and the reference nothing of the port."""
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

import run as bench_run

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
sys.modules["tensorboard"] = None
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=BENCH, root=ROOT,
                                            body=body)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = loaded(
        "import run; run.set_environment()\n"
        "from harness import train_cell, render_cell, compare, faults\n"
        "import gscream_tpu_torch.train.loop, "
        "gscream_tpu_torch.train.render_sets\n")
    assert "gscream_tpu_torch" in mods
    assert not mods & set(bench_run.FORBIDDEN), mods & set(
        bench_run.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from reference import step, blend, losses, attention, "
                  "optim, draws, model, project\n")
    assert not mods & ({"gscream_tpu_torch"} | set(bench_run.FORBIDDEN))


def test_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gscream_tpu_torch_probe", sys)
    assert "gscream_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in bench_run.forbidden_modules()


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        return
    rc = bench_run.main(["--workload", "spinnerf.train_p1", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
