"""``run_torch.py``, the port's experiment runner, against
``scripts/run.py``: JAX's three watchdog cases
(``tests/test_watchdog.py``) with stub children against
``run_torch.run_with_watchdog``, and the per-scene command, which must
be ``scripts/run.py``'s with ``train.py`` replaced by
``train_torch.py``, for a data root holding one scene (the others
skipped)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from run_torch import run_with_watchdog  # noqa: E402


def test_healthy_child_passes_through(tmp_path):
    log = str(tmp_path / "a.log")
    rc = run_with_watchdog(
        [sys.executable, "-c", "print('done')"], log,
        str(tmp_path / "no_ckpt"), stall_s=30, poll_s=0.2)
    assert rc == 0
    assert "done" in open(log).read()


def test_stalled_child_killed_and_restarted(tmp_path):
    log = str(tmp_path / "b.log")
    ckpt = tmp_path / "ckpt"
    ckpt.write_bytes(b"")             # the port's checkpoint is one file
    marker = tmp_path / "ran_twice"
    # first run: prints then hangs silently; the restart (which gets
    # --start_checkpoint appended) sees the marker and exits cleanly
    child = (
        "import os, sys, time\n"
        f"m = {str(marker)!r}\n"
        "if os.path.exists(m) or '--start_checkpoint' in sys.argv:\n"
        "    print('resumed ok'); sys.exit(0)\n"
        "open(m, 'w').close()\n"
        "print('hanging', flush=True)\n"
        "time.sleep(300)\n"
    )
    rc = run_with_watchdog([sys.executable, "-c", child], log, str(ckpt),
                           stall_s=5, max_restarts=2, poll_s=0.3)
    assert rc == 0
    txt = open(log).read()
    assert "hanging" in txt and "watchdog restart 1" in txt
    assert "resumed ok" in txt


def test_gives_up_after_max_restarts(tmp_path):
    log = str(tmp_path / "c.log")
    rc = run_with_watchdog(
        [sys.executable, "-c", "import time; time.sleep(300)"], log,
        str(tmp_path / "no_ckpt"), stall_s=1, max_restarts=1, poll_s=0.2)
    assert rc == 1


def test_scene_command_is_run_py_with_train_torch(tmp_path, monkeypatch,
                                                   capsys):
    import run_torch
    from scripts import run as jrun
    data = tmp_path / "data"
    (data / "book").mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jrun.time, "strftime", lambda fmt: "STAMP")
    got = {}

    def fake(name):
        def watchdog(cmd, log, ckpt, **kw):
            got[name] = (cmd, log, ckpt, kw)
            return 0
        return watchdog
    argv = ["run.py", str(data), "refs_dir", "out", "--eval_lpips", "1"]
    for name, mod in (("jax", jrun), ("port", run_torch)):
        monkeypatch.setattr(mod, "run_with_watchdog", fake(name))
        monkeypatch.setattr(sys, "argv", argv)
        mod.main()
    out = capsys.readouterr().out
    cmd, log, ckpt, kw = got["jax"]
    want = ["train_torch.py" if c == "train.py" else c for c in cmd]
    assert got["port"] == (want, log, ckpt, kw)
    assert cmd[1] == "train.py" and want[1] == "train_torch.py"
    assert cmd[-2:] == ["--eval_lpips", "1"]
    assert log == os.path.join("log_training", "book_STAMP.log")
    assert os.path.isdir(tmp_path / "log_training")
    for scene in run_torch.SCENES:
        if scene != "book":
            assert out.count(f"[skip] {scene}: no data at") == 2, scene
