"""``train_torch.py --synthetic --device cpu``: a dozen iterations on a
32×32 synthetic scene through phase 1, a densification and phase 2, with
a checkpoint; then ``render_torch.py --synthetic`` loads what it wrote
and renders both splits."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path):
    # two intra-op threads, as tests/test_torch_common.py's
    # two_torch_threads gives the in-process tests
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable] + args, cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=170)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.mark.timeout(180)
def test_train_then_render(tmp_path):
    model = str(tmp_path / "model")
    _run([os.path.join(ROOT, "train_torch.py"), "--synthetic",
          "--synthetic_size", "32", "--device", "cpu", "--iterations", "12",
          "--model_path", model, "--feat_dim", "8", "--n_offsets", "2",
          "--voxel_size", "0.1", "--anchor_capacity", "512",
          "--instance_capacity", "4096", "--start_crossattn_from", "8",
          "--checkpoint_interval", "6"], tmp_path)
    for f in ("cfg.json", "input.ply", "cameras.json", "metrics.jsonl",
              "synthetic.json", "checkpoint", "ckpt", "ckpt_meta.json",
              "point_cloud/iteration_12/point_cloud.ply",
              "point_cloud/iteration_12/mlp_checkpoints.npz",
              "test/renders/00000.png"):
        assert os.path.exists(os.path.join(model, f)), f
    with open(os.path.join(model, "cameras.json")) as f:
        assert len(json.load(f)) == 8           # 2 test + 6 train views
    with open(os.path.join(model, "metrics.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["step"] == 12 and last["loss"] == last["loss"]
    with open(os.path.join(model, "ckpt_meta.json")) as f:
        assert json.load(f)["iteration"] == 12
    r = _run([os.path.join(ROOT, "render_torch.py"), "--model_path", model,
              "--synthetic", "--device", "cpu", "--instance_capacity",
              "4096"], tmp_path)
    assert "test: 2 views" in r.stdout and "train: 6 views" in r.stdout
    assert "iteration 12" in r.stdout
    assert len(os.listdir(os.path.join(model, "train", "renders"))) == 6


def test_unported_modes_are_refused(tmp_path):
    import train_torch
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        train_torch.main(["--synthetic", "--eval", "--device", "cpu",
                          "--model_path", str(tmp_path)])
    (tmp_path / "transforms_train.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="Blender"):
        train_torch.main(["--source_path", str(tmp_path), "--device", "cpu",
                          "--model_path", str(tmp_path / "m")])


def test_entry_points_want_a_card(tmp_path):
    """``train_scene`` and ``train_torch.py`` run on the GPU unless told
    otherwise, and say so where there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would train")
    import train_torch
    from gscream_tpu_torch.config import RunConfig
    from gscream_tpu_torch.train.loop import train_scene
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_scene([], 0, None, RunConfig(), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_torch.main(["--synthetic", "--model_path", str(tmp_path)])
