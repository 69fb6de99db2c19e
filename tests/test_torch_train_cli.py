"""``train_torch.py --synthetic --device cpu``: a dozen iterations on a
32×32 synthetic scene through phase 1, a densification and phase 2, with
a checkpoint; then ``render_torch.py --synthetic`` loads what it wrote
and renders both splits.  With ``--test_iterations`` the evaluation
callback logs the test PSNR and image grids, and the run ends by writing
``results.json``, which ``render_torch.py --eval`` and
``evaluate_torch.py`` reproduce from the model directory; a
NeRF-synthetic (Blender) scene trains too."""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, **env):
    # two intra-op threads, as tests/test_torch_common.py's
    # two_torch_threads gives the in-process tests
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **env)
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


SMALL = ["--device", "cpu", "--feat_dim", "8", "--n_offsets", "2",
         "--voxel_size", "0.1", "--anchor_capacity", "512",
         "--instance_capacity", "4096"]


def _run_no_lpips(args, tmp_path):
    """``_run`` with no LPIPS weight file in reach: LPIPS must be null."""
    return _run(args, tmp_path, HOME=str(tmp_path), GSCREAM_LPIPS_WEIGHTS="")


@pytest.fixture(scope="module")
def evaluated_model(tmp_path_factory):
    """``train_torch.py --synthetic`` at 32×32 with the evaluation
    callback at iterations 6 and 12 and the final evaluation on."""
    tmp = tmp_path_factory.mktemp("evaluated")
    model = str(tmp / "model")
    _run_no_lpips([os.path.join(ROOT, "train_torch.py"), "--synthetic",
                   "--synthetic_size", "32", "--iterations", "12",
                   "--test_iterations", "6", "12", "--model_path", model]
                  + SMALL, tmp)
    return model, tmp


@pytest.mark.timeout(180)
def test_train_evaluates_and_fires_the_callback(evaluated_model):
    model, _ = evaluated_model
    with open(os.path.join(model, "results.json")) as f:
        summary = json.load(f)["ours"]
    assert set(summary) == {"PSNR", "SSIM", "LPIPS", "PSNR_masked",
                            "SSIM_masked"}
    assert summary["LPIPS"] is None
    assert all(np.isfinite(v) for k, v in summary.items() if k != "LPIPS")
    with open(os.path.join(model, "per_view.json")) as f:
        assert sorted(json.load(f)["ours"]) == ["00000", "00001"]
    with open(os.path.join(model, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    psnrs = {r["step"]: r["test_psnr"] for r in recs if "test_psnr" in r}
    assert sorted(psnrs) == [6, 12]
    # the callback's PSNR at the last iteration is the evaluation's
    assert psnrs[12] == pytest.approx(summary["PSNR"], abs=1e-4)
    with zipfile.ZipFile(os.path.join(model, "code_snapshot.zip")) as z:
        assert "train_torch.py" in z.namelist()
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(os.path.join(model, "tb"))
    acc.Reload()
    steps = {t: [e.step for e in acc.Images(t)] for t in acc.Tags()["images"]}
    assert steps["test_view_0/render"] == [6, 12]
    assert steps["test_view_1/errormap"] == [6, 12]
    assert steps["test_view_0/ground_truth"] == [6]


@pytest.mark.timeout(180)
def test_render_and_evaluate_reproduce_the_results(evaluated_model):
    """``render_torch.py --eval`` and ``evaluate_torch.py --device cpu``
    score the model directory's test renders from their 8-bit PNGs: the
    scores of the float renders within the quantization's reach (PSNR
    0.02 dB, SSIM 5e-3), and the two CLIs identical."""
    model, tmp = evaluated_model
    with open(os.path.join(model, "results.json")) as f:
        trained = json.load(f)["ours"]
    r = _run_no_lpips([os.path.join(ROOT, "render_torch.py"), "--model_path",
                       model, "--synthetic", "--eval", "--skip_train",
                       "--device", "cpu", "--instance_capacity", "4096"], tmp)
    assert "eval:" in r.stdout
    results = os.path.join(model, "test", "results.json")
    with open(results) as f:
        rendered = json.load(f)["ours"]
    os.remove(results)
    _run_no_lpips([os.path.join(ROOT, "evaluate_torch.py"), "--model_path",
                   model, "--device", "cpu"], tmp)
    with open(results) as f:
        evaluated = json.load(f)["ours"]
    assert rendered == evaluated
    assert set(evaluated) == {"PSNR", "SSIM", "LPIPS"}
    assert evaluated["LPIPS"] is None
    assert evaluated["PSNR"] == pytest.approx(trained["PSNR"], abs=0.02)
    assert evaluated["SSIM"] == pytest.approx(trained["SSIM"], abs=5e-3)


@pytest.mark.timeout(180)
def test_blender_layout_trains(tmp_path):
    """A NeRF-synthetic scene (``transforms_train.json``) trains for a few
    iterations and its test view is evaluated."""
    from gscream_tpu_torch.data.ply import write_ply
    from tests.test_torch_blender import write_blender_scene
    scene = tmp_path / "scene"
    write_blender_scene(str(scene), n_train=3, n_test=1)
    pts = np.random.default_rng(0).uniform(-0.5, 0.5, (150, 3))
    write_ply(str(scene / "points3d.ply"),
              {c: pts[:, i].astype(np.float32) for i, c in enumerate("xyz")})
    model = str(tmp_path / "model")
    _run_no_lpips([os.path.join(ROOT, "train_torch.py"), "--source_path",
                   str(scene), "--iterations", "4", "--model_path", model]
                  + SMALL, tmp_path)
    with open(os.path.join(model, "cameras.json")) as f:
        assert len(json.load(f)) == 4               # 1 test + 3 train views
    with open(os.path.join(model, "results.json")) as f:
        summary = json.load(f)["ours"]
    assert set(summary) == {"PSNR", "SSIM", "LPIPS"}
    assert np.isfinite(summary["PSNR"]) and summary["LPIPS"] is None
    assert os.path.exists(os.path.join(model, "test", "renders",
                                       "00000.png"))


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
    import evaluate_torch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_torch.main(["--model_path", str(tmp_path)])


@pytest.mark.timeout(180)
def test_bf16_loss_dtype_matches_train_scene(tmp_path):
    """``--loss_dtype bfloat16`` (and ``--save_iterations``, accepted and
    unused, as ``train.py`` parses it) at 64×64: the CLI's losses are
    those of one in-process ``train_scene`` with the same options
    (rtol 1e-5: the two processes run different thread counts), and they
    differ from a float32 run's."""
    import torch
    import train_torch
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.data.synthetic import make_scene
    from gscream_tpu_torch.train.loop import train_scene
    model = str(tmp_path / "model")
    _run([os.path.join(ROOT, "train_torch.py"), "--synthetic",
          "--synthetic_size", "64", "--iterations", "4", "--model_path",
          model, "--loss_dtype", "bfloat16", "--save_iterations", "2", "4",
          "--skip_render", "--skip_eval", "--test_iterations"] + SMALL,
         tmp_path)
    with open(os.path.join(model, "cfg.json")) as f:
        assert json.load(f)["optim"]["loss_dtype"] == "bfloat16"
    with open(os.path.join(model, "train_log.json")) as f:
        cli = json.load(f)["losses"]
    scene = make_scene(device="cpu", **dict(train_torch.SYNTHETIC, width=64,
                                            height=64, seed=0))
    losses = {}
    for dt in ("bfloat16", "float32"):
        run = RunConfig(model=ModelConfig(feat_dim=8, n_offsets=2,
                                          voxel_size=0.1,
                                          anchor_capacity=512,
                                          instance_capacity=4096),
                        optim=OptimConfig(iterations=4, loss_dtype=dt),
                        test_iterations=())
        torch.manual_seed(0)
        _, log = train_scene(scene.views, scene.ref_index, scene.points, run,
                             out_dir=str(tmp_path / dt), capacity=4096,
                             iterations=4, device="cpu")
        losses[dt] = log.losses
    assert len(cli) == 4
    np.testing.assert_allclose(cli, losses["bfloat16"], rtol=1e-5)
    assert not np.allclose(losses["bfloat16"], losses["float32"], rtol=1e-5)
