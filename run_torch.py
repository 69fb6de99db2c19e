#!/usr/bin/env python3
"""Experiment runner of the PyTorch/CUDA port: loop the 10 SPIN-NeRF
scenes through ``train_torch.py`` (counterpart of ``scripts/run.py``).

Builds the per-scene ``train_torch.py`` command with the paper's
hyperparameters (reference scripts/run.py:14-80): voxel_size 0.005,
update_init_factor 16, 30k iterations, the ``refs/<scene>_out.png``
inpainted reference view and ``refs/<scene>_out_pred.npy`` reference
depth, cross-attention from 15k with EMA 0.03, the spiral render and a
checkpoint every 5,000 iterations.  Extra arguments pass through to
``train_torch.py`` verbatim; scenes without data are skipped; the logs
go to ``log_training/``.

Usage, from the repository root::

    python run_torch.py [DATA_ROOT [REFS_ROOT [OUT_ROOT [train_torch.py
                        flags...]]]]

Each scene runs under a stall watchdog: if its log stops growing for
``GSCREAM_STALL_S`` seconds (default 900) the exact child PID is killed
and the run relaunches from its periodic checkpoint
(``--start_checkpoint``), up to ``GSCREAM_MAX_RESTARTS`` times (default
3).  The port's resume is bit-exact (``tests/test_torch_loop.py``), so a
restart does not perturb the trajectory.
"""
import os
import subprocess
import sys
import time

SCENES = ["1", "2", "3", "4", "7", "9", "10", "12", "book", "trash"]


def run_with_watchdog(cmd, log_path, ckpt_path, stall_s=900,
                      max_restarts=3, poll_s=20):
    """Run ``cmd`` tee'd to ``log_path``; kill-and-resume on log stalls.

    Returns the final returncode (0 on success).  Restarts append
    ``--start_checkpoint <ckpt_path>`` once the checkpoint exists.
    """
    for attempt in range(max_restarts + 1):
        c = list(cmd)
        if attempt and os.path.exists(ckpt_path):
            c += ["--start_checkpoint", ckpt_path]
            print(f"[watchdog] restart {attempt} from {ckpt_path}")
        with open(log_path, "a") as f:
            if attempt:
                f.write(f"\n=== watchdog restart {attempt} ===\n")
                f.flush()
            p = subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT)
            stalled = False
            while p.poll() is None:
                time.sleep(poll_s)
                try:
                    age = time.time() - os.path.getmtime(log_path)
                except OSError:
                    age = 0.0
                if age > stall_s:
                    print(f"[watchdog] log silent {age:.0f}s — killing "
                          f"pid {p.pid}")
                    p.kill()        # exact child PID, never by pattern
                    p.wait()
                    stalled = True
                    break
        if not stalled:
            return p.returncode
    return 1


def scene_command(scene, src, refs_root, model_path, extra):
    """The ``train_torch.py`` command of one scene."""
    return [
        sys.executable, "train_torch.py",
        "--source_path", src,
        "--model_path", model_path,
        "--specified_ply_path",
        os.path.join(src, "sparse/0/points3D.ply"),
        "--ref_image_path",
        os.path.join(refs_root, f"{scene}_out.png"),
        "--ref_depth_path",
        os.path.join(refs_root, f"{scene}_out_pred.npy"),
        "--voxel_size", "0.005",
        "--update_init_factor", "16",
        "--iterations", "30000",
        "--start_crossattn_from", "15000",
        "--crossattn_feat_update_ema", "0.03",
        "--render_spiral",
        "--checkpoint_interval", "5000",
    ] + list(extra)


def main():
    data_root = sys.argv[1] if len(sys.argv) > 1 else "data/spinnerf"
    refs_root = sys.argv[2] if len(sys.argv) > 2 else "refs"
    out_root = sys.argv[3] if len(sys.argv) > 3 else "output"
    os.makedirs("log_training", exist_ok=True)

    for scene in SCENES:
        src = os.path.join(data_root, scene)
        if not os.path.isdir(src):
            print(f"[skip] {scene}: no data at {src}")
            continue
        stamp = time.strftime("%Y%m%d_%H%M%S")
        model_path = os.path.join(out_root, f"{scene}_{stamp}")
        cmd = scene_command(scene, src, refs_root, model_path, sys.argv[4:])
        log = os.path.join("log_training", f"{scene}_{stamp}.log")
        print(" ".join(cmd), "->", log)
        rc = run_with_watchdog(
            cmd, log, os.path.join(model_path, "ckpt"),
            stall_s=int(os.environ.get("GSCREAM_STALL_S", "900")),
            max_restarts=int(os.environ.get("GSCREAM_MAX_RESTARTS", "3")))
        if rc != 0:
            print(f"[{scene}] FAILED rc={rc} (see {log})")


if __name__ == "__main__":
    main()
