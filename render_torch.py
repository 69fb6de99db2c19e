"""Render-only entry of the PyTorch/CUDA port: load a trained model
directory and render its splits on the GPU.

    python render_torch.py --model_path output/scene --source_path data/scene \
        [--iteration 30000] [--skip_train] [--skip_test] [--spiral] \
        [--eval] [--instance_capacity N]
    python render_torch.py --model_path output/synthetic --synthetic [--eval]

The counterpart of ``render.py``: it reads ``<model>/cfg.json`` and
``<model>/point_cloud/iteration_<N>/{point_cloud.ply, mlp_checkpoints.npz}``
(written by either package) and the scene's cameras (with
``--synthetic``, the scene ``train_torch.py --synthetic`` recorded in
``<model>/synthetic.json``: its first two views are the test split), and
writes render sets under ``<model>/<split>/`` (renders/gt/errors/depth,
per_view_count.json; with ``--spiral``, a SPIN-NeRF scene's spiral path
with normal maps and the video), printing each split's FPS.  With
``--eval`` it then evaluates ``<model>/test`` as ``evaluate_torch.py``
does (the ``images_4/test_label`` masks of ``--source_path``).  A view
whose instance demand exceeds ``--instance_capacity`` is rendered
truncated, with a warning, as the JAX package does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--source_path", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic scene train_torch.py trained on")
    p.add_argument("--iteration", type=int, default=-1,
                   help="-1 = highest iteration_<N> dir present")
    p.add_argument("--resolution", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--instance_capacity", type=int, default=1 << 20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    p.add_argument("--spiral", action="store_true",
                   help="also render the spiral path (SPIN-NeRF scenes)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate the test renders into results.json")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not (args.source_path or args.synthetic):
        raise SystemExit("render_torch.py: give --source_path or "
                         "--synthetic")
    from gscream_tpu_torch.data.dataset import load_spinnerf_scene
    from gscream_tpu_torch.device import resolve_device
    from gscream_tpu_torch.model.io import load_trained_scaffold
    from gscream_tpu_torch.train.render_sets import render_set

    dev = resolve_device(args.device)
    scaffold, cfg, it = load_trained_scaffold(args.model_path,
                                              args.iteration, dev)
    sd = None
    if args.synthetic:
        from gscream_tpu_torch.data.synthetic import make_scene
        with open(os.path.join(args.model_path, "synthetic.json")) as f:
            views = make_scene(device=dev, **json.load(f)).views
        test_views, train_views = views[:2], views
    else:
        sd = load_spinnerf_scene(args.source_path,
                                 resolution=args.resolution, device=dev)
        test_views, train_views = sd.test_views, sd.train_views
    splits = []
    if not args.skip_test:
        splits.append(("test", test_views))
    if not args.skip_train:
        splits.append(("train", train_views))
    for name, views in splits:
        if not views:
            continue
        gts = [v.image for v in views]
        res = render_set(args.model_path, name, [v.camera for v in views],
                         scaffold, cfg, capacity=args.instance_capacity,
                         gt_images=gts if any(
                             g is not None for g in gts) else None)
        worst = max(res["overflow_demand"])
        print(f"{name}: {len(views)} views, FPS {res['fps']:.2f}, "
              f"iteration {it}, max instance demand {worst} "
              f"(capacity {args.instance_capacity})")
        if worst > args.instance_capacity:
            print(f"WARNING: {name}: raise --instance_capacity to at least "
                  f"{worst} for exact renders", file=sys.stderr)
    if args.spiral:
        if sd is None or sd.spiral_c2ws is None:
            print("WARNING: --spiral: this scene has no spiral path (only "
                  "SPIN-NeRF scenes do)", file=sys.stderr)
        else:
            from gscream_tpu_torch.cameras import make_camera_from_c2w
            cams = [make_camera_from_c2w(c2w, sd.fov_x, sd.fov_y, sd.width,
                                         sd.height, sd.cx_ndc, sd.cy_ndc,
                                         device=dev)
                    for c2w in sd.spiral_c2ws]
            res = render_set(args.model_path, "spiral", cams, scaffold, cfg,
                             capacity=args.instance_capacity)
            print(f"spiral: {len(cams)} views, FPS {res['fps']:.2f}")
    if args.eval and not args.skip_test:
        from gscream_tpu_torch.train.evaluate import evaluate_dir
        r = evaluate_dir(os.path.join(args.model_path, "test"),
                         source_path=args.source_path, device=dev)
        print("eval:", json.dumps(r["summary"]))


if __name__ == "__main__":
    main()
