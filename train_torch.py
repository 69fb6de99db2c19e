"""Train → render entry point of the PyTorch/CUDA port for one scene (the
counterpart of ``train.py``).

SPIN-NeRF layout (the reference's scripts/run.py flags):

    python train_torch.py --source_path data/spinnerf/book \\
        --model_path output/book \\
        --specified_ply_path data/spinnerf/book/sparse/0/points3D.ply \\
        --ref_image_path refs/book_out.png \\
        --ref_depth_path refs/book_out_pred.npy \\
        --voxel_size 0.005 --update_init_factor 16 --iterations 30000

A synthetic scene, no dataset needed:

    python train_torch.py --synthetic --iterations 200 --model_path output/synthetic

It trains on the GPU (``--device cpu`` runs the plain versions of the
kernels), writes ``cfg.json``, ``input.ply``, ``cameras.json``,
``metrics.jsonl``, the anchors and decoders under
``point_cloud/iteration_<N>/`` (which ``render_torch.py`` loads), the
full train state as ``checkpoint``, and renders the test split.
Evaluation, spiral renders and NeRF-synthetic (Blender) scenes are not
ported yet and are refused.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

NOT_PORTED = ("is not ported to the PyTorch package yet (ROADMAP.md, "
              "Queue 1 item {}); use train.py")


def parse_args(argv=None):
    from gscream_tpu_torch.config import OptimConfig as d
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source_path", default="")
    p.add_argument("--model_path", default="output/run")
    p.add_argument("--specified_ply_path", default="")
    p.add_argument("--ref_image_path", default="")
    p.add_argument("--ref_depth_path", default="")
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--voxel_size", type=float, default=0.005)
    p.add_argument("--update_init_factor", type=int, default=16)
    p.add_argument("--feat_dim", type=int, default=32)
    p.add_argument("--n_offsets", type=int, default=10)
    p.add_argument("--use_feat_bank", action="store_true")
    p.add_argument("--start_crossattn_from", type=int, default=15000)
    p.add_argument("--crossattn_feat_update_ema", type=float, default=0.03)
    for name in ("refer_rgb_lr", "refer_rgb_lr_fg", "other_rgb_lr",
                 "other_rgb_lr_fg", "refer_depth_lr", "refer_depth_lr_fg",
                 "refer_depth_lr_smooth", "other_depth_lr",
                 "other_depth_lr_smooth", "crossattn_lr_init",
                 "crossattn_lr_final", "enable_crossattn_refview",
                 "enable_crossattn_otherview"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--anchor_capacity", type=int, default=1 << 17)
    p.add_argument("--instance_capacity", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic scene (no data)")
    p.add_argument("--synthetic_size", type=int, default=128,
                   help="the synthetic views' width and height in pixels")
    p.add_argument("--skip_render", action="store_true")
    p.add_argument("--pretrained_ply", default="")
    p.add_argument("--start_checkpoint", default="",
                   help="resume from a checkpoint file this script wrote")
    p.add_argument("--checkpoint_interval", type=int, default=0,
                   help="save the full train state every N iterations")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    p.add_argument("--eval", action="store_true",
                   help="not yet ported (ROADMAP.md Queue 1 item 2)")
    p.add_argument("--render_spiral", action="store_true",
                   help="not yet ported (ROADMAP.md Queue 1 item 2)")
    return p.parse_args(argv)


SYNTHETIC = dict(n_views=6, n_gauss=300)   # train.py's synthetic scene


def synthetic_scene(model_path: str, size: int, seed: int, device):
    """The synthetic scene (``train.py``'s: 6 views of 300 gaussians),
    its parameters recorded in ``<model>/synthetic.json`` so that
    ``render_torch.py --synthetic`` rebuilds it."""
    from gscream_tpu_torch.data.synthetic import make_scene
    kw = dict(SYNTHETIC, width=size, height=size, seed=seed)
    with open(os.path.join(model_path, "synthetic.json"), "w") as f:
        json.dump(kw, f)
    return make_scene(device=device, **kw)


def main(argv=None):
    args = parse_args(argv)
    if args.eval or args.render_spiral:
        raise NotImplementedError("evaluation and the spiral render set "
                                  + NOT_PORTED.format(2))
    if not args.synthetic and os.path.exists(
            os.path.join(args.source_path, "transforms_train.json")):
        raise NotImplementedError("the NeRF-synthetic (Blender) layout "
                                  + NOT_PORTED.format(1))
    from gscream_tpu_torch.config import (ModelConfig, OptimConfig,
                                          RunConfig, save_config)
    from gscream_tpu_torch.device import resolve_device
    from gscream_tpu_torch.model.io import (save_anchors_ply,
                                            save_checkpoint, save_mlps_npz,
                                            write_scene_artifacts)
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.loop import get_logger, train_scene
    from gscream_tpu_torch.train.render_sets import render_set

    dev = resolve_device(args.device)
    run = RunConfig(
        model=ModelConfig(
            feat_dim=args.feat_dim, n_offsets=args.n_offsets,
            voxel_size=args.voxel_size,
            update_init_factor=args.update_init_factor,
            source_path=args.source_path, model_path=args.model_path,
            specified_ply_path=args.specified_ply_path,
            ref_image_path=args.ref_image_path,
            ref_depth_path=args.ref_depth_path,
            anchor_capacity=args.anchor_capacity,
            instance_capacity=args.instance_capacity,
            use_feat_bank=args.use_feat_bank),
        optim=OptimConfig(
            iterations=args.iterations,
            start_crossattn_from=args.start_crossattn_from,
            crossattn_feat_update_ema=args.crossattn_feat_update_ema,
            **{name: getattr(args, name) for name in (
                "refer_rgb_lr", "refer_rgb_lr_fg", "other_rgb_lr",
                "other_rgb_lr_fg", "refer_depth_lr", "refer_depth_lr_fg",
                "refer_depth_lr_smooth", "other_depth_lr",
                "other_depth_lr_smooth", "crossattn_lr_init",
                "crossattn_lr_final", "enable_crossattn_refview",
                "enable_crossattn_otherview")}),
        seed=args.seed)
    os.makedirs(args.model_path, exist_ok=True)
    save_config(run, os.path.join(args.model_path, "cfg.json"))
    logger = get_logger(args.model_path)

    ref_image = ref_depth = None
    if args.synthetic:
        scene = synthetic_scene(args.model_path, args.synthetic_size,
                                args.seed, dev)
        views, ref_index, points = scene.views, scene.ref_index, scene.points
        extent = 1.0
        test_views = views[:2]
    else:
        from gscream_tpu_torch.data.dataset import load_spinnerf_scene
        sd = load_spinnerf_scene(args.source_path, args.specified_ply_path,
                                 resolution=args.resolution, device=dev)
        views, points = sd.train_views, sd.points
        ref_index = next((i for i, v in enumerate(views)
                          if v.name == sd.ref_name), 0)
        extent = sd.cameras_extent
        test_views = sd.test_views
        # the substituted reference artifacts are stored at the dataset's
        # native resolution: resized through the views' own paths
        vh, vw = sd.height, sd.width
        if args.ref_image_path:
            import imageio.v2 as imageio
            from gscream_tpu_torch.data.dataset import _resize_image
            ref_image = (np.asarray(imageio.imread(args.ref_image_path),
                                    np.float32) / 255.0)[:, :, :3]
            ref_image = ref_image.transpose(2, 0, 1)
            if ref_image.shape[1:] != (vh, vw):
                ref_image = _resize_image(ref_image, (vh, vw))
        if args.ref_depth_path:
            from gscream_tpu_torch.data.dataset import _resize_nearest
            ref_depth = np.load(args.ref_depth_path).astype(
                np.float32)[None]
            if ref_depth.shape[1:] != (vh, vw):
                ref_depth = _resize_nearest(ref_depth, (vh, vw))

    logger.info("training %d views, %d points, %d iters on %s", len(views),
                len(points), args.iterations, dev)
    write_scene_artifacts(args.model_path, list(test_views) + list(views),
                          points)
    ts, log = train_scene(
        views, ref_index, points, run, out_dir=args.model_path,
        ref_image=ref_image, ref_depth=ref_depth, spatial_lr_scale=extent,
        capacity=args.instance_capacity, iterations=args.iterations,
        logger=logger, pretrained_ply=args.pretrained_ply,
        start_checkpoint=args.start_checkpoint,
        checkpoint_interval=args.checkpoint_interval, device=dev)

    m = run.model
    cfg = ScaffoldConfig(
        feat_dim=m.feat_dim, n_offsets=m.n_offsets,
        voxel_size=m.voxel_size, capacity=m.anchor_capacity,
        attn_heads=run.optim.attn_head_num,
        attn_head_dim=run.optim.attn_head_dim,
        use_feat_bank=m.use_feat_bank)
    ply_dir = os.path.join(args.model_path, "point_cloud",
                           f"iteration_{args.iterations}")
    save_anchors_ply(os.path.join(ply_dir, "point_cloud.ply"), ts.scaffold,
                     cfg)
    save_mlps_npz(os.path.join(ply_dir, "mlp_checkpoints.npz"),
                  ts.scaffold.mlps)
    save_checkpoint(os.path.join(args.model_path, "checkpoint"), ts)
    logger.info("trained %d iterations: last loss %.5f, %d anchors, "
                "events %s", args.iterations,
                log.losses[-1] if log.losses else float("nan"),
                int(ts.scaffold.alive.sum()), log.events)

    if not args.skip_render and test_views:
        gts = [v.image for v in test_views]
        res = render_set(args.model_path, "test",
                         [v.camera for v in test_views], ts.scaffold, cfg,
                         capacity=args.instance_capacity,
                         gt_images=gts if any(
                             g is not None for g in gts) else None)
        logger.info("test FPS: %.2f", res["fps"])


if __name__ == "__main__":
    main()
