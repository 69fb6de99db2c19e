"""Train → render → evaluate entry point of the PyTorch/CUDA port for one
scene (the counterpart of ``train.py``).

SPIN-NeRF layout (the reference's scripts/run.py flags):

    python train_torch.py --source_path data/spinnerf/book \\
        --model_path output/book \\
        --specified_ply_path data/spinnerf/book/sparse/0/points3D.ply \\
        --ref_image_path refs/book_out.png \\
        --ref_depth_path refs/book_out_pred.npy \\
        --voxel_size 0.005 --update_init_factor 16 --iterations 30000

A NeRF-synthetic (Blender) scene is recognised by its
``transforms_train.json``.  A synthetic scene, no dataset needed:

    python train_torch.py --synthetic --iterations 200 --model_path output/synthetic

It trains on the GPU (``--device cpu`` runs the plain versions of the
kernels), writes ``cfg.json``, ``code_snapshot.zip``, ``input.ply``,
``cameras.json``, ``metrics.jsonl``, the anchors and decoders under
``point_cloud/iteration_<N>/`` (which ``render_torch.py`` loads), the
full train state as ``checkpoint`` and each iteration's loss, step and
the loop's events as ``train_log.json``; at each of ``--test_iterations`` it
logs the test split's PSNR (and TensorBoard image grids); then it
renders the test split (and, with ``--render_spiral``, a SPIN-NeRF
scene's spiral path) and, unless ``--skip_eval``, evaluates the test
renders into ``results.json`` and ``per_view.json``.

On several cards, one process per card over a (data, tiles) mesh (views
per step × bands of tile rows per view), started alike on every rank:

    torchrun --nproc_per_node 4 train_torch.py --synthetic \
        --mesh_data 2 --mesh_tiles 2 --model_path output/synthetic

or with ``--dist_coordinator HOST:PORT --dist_nprocs 4 --dist_pid I`` per
process (``--dist_backend gloo`` lets ranks share a card).  Rank 0 writes
the run's files, renders and evaluates.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    from gscream_tpu_torch.config import OptimConfig as d, RunConfig
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
    # the densification schedule (statistics from start_stat; adjust
    # every update_interval iterations strictly between update_from and
    # update_until)
    for name in ("start_stat", "update_from", "update_interval",
                 "update_until"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    p.add_argument("--loss_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the RGB L1/SSIM maps' dtype (bfloat16: float32 "
                        "means, the depth terms and the render float32)")
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("--anchor_capacity", type=int, default=1 << 17)
    p.add_argument("--instance_capacity", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic scene (no data)")
    p.add_argument("--synthetic_size", type=int, default=128,
                   help="the synthetic views' width and height in pixels")
    p.add_argument("--skip_render", action="store_true")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--save_iterations", type=int, nargs="*", default=None,
                   help="accepted as train.py accepts it; unused")
    p.add_argument("--test_iterations", type=int, nargs="*",
                   default=list(RunConfig.test_iterations),
                   help="iterations that log the test split's PSNR")
    p.add_argument("--pretrained_ply", default="")
    p.add_argument("--start_checkpoint", default="",
                   help="resume from a checkpoint file this script wrote")
    p.add_argument("--checkpoint_interval", type=int, default=0,
                   help="save the full train state every N iterations")
    p.add_argument("--render_spiral", action="store_true",
                   help="also render the 120-pose spiral path (SPIN-NeRF "
                        "scenes)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    # multi-GPU training over a (data, tiles) mesh: one process per card,
    # started with the same flags (see gscream_tpu_torch/parallel/);
    # torchrun's environment works in place of the --dist_ flags
    p.add_argument("--dist_coordinator", default="",
                   help="host:port of rank 0 (enables multi-process mode)")
    p.add_argument("--dist_nprocs", type=int, default=1,
                   help="the world size: one process per card")
    p.add_argument("--dist_pid", type=int, default=0,
                   help="this process's rank")
    p.add_argument("--dist_backend", default="",
                   help="nccl (default on cuda; one card per rank) or gloo "
                        "(default on cpu; ranks may share a card)")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="views per step (the data axis); with --mesh_tiles "
                        "routes training through the sharded step. 0 = "
                        "auto when distributed (every rank), off otherwise")
    p.add_argument("--mesh_tiles", type=int, default=0,
                   help="bands of tile rows each view is rasterized in")
    return p.parse_args(argv)


SYNTHETIC = dict(n_views=6, n_gauss=300)   # train.py's synthetic scene


def synthetic_scene(model_path: str, size: int, seed: int, device,
                    record: bool = True):
    """The synthetic scene (``train.py``'s: 6 views of 300 gaussians),
    its parameters recorded (``record``) in ``<model>/synthetic.json`` so
    that ``render_torch.py --synthetic`` rebuilds it."""
    from gscream_tpu_torch.data.synthetic import make_scene
    kw = dict(SYNTHETIC, width=size, height=size, seed=seed)
    if record:
        with open(os.path.join(model_path, "synthetic.json"), "w") as f:
            json.dump(kw, f)
    return make_scene(device=device, **kw)


def start_mesh(args):
    """(device, mesh, rank): this process's rank of a multi-process run
    (``--dist_*`` or torchrun's environment) and the (data, tiles) mesh
    (``--mesh_data/--mesh_tiles``, else every rank when distributed);
    (the ``--device``, None, 0) for one process."""
    from gscream_tpu_torch.device import resolve_device
    from gscream_tpu_torch.parallel.distributed import init_distributed
    from gscream_tpu_torch.parallel.mesh import auto_mesh, make_mesh
    dev = init_distributed(args.dist_coordinator, args.dist_nprocs,
                           args.dist_pid, backend=args.dist_backend or None,
                           device=args.device)
    if args.mesh_data or args.mesh_tiles:
        mesh = make_mesh(data=max(args.mesh_data, 1),
                         tiles=max(args.mesh_tiles, 1))
    elif dev is not None:
        mesh = auto_mesh()
    else:
        mesh = None
    if dev is None:
        dev = resolve_device(args.device)
    return dev, mesh, 0 if mesh is None else mesh.rank


def make_eval_callback(test_views, run, cfg, capacity: int, logger):
    """The in-training evaluation (reference training_report,
    train.py:655-695; train.py:237-280): at each of
    ``run.test_iterations``, the test split's mean PSNR through the
    port's render function, logged to the logger and the metrics, with
    TensorBoard grids of the render and error map of the first 5 views
    (the ground truth at the first test iteration only).
    ``callback(it, ts, aux, mlog=None)``, as ``train_scene`` calls it."""
    import torch
    from gscream_tpu_torch.ops.losses import psnr
    from gscream_tpu_torch.train.render_sets import make_render_fn

    def callback(it, ts, aux, mlog=None):
        if it not in run.test_iterations or not test_views:
            return
        cam0 = test_views[0].camera
        render = make_render_fn(ts.scaffold, cfg, cam0.width, cam0.height,
                                capacity)
        vals = []
        for vi, v in enumerate(test_views):
            if v.image is None:
                continue
            out, _, demand = render(ts.scaffold.params, ts.scaffold.mlps,
                                    v.camera)
            if int(demand) > capacity:
                logger.warning("[ITER %d] test view %d: instance demand %d "
                               "exceeds capacity %d; its PSNR is of a "
                               "truncated render", it, vi, int(demand),
                               capacity)
            render_chw = out.color.permute(2, 0, 1)
            gt = torch.as_tensor(v.image, device=render_chw.device)
            vals.append(float(psnr(render_chw, gt)))
            if mlog is not None and vi < 5:
                rnp = render_chw.cpu().numpy()
                gnp = np.asarray(v.image)
                mlog.log_images(it, {
                    f"test_view_{vi}/render": rnp,
                    f"test_view_{vi}/errormap": np.repeat(
                        np.abs(rnp - gnp).mean(0, keepdims=True), 3, 0),
                    **({f"test_view_{vi}/ground_truth": gnp}
                       if it == run.test_iterations[0] else {}),
                })
        if vals:
            logger.info("[ITER %d] test PSNR %.3f", it, sum(vals) / len(vals))
            if mlog is not None:
                mlog.log(it, {"test_psnr": sum(vals) / len(vals)})

    return callback


def main(argv=None):
    args = parse_args(argv)
    dev, mesh, rank = start_mesh(args)
    try:
        train_and_evaluate(args, dev, mesh, rank)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def train_and_evaluate(args, dev, mesh, rank: int):
    """Train on this rank; rank 0 alone writes the run's files, renders
    and evaluates."""
    import logging
    from gscream_tpu_torch.config import (ModelConfig, OptimConfig,
                                          RunConfig, save_config)
    from gscream_tpu_torch.model.io import (save_anchors_ply,
                                            save_checkpoint, save_mlps_npz,
                                            write_scene_artifacts)
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.loop import get_logger, train_scene
    from gscream_tpu_torch.train.render_sets import render_set
    from gscream_tpu_torch.utils.snapshot import save_runtime_code
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
                "enable_crossattn_otherview", "start_stat", "update_from",
                "update_interval", "update_until")},
            loss_dtype=args.loss_dtype),
        test_iterations=tuple(args.test_iterations),
        seed=args.seed)
    if rank == 0:
        os.makedirs(args.model_path, exist_ok=True)
        save_config(run, os.path.join(args.model_path, "cfg.json"))
        logger = get_logger(args.model_path)
        # the run's code backup (reference saveRuntimeCode,
        # train.py:1053-1064)
        try:
            save_runtime_code(args.model_path)
        except OSError as e:         # never let bookkeeping kill a run
            logger.warning("code snapshot failed: %s", e)
    else:
        logger = logging.getLogger(f"gscream_tpu_torch.rank{rank}")

    ref_image = ref_depth = None
    sd = None
    if args.synthetic:
        scene = synthetic_scene(args.model_path, args.synthetic_size,
                                args.seed, dev, record=rank == 0)
        views, ref_index, points = scene.views, scene.ref_index, scene.points
        extent = 1.0
        test_views = views[:2]
    elif os.path.exists(os.path.join(args.source_path,
                                     "transforms_train.json")):
        # NeRF-synthetic layout (reference sceneLoadTypeCallbacks
        # "Blender", dataset_readers.py:471-474)
        from gscream_tpu_torch.data.blender import load_blender_scene
        sd = load_blender_scene(args.source_path, white_background=False,
                                ply_path=args.specified_ply_path,
                                device=dev)
        views, points, ref_index = sd.train_views, sd.points, 0
        extent = sd.cameras_extent
        test_views = sd.test_views
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
    if mesh is not None:
        from gscream_tpu_torch.parallel.distributed import process_info
        logger.info("mesh: data=%d tiles=%d; rank %d of %d (backend %s)",
                    mesh.data, mesh.tiles, *process_info())
    if rank == 0:
        write_scene_artifacts(args.model_path,
                              list(test_views) + list(views), points)
    m = run.model
    cfg = ScaffoldConfig(
        feat_dim=m.feat_dim, n_offsets=m.n_offsets,
        voxel_size=m.voxel_size, capacity=m.anchor_capacity,
        attn_heads=run.optim.attn_head_num,
        attn_head_dim=run.optim.attn_head_dim,
        use_feat_bank=m.use_feat_bank)
    ts, log = train_scene(
        views, ref_index, points, run, out_dir=args.model_path,
        ref_image=ref_image, ref_depth=ref_depth, spatial_lr_scale=extent,
        capacity=args.instance_capacity, iterations=args.iterations,
        logger=logger,
        callback=make_eval_callback(test_views, run, cfg,
                                    args.instance_capacity, logger),
        pretrained_ply=args.pretrained_ply,
        start_checkpoint=args.start_checkpoint,
        checkpoint_interval=args.checkpoint_interval, device=dev,
        mesh=mesh)
    if rank != 0:
        return

    ply_dir = os.path.join(args.model_path, "point_cloud",
                           f"iteration_{args.iterations}")
    save_anchors_ply(os.path.join(ply_dir, "point_cloud.ply"), ts.scaffold,
                     cfg)
    save_mlps_npz(os.path.join(ply_dir, "mlp_checkpoints.npz"),
                  ts.scaffold.mlps)
    save_checkpoint(os.path.join(args.model_path, "checkpoint"), ts)
    with open(os.path.join(args.model_path, "train_log.json"), "w") as f:
        json.dump({"losses": log.losses, "events": log.events,
                   "steps": log.steps}, f, default=lambda x: x.item())
    logger.info("trained %d iterations: last loss %.5f, %d anchors, "
                "events %s", args.iterations,
                log.losses[-1] if log.losses else float("nan"),
                int(ts.scaffold.alive.sum()), log.events)

    if args.skip_render or not test_views:
        return
    # index-aligned gts (None slots for missing PNGs, never shifted)
    gts = [v.image for v in test_views]
    res = render_set(args.model_path, "test",
                     [v.camera for v in test_views], ts.scaffold, cfg,
                     capacity=args.instance_capacity,
                     gt_images=gts if any(
                         g is not None for g in gts) else None)
    logger.info("test FPS: %.2f", res["fps"])
    if args.render_spiral and getattr(sd, "spiral_c2ws", None) is not None:
        from gscream_tpu_torch.cameras import make_camera_from_c2w
        spiral_cams = [make_camera_from_c2w(
            c2w, sd.fov_x, sd.fov_y, sd.width, sd.height, sd.cx_ndc,
            sd.cy_ndc, device=dev) for c2w in sd.spiral_c2ws]
        sres = render_set(args.model_path, "spiral", spiral_cams,
                          ts.scaffold, cfg, capacity=args.instance_capacity)
        logger.info("spiral FPS: %.2f", sres["fps"])
    if args.skip_eval:
        return
    from gscream_tpu_torch.train.evaluate import (evaluate_pairs,
                                                  load_test_label_masks,
                                                  write_results)
    # pair render i with test view i; skip views without a GT image
    idxs = [i for i, v in enumerate(test_views)
            if v.image is not None and i < len(res["renders"])]
    if not idxs:
        return
    gts = [test_views[i].image for i in idxs]
    renders = [res["renders"][i] for i in idxs]
    # the reference's masked protocol: images_4/test_label masks,
    # 1-indexed by test position, LANCZOS-resized to the render size
    # (train.py:895-899); the views' own masks otherwise
    h, w = gts[0].shape[1:]
    masks = (load_test_label_masks(args.source_path, len(test_views),
                                   (w, h)) if args.source_path else None)
    masks = ([masks[i] for i in idxs] if masks is not None
             else [test_views[i].mask for i in idxs])
    results = evaluate_pairs(renders, gts, masks,
                             names=[f"{i:05d}" for i in idxs], device=dev)
    write_results(args.model_path, results)
    logger.info("eval: %s", json.dumps(results["summary"]))


if __name__ == "__main__":
    main()
