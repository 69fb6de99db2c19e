"""Metric evaluation of a model directory's renders with the PyTorch/CUDA
port (the counterpart of ``evaluate.py``):

    python evaluate_torch.py --model_path output/scene \\
        [--source_path data/scene] [--split test] [--device cuda]

It walks ``<model>/<split>/renders`` against ``.../gt`` (or the
reference's nested ``<model>/<split>/<method>/renders``), loads the
object-region masks from ``<source>/images_4/test_label/out_%05d.png``
when a source is given (1-indexed, LANCZOS-resized to the render size,
binarized), scores every pair on the card (``--device cpu`` for the
CPU) with PSNR, ``my_ssim`` and VGG-LPIPS, full and masked, and writes
``results.json`` and ``per_view.json`` beside the renders' parent, in the
reference's format.  LPIPS is null without a weight file
(``$GSCREAM_LPIPS_WEIGHTS`` or ``~/.cache/gscream/lpips_vgg.npz``).
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--source_path", default="",
                   help="scene dir holding images_4/test_label masks")
    p.add_argument("--split", default="test")
    p.add_argument("--method", default="ours")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gscream_tpu_torch.device import resolve_device
    from gscream_tpu_torch.train.evaluate import evaluate_dir, \
        find_method_dirs
    dev = resolve_device(args.device)
    dirs = find_method_dirs(args.model_path, args.split)
    if not dirs:
        raise SystemExit(f"no {args.split}/renders under {args.model_path}")
    for d in dirs:
        r = evaluate_dir(d, args.source_path, args.method, device=dev)
        print(d, json.dumps(r["summary"]))


if __name__ == "__main__":
    main()
