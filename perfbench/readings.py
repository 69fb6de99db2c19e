#!/usr/bin/env python3
"""Readings that set a cell's limits: the numbers of its comparison over
many seeds, for the program, for the control, or with a fault planted.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|unchanged|half_batch|altered [--seconds 6]

``program``: the timed path as a run drives it (a training cell's first
iterations through ``train_scene``, to its first densification where it
has one; a render cell's sampled frames of a short window) against the
reference.  ``control``: the reference
computed with TF32 matrix products and convolutions in the program's
place (the configuration states float32 with TF32 off), against the
reference.  A fault (``harness.faults``): the program with that fault
planted.  One JSON line per seed, then the largest and smallest of each
number.  Needs a CUDA card, as a run does.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import run as bench_run


def control_numbers(cell, seed, dev, tmp):
    import torch

    from harness import compare, render_cell, scene, train_cell
    cfg = cell["config"]

    def both(fn):
        out = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            out.append(fn())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return out
    if cell["traffic"]["kind"] == "train":
        sc, ply, tg, ri, rd, _ = train_cell.build_inputs(cfg, seed, dev, tmp)
        ref, low = both(lambda: train_cell.reference_steps(
            cell, ply, sc, tg, ri, rd, dev))
        return compare.train_numbers(low, ref)
    sc = scene.cameras(cfg)
    ply = os.path.join(tmp, "anchors.ply")
    from reference import model as ref_model
    ref_model.write_anchor_ply(ply, scene.anchor_columns(cfg, seed, dev))
    poses = (sc.test + sc.spiral)[:cell["traffic"]["samples"]]
    ref, low = both(lambda: render_cell.reference_frames(
        cfg, ply, sc, poses, dev))
    return compare.render_numbers(low, ref)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=6.0)
    a = ap.parse_args()
    bench_run.set_environment()
    import torch

    from harness import faults, render_cell, spec, train_cell
    from harness.trace import Capture
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(a.workload)
    dev = torch.device("cuda")
    rows = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        tmp = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get(
            "TMPDIR") or tempfile.gettempdir())
        t0 = time.perf_counter()
        try:
            if a.mode == "control":
                nums = control_numbers(cell, seed, dev, tmp)
            else:
                import contextlib
                ctx = faults.planted(a.mode) if a.mode != "program" \
                    else contextlib.nullcontext()
                with ctx:
                    if cell["traffic"]["kind"] == "train":
                        r = train_cell.run(cell, seed, 0, False, dev, tmp,
                                           t0, steps_only=True)
                        nums = train_cell.numbers(cell, r.prog, r.densify,
                                                  r.densify_it, r.inputs, dev)
                    else:
                        r = render_cell.run(cell, seed, a.seconds, False,
                                            dev, tmp, t0,
                                            capture_cls=Capture)
                        nums = r.numbers
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        nums["seconds"] = time.perf_counter() - t0
        rows.append(nums)
        print(json.dumps({"workload": a.workload, "mode": a.mode,
                          "seed": seed, "numbers": nums}), flush=True)
        torch.cuda.empty_cache()
    keys = [k for k in rows[0] if k != "seconds"]
    print(json.dumps({"workload": a.workload, "mode": a.mode,
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
