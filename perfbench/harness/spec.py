"""The benchmark's data files, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Dict:
    """The workload entry ``name`` with its configuration, traffic and
    limits loaded, and its end-to-end and per-layer metrics."""
    bench = benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])
    return {
        "name": name, "chips": wl["chips"],
        "config": _load(os.path.join(ROOT, conf["file"])),
        "traffic": traffic(wl["traffic"]),
        "limits": _load(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def traffic(name: str) -> Dict:
    return _load(os.path.join(HERE, "traffic", name + ".json"))


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
