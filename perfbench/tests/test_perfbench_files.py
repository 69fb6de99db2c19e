"""The benchmark's data files: every configuration, traffic mix, limits
file and per-layer reader that ``BENCHMARK.json`` names exists and loads,
and the file keeps to the contract's shapes."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51


@pytest.mark.parametrize("name", ["spinnerf", "garden"])
def test_config_names_source_assumed_reduced(name, bench):
    cfg = load(f"configs/{name}.json")
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200
    assert isinstance(cfg["assumed"], list) and cfg["assumed"]
    for entry in bench["configs"]:
        if entry["name"] == name:
            assert entry["file"] == f"perfbench/configs/{name}.json"
            assert cfg["reduced"] == entry["reduced"]
    m = cfg["model"]
    # the published widths: Scaffold-GS feat_dim 32, 10 offsets; GScream's
    # cross-attention 8 heads of 64 and at most 2,000 tokens
    assert (m["feat_dim"], m["n_offsets"]) == (32, 10)
    o = cfg["optim"]
    assert (o["attn_head_num"], o["attn_head_dim"],
            o["crossattn_max_tokens"]) == (8, 64, 2000)


@pytest.mark.parametrize("mix", ["train_p1", "train_p2", "render_loop"])
def test_traffic_loads(mix):
    tr = load(f"traffic/{mix}.json")
    assert tr["kind"] in ("train", "render")
    assert tr["doc"]


def test_every_name_and_unit(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_each_cell_has_limits_and_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))

        def reports(m):
            return w["name"] in m.get("workloads", [w["name"]])
        got = [m for m in bench["end_to_end"] if reports(m)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        layer = [m for m in bench["per_layer"] if reports(m)]
        assert layer
        for m in layer:
            assert reports(e2e[m["moves"]])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
