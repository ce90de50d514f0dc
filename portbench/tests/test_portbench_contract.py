"""BENCHMARK.json against the rules a benchmark file keeps, and every name
it holds against the files that read and define it."""

import json
import os
import re

import pytest

from portbench.harness import bench

ROOT = bench.CHECKOUT
SPEC = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(SPEC["command"]) <= 32
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word


def test_run_seconds_fits_the_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("portbench/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["reduced"] == conf["reduced"] == []
    assert data["source"] == conf["source"]
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    for name in (cell["config"], cell["traffic"]):
        assert NAME.match(name)
    assert os.path.isfile(os.path.join(bench.PORTBENCH_DIR, "traffic", cell["traffic"] + ".json"))
    loaded = bench.load_cell(cell["name"])
    assert loaded.limits, "every cell has the limits of its output check"
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded.per_layer
    for m in loaded.per_layer:
        assert m["moves"] in reported


def test_pairs_appear_once_and_four_chip_cells():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metrics(metric):
    e2e = metric in SPEC["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in (("host_clock", "device_trace") if e2e else
                                ("device_trace", "program_span", "program_counter", "host_clock"))
    assert os.path.isfile(os.path.join(bench.PORTBENCH_DIR, "metrics", metric["name"] + ".py"))
    if e2e:
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        if metric["name"].endswith("_roofline_pct") or "_roofline_pct." in metric["name"] \
                or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in SPEC["workloads"]}


def test_setup_metric():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for layer in layers:
        assert layer == layer.strip() and "\n" not in layer
