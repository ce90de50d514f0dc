"""What a run of a cell is: its entry in BENCHMARK.json, its configuration
and traffic files, the metrics it reports and their readers, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the traffic file names its driver
(``drivers/<driver>.py``) and the configuration's file the sizes it runs
at. A metric is read by ``metrics/<name>.py``, whose ``read(run)`` returns
a number or None. Limits of the output check are in
``limits/<workload>.json``. A later cell, mix, driver or metric is a new
file and a new entry; nothing here names one.
"""

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List

PORTBENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pod_compare_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict = field(default_factory=dict)


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = CHECKOUT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = CHECKOUT) -> Cell:
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(PORTBENCH_DIR, "traffic", entry["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    limits_path = os.path.join(PORTBENCH_DIR, "limits", name + ".json")
    limits = _load_json(limits_path) if os.path.isfile(limits_path) else {}
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer, limits)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(PORTBENCH_DIR, kind, name + ".py")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {value, unit}} of every metric whose reader found something."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN_MODULES})


def check_limits(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {value, limit, ok}} of each number the cell's limits name; a
    limit without its number, or a number that is not finite, fails."""
    out = {}
    for name in sorted(limits):
        value, limit = numbers.get(name), limits.get(name)
        ok = value is not None and limit is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def emit(result: dict, checks: Dict[str, dict], diagnostics: List[str]) -> None:
    """Diagnostics on earlier lines, each compared number beside its limit
    as the last lines on standard error, and the result as the last line
    of standard output, its checks last."""
    for line in diagnostics:
        print(line, flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(result), flush=True)
