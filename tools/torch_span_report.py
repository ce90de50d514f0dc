#!/usr/bin/env python3
"""Where the host's time goes inside the port, read from its ``pod.*`` spans.

    python tools/torch_span_report.py --workload <cell> --seed <n> --seconds <s>
    python tools/torch_span_report.py --span-cost

The first form runs one ``--trace 1`` run of a benchmark cell
(``portbench/run.py``, which prints its own result line) and reads the
host-traced pass that run made: each ``pod.*`` span's milliseconds a
batch or step, the share of ``pod.detect``, ``pod.head_bank`` and
``pod.step`` that their direct children cover, the device's idle time by
innermost span, and the profiler's inflation (``pod.detect`` and
``pod.head_bank`` a batch against the same stages timed between syncs
without the profiler, ``detect_ms.infer`` and ``head_bank_ms.infer``;
``pod.step`` a step against the untraced window's wall time a step). It
prints that as one ``span_report:`` JSON line and writes it to
``chiprun_out/span_report_<cell>.json``.

The second form times ``utils/profiling.span`` with no profiler and under
a CPU and CUDA profiler, and a bare ``record_function`` with none, in
microseconds a span.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.harness import bench, trace as tr  # noqa: E402
from portbench.harness.program_spans import UNITS  # noqa: E402

CHILDREN = {
    "pod.detect": ("pod.core", "pod.mode", "pod.rescale", "pod.stack"),
    "pod.head_bank": ("pod.backbone", "pod.head_runs"),
    "pod.step": ("pod.forward", "pod.loss", "pod.backward", "pod.optimizer"),
}


def coverage(spans, parent: str, children) -> float:
    """Share of the `parent` spans' time that the union of their
    `children` spans covers."""
    total = covered = 0.0
    for name, ps, pe in spans:
        if name != parent:
            continue
        kids = [(max(s, ps), min(e, pe)) for n, s, e in spans
                if n in children and s < pe and e > ps]
        covered += sum(e - s for s, e in tr.merged(kids))
        total += pe - ps
    return covered / total if total > 0 else float("nan")


def summarize(record: dict) -> dict:
    host = record["host_trace"]
    lo, hi = host.window
    units = int(record["cell"].traffic[UNITS[record["kind"]]])
    spans = [(n, s, e) for n, s, e in host.spans if n.startswith("pod.") and e > lo and s < hi]
    per_unit = {}
    for n, s, e in spans:
        per_unit[n] = per_unit.get(n, 0.0) + (min(e, hi) - max(s, lo)) * 1e-3 / units
    out = {
        "cell": record["cell"].name, "units": units,
        "window_ms": (hi - lo) * 1e-3,
        "span_ms_per_unit": dict(sorted(per_unit.items(), key=lambda kv: -kv[1])),
        "span_counts": {n: sum(1 for m, _, _ in spans if m == n) for n in per_unit},
        "coverage": {p: coverage(spans, p, c) for p, c in CHILDREN.items() if p in per_unit},
        "idle_by_span_s": tr.idle_by_span(host, n=40),
        "host_busy_s": tr.busy_s(host), "host_window_s": host.window_s,
    }
    if record["kind"] == "infer":
        stage = record["stage_ms"]
        for span, key in (("pod.detect", "detect"), ("pod.head_bank", "head_outputs")):
            untraced = sum(stage[key]) / len(stage[key]) if stage.get(key) else None
            out[f"{span}.untraced_ms"] = untraced
            if untraced and span in per_unit:
                out[f"{span}.inflation"] = per_unit[span] / untraced
    else:
        untraced = record["window_s"] * 1e3 / max(record["steps"], 1)
        out["pod.step.untraced_ms"] = untraced
        if "pod.step" in per_unit:
            out["pod.step.inflation"] = per_unit["pod.step"] / untraced
    return out


def report(argv, device=None, tweak=None, out_dir=os.path.join(ROOT, "chiprun_out")) -> dict:
    """One traced run of the cell `argv` names; its span report."""
    captured = {}
    read_metrics = bench.read_metrics

    def keep(metrics, record):
        captured["record"] = record
        return read_metrics(metrics, record)

    bench.read_metrics = keep
    try:
        rc = run.main(list(argv) + ["--trace", "1"], device=device, tweak=tweak)
    finally:
        bench.read_metrics = read_metrics
    if rc != 0 or captured.get("record", {}).get("host_trace") is None:
        raise SystemExit(f"the traced run gave no host trace (exit code {rc})")
    out = summarize(captured["record"])
    print("span_report: " + json.dumps(out), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"span_report_{out['cell']}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def span_cost(calls_off: int = 1_000_000, calls_on: int = 20_000) -> dict:
    """Microseconds a `with span(...)` with no profiler and under a CPU (and
    CUDA) profiler, a bare `record_function` with none, and the empty loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pod_compare_tpu_torch.utils.profiling import span

    def per_call(fn, calls):
        t0 = time.perf_counter()
        for _ in range(calls):
            with fn("pod.x"):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    t0 = time.perf_counter()
    for _ in range(calls_off):
        pass
    out = {"empty_loop_us": (time.perf_counter() - t0) / calls_off * 1e6,
           "span_off_us": per_call(span, calls_off),
           "record_function_off_us": per_call(record_function, calls_on)}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        out["span_on_us"] = per_call(span, calls_on)
    print("span_cost: " + json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--span-cost", action="store_true")
    args, rest = p.parse_known_args(argv)
    if args.span_cost:
        span_cost()
        return 0
    report(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
