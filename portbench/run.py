"""Run one cell of the port's benchmark on the machine it is started on.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration and traffic, its
metrics and its limits come from BENCHMARK.json and the files under
portbench/ (``harness/bench.py``). With --trace 0 the last line of
standard output is the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from a run whose stages are timed between syncs
and a short sub-window traced by ``torch.profiler``. Earlier lines give
the card, the kernels' launch counts and what the detections hold; the
last lines of standard error give each number of the output check beside
its limit. Exits with 3, printing no result, without enough CUDA cards,
and with 4 if a JAX module or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)
# Kernel caches at fixed paths inside the checkout (build/ is where the
# port's nvcc libraries go), so that only a checkout's first run builds.
os.environ["TRITON_CACHE_DIR"] = os.path.join(CHECKOUT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CHECKOUT, "build", "torch_extensions")

import torch  # noqa: E402

from portbench.harness import bench, trace as tr  # noqa: E402


@dataclass
class Context:
    cell: bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float


def card_line() -> str:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else name
    except (OSError, subprocess.SubprocessError, IndexError):
        return name


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, tweak=None, t0=None) -> int:
    """`device` and `tweak` (a function of the loaded cell) are for tests:
    a CPU run at a small size, which skips the look for cards."""
    args = parse(argv)
    cell = bench.load_cell(args.workload)
    if tweak is not None:
        tweak(cell)
    diagnostics = []
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda")
        diagnostics.append(f"card: {card_line()}, {torch.cuda.device_count()} visible")
    device = torch.device(device)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device,
                  T0 if t0 is None else t0)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    record, numbers, driver_lines, attempted, failed = driver.run(ctx)
    diagnostics += driver_lines
    diagnostics.append("compared: " + ", ".join(f"{k} {v!r}" for k, v in sorted(numbers.items())))
    checks = bench.check_limits(numbers, cell.limits)
    correct = failed == 0 and all(c["ok"] for c in checks.values())
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    metrics = bench.read_metrics(cell.per_layer if args.trace else cell.end_to_end, record)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(record["peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    trace = record.get("trace")
    if args.trace and trace is not None:
        dev["busy_s"] = tr.busy_s(trace)
        dev["window_s"] = trace.window_s
        host = record.get("host_trace")
        result["breakdown"] = {"device_ops": tr.top_device_ops(trace),
                               "idle_gaps": tr.idle_by_span(host) if host else []}
    bench.emit(result, checks, diagnostics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
