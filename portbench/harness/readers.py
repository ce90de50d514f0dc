"""What the metric readers share: the run's counts and the trace's kernels.

A reader (``metrics/<name>.py``) takes the run's record, a dict with
`kind` ('infer' or 'train'), `cell`, `window_s`, `images`, `batch`,
`peak_bytes`, `setup_s`, the per-batch or per-step times, `stage_ms`,
the launch counts and `trace` (a ``trace.Trace`` in a traced run, else
None), and returns a number, or None where it finds nothing to read.
"""

import re
import statistics
from typing import Callable, List, Optional

from portbench.counts import convs, kernels, peaks
from portbench.harness import trace as tr

K1 = re.compile(r"dropout_levels_kernel")
K2 = re.compile(r"focal_kernel")


def k1_direction(name: str) -> Optional[str]:
    """'forward' or 'backward' of a K1 kernel name, demangled
    (`dropout_levels_kernel<T, false, N>`) or mangled (`...Lb0E...`)."""
    if not K1.search(name):
        return None
    m = re.search(r"dropout_levels_kernel<[^,>]+,\s*(true|false)", name)
    if m:
        return "backward" if m.group(1) == "true" else "forward"
    m = re.search(r"dropout_levels_kernelI\w*?Lb([01])E", name)
    if m:
        return "backward" if m.group(1) == "1" else "forward"
    return None


def quantile(values: List[float], q: int, n: int) -> Optional[float]:
    """statistics.quantiles(values, n=n)[q - 1], or None for too few."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=n)[q - 1]


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def _model(run):
    return run["cell"].config["model"]


def flops_per_image(run) -> float:
    m = _model(run)
    cs = convs.convs(run["cell"].config["canvas"], m["num_classes"], m["num_anchors"],
                     m["num_convs"], m["cls_var"], m["bbox_cov_dims"])
    if run["kind"] == "train":
        return 2.0 * convs.train_macs_per_image(cs)
    return 2.0 * convs.infer_macs_per_image(cs, run["num_runs"])


def mfu_pct(run, kind: str) -> Optional[float]:
    if run["kind"] != kind or not run["images"] or run["window_s"] <= 0:
        return None
    return 100.0 * flops_per_image(run) * run["images"] / run["window_s"] / peaks.BF16_FLOPS


def kernel_time_s(run, match: Callable[[str], bool]):
    """(launches, device seconds) of the traced kernels `match` takes."""
    trace = run.get("trace")
    if trace is None:
        return 0, 0.0
    ks = trace.kernels(match)
    return len(ks), sum(e - s for _, s, e in ks) * 1e-6


def k1_bytes(run) -> int:
    """Bytes of x in one K1 launch: every image's five levels in bf16 (a
    mask shared by the batch is still applied to each image)."""
    return kernels.k1_bytes(run["batch"], convs.level_positions(run["cell"].config["canvas"]))


def roofline_pct(bound_s: float, time_s: float) -> Optional[float]:
    if time_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / time_s


def idle_pct(run, kind: str) -> Optional[float]:
    trace = run.get("trace")
    if run["kind"] != kind or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(trace) / trace.window_s)
