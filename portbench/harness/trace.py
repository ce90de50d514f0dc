"""Host spans and the device trace of a run.

``Spans`` records the benchmark's own host spans (name, start, end on the
host clock) around its calls into the program; while the profiler runs,
each span is also a ``record_function`` range, so that the trace places it
on the device's timeline. ``profiled()`` runs ``torch.profiler`` over a
short sub-window and returns a ``Trace``: the device's activity (kernels,
copies and fills) and the host spans, in microseconds, read from the
profiler's Chrome trace (written to the run's temporary directory and
removed). Its reductions take the union of device intervals, so work that
overlaps is counted once.
"""

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "traced_window"


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations_ms(self, name: str) -> List[float]:
        return [(t1 - t0) * 1e3 for n, t0, t1 in self.records if n == name]


@dataclass
class Trace:
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end (us)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, match) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if match(e[0])]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi]
    return merged([iv for iv in clipped if iv[1] > iv[0]])


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) * 1e-6


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def top_device_ops(trace: Trace, n: int = 10) -> List[list]:
    total: Dict[str, float] = defaultdict(float)
    lo, hi = trace.window
    for name, s, e in trace.device:
        if e > lo and s < hi:
            total[name[:160]] += (min(e, hi) - max(s, lo)) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_span(trace: Trace, n: int = 10) -> List[list]:
    """Idle device time summed by the innermost host span at each gap's
    midpoint ('outside spans' where none was open)."""
    total: Dict[str, float] = defaultdict(float)
    spans = [s for s in trace.spans if s[0] != WINDOW_SPAN]
    for s, e in idle_gaps(trace):
        mid = 0.5 * (s + e)
        open_ = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "outside spans"
        total[name] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def parse_chrome_trace(events: List[dict]) -> Trace:
    trace = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            trace.device.append((ev.get("name", ""), start, end))
        elif cat == "user_annotation":
            trace.spans.append((ev.get("name", ""), start, end))
    windows = [s for s in trace.spans if s[0] == WINDOW_SPAN]
    if windows:
        trace.window = (windows[0][1], windows[0][2])
    return trace


@contextlib.contextmanager
def profiled(spans: Spans, out: list, host: bool):
    """Profile the body, which ends in a device sync, and append its Trace
    to `out`. With `host`, the profiler records the host's operations and
    the benchmark's spans too (the body's host time grows under it), and
    the window is the span WINDOW_SPAN; without, it records the device's
    activity alone, and the window is the body's wall time from its first
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    prof = profile(activities=activities)
    prof.__enter__()
    spans.profiling = host
    t0 = time.perf_counter()
    try:
        with spans(WINDOW_SPAN):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        wall_us = (time.perf_counter() - t0) * 1e6
        spans.profiling = False
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    trace = parse_chrome_trace(data["traceEvents"] if isinstance(data, dict) else data)
    if not host and trace.device:
        first = min(s for _, s, _ in trace.device)
        trace.window = (first, first + wall_us)
    out.append(trace)
