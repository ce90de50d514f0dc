"""Tracing and section timing.

The port's counterpart of ``pod_compare_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace of the host and, on CUDA, the
card around a training window or an inference loop, written under
``<output_dir>/profile`` in TensorBoard's format (a Chrome trace json);
``annotate`` names a region in it; ``SectionTimer`` sums wall-clock time per
named section.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(output_dir: Optional[str], enabled: bool = True):
    """Profile the block (the card too when CUDA is available); yields the
    profiler, or None when disabled."""
    if not enabled or output_dir is None:
        yield None
        return
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return record_function(name)


class SectionTimer:
    """Host-side cumulative wall-clock timer for pipeline sections."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the block. With `sync` (a tensor or a device) on CUDA, the
        section ends when the stream it ran on, that device's current
        stream, has finished its work."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per call of each section."""
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}

    def report(self) -> str:
        return "\n".join(
            f"{name}: {avg * 1000:.2f} ms/call ({self.counts[name]} calls)"
            for name, avg in sorted(self.summary().items())
        )
