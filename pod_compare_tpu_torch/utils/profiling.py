"""Tracing and named spans.

The port's counterpart of ``pod_compare_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace of the host and, on CUDA, the
card around a training window or an inference loop, written under
``<output_dir>/profile`` in TensorBoard's format (a Chrome trace json);
``span`` names a region of the port's work in whatever profiler is
recording, on the clock of its device events, and costs one check of the
profiler's state when none is.
"""

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A ``record_function`` range named `name` while a profiler records
    (it appears in the trace as a ``user_annotation`` event); otherwise a
    shared no-op context, with no clock read and no allocation."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN
