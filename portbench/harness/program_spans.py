"""What the readers of the program's own spans share.

While a profiler records, the port opens ``pod.*`` spans
(``record_function`` ranges, ``utils/profiling.span``) around its stages;
the host-traced pass of a ``--trace 1`` run keeps them in
``run["host_trace"].spans``, in microseconds on the profiler's clock. A
reader sums one span's durations inside the traced window and divides by
the pass's batches (the traffic's `profile_batches`) or steps
(`profile_steps`). The profiler records every operator in that pass, so
the host time it reads is longer than the same stage's untraced time.
"""

from typing import Optional

UNITS = {"infer": "profile_batches", "train": "profile_steps"}


def span_ms(run, kind: str, name: str) -> Optional[float]:
    """Milliseconds a batch or step inside the span `name`; None for
    another kind of run, without a host trace or its window, or where the
    span never opened inside the window (a program without it)."""
    trace = run.get("host_trace")
    if run["kind"] != kind or trace is None:
        return None
    lo, hi = trace.window
    if hi <= lo:
        return None
    inside = [(max(s, lo), min(e, hi)) for n, s, e in trace.spans
              if n == name and e > lo and s < hi]
    if not inside:
        return None
    return sum(e - s for s, e in inside) * 1e-3 / int(run["cell"].traffic[UNITS[kind]])
