"""Host milliseconds a batch inside the port's ``pod.core`` spans: the
per-image candidate core (``inference/core.py``), summed over the
batch's images, in the host-traced pass (``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "infer", "pod.core")
