"""Host milliseconds a step inside the port's ``pod.forward`` spans: the
training forward, in the host-traced pass
(``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "train", "pod.forward")
