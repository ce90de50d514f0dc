"""Host milliseconds a step inside the port's ``pod.loss`` spans: the
losses, the matcher included, in the host-traced pass
(``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "train", "pod.loss")
