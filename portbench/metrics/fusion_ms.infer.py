"""Host milliseconds a batch inside the port's ``pod.fusion`` spans:
BayesOD's box fusion and class merge, summed over the batch's images, in
the host-traced pass (``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "infer", "pod.fusion")
