"""Host milliseconds a step inside the port's ``pod.backbone`` spans: the
training forward's backbone and FPN (``models/retinanet.py::
forward_train``), in the host-traced pass (``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "train", "pod.backbone")
