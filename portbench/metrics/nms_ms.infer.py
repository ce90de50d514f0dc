"""Host milliseconds a batch inside the port's ``pod.nms`` spans:
class-aware NMS (``ops/nms.py::batched_nms``), every call of the batch,
in the host-traced pass (``harness/program_spans.py``)."""

from portbench.harness.program_spans import span_ms


def read(run):
    return span_ms(run, "infer", "pod.nms")
