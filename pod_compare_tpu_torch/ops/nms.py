"""Fixed-shape, padded non-maximum suppression.

Counterpart of ``pod_compare_tpu/ops/nms.py`` (a ``lax.scan`` there, not a
Pallas kernel): ``max_out`` greedy steps of (argmax over the live scores,
suppress one IoU row), so every shape is static and the output is padded
with a validity mask. Ties go to the lower index, as ``jnp.argmax`` breaks
them. ``batched_nms`` is the operator ``pod_compare_tpu_torch::batched_nms``
(``ops/kernels/nms.py``): the plain loop on the CPU, one launch of the CUDA
kernel ``csrc/nms.cu`` on a card, one node of an exported program.
"""

from typing import NamedTuple

import torch

from pod_compare_tpu_torch.ops.kernels import nms as _knms
from pod_compare_tpu_torch.utils.profiling import span


class NMSResult(NamedTuple):
    """Padded NMS output: indices into the input, score-descending order."""

    indices: torch.Tensor  # (max_out,) int64
    valid: torch.Tensor  # (max_out,) bool


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> NMSResult:
    """Class-agnostic greedy NMS over padded candidates (the plain loop,
    ``ops/kernels/nms.py::nms_plain``).

    Args:
        boxes: (N, 4) XYXY; scores: (N,), higher kept first; valid: (N,)
            bool, padded entries never selected.
        iou_threshold: suppress boxes with IoU > threshold (equality kept).
        max_out: output size.
    """
    return NMSResult(*_knms.nms_plain(boxes, scores, valid, iou_threshold, max_out))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> NMSResult:
    """Class-aware NMS through per-class coordinate offsets: boxes of
    different classes never suppress each other. One call of the operator;
    while a profiler records, the call is the span ``pod.nms``."""
    with span("pod.nms"):
        return NMSResult(*_knms.batched_nms_op(boxes, scores, classes, valid, iou_threshold,
                                               max_out))
