"""Fixed-shape, padded non-maximum suppression in plain PyTorch.

Counterpart of ``pod_compare_tpu/ops/nms.py`` (a ``lax.scan`` there, not a
Pallas kernel): ``max_out`` greedy steps of (argmax over the live scores,
suppress one IoU row), so every shape is static and the output is padded
with a validity mask. Nothing reads a value back to the host, so on a GPU
the loop only queues work. Ties go to the lower index, as ``jnp.argmax``
breaks them.
"""

from typing import NamedTuple

import torch

from pod_compare_tpu_torch.utils.profiling import span

_NEG_INF = -1e10


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
    """Class-agnostic greedy NMS over padded candidates.

    Args:
        boxes: (N, 4) XYXY; scores: (N,), higher kept first; valid: (N,)
            bool, padded entries never selected.
        iou_threshold: suppress boxes with IoU > threshold (equality kept).
        max_out: output size.
    """
    cur = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    # The corners and areas of every box, once: a step picks one row of each
    # and computes the IoU of that box against all, with the same operations
    # in the same order as one box's row alone. Each step is ~24 operations,
    # which is what an exported program records for it.
    lo, hi = boxes[:, 0:2], boxes[:, 2:4]
    areas = (boxes[:, 2] - boxes[:, 0]).clamp_min(0.0) * (boxes[:, 3] - boxes[:, 1]).clamp_min(0.0)
    indices, oks = [], []
    for _ in range(max_out):
        # One-element index tensors throughout: indexing with a 0-d tensor
        # would read it back to the host at every step.
        idx = torch.argmax(cur).reshape(1)
        ok = cur.index_select(0, idx) > _NEG_INF / 2
        rb = torch.minimum(hi.index_select(0, idx), hi)
        lt = torch.maximum(lo.index_select(0, idx), lo)
        wh = (rb - lt).clamp_min(0.0)
        inter = wh[:, 0] * wh[:, 1]
        union = areas.index_select(0, idx) + areas - inter
        pos = union > 0
        iou = torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)
        cur = torch.where(ok & (iou > iou_threshold), _NEG_INF, cur).index_fill(0, idx, _NEG_INF)
        indices.append(idx)
        oks.append(ok)
    return NMSResult(indices=torch.cat(indices), valid=torch.cat(oks))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> NMSResult:
    """Class-aware NMS through per-class coordinate offsets: boxes of
    different classes never suppress each other. While a profiler records,
    the call is the span ``pod.nms``."""
    with span("pod.nms"):
        max_coord = torch.where(valid[:, None], boxes, 0.0).max() + 1.0
        offsets = classes.to(boxes.dtype)[:, None] * max_coord
        return nms(boxes + offsets, scores, valid, iou_threshold, max_out)
