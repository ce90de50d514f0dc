"""Anchor–ground-truth label assignment.

Counterpart of ``pod_compare_tpu/ops/matcher.py`` (detectron2's Matcher +
RetinaNet.label_anchors): interval labels on the best IoU of each anchor,
low-quality matches forced positive, ground truth padded to a static G with
a validity mask. The JAX package selects the matched class and box with a
one-hot product, a TPU workaround for slow gathers; here a gather gives the
same values.
"""

from typing import NamedTuple, Tuple

import torch

from pod_compare_tpu_torch.ops.boxes import pairwise_iou


class AnchorLabels(NamedTuple):
    """Per-anchor assignment.

    gt_classes: (..., R) int64: the matched class for positives,
        `num_classes` for background, -1 for ignore.
    matched_boxes: (..., R, 4): the matched gt box (arbitrary where the
        anchor is not positive).
    """

    gt_classes: torch.Tensor
    matched_boxes: torch.Tensor


def label_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    iou_thresholds: Tuple[float, float] = (0.4, 0.5),
    allow_low_quality: bool = True,
) -> AnchorLabels:
    """Assign each anchor a class label and a regression target box.

    Args:
        anchors: (R, 4) XYXY.
        gt_boxes: (G, 4) padded ground truth.
        gt_classes: (G,) contiguous class ids.
        gt_valid: (G,) bool padding mask.
        num_classes: K, the background label.
        iou_thresholds: (negative below, positive at or above).
        allow_low_quality: anchors achieving a gt's highest IoU become
            positive (RetinaNet uses True).
    """
    lo, hi = iou_thresholds
    iou = pairwise_iou(gt_boxes, anchors)  # (G, R)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))

    # torch.argmax returns the first maximum, as jnp.argmax does.
    matched_idx = torch.argmax(iou, dim=0)  # (R,)
    matched_iou = iou.gather(0, matched_idx[None])[0]

    # [< lo] -> 0 (background), [lo, hi) -> -1 (ignore), [>= hi] -> 1.
    label = torch.where(matched_iou >= hi, 1, torch.where(matched_iou >= lo, -1, 0))

    if allow_low_quality:
        # Anchors achieving each gt's maximum IoU become positive and keep
        # their own argmax assignment; a gt whose best IoU is 0 would flag
        # every anchor, hence the guard.
        highest_per_gt = iou.max(dim=1).values  # (G,)
        is_best = (iou == highest_per_gt[:, None]) & (highest_per_gt > 0)[:, None]
        forced = (is_best & gt_valid[:, None]).any(dim=0)
        del is_best
        label = torch.where(forced, 1, label)
    del iou

    matched_cls = gt_classes.long()[matched_idx]
    anchor_classes = torch.where(
        label == 1, matched_cls, torch.where(label == 0, num_classes, -1)
    )
    return AnchorLabels(gt_classes=anchor_classes, matched_boxes=gt_boxes[matched_idx])


def label_anchors_batch(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    iou_thresholds: Tuple[float, float] = (0.4, 0.5),
) -> AnchorLabels:
    """`label_anchors` for each image of a (B, G, ...) batch of ground truth.

    Image by image, so that one (G, R) IoU matrix is alive at a time: at
    G = 100 and R = 176,580 that is 71 MB, where a (B, G, R) batch of them
    would be B times that."""
    per_image = [
        label_anchors(anchors, b, c, v, num_classes, iou_thresholds)
        for b, c, v in zip(gt_boxes, gt_classes, gt_valid)
    ]
    return AnchorLabels(
        gt_classes=torch.stack([p.gt_classes for p in per_image]),
        matched_boxes=torch.stack([p.matched_boxes for p in per_image]),
    )
