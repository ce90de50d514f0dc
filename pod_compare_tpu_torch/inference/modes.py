"""Inference/fusion modes on one image's padded candidates.

Counterpart of ``pod_compare_tpu/inference/modes.py`` for ``standard_nms``
and ``bayes_od``; the other modes come with a later slice.
"""

import torch

from pod_compare_tpu_torch.inference.core import Candidates, Detections
from pod_compare_tpu_torch.ops.boxes import pairwise_iou
from pod_compare_tpu_torch.ops.fusion import bayesian_fusion
from pod_compare_tpu_torch.ops.nms import batched_nms

# Relative diagonal jitter added before precision-matrix inversion in
# Bayesian fusion (float32 Cholesky needs a floor scaled to the covariance).
_FUSION_JITTER = 1e-5


def _condition(covs: torch.Tensor) -> torch.Tensor:
    """Add trace-relative diagonal jitter keeping fusion float32-stable."""
    mean_diag = torch.diagonal(covs, dim1=-2, dim2=-1).mean(dim=-1, keepdim=True)
    eps = _FUSION_JITTER * mean_diag.clamp_min(1.0)[..., None]
    return covs + eps * torch.eye(covs.shape[-1], dtype=covs.dtype, device=covs.device)


def _as_detections(c: Candidates) -> Detections:
    return Detections(
        boxes=c.boxes, covs=c.covs, scores=c.scores, classes=c.classes,
        prob_vectors=c.prob_vectors, valid=c.valid, anchor_idx=c.anchor_idx,
    )


def standard_nms(cands: Candidates, nms_thresh: float, max_dets: int) -> Detections:
    """Class-aware NMS + top-`max_dets`."""
    keep = batched_nms(
        cands.boxes, cands.scores, cands.classes, cands.valid, nms_thresh, max_dets
    )
    return _as_detections(cands).gather(keep.indices, keep.valid)


def bayes_od(
    cands: Candidates,
    nms_thresh: float,
    max_dets: int,
    affinity_threshold: float,
    box_merge_mode: str,
    cls_merge_mode: str,
) -> Detections:
    """BayesOD: NMS centers define clusters (IoU > affinity); each cluster's
    class-consistent members are fused as Gaussians; the class comes from
    the center (`max_score`) or the members' mean (`bayesian_inference`).
    Without a covariance source, members get identical 1e-4·I covariances."""
    keep = batched_nms(
        cands.boxes, cands.scores, cands.classes, cands.valid, nms_thresh, max_dets
    )
    iou = pairwise_iou(cands.boxes[keep.indices], cands.boxes)
    cluster_mask = (iou > affinity_threshold) & cands.valid[None, :]
    center_classes = cands.classes[keep.indices]
    fusion_mask = cluster_mask & (cands.classes[None, :] == center_classes[:, None])

    if cands.has_cov:
        covs = _condition(cands.covs)
    else:
        eye = torch.eye(4, dtype=cands.boxes.dtype, device=cands.boxes.device)
        covs = (1e-4 * eye).expand(cands.covs.shape)
    if box_merge_mode != "bayesian_inference":
        raise NotImplementedError(
            f"BAYES_OD.BOX_MERGE_MODE={box_merge_mode!r} is not ported yet"
        )
    fused_boxes, fused_covs = bayesian_fusion(fusion_mask, cands.boxes, covs)

    if cls_merge_mode == "bayesian_inference":
        m = cluster_mask.to(cands.prob_vectors.dtype)
        counts = m.sum(dim=1).clamp_min(1.0)
        probs = (m @ cands.prob_vectors) / counts[:, None]
        scores = probs.amax(dim=1)
        classes = probs.argmax(dim=1)
    elif cls_merge_mode == "max_score":
        probs = cands.prob_vectors[keep.indices]
        scores = cands.scores[keep.indices]
        classes = center_classes
    else:
        raise ValueError(f"Invalid BAYES_OD.CLS_MERGE_MODE {cls_merge_mode}")

    return Detections(
        boxes=fused_boxes, covs=fused_covs, scores=scores, classes=classes,
        prob_vectors=probs, valid=keep.valid, cluster_size=fusion_mask.sum(dim=1),
    )
