"""Inference/fusion modes on one image's padded candidates.

Counterpart of ``pod_compare_tpu/inference/modes.py``: ``standard_nms``,
``anchor_statistics``, ``bayes_od`` (Bayesian or covariance-intersection
box merge) and the black-box merge of post-NMS detections from several
runs or ensemble members. The pre-NMS MC-dropout and ensemble modes are
``standard_nms`` on the averaged head outputs (the predictor's dispatch).
While a profiler records, BayesOD's fusion opens the span ``pod.fusion``
and the greedy merge's clustering ``pod.merge``.
"""

import torch

from pod_compare_tpu_torch.inference.core import Candidates, Detections
from pod_compare_tpu_torch.ops.boxes import pairwise_iou
from pod_compare_tpu_torch.ops.fusion import (
    bayesian_fusion,
    cluster_statistics,
    covariance_intersection_fusion,
    greedy_sequential_clusters,
)
from pod_compare_tpu_torch.ops.nms import batched_nms
from pod_compare_tpu_torch.utils.profiling import span

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


def _nms_clusters(cands: Candidates, nms_thresh: float, max_dets: int,
                  affinity_threshold: float):
    """NMS centers and their clusters: every valid candidate with IoU above
    the affinity threshold (`raw`), and those of the center's class."""
    keep = batched_nms(
        cands.boxes, cands.scores, cands.classes, cands.valid, nms_thresh, max_dets
    )
    # (max_dets, C) kept-vs-all IoU, not the (C, C) matrix
    iou = pairwise_iou(cands.boxes[keep.indices], cands.boxes)
    raw = (iou > affinity_threshold) & cands.valid[None, :]
    center_classes = cands.classes[keep.indices]
    return keep, raw, raw & (cands.classes[None, :] == center_classes[:, None])


def anchor_statistics(
    cands: Candidates,
    nms_thresh: float,
    max_dets: int,
    affinity_threshold: float,
) -> Detections:
    """Output-redundancy fusion: NMS centers, IoU clusters, the members'
    sample mean and covariance plus their mean covariance. A cluster falls
    back to its center when it has fewer than two raw IoU members, counted
    before the class filter as the reference counts them."""
    keep, raw_members, member_mask = _nms_clusters(cands, nms_thresh, max_dets,
                                                   affinity_threshold)
    boxes, probs, covs = cluster_statistics(
        member_mask, cands.boxes, cands.prob_vectors,
        cands.covs if cands.has_cov else None,
        min_members=2, center_idx=keep.indices,
        fallback_counts=raw_members.sum(dim=1),
    )
    return Detections(
        boxes=boxes, covs=covs, scores=probs.amax(dim=1), classes=probs.argmax(dim=1),
        prob_vectors=probs, valid=keep.valid, cluster_size=member_mask.sum(dim=1),
    )


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
    keep, cluster_mask, fusion_mask = _nms_clusters(cands, nms_thresh, max_dets,
                                                    affinity_threshold)
    with span("pod.fusion"):
        if cands.has_cov:
            covs = _condition(cands.covs)
        else:
            eye = torch.eye(4, dtype=cands.boxes.dtype, device=cands.boxes.device)
            covs = (1e-4 * eye).expand(cands.covs.shape)
        if box_merge_mode == "bayesian_inference":
            fused_boxes, fused_covs = bayesian_fusion(fusion_mask, cands.boxes, covs)
        elif box_merge_mode == "covariance_intersection":
            fused_boxes, fused_covs = covariance_intersection_fusion(fusion_mask, cands.boxes, covs)
        else:
            raise ValueError(f"Invalid BAYES_OD.BOX_MERGE_MODE {box_merge_mode}")

        if cls_merge_mode == "bayesian_inference":
            m = cluster_mask.to(cands.prob_vectors.dtype)
            counts = m.sum(dim=1).clamp_min(1.0)
            probs = (m @ cands.prob_vectors) / counts[:, None]
            scores = probs.amax(dim=1)
            classes = probs.argmax(dim=1)
        elif cls_merge_mode == "max_score":
            probs = cands.prob_vectors[keep.indices]
            scores = cands.scores[keep.indices]
            classes = cands.classes[keep.indices]
        else:
            raise ValueError(f"Invalid BAYES_OD.CLS_MERGE_MODE {cls_merge_mode}")

        return Detections(
            boxes=fused_boxes, covs=fused_covs, scores=scores, classes=classes,
            prob_vectors=probs, valid=keep.valid, cluster_size=fusion_mask.sum(dim=1),
        )


def black_box_merge(
    dets: Detections,
    nms_thresh: float,
    max_dets: int,
    affinity_threshold: float,
    is_generalized_rcnn: bool = False,
) -> Detections:
    """Merge post-NMS detections of M runs or ensemble members: greedy
    same-class clusters in input order, each cluster's member mean, sample
    covariance plus mean member covariance and mean prob vector (its center
    alone below two members), then class-aware NMS over the cluster centers.

    `dets` holds the members' detections concatenated run-major (member 0's
    first): the clustering depends on that order. Generalized-RCNN prob
    vectors carry a trailing background column left out of the score.
    """
    iou = pairwise_iou(dets.boxes, dets.boxes)
    with span("pod.merge"):
        centers, members = greedy_sequential_clusters(
            iou, dets.classes, dets.valid, affinity_threshold
        )
    n = dets.boxes.shape[0]
    boxes, probs, covs = cluster_statistics(
        members, dets.boxes, dets.prob_vectors, dets.covs,
        min_members=2, center_idx=torch.arange(n, device=dets.boxes.device),
    )
    score_probs = probs[:, :-1] if is_generalized_rcnn else probs
    scores = score_probs.amax(dim=1)
    classes = score_probs.argmax(dim=1)
    keep = batched_nms(boxes, scores, classes, centers, nms_thresh, max_dets)
    merged = Detections(
        boxes=boxes, covs=covs, scores=scores, classes=classes,
        prob_vectors=probs, valid=centers, cluster_size=members.sum(dim=1),
    )
    return merged.gather(keep.indices, keep.valid)


def concatenate_detections(dets_list) -> Detections:
    """Concatenate per-member Detections along the detection axis (the
    per-candidate bookkeeping fields are dropped)."""
    cat = lambda name: torch.cat([getattr(d, name) for d in dets_list], dim=0)
    return Detections(
        boxes=cat("boxes"), covs=cat("covs"), scores=cat("scores"),
        classes=cat("classes"), prob_vectors=cat("prob_vectors"), valid=cat("valid"),
    )
