"""Probabilistic box fusion and clustering on fixed-size padded sets.

Counterpart of ``pod_compare_tpu/ops/fusion.py``. Cluster membership is a
(C, N) boolean matrix: row c flags the members fused into output slot c.
"""

from typing import Optional, Tuple

import torch

from pod_compare_tpu_torch.ops.gaussian import det4x4_psd, inv4x4_psd


def bayesian_fusion(
    member_mask: torch.Tensor,
    boxes: torch.Tensor,
    covs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision-weighted Gaussian product over cluster members.

    Args:
        member_mask: (C, N) bool; boxes: (N, 4) member means; covs:
            (N, 4, 4) member covariances (PSD and conditioned).
    Returns:
        fused mean (C, 4), fused covariance (C, 4, 4).
    """
    precs = inv4x4_psd(covs)
    m = member_mask.to(boxes.dtype)
    prec_sum = torch.einsum("cn,nij->cij", m, precs)
    # Guard empty clusters against singular sums; the caller masks them.
    prec_sum = prec_sum + 1e-8 * torch.eye(4, dtype=boxes.dtype, device=boxes.device)
    fused_cov = inv4x4_psd(prec_sum)
    weighted_means = m @ torch.einsum("nij,nj->ni", precs, boxes)
    fused_mean = torch.einsum("cij,cj->ci", fused_cov, weighted_means)
    return fused_mean, fused_cov


def covariance_intersection_fusion(
    member_mask: torch.Tensor,
    boxes: torch.Tensor,
    covs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance-intersection fusion with the reference's closed-form
    weights: member i of a cluster gets

        w_i = (det(P) - det(P - P_i) + det(P_i)) / (m det(P) + sum_j (det(P_j) - det(P - P_j)))

    where P_i are the member precisions, P their sum and m their count.
    The determinants of P - P_i are generic (the matrix is not PSD). The
    weights are differences of determinants and lose digits to
    cancellation in float32, as the JAX package's do.

    Args, returns: as `bayesian_fusion`.
    """
    dtype = boxes.dtype
    eye = torch.eye(4, dtype=dtype, device=boxes.device)
    precs = inv4x4_psd(covs)
    m = member_mask.to(dtype)
    counts = m.sum(dim=1)
    prec_sum = torch.einsum("cn,nij->cij", m, precs)
    prec_dets = det4x4_psd(precs)
    total_det = det4x4_psd(prec_sum + 1e-12 * eye)
    diff_det = torch.linalg.det(prec_sum[:, None] - precs[None])  # (C, N)
    numer = total_det[:, None] - diff_det + prec_dets[None]
    denom = counts * total_det + (m * (prec_dets[None] - diff_det)).sum(dim=1)
    omegas = m * numer / denom.clamp_min(1e-20)[:, None]
    weighted_prec_sum = torch.einsum("cn,nij->cij", omegas, precs) + 1e-8 * eye
    fused_cov = inv4x4_psd(weighted_prec_sum)
    weighted_means = omegas @ torch.einsum("nij,nj->ni", precs, boxes)
    fused_mean = torch.einsum("cij,cj->ci", fused_cov, weighted_means)
    return fused_mean, fused_cov


def cluster_statistics(
    member_mask: torch.Tensor,
    boxes: torch.Tensor,
    prob_vectors: torch.Tensor,
    covs: Optional[torch.Tensor] = None,
    min_members: int = 2,
    center_idx: Optional[torch.Tensor] = None,
    center_cov_fallback: float = 1e-4,
    fallback_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cluster member mean, unbiased sample covariance (plus the mean
    member covariance when `covs` is given) and mean prob vector; clusters
    with fewer than `min_members` fall back to their center's own values
    (covariance: the center's, or `center_cov_fallback`·I).

    Returns (C, 4) boxes, (C, K) prob vectors, (C, 4, 4) covariances.
    """
    dtype = boxes.dtype
    m = member_mask.to(dtype)
    counts = m.sum(dim=1)
    mean_boxes = (m @ boxes) / counts.clamp_min(1.0)[:, None]
    resid = (boxes[None] - mean_boxes[:, None]) * m[..., None]
    sample_cov = torch.einsum("cni,cnj->cij", resid, resid) / (
        (counts - 1.0).clamp_min(1.0)[:, None, None]
    )
    mean_probs = (m @ prob_vectors) / counts.clamp_min(1.0)[:, None]
    if covs is not None:
        mean_member_cov = torch.einsum("cn,nij->cij", m, covs) / (
            counts.clamp_min(1.0)[:, None, None]
        )
        cluster_cov = sample_cov + mean_member_cov
    else:
        cluster_cov = sample_cov

    if center_idx is not None:
        if covs is not None:
            center_cov = covs[center_idx]
        else:
            eye = torch.eye(4, dtype=dtype, device=boxes.device)
            center_cov = (center_cov_fallback * eye).expand(center_idx.shape[0], 4, 4)
        decision = counts if fallback_counts is None else fallback_counts
        big = (decision >= min_members)[:, None]
        mean_boxes = torch.where(big, mean_boxes, boxes[center_idx])
        mean_probs = torch.where(big, mean_probs, prob_vectors[center_idx])
        cluster_cov = torch.where(big[..., None], cluster_cov, center_cov)
    return mean_boxes, mean_probs, cluster_cov


def greedy_sequential_clusters(
    iou_matrix: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    affinity_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy same-class clustering in input order: box i opens a cluster
    iff no earlier cluster claimed it; its cluster is every valid
    same-class box with IoU >= threshold (clusters may overlap).

    The loop runs once per cluster and reads one flag back to the host per
    step.

    Returns:
        centers: (N,) bool, rows that opened a cluster; members: (N, N)
        bool, members[i] is cluster i's membership where centers[i].
    """
    affinity = (iou_matrix >= affinity_threshold) & (classes[:, None] == classes[None, :])
    affinity = affinity & valid[None, :] & valid[:, None]
    n = iou_matrix.shape[0]
    claimed = torch.zeros(n, dtype=torch.bool, device=iou_matrix.device)
    centers = torch.zeros_like(claimed)
    while True:
        open_ = valid & ~claimed
        if not bool(open_.any()):
            break
        i = int(torch.argmax(open_.to(torch.int8)))
        centers[i] = True
        claimed |= affinity[i]
        claimed[i] = True
    return centers, affinity & centers[:, None]
