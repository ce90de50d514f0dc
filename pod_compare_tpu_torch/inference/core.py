"""Per-image probabilistic anchorwise inference core (analytic sampling).

Counterpart of ``pod_compare_tpu/inference/core.py``: class probabilities
from the predicted logit Gaussians, a per-level top-k of candidates, their
closed-form decode moments, and the epistemic box covariance across
stochastic runs. Shapes stay fixed: the top-k is padded and carries a
validity mask. This slice ports the default ``analytic`` sampling; the
Monte-Carlo banks (``mc_iid``, ``mc_shared``) come later and raise here.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from pod_compare_tpu_torch.ops.boxes import (
    decode_deltas,
    decoded_box_mean,
    decoded_box_moments,
)
from pod_compare_tpu_torch.ops.gaussian import (
    covariance_output_to_cholesky,
    sample_mean_covariance,
)


class Detections(NamedTuple):
    """Padded detection set (one image, or a batch with a leading axis).

    boxes (D, 4) XYXY; covs (D, 4, 4); scores (D,); classes (D,) int64;
    prob_vectors (D, K); valid (D,) bool. `anchor_idx` is the source anchor
    of each detection on NMS-first paths; `cluster_size` is the number of
    candidates BayesOD fused into each detection.
    """

    boxes: torch.Tensor
    covs: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    prob_vectors: torch.Tensor
    valid: torch.Tensor
    anchor_idx: Optional[torch.Tensor] = None
    cluster_size: Optional[torch.Tensor] = None

    def gather(self, idx: torch.Tensor, idx_valid: torch.Tensor) -> "Detections":
        """Reindex all fields by `idx`, intersecting validity."""
        pick = lambda t: None if t is None else t[idx]
        return Detections(
            boxes=self.boxes[idx],
            covs=self.covs[idx],
            scores=self.scores[idx],
            classes=self.classes[idx],
            prob_vectors=self.prob_vectors[idx],
            valid=self.valid[idx] & idx_valid,
            anchor_idx=pick(self.anchor_idx),
            cluster_size=pick(self.cluster_size),
        )


class Candidates(NamedTuple):
    """Top-k anchor candidates before NMS/fusion (one image)."""

    boxes: torch.Tensor  # (C, 4) decoded box means
    covs: torch.Tensor  # (C, 4, 4); zeros if no covariance source
    has_cov: bool
    scores: torch.Tensor  # (C,)
    classes: torch.Tensor  # (C,) int64
    prob_vectors: torch.Tensor  # (C, K)
    valid: torch.Tensor  # (C,)
    anchor_idx: Optional[torch.Tensor] = None


def classification_probs(
    box_cls: torch.Tensor,
    box_cls_var: Optional[torch.Tensor],
    impl: str = "analytic",
) -> torch.Tensor:
    """Mean sigmoid probability under the logit Gaussian N(logit, exp(var)):
    32-node Gauss-Hermite quadrature (the S -> inf limit of the JAX
    package's Monte-Carlo banks). Without a variance head, the sigmoid."""
    if box_cls_var is None:
        return torch.sigmoid(box_cls)
    if impl != "analytic":
        raise NotImplementedError(f"CLS_SAMPLING={impl!r} is not ported yet; use 'analytic'")
    std = torch.sqrt(torch.exp(box_cls_var))
    nodes, weights = np.polynomial.hermite.hermgauss(32)
    nodes = torch.as_tensor(np.sqrt(2.0) * nodes, dtype=box_cls.dtype, device=box_cls.device)
    weights = torch.as_tensor(
        weights / np.sqrt(np.pi), dtype=box_cls.dtype, device=box_cls.device
    )
    z = box_cls[None] + nodes[:, None, None] * std[None]
    return torch.einsum("s,sak->ak", weights, torch.sigmoid(z))


def _topk(scores: torch.Tensor, k: int):
    """Top-k with ties to the lower index, as `jax.lax.top_k` breaks them."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def topk_candidates(
    scores_all: torch.Tensor,
    topk: int,
    level_sizes: Optional[Sequence[int]],
):
    """Top-k per FPN level, concatenated (the reference selects per level);
    a single global top-k when `level_sizes` is None."""
    if level_sizes is None:
        return _topk(scores_all, topk)
    assert sum(level_sizes) == scores_all.shape[0], (level_sizes, scores_all.shape)
    scores_parts, idx_parts = [], []
    start = 0
    for n in level_sizes:
        s, i = _topk(scores_all[start:start + n], min(topk, int(n)))
        scores_parts.append(s)
        idx_parts.append(i + start)
        start += n
    return torch.cat(scores_parts), torch.cat(idx_parts)


def probabilistic_inference_core(
    anchors: torch.Tensor,
    box_cls: torch.Tensor,
    box_delta: torch.Tensor,
    box_cls_var: Optional[torch.Tensor],
    box_reg_var: Optional[torch.Tensor],
    run_deltas: Optional[torch.Tensor],
    *,
    topk: int,
    score_thresh: float,
    box_reg_weights=(1.0, 1.0, 1.0, 1.0),
    level_sizes: Optional[Sequence[int]] = None,
    cls_sampling: str = "analytic",
    box_sampling: str = "analytic",
    defer_covariance: bool = False,
) -> Candidates:
    """Single-image anchorwise probabilistic inference.

    Args:
        anchors: (R, 4).
        box_cls/box_delta: (R, K) logits / (R, 4) deltas, averaged over
            stochastic runs when there are several.
        box_cls_var/box_reg_var: optional (R, K) / (R, 4 or 10) heads.
        run_deltas: optional (M, R, 4) per-run deltas; their decoded spread
            is the epistemic box covariance.
        topk: candidates per level; level_sizes: per-level anchor counts.
        defer_covariance: compute only the decode means (for NMS-first
            paths that rebuild covariances of the survivors through
            `deferred_covariance`).
    """
    if box_reg_var is not None and box_sampling != "analytic":
        raise NotImplementedError(
            f"BOX_SAMPLING={box_sampling!r} is not ported yet; use 'analytic'"
        )
    probs = classification_probs(box_cls, box_cls_var, impl=cls_sampling)
    scores_all = probs.amax(dim=1)
    classes_all = probs.argmax(dim=1)  # ties to the lower class, as jnp.argmax
    top_scores, top_idx = topk_candidates(scores_all, topk, level_sizes)
    valid = top_scores > score_thresh

    sel_deltas = box_delta[top_idx]
    sel_anchors = anchors[top_idx]
    sel_probs = probs[top_idx]
    sel_classes = classes_all[top_idx]

    epistemic_cov = None
    if run_deltas is not None:
        run_boxes = decode_deltas(run_deltas[:, top_idx, :], sel_anchors, box_reg_weights)
        _, epistemic_cov = sample_mean_covariance(run_boxes)

    if box_reg_var is not None and defer_covariance and epistemic_cov is None:
        chol = covariance_output_to_cholesky(box_reg_var[top_idx])
        diag = torch.einsum("cij,cij->ci", chol, chol)
        boxes = decoded_box_mean(sel_deltas, diag, sel_anchors, box_reg_weights)
        covs = boxes.new_zeros(boxes.shape[:-1] + (4, 4))
        has_cov = False
    elif box_reg_var is not None:
        chol = covariance_output_to_cholesky(box_reg_var[top_idx])
        delta_cov = torch.einsum("cij,ckj->cik", chol, chol)
        boxes, covs = decoded_box_moments(sel_deltas, delta_cov, sel_anchors, box_reg_weights)
        if epistemic_cov is not None:
            covs = covs + epistemic_cov
        has_cov = True
    else:
        boxes = decode_deltas(sel_deltas, sel_anchors, box_reg_weights)
        has_cov = epistemic_cov is not None
        covs = epistemic_cov if has_cov else boxes.new_zeros(boxes.shape[:-1] + (4, 4))

    return Candidates(
        boxes=boxes,
        covs=covs,
        has_cov=has_cov,
        scores=top_scores,
        classes=sel_classes,
        prob_vectors=sel_probs,
        valid=valid,
        anchor_idx=top_idx,
    )


def deferred_covariance(
    dets: Detections,
    box_delta: torch.Tensor,
    box_reg_var: torch.Tensor,
    anchors: torch.Tensor,
    box_reg_weights=(1.0, 1.0, 1.0, 1.0),
) -> Detections:
    """Fill analytic box covariances for NMS survivors only (companion of
    `probabilistic_inference_core(defer_covariance=True)`)."""
    a_idx = dets.anchor_idx
    chol = covariance_output_to_cholesky(box_reg_var[a_idx])
    delta_cov = torch.einsum("cij,ckj->cik", chol, chol)
    _, covs = decoded_box_moments(box_delta[a_idx], delta_cov, anchors[a_idx], box_reg_weights)
    return dets._replace(covs=covs)
