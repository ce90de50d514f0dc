"""Per-image probabilistic anchorwise inference core.

Counterpart of ``pod_compare_tpu/inference/core.py``: class probabilities
from the predicted logit Gaussians, a per-level top-k of candidates, their
box means and covariances, and the epistemic box covariance across
stochastic runs. Shapes stay fixed: the top-k is padded and carries a
validity mask.

Sampling (``CLS_SAMPLING``, ``BOX_SAMPLING``): ``analytic`` (Gauss-Hermite
class probabilities, closed-form decode moments; no random numbers),
``mc_iid`` (the reference's semantics: iid normals per anchor and class,
per candidate and sample) and ``mc_shared`` (one bank of normals shared
across anchors or candidates: the same marginal law per anchor). The
Monte-Carlo banks draw from a ``torch.Generator`` on the tensors' device;
their bits differ from the JAX package's threefry bits, their law does not.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from pod_compare_tpu_torch.ops.boxes import (
    decode_deltas,
    decoded_box_mean,
    decoded_box_moments,
    decode_delta_samples,
)
from pod_compare_tpu_torch.ops.gaussian import (
    covariance_output_to_cholesky,
    mvn_sample,
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


# Largest (chunk, C, 4) bank of box samples the sampled decode holds at once.
BOX_SAMPLE_CHUNK_ELEMS = 1 << 21
SAMPLING_IMPLS = ("analytic", "mc_iid", "mc_shared")


def _normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)


def classification_probs(
    box_cls: torch.Tensor,
    box_cls_var: Optional[torch.Tensor],
    impl: str = "analytic",
    num_samples: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Mean sigmoid probability under the logit Gaussian N(logit, exp(var)).

    impl 'analytic': 32-node Gauss-Hermite quadrature (the S -> inf limit
    of both banks); 'mc_iid': the mean over `num_samples` iid normals per
    (anchor, class); 'mc_shared': one (S, 1, K) bank shared across anchors.
    Without a variance head, the sigmoid."""
    if box_cls_var is None:
        return torch.sigmoid(box_cls)
    if impl not in SAMPLING_IMPLS:
        raise ValueError(f"Invalid CLS_SAMPLING {impl!r}")
    std = torch.sqrt(torch.exp(box_cls_var))
    if impl != "analytic":
        if impl == "mc_shared":
            shape = (num_samples,) + (1,) * (box_cls.dim() - 1) + tuple(box_cls.shape[-1:])
        else:
            shape = (num_samples,) + tuple(box_cls.shape)
        noise = _normal(generator, shape, box_cls)
        return torch.sigmoid(box_cls[None] + noise * std[None]).mean(dim=0)
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


def pick_chunk(num_samples: int, num_candidates: int) -> int:
    """Largest divisor of `num_samples` keeping a (chunk, C, 4) bank of box
    samples under BOX_SAMPLE_CHUNK_ELEMS elements."""
    limit = max(1, BOX_SAMPLE_CHUNK_ELEMS // max(4 * num_candidates, 1))
    if num_samples <= limit:
        return num_samples
    for c in range(limit, 0, -1):
        if num_samples % c == 0:
            return c
    return 1


def sampled_box_moments(
    generator: torch.Generator,
    deltas: torch.Tensor,
    chol: torch.Tensor,
    anchors: torch.Tensor,
    num_samples: int,
    weights=(1.0, 1.0, 1.0, 1.0),
    shared: bool = False,
):
    """Mean and unbiased (divisor S-1) covariance of the boxes decoded from
    `num_samples` delta samples deltas + L z per candidate, drawn in chunks
    (`pick_chunk`). Residuals are summed against the deterministic decode,
    so the sums stay small in float32. With `shared`, every candidate uses
    the same (chunk, 4) normals. (C, 4), (C, 4, 4) -> (C, 4), (C, 4, 4)."""
    num_cand = deltas.shape[0]
    chunk = pick_chunk(num_samples, num_cand)
    center = decode_deltas(deltas, anchors, weights)
    resid_sum = torch.zeros_like(center)
    outer_sum = center.new_zeros((num_cand, 4, 4))
    for _ in range(num_samples // chunk):
        if shared:
            z = _normal(generator, (chunk, 4), deltas)
            samples = deltas[None] + torch.einsum("cij,sj->sci", chol, z)
        else:
            samples = mvn_sample(generator, deltas, chol, chunk)
        resid = decode_delta_samples(samples, anchors, weights) - center[None]
        resid_sum = resid_sum + resid.sum(dim=0)
        outer_sum = outer_sum + torch.einsum("sci,scj->cij", resid, resid)
    n = float(num_samples)
    resid_mean = resid_sum / n
    covs = (outer_sum - n * torch.einsum("ci,cj->cij", resid_mean, resid_mean)) / max(n - 1.0, 1.0)
    return center + resid_mean, covs


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
    cls_num_samples: int = 0,
    box_num_samples: int = 0,
    generator: Optional[torch.Generator] = None,
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
        cls_sampling/box_sampling: 'analytic', 'mc_iid' or 'mc_shared'
            (`classification_probs`, `sampled_box_moments`), with
            cls_num_samples/box_num_samples draws from `generator`, a
            generator on the tensors' device (the class bank is drawn
            first, then the box bank).
        defer_covariance: compute only the analytic decode means (for
            NMS-first paths that rebuild covariances of the survivors
            through `deferred_covariance`).
    """
    if box_sampling not in SAMPLING_IMPLS:
        raise ValueError(f"Invalid BOX_SAMPLING {box_sampling!r}")
    probs = classification_probs(box_cls, box_cls_var, cls_sampling, cls_num_samples,
                                 generator)
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

    analytic = box_sampling == "analytic"
    if box_reg_var is not None and analytic and defer_covariance and epistemic_cov is None:
        chol = covariance_output_to_cholesky(box_reg_var[top_idx])
        diag = torch.einsum("cij,cij->ci", chol, chol)
        boxes = decoded_box_mean(sel_deltas, diag, sel_anchors, box_reg_weights)
        covs = boxes.new_zeros(boxes.shape[:-1] + (4, 4))
        has_cov = False
    elif box_reg_var is not None:
        chol = covariance_output_to_cholesky(box_reg_var[top_idx])
        if analytic:
            delta_cov = torch.einsum("cij,ckj->cik", chol, chol)
            boxes, covs = decoded_box_moments(sel_deltas, delta_cov, sel_anchors,
                                              box_reg_weights)
        else:
            boxes, covs = sampled_box_moments(
                generator, sel_deltas, chol, sel_anchors, box_num_samples, box_reg_weights,
                shared=box_sampling == "mc_shared",
            )
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
