"""Proper scoring rules for classification and regression uncertainty.

Counterpart of ``pod_compare_tpu/evaluation/scoring.py`` (reference:
src/core/evaluation_tools/scoring_rules.py). The MVN log-probabilities and
entropies run in float32 on the given device (CUDA unless the caller names
one), as the JAX package runs them jitted on its device; the thin
aggregation stays numpy.
"""

from typing import Dict, Optional

import numpy as np
import torch

from pod_compare_tpu_torch.ops.gaussian import mvn_entropy, mvn_log_prob
from pod_compare_tpu_torch.utils.device import resolve_device

# Covariance conditioning used by the reference before NLL/entropy
# (scoring_rules.py:68-69, 100-101).
REG_CONDITIONING = 1e-2


def _f32(array, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array), dtype=torch.float32, device=device)


def _conditioned(covs: torch.Tensor) -> torch.Tensor:
    return covs + REG_CONDITIONING * torch.eye(4, dtype=covs.dtype, device=covs.device)


def compute_cls_scores(
    predicted_score_of_gt_category: np.ndarray,
) -> Dict[str, Optional[float]]:
    """Binary-multilabel ignorance score: mean −log p(gt category)
    (reference: retinanet_compute_cls_scores, scoring_rules.py:6-42)."""
    p = np.asarray(predicted_score_of_gt_category, float)
    if p.size == 0:
        return {"ignorance_score_mean": None}
    return {"ignorance_score_mean": float(np.mean(-np.log(p)))}


def compute_reg_scores(
    predicted_box_means: np.ndarray,
    predicted_box_covariances: np.ndarray,
    gt_box_means: np.ndarray,
    device=None,
) -> Dict[str, Optional[float]]:
    """Multivariate-Gaussian NLL + MSE of matched detections
    (reference: compute_reg_scores, scoring_rules.py:45-81)."""
    if len(predicted_box_means) == 0:
        return {"ignorance_score_mean": None, "mean_squared_error": None}
    device = resolve_device(device)
    nll = -mvn_log_prob(
        _f32(gt_box_means, device),
        _f32(predicted_box_means, device),
        _conditioned(_f32(predicted_box_covariances, device)),
    )
    mse = float(np.mean((predicted_box_means - gt_box_means) ** 2))
    return {"ignorance_score_mean": float(nll.mean()), "mean_squared_error": mse}


def compute_reg_scores_fn(
    predicted_box_covariances: np.ndarray,
    device=None,
) -> Dict[str, Optional[float]]:
    """False-positive regression score: mean predictive entropy
    (reference: compute_reg_scores_fn, scoring_rules.py:84-114)."""
    if len(predicted_box_covariances) == 0:
        return {"total_entropy_mean": None}
    ent = mvn_entropy(_conditioned(_f32(predicted_box_covariances, resolve_device(device))))
    return {"total_entropy_mean": float(ent.mean())}
