"""Gaussian and covariance primitives in PyTorch.

Counterpart of ``pod_compare_tpu/ops/gaussian.py`` for the functions the
inference path uses. 4x4 inverses go through Cholesky solves. The Cholesky
factor comes from ``torch.linalg.cholesky_ex``, which does not check its
result on the host, so nothing here waits for the device.
"""

import torch

_TRIL_ROWS = [1, 2, 2, 3, 3, 3]
_TRIL_COLS = [0, 0, 1, 0, 1, 2]


def covariance_output_to_cholesky(pred_bbox_cov: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor from head outputs: the first 4
    channels are log-variances (sqrt(exp(.)) on the diagonal); a 10-channel
    'full' output fills the strict lower triangle raw. (..., 4 or 10) ->
    (..., 4, 4)."""
    diag = torch.sqrt(torch.exp(pred_bbox_cov[..., 0:4]))
    chol = torch.diag_embed(diag)
    if pred_bbox_cov.shape[-1] > 4:
        chol[..., _TRIL_ROWS, _TRIL_COLS] = pred_bbox_cov[..., 4:10]
    return chol


def sample_mean_covariance(samples: torch.Tensor):
    """Mean and unbiased covariance (divisor S-1) over a leading sample
    axis: (S, ..., k) -> (..., k), (..., k, k)."""
    num = samples.shape[0]
    mean = samples.mean(dim=0)
    resid = samples - mean[None]
    cov = torch.einsum("s...i,s...j->...ij", resid, resid) / max(num - 1, 1)
    return mean, cov


def inv4x4_psd(cov: torch.Tensor) -> torch.Tensor:
    """Batched inverse of PSD 4x4 matrices via Cholesky solves."""
    chol = torch.linalg.cholesky_ex(cov).L
    eye = torch.eye(4, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("...ki,...kj->...ij", inv_l, inv_l)

