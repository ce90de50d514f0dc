"""Gaussian and covariance primitives in PyTorch.

Counterpart of ``pod_compare_tpu/ops/gaussian.py`` for the functions the
inference path and the scoring rules use. 4x4 inverses go through
Cholesky solves. The Cholesky factor comes from
``torch.linalg.cholesky_ex``, which does not check its result on the
host, so nothing here waits for the device.
"""

import math

import torch

from pod_compare_tpu_torch.ops.kernels.normal import normal

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


def mvn_sample(
    seed,
    mean: torch.Tensor,
    scale_tril: torch.Tensor,
    num_samples: int,
    offset: int = 0,
    index=None,
    rows: int = 0,
) -> torch.Tensor:
    """(S, ..., k) samples of N(mean, L L^T) as mean + L z, the normals z
    the (S,) + mean.shape stream indices from `offset` of `seed` (an int64
    0-d CPU tensor or an int; ``ops/kernels/normal.py``), on mean's device;
    with `index`, for a (C, 4) mean, row index[c] of an (S, rows, 4) bank
    for row c, so that each row's normals follow its index."""
    z = normal(seed, (num_samples,) + tuple(mean.shape), mean, offset, index, rows)
    return mean[None] + torch.einsum("...ij,s...j->s...i", scale_tril, z)


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


def det4x4_psd(cov: torch.Tensor) -> torch.Tensor:
    """Batched determinant of PSD 4x4 matrices: the squared product of the
    Cholesky factor's diagonal."""
    chol = torch.linalg.cholesky_ex(cov).L
    return torch.diagonal(chol, dim1=-2, dim2=-1).prod(dim=-1) ** 2


def _cholesky_or_nan(cov: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN for a matrix that is not positive definite (as
    XLA's factor is), without a check that waits for the device."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, float("nan")))


def _log_det(chol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)


def mvn_log_prob(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Multivariate normal log density through a Cholesky factor and a
    triangular solve, batched over leading axes (JAX
    ``ops/gaussian.py::mvn_log_prob``)."""
    k = mean.shape[-1]
    chol = _cholesky_or_nan(cov)
    sol = torch.linalg.solve_triangular(chol, (x - mean)[..., None], upper=False)[..., 0]
    maha = (sol * sol).sum(dim=-1)
    return -0.5 * (k * math.log(2.0 * math.pi) + _log_det(chol) + maha)


def mvn_entropy(cov: torch.Tensor) -> torch.Tensor:
    """Differential entropy of N(., cov): 0.5 log det(2 pi e cov)."""
    k = cov.shape[-1]
    return 0.5 * k * (1.0 + math.log(2.0 * math.pi)) + 0.5 * _log_det(_cholesky_or_nan(cov))


def normal_cdf(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Univariate normal CDF via erf."""
    return 0.5 * (1.0 + torch.erf((x - mean) / (std * math.sqrt(2.0))))
