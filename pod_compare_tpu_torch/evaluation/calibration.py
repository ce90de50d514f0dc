"""Calibration errors and minimum uncertainty error (MUE).

The port's copy of ``pod_compare_tpu/evaluation/calibration.py`` (numpy and
scipy's erf, as there).

TPU-native equivalents of the reference's calibration evaluation
(reference: src/offline_evaluation/compute_calibration_errors.py):
  * marginal classification calibration error — the reference calls the
    `uncertainty-calibration` library (Kumar et al. 2019,
    compute_calibration_errors.py:136-137); reimplemented here as the
    debiased L2 calibration error with equal-mass binning, the library's
    default estimator.
  * per-box-dimension regression calibration from the Gaussian CDF of the
    gt in 15 histogram bins → expected + maximum calibration error
    (compute_calibration_errors.py:202-242; "Accurate Uncertainties for
    Deep Learning Using Calibrated Regression").
  * classification/regression MUE: sweep an entropy threshold over
    TP(1)/FP(0) labels, min of 0.5·miss-rate + 0.5·false-alarm-rate
    (compute_calibration_errors.py:156-177, 244-269).
"""

import math
from typing import List, Tuple

import numpy as np


def marginal_calibration_error(
    probs: np.ndarray, labels: np.ndarray, num_bins: int = 15, debias: bool = True
) -> float:
    """Debiased L2 calibration error with equal-mass bins.

    Matches the estimator of `calibration.get_calibration_error` used by
    the reference: probs/labels are flattened per-class binary pairs.
    """
    probs = np.asarray(probs, float).ravel()
    labels = np.asarray(labels, float).ravel()
    assert probs.shape == labels.shape
    if probs.size == 0:
        return float("nan")
    order = np.argsort(probs, kind="stable")
    probs, labels = probs[order], labels[order]
    bins = np.array_split(np.arange(probs.size), num_bins)
    sq_err = 0.0
    total = probs.size
    for idx in bins:
        if idx.size == 0:
            continue
        p_mean = probs[idx].mean()
        l_mean = labels[idx].mean()
        weight = idx.size / total
        err2 = (p_mean - l_mean) ** 2
        if debias and idx.size > 1:
            # subtract the binomial variance of the plugin estimate
            err2 -= l_mean * (1.0 - l_mean) / (idx.size - 1)
        sq_err += weight * err2
    return math.sqrt(max(sq_err, 0.0))


def minimum_uncertainty_error(
    entropies: np.ndarray, is_tp: np.ndarray, seed: int = 0
) -> float:
    """min over thresholds of 0.5·(missed TP rate) + 0.5·(FP accept rate)
    (reference: compute_calibration_errors.py:156-177)."""
    entropies = np.asarray(entropies, float)
    is_tp = np.asarray(is_tp, float)
    if entropies.size == 0 or is_tp.sum() == 0 or (1 - is_tp).sum() == 0:
        return float("nan")
    # The reference shuffles before a stable sort so ties break randomly.
    rng = np.random.RandomState(seed)
    perm = rng.permutation(entropies.size)
    entropies, is_tp = entropies[perm], is_tp[perm]
    order = np.argsort(entropies, kind="stable")
    tp_sorted = is_tp[order]
    fp_sorted = 1.0 - tp_sorted
    tp_cum = np.cumsum(tp_sorted)
    fp_cum = np.cumsum(fp_sorted)
    u_err = 0.5 * (tp_sorted.sum() - tp_cum) / tp_sorted.sum() + 0.5 * (
        fp_cum / fp_sorted.sum()
    )
    return float(u_err.min())


def regression_calibration_errors(
    means: np.ndarray,
    covariances: np.ndarray,
    gts: np.ndarray,
    num_bins: int = 15,
) -> Tuple[List[float], List[float]]:
    """Per-box-dimension expected and maximum calibration errors from the
    univariate Gaussian CDF of the gt (reference:
    compute_calibration_errors.py:202-242). Returns (expected[4], max[4])."""
    from scipy.special import erf

    diag = np.diagonal(covariances, axis1=1, axis2=2)
    expected, maximum = [], []
    step = 1.0 / num_bins
    for dim in range(gts.shape[1]):
        std = np.sqrt(diag[:, dim])
        cdf = 0.5 * (1.0 + erf((gts[:, dim] - means[:, dim]) / (std * math.sqrt(2))))
        errs = []
        for edge in np.arange(0.0, 1.0 - step, step):
            frac = float((cdf < (edge + step)).mean()) if cdf.size else np.nan
            errs.append((frac - (edge + step)) ** 2)
        errs = np.asarray(errs)
        expected.append(float(np.mean(errs)))
        maximum.append(float(np.max(errs)))
    return expected, maximum


def mvn_entropies(covariances: np.ndarray, conditioning: float = 1e-4) -> np.ndarray:
    """Entropies of N(0, Σ + c·I) (reference:
    compute_calibration_errors.py:251-254)."""
    covs = covariances + conditioning * np.eye(covariances.shape[-1])
    sign, logdet = np.linalg.slogdet(covs)
    k = covariances.shape[-1]
    return 0.5 * k * (1.0 + math.log(2 * math.pi)) + 0.5 * logdet
