"""Probability-based Detection Quality (PDQ; Hall et al., "Probabilistic
Object Detection: Definition and Evaluation", WACV 2020).

The port's copy of ``pod_compare_tpu/evaluation/pdq.py``, on numpy and
scipy as there, scoring ``coco_instances_results.json`` (``cls_prob`` and
``bbox_covar``) against the ground truth:

* A detection's spatial distribution: its top-left and bottom-right corners
  as 2-D Gaussians (the diagonal 2x2 blocks of the 4x4 xyxy covariance).
  P(pixel p=(u,v) inside) = F_TL(u,v) · P(X2>=u, Y2>=v), at pixel centres.
* Spatial quality  Q_S = exp((L_FG + L_BG) / |S_gt|), with L_FG the sum
  over the gt box's pixels of log P(p in det) and L_BG the sum over the
  other pixels of log(1 - P(p in det)), probabilities clipped to
  [1e-14, 1-1e-14].
* Label quality    Q_L = the probability given to the gt class.
* Pairwise quality pPDQ = sqrt(Q_S · Q_L).
* Per image, a Hungarian assignment maximising the total pPDQ; assigned
  pairs with pPDQ > 1e-6 are TPs, the rest FPs and FNs.
* PDQ = (sum of TP pPDQ) / (N_TP + N_FP + N_FN) over the dataset.

The bivariate corner CDF comes from one 513-point x-quadrature per corner,
F(u, v) = INT_{-inf}^{u} phi(x) Phi((v - m_y - rho sy/sx (x - m_x)) /
(sy sqrt(1-rho^2))) dx, cumulatively summed and interpolated over the
grid. Each detection is evaluated only inside the ±9σ window of its corner
Gaussians: outside it P(p in det) is 0 to float64 precision.
"""

import json
import logging
import os
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.special import ndtr

from pod_compare_tpu_torch.evaluation.matching import (
    preprocess_gt,
    preprocess_predictions,
)
from pod_compare_tpu_torch.utils.table import Table

_P_EPS = 1e-14
_MIN_VAR = 0.25  # floor corner variances at (0.5 px)^2 — PDQ needs a pdf


def bivariate_cdf_grid(
    mean: np.ndarray, cov: np.ndarray, us: np.ndarray, vs: np.ndarray,
    n_quad: int = 513,
) -> np.ndarray:
    """P(X <= u, Y <= v) for all (v, u) in the grid; shape (len(vs), len(us)).

    Exact up to the x-quadrature (trapezoid over ±8 sigma, `n_quad`
    points); for rho=0 it matches the product of 1-D CDFs to ~1e-6.
    """
    mx, my = float(mean[0]), float(mean[1])
    sx = float(np.sqrt(max(cov[0, 0], _MIN_VAR)))
    sy = float(np.sqrt(max(cov[1, 1], _MIN_VAR)))
    rho = float(np.clip(cov[0, 1] / (sx * sy), -0.99, 0.99))

    xs = np.linspace(mx - 8 * sx, mx + 8 * sx, n_quad)  # (X,)
    phi = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * np.sqrt(2 * np.pi))
    cond = (vs[None, :] - my - rho * sy / sx * (xs[:, None] - mx)) / (
        sy * np.sqrt(1.0 - rho * rho)
    )  # (X, V)
    integrand = phi[:, None] * ndtr(cond)  # (X, V)
    dx = xs[1] - xs[0]
    # cumulative trapezoid along x -> F(xs[i], v)
    cum = np.concatenate(
        [np.zeros((1, len(vs))),
         np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * dx, axis=0)],
        axis=0,
    )  # (X, V)
    # interpolate at the requested u positions (clamp outside the span)
    ui = np.clip(np.searchsorted(xs, us) - 1, 0, n_quad - 2)
    frac = np.clip((us - xs[ui]) / dx, 0.0, 1.0)
    f = cum[ui] + frac[:, None] * (cum[ui + 1] - cum[ui])  # (U, V)
    return f.T  # (V, U)


def _detection_window(
    box: np.ndarray, cov4: np.ndarray, width: int, height: int,
    n_sigma: float = 9.0,
) -> Tuple[int, int, int, int]:
    """Pixel window (r0, r1, c0, c1) outside which the detection's
    inclusion probability is 0 to float64 precision."""
    sx1 = np.sqrt(max(cov4[0, 0], _MIN_VAR))
    sy1 = np.sqrt(max(cov4[1, 1], _MIN_VAR))
    sx2 = np.sqrt(max(cov4[2, 2], _MIN_VAR))
    sy2 = np.sqrt(max(cov4[3, 3], _MIN_VAR))
    c0 = int(np.clip(np.floor(min(box[0] - n_sigma * sx1,
                                  box[2] - n_sigma * sx2)), 0, width))
    c1 = int(np.clip(np.ceil(max(box[0] + n_sigma * sx1,
                                 box[2] + n_sigma * sx2)), 0, width))
    r0 = int(np.clip(np.floor(min(box[1] - n_sigma * sy1,
                                  box[3] - n_sigma * sy2)), 0, height))
    r1 = int(np.clip(np.ceil(max(box[1] + n_sigma * sy1,
                                 box[3] + n_sigma * sy2)), 0, height))
    return r0, r1, c0, c1


def _prob_in_grid(
    box: np.ndarray, cov4: np.ndarray, us: np.ndarray, vs: np.ndarray
) -> np.ndarray:
    """(len(vs), len(us)) probability that each pixel center lies inside
    the corner-Gaussian probabilistic box."""
    tl = bivariate_cdf_grid(box[0:2], cov4[0:2, 0:2], us, vs)
    # P(X2 >= u, Y2 >= v) = 1 - Fx(u) - Fy(v) + F(u, v)
    sx2 = np.sqrt(max(cov4[2, 2], _MIN_VAR))
    sy2 = np.sqrt(max(cov4[3, 3], _MIN_VAR))
    fx2 = ndtr((us - box[2]) / sx2)  # (W,)
    fy2 = ndtr((vs - box[3]) / sy2)  # (H,)
    fbr = bivariate_cdf_grid(box[2:4], cov4[2:4, 2:4], us, vs)
    br_sf = 1.0 - fx2[None, :] - fy2[:, None] + fbr
    return np.clip(tl, 0.0, 1.0) * np.clip(br_sf, 0.0, 1.0)


def prob_in_map(
    box: np.ndarray, cov4: np.ndarray, width: int, height: int
) -> np.ndarray:
    """(H, W) probability that each pixel center lies inside the
    corner-Gaussian probabilistic box (full-image grid)."""
    return _prob_in_grid(
        box, cov4, np.arange(width) + 0.5, np.arange(height) + 0.5
    )


def _pairwise_ppdq(
    det: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    cat_mapping: Dict[int, int],
    width: int,
    height: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n_det, n_gt) pPDQ plus the matching spatial / label qualities."""
    n_det = len(det["boxes"])
    n_gt = len(gts["boxes"])
    ppdq = np.zeros((n_det, n_gt))
    q_spatial = np.zeros((n_det, n_gt))
    q_label = np.zeros((n_det, n_gt))
    gt_regions = []
    for j in range(n_gt):
        x1, y1, x2, y2 = gts["boxes"][j]
        c0, r0 = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
        c1 = min(int(np.ceil(x2)), width)
        r1 = min(int(np.ceil(y2)), height)
        gt_regions.append((r0, r1, c0, c1))
    log_eps = float(np.log(_P_EPS))
    for i in range(n_det):
        if not (
            np.isfinite(det["boxes"][i]).all()
            and np.isfinite(det["covs"][i]).all()
        ):
            # Leave the row at 0: the assignment threshold counts this
            # detection as an FP instead of aborting the whole evaluation.
            continue
        # Everything outside the ±9σ window has p = 0 exactly: background
        # pixels there contribute log(1-0) = 0 and gt pixels log(eps).
        wr0, wr1, wc0, wc1 = _detection_window(
            det["boxes"][i], det["covs"][i], width, height
        )
        if wr1 > wr0 and wc1 > wc0:
            pmap = _prob_in_grid(
                det["boxes"][i], det["covs"][i],
                np.arange(wc0, wc1) + 0.5, np.arange(wr0, wr1) + 0.5,
            )
            log_p = np.log(np.clip(pmap, _P_EPS, 1.0))
            log_not_p = np.log(np.clip(1.0 - pmap, _P_EPS, 1.0))
            total_log_not_p = float(log_not_p.sum())
        else:
            log_p = log_not_p = None
            total_log_not_p = 0.0
        for j in range(n_gt):
            r0, r1, c0, c1 = gt_regions[j]
            if r1 <= r0 or c1 <= c0:
                continue
            n_seg = (r1 - r0) * (c1 - c0)
            ir0, ir1 = max(r0, wr0), min(r1, wr1)
            ic0, ic1 = max(c0, wc0), min(c1, wc1)
            if log_p is not None and ir1 > ir0 and ic1 > ic0:
                n_in = (ir1 - ir0) * (ic1 - ic0)
                l_fg = float(
                    log_p[ir0 - wr0:ir1 - wr0, ic0 - wc0:ic1 - wc0].sum()
                ) + (n_seg - n_in) * log_eps
                # background = window pixels outside the gt box (the rest
                # of the image contributes log(1-0) = 0)
                l_bg = total_log_not_p - float(
                    log_not_p[ir0 - wr0:ir1 - wr0, ic0 - wc0:ic1 - wc0].sum()
                )
            else:
                l_fg = n_seg * log_eps
                l_bg = total_log_not_p
            q_s = float(np.exp((l_fg + l_bg) / n_seg))
            model_idx = cat_mapping.get(int(gts["cats"][j]), None)
            q_l = (
                float(det["probs"][i][model_idx])
                if model_idx is not None
                and model_idx < len(det["probs"][i])
                else 0.0
            )
            q_spatial[i, j] = q_s
            q_label[i, j] = q_l
            ppdq[i, j] = np.sqrt(q_s * q_l)
    # A non-finite covariance/box entry in ONE detection must not abort the
    # dataset evaluation via linear_sum_assignment — score that pair 0.
    ppdq = np.nan_to_num(ppdq, nan=0.0, posinf=0.0, neginf=0.0)
    q_spatial = np.nan_to_num(q_spatial, nan=0.0, posinf=0.0, neginf=0.0)
    q_label = np.nan_to_num(q_label, nan=0.0, posinf=0.0, neginf=0.0)
    return ppdq, q_spatial, q_label


def evaluate_pdq(
    inference_output_dir: str,
    gt_json_file: str,
    cat_mapping: Dict[int, int],
    min_allowed_score: float = 0.0,
    verbose: bool = True,
) -> Dict[str, float]:
    """Score `coco_instances_results.json` against the gt with PDQ.

    `cat_mapping` maps DATASET category ids to model-contiguous class
    indices (evaluation/category_mapping.py). Returns
    {pdq, avg_ppdq, avg_spatial_quality, avg_label_quality, tp, fp, fn}.
    """
    with open(
        os.path.join(inference_output_dir, "coco_instances_results.json")
    ) as f:
        predictions = json.load(f)
    with open(gt_json_file) as f:
        gt = json.load(f)

    preds = preprocess_predictions(predictions, min_allowed_score)
    gts = preprocess_gt(gt["annotations"])
    dims = {im["id"]: (im["width"], im["height"]) for im in gt["images"]}

    total_tp = total_fp = total_fn = 0
    sum_ppdq = 0.0
    tp_spatial: List[float] = []
    tp_label: List[float] = []

    for image_id, (width, height) in dims.items():
        det = preds.get(image_id)
        gt_i = gts.get(image_id)
        n_det = 0 if det is None else len(det["boxes"])
        n_gt = 0 if gt_i is None else len(gt_i["boxes"])
        if n_det == 0 and n_gt == 0:
            continue
        if n_det == 0:
            total_fn += n_gt
            continue
        if n_gt == 0:
            total_fp += n_det
            continue
        ppdq, q_s, q_l = _pairwise_ppdq(
            det, gt_i, cat_mapping, width, height
        )
        rows, cols = linear_sum_assignment(-ppdq)
        # Pairs at the eps-clipped floor (a hopeless pairing still gets
        # sqrt(exp(|S| log eps)/|S|) > 0 numerically) count as unassigned.
        assigned = ppdq[rows, cols] > 1e-6
        tp = int(assigned.sum())
        total_tp += tp
        total_fp += n_det - tp
        total_fn += n_gt - tp
        sum_ppdq += float(ppdq[rows, cols][assigned].sum())
        tp_spatial.extend(q_s[rows, cols][assigned].tolist())
        tp_label.extend(q_l[rows, cols][assigned].tolist())

    # Detections on images absent from the gt json are unassigned by
    # definition — PDQ counts every unassigned detection as an FP; dropping
    # them would silently inflate the score.
    orphan_fp = sum(
        len(det["boxes"]) for iid, det in preds.items() if iid not in dims
    )
    if orphan_fp:
        logging.getLogger(__name__).warning(
            "PDQ: %d detections reference image ids missing from the gt "
            "json; counted as false positives.", orphan_fp,
        )
        total_fp += orphan_fp

    denom = max(total_tp + total_fp + total_fn, 1)
    out = {
        "pdq": sum_ppdq / denom,
        "avg_ppdq": sum_ppdq / max(total_tp, 1),
        "avg_spatial_quality": float(np.mean(tp_spatial)) if tp_spatial else 0.0,
        "avg_label_quality": float(np.mean(tp_label)) if tp_label else 0.0,
        "tp": total_tp,
        "fp": total_fp,
        "fn": total_fn,
    }
    if verbose:
        table = Table(
            ["PDQ", "avg pPDQ", "avg spatial", "avg label", "TP/FP/FN"]
        )
        table.add_row([
            f"{out['pdq']:.4f}", f"{out['avg_ppdq']:.4f}",
            f"{out['avg_spatial_quality']:.4f}",
            f"{out['avg_label_quality']:.4f}",
            f"{total_tp}/{total_fp}/{total_fn}",
        ])
        print(table)
    return out
