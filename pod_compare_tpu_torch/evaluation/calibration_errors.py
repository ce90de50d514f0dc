"""Calibration-error and MUE report
(reference: src/offline_evaluation/compute_calibration_errors.py).

The port's copy of ``pod_compare_tpu/evaluation/calibration_errors.py``."""

from typing import Dict, Optional

import numpy as np

from pod_compare_tpu_torch.config import evaluation_cli
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.evaluation import calibration as cal
from pod_compare_tpu_torch.evaluation.average_precision import (
    read_optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.category_mapping import (
    dataset_id_to_model_contiguous_map,
)
from pod_compare_tpu_torch.evaluation.matching import get_matched_results
from pod_compare_tpu_torch.utils.table import Table


def _quiet_nanmean(values) -> float:
    """nanmean that returns NaN for empty or all-NaN input without the
    numpy "Mean of empty slice" RuntimeWarning — classes with no matched
    detections legitimately contribute NaN per-class metrics (the
    reference nanmean-aggregates the same way,
    compute_calibration_errors.py:272-302)."""
    arr = np.asarray(values, float)
    finite = arr[np.isfinite(arr)]
    return float(finite.mean()) if finite.size else float("nan")


def evaluate_calibration_errors(
    inference_output_dir: str,
    test_dataset: str,
    train_dataset: str,
    iou_min: float = 0.1,
    iou_correct: float = 0.7,
    min_allowed_score: Optional[float] = None,
    verbose: bool = True,
    seed: int = 0,
    use_native: bool = True,
) -> Dict[str, float]:
    """Marginal cls calibration, per-dim reg calibration, cls/reg MUE
    (reference: compute_calibration_errors.py:19-302). `use_native=False`
    matches with the numpy engine."""
    if min_allowed_score is None:
        try:
            min_allowed_score = read_optimal_score_threshold(inference_output_dir)
        except FileNotFoundError:
            min_allowed_score = 0.0

    matched = get_matched_results(
        inference_output_dir,
        get_dataset(test_dataset).json_file,
        iou_min=iou_min,
        iou_correct=iou_correct,
        min_allowed_score=min_allowed_score,
        use_native=use_native,
    )
    cat_mapping = dataset_id_to_model_contiguous_map(train_dataset, test_dataset)

    def converted(part):
        cats = matched[part].get("gt_cat_idxs", np.zeros((0,)))
        if len(cats) == 0:
            return np.zeros((0,), np.int64)
        return np.asarray([cat_mapping[int(c)] for c in cats], np.int64)

    tp, dup, fp = (
        matched["true_positives"],
        matched["duplicates"],
        matched["false_positives"],
    )
    tp_cats, dup_cats = converted("true_positives"), converted("duplicates")

    def probs_of(part):
        p = part.get("predicted_cls_probs", np.zeros((0,)))
        return p if len(p) else np.zeros((0, 1))

    tp_probs, dup_probs, fp_probs = probs_of(tp), probs_of(dup), probs_of(fp)

    # Marginal classification calibration over flattened per-class pairs
    # (compute_calibration_errors.py:117-137).
    def one_hot(cats, k):
        out = np.zeros((len(cats), k))
        if len(cats):
            out[np.arange(len(cats)), cats] = 1.0
        return out

    k = tp_probs.shape[1]
    all_probs = np.concatenate(
        [tp_probs.ravel(), dup_probs.ravel(), fp_probs.ravel()]
    )
    all_labels = np.concatenate(
        [
            one_hot(tp_cats, k).ravel(),
            one_hot(dup_cats, k).ravel(),
            np.zeros(fp_probs.size),
        ]
    )
    cls_marginal = cal.marginal_calibration_error(all_probs, all_labels)

    # Per-class loops (reference iterates all mapped classes,
    # compute_calibration_errors.py:139).
    cls_mue_list, reg_mue_list = [], []
    reg_ece_list, reg_mce_list = [], []
    fp_cats = fp_probs.argmax(axis=1) if len(fp_probs) else np.zeros((0,), int)
    fp_top = fp_probs.max(axis=1) if len(fp_probs) else np.zeros((0,))
    tp_top = tp_probs.max(axis=1) if len(tp_probs) else np.zeros((0,))
    dup_top = dup_probs.max(axis=1) if len(dup_probs) else np.zeros((0,))

    for class_idx in sorted(set(cat_mapping.values())):
        tmask = tp_cats == class_idx
        dmask = dup_cats == class_idx
        fmask = fp_cats == class_idx

        gt_scores = np.concatenate(
            [np.ones(tmask.sum()), np.zeros(dmask.sum()), np.zeros(fmask.sum())]
        )
        # Classification MUE from −log(top score) entropies
        # (compute_calibration_errors.py:156-177).
        cat_entropy = -np.log(
            np.concatenate([tp_top[tmask], dup_top[dmask], fp_top[fmask]])
        )
        cls_mue_list.append(
            cal.minimum_uncertainty_error(cat_entropy, gt_scores, seed)
        )

        # Regression calibration over TP+duplicates.
        means = np.concatenate(
            [m for m in (tp.get("predicted_box_means", np.zeros((0, 4)))[tmask],
                         dup.get("predicted_box_means", np.zeros((0, 4)))[dmask])
             if len(m)] or [np.zeros((0, 4))]
        )
        covs = np.concatenate(
            [m for m in (
                tp.get("predicted_box_covariances", np.zeros((0, 4, 4)))[tmask],
                dup.get("predicted_box_covariances", np.zeros((0, 4, 4)))[dmask],
            ) if len(m)] or [np.zeros((0, 4, 4))]
        )
        gts = np.concatenate(
            [m for m in (tp.get("gt_box_means", np.zeros((0, 4)))[tmask],
                         dup.get("gt_box_means", np.zeros((0, 4)))[dmask])
             if len(m)] or [np.zeros((0, 4))]
        )
        if len(means):
            ece, mce = cal.regression_calibration_errors(means, covs, gts)
            reg_ece_list.extend(ece)
            reg_mce_list.extend(mce)

        # Regression MUE over TP+dup+FP covariance entropies
        # (compute_calibration_errors.py:244-269).
        all_covs = np.concatenate(
            [m for m in (
                tp.get("predicted_box_covariances", np.zeros((0, 4, 4)))[tmask],
                dup.get("predicted_box_covariances", np.zeros((0, 4, 4)))[dmask],
                fp.get("predicted_box_covariances", np.zeros((0, 4, 4)))[fmask],
            ) if len(m)] or [np.zeros((0, 4, 4))]
        )
        if len(all_covs):
            reg_entropy = cal.mvn_entropies(all_covs)
            reg_mue_list.append(
                cal.minimum_uncertainty_error(reg_entropy, gt_scores, seed)
            )

    summary = {
        "cls_marginal_calibration_error": float(cls_marginal),
        "reg_expected_calibration_error": _quiet_nanmean(reg_ece_list),
        "reg_maximum_calibration_error": _quiet_nanmean(reg_mce_list),
        "cls_min_uncertainty_error": _quiet_nanmean(cls_mue_list),
        "reg_min_uncertainty_error": _quiet_nanmean(reg_mue_list),
        "min_allowed_score": float(min_allowed_score),
    }
    if verbose:
        table = Table([
            "Cls Marginal Calibration Error", "Reg Expected Calibration Error",
            "Reg Maximum Calibration Error", "Cls Minimum Uncertainty Error",
            "Reg Minimum Uncertainty Error",
        ])
        table.add_row([
            f"{summary['cls_marginal_calibration_error']:.4f}",
            f"{summary['reg_expected_calibration_error']:.4f}",
            f"{summary['reg_maximum_calibration_error']:.4f}",
            f"{summary['cls_min_uncertainty_error']:.4f}",
            f"{summary['reg_min_uncertainty_error']:.4f}",
        ])
        print(table)
    return summary


if __name__ == "__main__":
    evaluation_cli(
        lambda cfg, args, inf_dir: evaluate_calibration_errors(
            inf_dir,
            args.test_dataset,
            cfg.DATASETS.TRAIN[0],
            iou_min=args.iou_min,
            iou_correct=args.iou_correct,
            min_allowed_score=args.min_allowed_score or None,
        )
    )
