"""Proper-scoring-rule report over matched TP/FP/FN partitions
(reference: src/offline_evaluation/compute_probabilistic_metrics.py).

The port's copy of ``pod_compare_tpu/evaluation/probabilistic_metrics.py``;
the regression scores run on `device` (CUDA unless the caller names one)."""

from typing import Dict, Optional, Sequence

import numpy as np

from pod_compare_tpu_torch.config import evaluation_cli
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.evaluation import scoring
from pod_compare_tpu_torch.evaluation.average_precision import (
    read_optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.category_mapping import (
    dataset_id_to_model_contiguous_map,
)
from pod_compare_tpu_torch.evaluation.matching import get_matched_results
from pod_compare_tpu_torch.utils.table import Table

# Per-class evaluation restriction (reference hardcodes [1, 3],
# compute_probabilistic_metrics.py:128).
DEFAULT_EVAL_CLASSES = (1, 3)


def prepare_partitions(
    matched: Dict[str, Dict[str, np.ndarray]], cat_mapping: Dict[int, int]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Convert gt dataset ids to model-contiguous indices and derive
    `predicted_score_of_gt_category` / `predicted_cat_idxs`
    (reference: compute_probabilistic_metrics.py:89-115)."""
    out = {}
    for part, fields in matched.items():
        fields = dict(fields)
        if "gt_cat_idxs" in fields and len(fields["gt_cat_idxs"]):
            converted = np.asarray(
                [cat_mapping[int(c)] for c in fields["gt_cat_idxs"]], np.int64
            )
            fields["gt_converted_cat_idxs"] = converted
            if "predicted_cls_probs" in fields and len(fields["predicted_cls_probs"]):
                fields["predicted_score_of_gt_category"] = fields[
                    "predicted_cls_probs"
                ][np.arange(len(converted)), converted]
        elif "predicted_cls_probs" in fields and len(fields["predicted_cls_probs"]):
            # False positives: correct category is "background"; for the
            # multilabel RetinaNet this is 1 − max prob.
            probs = fields["predicted_cls_probs"]
            fields["predicted_score_of_gt_category"] = 1.0 - probs.max(axis=1)
            fields["predicted_cat_idxs"] = probs.argmax(axis=1)
        for key in ("gt_converted_cat_idxs", "predicted_cat_idxs",
                    "predicted_score_of_gt_category"):
            fields.setdefault(key, np.zeros((0,)))
        out[part] = fields
    return out


def evaluate_probabilistic_metrics(
    inference_output_dir: str,
    test_dataset: str,
    train_dataset: str,
    iou_min: float = 0.1,
    iou_correct: float = 0.7,
    min_allowed_score: Optional[float] = None,
    eval_classes: Sequence[int] = DEFAULT_EVAL_CLASSES,
    verbose: bool = True,
    device=None,
    use_native: bool = True,
) -> Dict[str, float]:
    """Compute NLL (ignorance) scores per partition; returns the summary
    dict and prints the reference's PrettyTable layout
    (compute_probabilistic_metrics.py:178-205). The regression scores run
    on `device`; `use_native=False` matches with the numpy engine."""
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
    parts = prepare_partitions(matched, cat_mapping)

    tp = parts["true_positives"]
    fp = parts["false_positives"]
    fn = parts["false_negatives"]

    per_class = []
    for class_idx in eval_classes:
        tp_idx = np.asarray(tp["gt_converted_cat_idxs"]) == class_idx
        fp_idx = np.asarray(fp["predicted_cat_idxs"]) == class_idx
        per_class.append(
            {
                "tp_cls": scoring.compute_cls_scores(
                    tp["predicted_score_of_gt_category"][tp_idx]
                ),
                "fp_cls": scoring.compute_cls_scores(
                    fp["predicted_score_of_gt_category"][fp_idx]
                ),
                "tp_reg": scoring.compute_reg_scores(
                    tp["predicted_box_means"][tp_idx],
                    tp["predicted_box_covariances"][tp_idx],
                    tp["gt_box_means"][tp_idx],
                    device,
                ),
                "fp_reg": scoring.compute_reg_scores_fn(
                    fp["predicted_box_covariances"][fp_idx], device
                ),
            }
        )

    def nanmean(key, inner):
        vals = np.asarray(
            [c[key][inner] for c in per_class if c[key][inner] is not None],
            float,
        )
        finite = vals[np.isfinite(vals)]
        # all-NaN per-class values (no matched detections for any class)
        # would trip numpy's "Mean of empty slice" warning under np.nanmean
        return float(finite.mean()) if finite.size else float("nan")

    summary = {
        "num_true_positives": int(len(tp["predicted_box_means"])),
        "num_false_positives": int(len(fp["predicted_box_means"])),
        "num_false_negatives": int(len(fn["gt_box_means"])),
        "tp_cls_ignorance": nanmean("tp_cls", "ignorance_score_mean"),
        "tp_reg_ignorance": nanmean("tp_reg", "ignorance_score_mean"),
        "tp_reg_mse": nanmean("tp_reg", "mean_squared_error"),
        "fp_cls_ignorance": nanmean("fp_cls", "ignorance_score_mean"),
        "fp_reg_entropy": nanmean("fp_reg", "total_entropy_mean"),
        "min_allowed_score": float(min_allowed_score),
    }

    if verbose:
        table = Table(
            ["Output Type", "Number of Instances", "Cls Ignorance Score",
             "Reg Ignorance Score"]
        )
        table.add_row([
            "True Positives:", summary["num_true_positives"],
            f"{summary['tp_cls_ignorance']:.4f}",
            f"{summary['tp_reg_ignorance']:.4f}",
        ])
        table.add_row([
            "False Positives:", summary["num_false_positives"],
            f"{summary['fp_cls_ignorance']:.4f}",
            f"{summary['fp_reg_entropy']:.4f}",
        ])
        table.add_row(["False Negatives:", summary["num_false_negatives"], "-", "-"])
        print(table)
    return summary


if __name__ == "__main__":
    evaluation_cli(
        lambda cfg, args, inf_dir: evaluate_probabilistic_metrics(
            inf_dir,
            args.test_dataset,
            cfg.DATASETS.TRAIN[0],
            iou_min=args.iou_min,
            iou_correct=args.iou_correct,
            min_allowed_score=args.min_allowed_score or None,
        )
    )
