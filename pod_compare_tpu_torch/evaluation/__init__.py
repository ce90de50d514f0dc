"""The metric suite: COCO mAP, matching, scoring rules, calibration, MUE
and PDQ (``evaluation.pdq``); the port's copy of
``pod_compare_tpu/evaluation``."""

from pod_compare_tpu_torch.evaluation.average_precision import (
    evaluate_average_precision,
    read_optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.calibration_errors import (
    evaluate_calibration_errors,
)
from pod_compare_tpu_torch.evaluation.coco_eval import (
    COCOEvaluator,
    optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.matching import (
    get_matched_results,
    match_predictions_to_groundtruth,
    preprocess_gt,
    preprocess_predictions,
)
from pod_compare_tpu_torch.evaluation.probabilistic_metrics import (
    evaluate_probabilistic_metrics,
)

__all__ = [
    "evaluate_average_precision",
    "read_optimal_score_threshold",
    "evaluate_calibration_errors",
    "COCOEvaluator",
    "optimal_score_threshold",
    "get_matched_results",
    "match_predictions_to_groundtruth",
    "preprocess_gt",
    "preprocess_predictions",
    "evaluate_probabilistic_metrics",
]
