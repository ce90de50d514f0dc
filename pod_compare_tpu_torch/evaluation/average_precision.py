"""mAP evaluation + optimal-F1 score threshold
(reference: src/offline_evaluation/compute_average_precision.py).

The port's copy of ``pod_compare_tpu/evaluation/average_precision.py``:
it writes and reads the same ``mAP_res.txt``."""

import json
import os
from typing import Optional, Sequence

from pod_compare_tpu_torch.config import evaluation_cli
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.evaluation.coco_eval import (
    COCOEvaluator,
    optimal_score_threshold,
)

# The reference restricts COCOeval to category ids [1, 3]
# (compute_average_precision.py:39).
DEFAULT_CAT_IDS = (1, 3)


def evaluate_average_precision(
    inference_output_dir: str,
    test_dataset: str,
    cat_ids: Optional[Sequence[int]] = DEFAULT_CAT_IDS,
    verbose: bool = True,
    use_native: bool = True,
):
    """Run COCO mAP on the dumped predictions and write `mAP_res.txt`
    (stats + optimal-F1 score threshold, compute_average_precision.py:50-68).

    `use_native=False` runs the numpy engine instead of the C++ one.
    Returns (stats[12], optimal_score_threshold).
    """
    prediction_file = os.path.join(
        inference_output_dir, "coco_instances_results.json"
    )
    with open(prediction_file) as f:
        detections = json.load(f)
    with open(get_dataset(test_dataset).json_file) as f:
        gt = json.load(f)

    evaluator = COCOEvaluator(gt, detections, cat_ids=cat_ids)
    stats = evaluator.run(verbose=verbose, use_native=use_native)
    threshold = optimal_score_threshold(evaluator)
    if verbose:
        print(f"Classification Score at Optimal F-1 Score: {threshold}")

    with open(os.path.join(inference_output_dir, "mAP_res.txt"), "w") as f:
        print(stats.tolist() + [threshold], file=f)
    return stats, threshold


def read_optimal_score_threshold(inference_output_dir: str) -> float:
    """Parse the threshold back from `mAP_res.txt`
    (reference: compute_probabilistic_metrics.py:54-66)."""
    path = os.path.join(inference_output_dir, "mAP_res.txt")
    with open(path) as f:
        value = f.read().strip("][\n").split(", ")[-1]
    return round(float(value), 4)


if __name__ == "__main__":
    evaluation_cli(
        lambda cfg, args, inf_dir: evaluate_average_precision(
            inf_dir, args.test_dataset
        )
    )
