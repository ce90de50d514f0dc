"""Prediction viewer CLI.

    python -m pod_compare_tpu_torch.cli.visualize_predictions \\
        --config-file BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml \\
        --inference-config Inference/bayes_od_mc_dropout.yaml \\
        --test-dataset bdd_val --dataset-dir /path/to/bdd --random-seed 0

Counterpart of ``pod_compare_tpu/cli/visualize_predictions.py``: overlays
the ground truth (green) and the predictions of apply_net's
``coco_instances_results.json``, coloured by categorical entropy, with 2σ
corner covariance ellipses; writes PNGs to ``<inference_output_dir>/viz/``.
"""

import json
import os

import cv2
import numpy as np

from pod_compare_tpu_torch.config import (
    inference_output_dir,
    setup_arg_parser,
    setup_config,
)
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.data.loader import load_image_bgr
from pod_compare_tpu_torch.evaluation.matching import (
    preprocess_gt,
    preprocess_predictions,
)
from pod_compare_tpu_torch.visualization.visualizer import (
    ProbabilisticVisualizer,
    entropy_color,
)


def categorical_entropy(probs: np.ndarray) -> np.ndarray:
    """Entropy of the predicted categorical distribution per detection
    (reference: visualize_predictions.py:88-107)."""
    p = probs / np.clip(probs.sum(axis=-1, keepdims=True), 1e-9, None)
    return -np.sum(p * np.log(np.clip(p, 1e-9, None)), axis=-1)


def visualize_dataset(
    test_dataset: str,
    out_dir: str,
    predictions_file: str,
    min_allowed_score: float = 0.0,
    max_images: int = 50,
):
    """One PNG per image of `predictions_file` (at most `max_images`, in
    the file's order), named by image id, into `out_dir`."""
    dataset = get_dataset(test_dataset)
    with open(predictions_file) as f:
        preds = preprocess_predictions(json.load(f), min_allowed_score)
    with open(dataset.json_file) as f:
        gt = json.load(f)
    gts = preprocess_gt(gt["annotations"])

    os.makedirs(out_dir, exist_ok=True)
    records = {r["image_id"]: r for r in dataset.load()}
    for i, (img_id, p) in enumerate(preds.items()):
        if i >= max_images or img_id not in records:
            break
        img = load_image_bgr(records[img_id]["file_name"]).astype(np.uint8)
        vis = ProbabilisticVisualizer(img)
        if img_id in gts:
            for box in gts[img_id]["boxes"]:
                vis.draw_box(box, color=(0, 255, 0), thickness=1)
        entropies = categorical_entropy(p["probs"])
        colors = [entropy_color(e) for e in entropies]
        vis.overlay_covariance_instances(p["boxes"], p["covs"], colors=colors)
        cv2.imwrite(os.path.join(out_dir, f"{img_id}.png"), vis.get_image())
    return out_dir


def main(args):
    """Draw the predictions apply_net wrote for `args`; returns the PNGs'
    directory."""
    cfg = setup_config(args, random_seed=args.random_seed, is_testing=True)
    test_dataset = args.test_dataset or cfg.DATASETS.TEST[0]
    inf_dir = inference_output_dir(cfg, test_dataset, args.inference_config)
    return visualize_dataset(
        test_dataset,
        os.path.join(inf_dir, "viz"),
        os.path.join(inf_dir, "coco_instances_results.json"),
        min_allowed_score=args.min_allowed_score,
    )


if __name__ == "__main__":
    parser = setup_arg_parser()
    args = parser.parse_args()
    main(args)
