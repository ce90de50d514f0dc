"""GT↔prediction matcher producing TP / duplicate / FP / FN partitions.

The port's copy of ``pod_compare_tpu/evaluation/matching.py``. The C++
engine is the port's own build (``pod_compare_tpu_torch/native``) and has
no fallback: the numpy engine runs only when the caller asks for it.

TPU-native counterpart of the reference's matching engine
(reference: evaluation_utils.py:19-367):
  * predictions read back from the COCO json with xywh→xyxy box and
    covariance transforms (evaluation_utils.py:45-66)
  * per-image partitioning with iou_min / iou_correct thresholds; for each
    gt, the highest-scoring detection with IoU ≥ iou_correct is the true
    positive and the rest are duplicates (evaluation_utils.py:191-367)
  * results cached on disk keyed by thresholds (evaluation_utils.py:101-136)

The reference's per-gt Python loop becomes a vectorized per-image
computation (argmax over masked score matrices); note the reference's
`gt_idxs_processed` filter is never updated there, so a detection CAN be
assigned to multiple gts — behavior preserved exactly.
"""

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def _xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    return np.concatenate([b[..., :2], b[..., :2] + b[..., 2:]], axis=-1)


# (x1,y1,w,h)->(x1,y1,x2,y2) covariance Jacobian
# (reference: evaluation_utils.py:57-66)
_COV_J = np.array(
    [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [1.0, 0, 1.0, 0], [0, 1.0, 0.0, 1.0]]
)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) IoU between xyxy box arrays."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)[:, None]
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)[None]
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def preprocess_predictions(
    predicted_instances: List[dict], min_allowed_score: float = 0.0
) -> Dict[int, Dict[str, np.ndarray]]:
    """Group predictions per image as xyxy boxes / prob vectors / xyxy
    covariances (reference: eval_predictions_preprocess,
    evaluation_utils.py:19-73). Detections with category_id == -1 or max
    prob below the threshold are dropped."""
    per_image = defaultdict(lambda: {"boxes": [], "probs": [], "covs": []})
    for inst in predicted_instances:
        probs = np.asarray(inst["cls_prob"], float)
        if inst["category_id"] == -1 or probs.max() < min_allowed_score:
            continue
        entry = per_image[inst["image_id"]]
        entry["boxes"].append(_xywh_to_xyxy(np.asarray(inst["bbox"], float)))
        entry["probs"].append(probs)
        cov = np.asarray(inst["bbox_covar"], float)
        if cov.size == 16:
            cov = _COV_J @ cov.reshape(4, 4) @ _COV_J.T
        else:
            cov = np.eye(4)
        entry["covs"].append(cov)
    return {
        img: {
            "boxes": np.stack(v["boxes"]),
            "probs": np.stack(v["probs"]),
            "covs": np.stack(v["covs"]),
        }
        for img, v in per_image.items()
    }


def preprocess_gt(gt_instances: List[dict]) -> Dict[int, Dict[str, np.ndarray]]:
    """Group GT per image (reference: eval_gt_preprocess,
    evaluation_utils.py:76-92)."""
    per_image = defaultdict(lambda: {"boxes": [], "cats": []})
    for g in gt_instances:
        per_image[g["image_id"]]["boxes"].append(
            _xywh_to_xyxy(np.asarray(g["bbox"], float))
        )
        per_image[g["image_id"]]["cats"].append(g["category_id"])
    return {
        img: {
            "boxes": np.stack(v["boxes"]),
            "cats": np.asarray(v["cats"], np.int64),
        }
        for img, v in per_image.items()
    }


def _empty_partitions() -> Dict[str, Dict[str, List[np.ndarray]]]:
    return {
        "true_positives": defaultdict(list),
        "duplicates": defaultdict(list),
        "false_positives": defaultdict(list),
        "false_negatives": defaultdict(list),
    }


def match_predictions_to_groundtruth(
    preds: Dict[int, Dict[str, np.ndarray]],
    gts: Dict[int, Dict[str, np.ndarray]],
    iou_min: float = 0.1,
    iou_correct: float = 0.7,
    use_native: bool = True,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Partition detections (reference: evaluation_utils.py:191-367).

    The C++ matching engine (pod_compare_tpu_torch/native/match_engine.cpp)
    runs unless `use_native` is False; both paths are equivalence-tested.
    """
    logger.info(f"matching engine: {'native C++' if use_native else 'numpy'} "
                f"({len(preds)} images with predictions)")
    if use_native:
        return _match_native(preds, gts, iou_min, iou_correct)
    parts = _empty_partitions()

    def add(part, **arrays):
        for k, v in arrays.items():
            parts[part][k].append(v)

    for img, p in preds.items():
        if img not in gts:
            add(
                "false_positives",
                predicted_box_means=p["boxes"],
                predicted_cls_probs=p["probs"],
                predicted_box_covariances=p["covs"],
            )
            continue
        g = gts[img]
        iou = iou_matrix(g["boxes"], p["boxes"])  # (G, D)

        fn_mask = (iou <= iou_min).all(axis=1)
        add(
            "false_negatives",
            gt_box_means=g["boxes"][fn_mask],
            gt_cat_idxs=g["cats"][fn_mask],
        )
        fp_mask = (iou <= iou_min).all(axis=0)
        add(
            "false_positives",
            predicted_box_means=p["boxes"][fp_mask],
            predicted_cls_probs=p["probs"][fp_mask],
            predicted_box_covariances=p["covs"][fp_mask],
        )

        tp_pairs = iou >= iou_correct  # (G, D)
        if not tp_pairs.any():
            continue
        det_scores = p["probs"].max(axis=1)  # (D,)
        masked_scores = np.where(tp_pairs, det_scores[None, :], -np.inf)
        best = masked_scores.argmax(axis=1)  # (G,)
        has_match = tp_pairs.any(axis=1)
        for gi in np.where(has_match)[0]:
            bi = best[gi]
            add(
                "true_positives",
                predicted_box_means=p["boxes"][bi : bi + 1],
                predicted_cls_probs=p["probs"][bi : bi + 1],
                predicted_box_covariances=p["covs"][bi : bi + 1],
                gt_box_means=g["boxes"][gi : gi + 1],
                gt_cat_idxs=g["cats"][gi : gi + 1],
                iou_with_ground_truth=iou[gi, bi : bi + 1],
            )
            dup = tp_pairs[gi].copy()
            dup[bi] = False
            if dup.any():
                di = np.where(dup)[0]
                add(
                    "duplicates",
                    predicted_box_means=p["boxes"][di],
                    predicted_cls_probs=p["probs"][di],
                    predicted_box_covariances=p["covs"][di],
                    gt_box_means=np.repeat(g["boxes"][gi : gi + 1], len(di), 0),
                    gt_cat_idxs=np.repeat(g["cats"][gi : gi + 1], len(di)),
                    iou_with_ground_truth=iou[gi, di],
                )

    # Canonical field schema so downstream code can index empty partitions.
    schema = {
        "true_positives": {
            "predicted_box_means": (0, 4),
            "predicted_cls_probs": (0, 0),
            "predicted_box_covariances": (0, 4, 4),
            "gt_box_means": (0, 4),
            "gt_cat_idxs": (0,),
            "iou_with_ground_truth": (0,),
        },
        "duplicates": {
            "predicted_box_means": (0, 4),
            "predicted_cls_probs": (0, 0),
            "predicted_box_covariances": (0, 4, 4),
            "gt_box_means": (0, 4),
            "gt_cat_idxs": (0,),
            "iou_with_ground_truth": (0,),
        },
        "false_positives": {
            "predicted_box_means": (0, 4),
            "predicted_cls_probs": (0, 0),
            "predicted_box_covariances": (0, 4, 4),
        },
        "false_negatives": {"gt_box_means": (0, 4), "gt_cat_idxs": (0,)},
    }
    out = {}
    for part, empty_shapes in schema.items():
        fields = parts[part]
        out[part] = {
            k: (
                np.concatenate(fields[k])
                if fields.get(k)
                else np.zeros(empty_shapes[k])
            )
            for k in empty_shapes
        }
    return out


def _match_native(
    preds: Dict[int, Dict[str, np.ndarray]],
    gts: Dict[int, Dict[str, np.ndarray]],
    iou_min: float,
    iou_correct: float,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Flatten per-image dicts, run the C++ engine, gather payloads.

    Mirrors the python path exactly, including the reference's quirk that
    images with no predictions are skipped entirely (their gt never counts
    as FN — evaluation_utils.py:223)."""
    from pod_compare_tpu_torch import native

    img_ids = list(preds.keys())
    det_boxes, det_scores, det_probs, det_covs = [], [], [], []
    gt_boxes, gt_cats = [], []
    det_off, gt_off = [0], [0]
    for img in img_ids:
        p = preds[img]
        det_boxes.append(p["boxes"])
        det_scores.append(p["probs"].max(axis=1))
        det_probs.append(p["probs"])
        det_covs.append(p["covs"])
        det_off.append(det_off[-1] + len(p["boxes"]))
        g = gts.get(img)
        if g is None:
            gt_off.append(gt_off[-1])
        else:
            gt_boxes.append(g["boxes"])
            gt_cats.append(g["cats"])
            gt_off.append(gt_off[-1] + len(g["boxes"]))

    def cat(parts, empty_shape):
        return np.concatenate(parts) if parts else np.zeros(empty_shape)

    det_boxes = cat(det_boxes, (0, 4))
    det_scores = cat(det_scores, (0,))
    det_probs = cat(det_probs, (0, 0))
    det_covs = cat(det_covs, (0, 4, 4))
    gt_boxes_f = cat(gt_boxes, (0, 4))
    gt_cats_f = cat(gt_cats, (0,)).astype(np.int64)

    res = native.match_engine_run(
        det_boxes, det_scores, gt_boxes_f,
        np.asarray(det_off, np.int64), np.asarray(gt_off, np.int64),
        iou_min, iou_correct,
    )

    def det_fields(idx):
        return {
            "predicted_box_means": det_boxes[idx],
            "predicted_cls_probs": det_probs[idx],
            "predicted_box_covariances": det_covs[idx],
        }

    out = {
        "true_positives": {
            **det_fields(res["tp_det"]),
            "gt_box_means": gt_boxes_f[res["tp_gt"]],
            "gt_cat_idxs": gt_cats_f[res["tp_gt"]],
            "iou_with_ground_truth": res["tp_iou"],
        },
        "duplicates": {
            **det_fields(res["dup_det"]),
            "gt_box_means": gt_boxes_f[res["dup_gt"]],
            "gt_cat_idxs": gt_cats_f[res["dup_gt"]],
            "iou_with_ground_truth": res["dup_iou"],
        },
        "false_positives": det_fields(res["fp_det"]),
        "false_negatives": {
            "gt_box_means": gt_boxes_f[res["fn_gt"]],
            "gt_cat_idxs": gt_cats_f[res["fn_gt"]],
        },
    }
    return out


def get_matched_results(
    inference_output_dir: str,
    gt_json_file: str,
    iou_min: float = 0.1,
    iou_correct: float = 0.7,
    min_allowed_score: float = 0.0,
    use_cache: bool = True,
    use_native: bool = True,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Load-or-compute matched results with threshold-keyed disk caching
    (reference: evaluation_utils.py:95-138; .pth caches become .npz)."""
    cache_path = os.path.join(
        inference_output_dir,
        f"matched_results_{iou_min}_{iou_correct}_{min_allowed_score}.npz",
    )
    if use_cache and os.path.isfile(cache_path):
        flat = np.load(cache_path, allow_pickle=False)
        out: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)
        for key in flat.files:
            part, field = key.split("/", 1)
            out[part][field] = flat[key]
        return dict(out)

    with open(
        os.path.join(inference_output_dir, "coco_instances_results.json")
    ) as f:
        predictions = json.load(f)
    with open(gt_json_file) as f:
        gt = json.load(f)

    preds = preprocess_predictions(predictions, min_allowed_score)
    gts = preprocess_gt(gt["annotations"])
    matched = match_predictions_to_groundtruth(preds, gts, iou_min, iou_correct, use_native)

    if use_cache:
        flat = {
            f"{part}/{field}": arr
            for part, fields in matched.items()
            for field, arr in fields.items()
        }
        np.savez(cache_path, **flat)
    return matched
