"""Detection postprocessing: rescale to the original resolution, COCO json.

Counterpart of ``pod_compare_tpu/inference/postprocess.py``; the json keeps
the reference's ``cls_prob`` and ``bbox_covar`` extensions.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from pod_compare_tpu_torch.inference.core import Detections
from pod_compare_tpu_torch.ops.boxes import (
    clip_boxes,
    covar_xyxy_to_xywh,
    nonempty,
    scale_boxes,
    scale_covariance,
)

# Conditioning added to covariances before rescaling.
COV_CONDITIONING = 1e-4


def detector_postprocess(
    det: Detections, input_height, input_width, output_height, output_width
) -> Detections:
    """Rescale boxes and conjugate covariances to the original image
    resolution; drop empty boxes (one image; sizes may be 0-d tensors)."""
    scale_x = output_width / input_width
    scale_y = output_height / input_height
    boxes = clip_boxes(scale_boxes(det.boxes, scale_x, scale_y), output_height, output_width)
    valid = det.valid & nonempty(boxes)
    eye = torch.eye(4, dtype=det.covs.dtype, device=det.covs.device)
    covs = scale_covariance(det.covs + COV_CONDITIONING * eye, scale_x, scale_y)
    return det._replace(boxes=boxes, covs=covs, valid=valid)


def detections_to_json(
    det: Detections, image_id, cat_mapping: Optional[Dict[int, int]] = None
) -> List[dict]:
    """One image's detections as COCO records with `cls_prob` and
    `bbox_covar` (XYWH covariance); unmapped classes are dropped when a
    contiguous-index -> category-id mapping is given."""
    as_np = lambda t: torch.as_tensor(t).detach().cpu().double().numpy()
    boxes = as_np(det.boxes)
    covs = as_np(covar_xyxy_to_xywh(torch.as_tensor(det.covs).detach().cpu().float()))
    scores = as_np(det.scores)
    classes = torch.as_tensor(det.classes).cpu().numpy()
    probs = as_np(det.prob_vectors)
    valid = torch.as_tensor(det.valid).cpu().numpy().astype(bool)

    results = []
    for k in np.flatnonzero(valid):
        cls = int(classes[k])
        if cat_mapping is not None:
            if cls not in cat_mapping:
                continue
            cat_id = int(cat_mapping[cls])
        else:
            cat_id = cls
        x1, y1, x2, y2 = boxes[k]
        results.append(
            {
                "image_id": image_id,
                "category_id": cat_id,
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "score": float(scores[k]),
                "cls_prob": probs[k].tolist(),
                "bbox_covar": covs[k].tolist(),
            }
        )
    return results
