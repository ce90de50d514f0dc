"""Shared helpers for dataset→COCO converters
(reference: src/core/datasets/convert_{bdd,kitti,lyft}_to_coco.py)."""

import json
import os
from typing import Dict, List, Sequence, Tuple

LICENSES = [{"id": 1, "name": "none", "url": "none"}]

BDD_CATEGORIES = [
    {"id": 1, "name": "car", "supercategory": "vehicle"},
    {"id": 2, "name": "bus", "supercategory": "vehicle"},
    {"id": 3, "name": "truck", "supercategory": "vehicle"},
    {"id": 4, "name": "person", "supercategory": "vehicle"},
    {"id": 5, "name": "rider", "supercategory": "vehicle"},
    {"id": 6, "name": "bike", "supercategory": "vehicle"},
    {"id": 7, "name": "motor", "supercategory": "vehicle"},
]

KITTI_CATEGORIES = [
    {"id": 1, "name": "car", "supercategory": "vehicle"},
    {"id": 2, "name": "person", "supercategory": "person"},
]


def category_mapper(categories: List[dict]) -> Dict[str, int]:
    return {c["name"]: c["id"] for c in categories}


def write_coco_json(
    path: str,
    images: List[dict],
    annotations: List[dict],
    categories: List[dict],
) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {
                "info": {"year": 2020},
                "licenses": LICENSES,
                "categories": categories,
                "images": images,
                "annotations": annotations,
            },
            f,
        )


def annotation(
    ann_id: int, image_id, category_id: int, xyxy: Sequence[float]
) -> dict:
    x1, y1, x2, y2 = [float(v) for v in xyxy]
    bbox = [x1, y1, x2 - x1, y2 - y1]
    return {
        "image_id": image_id,
        "id": ann_id,
        "category_id": category_id,
        "bbox": bbox,
        "area": bbox[2] * bbox[3],
        "iscrowd": 0,
    }


def read_kitti_label_file(path: str) -> List[Tuple[str, List[float]]]:
    """Parse a KITTI label_2 txt file into (class_name, xyxy) tuples."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8:
                continue
            out.append((parts[0], [float(v) for v in parts[4:8]]))
    return out
