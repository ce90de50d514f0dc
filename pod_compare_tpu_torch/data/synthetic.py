"""Synthetic COCO-format dataset generator for tests and benchmarks.

The port's counterpart of ``pod_compare_tpu/data/synthetic.py``: the same
RandomState draws in the same order, written the same way (``cv2.imwrite``),
so the two packages' datasets are byte-identical files.

The reference has no test assets; SURVEY.md §4 calls for integration tests
on a tiny synthetic COCO dataset. Images contain solid rectangles on noise
backgrounds so a detector can actually learn/localize them.
"""

import json
import os
from typing import List, Tuple

import cv2
import numpy as np

from pod_compare_tpu_torch.data.datasets import register_coco_instances


def generate_synthetic_dataset(
    root: str,
    name: str = "synthetic",
    num_images: int = 8,
    image_size: Tuple[int, int] = (64, 80),
    num_classes: int = 3,
    max_objects: int = 3,
    seed: int = 0,
) -> Tuple[str, str]:
    """Write images + COCO json; returns (json_file, image_dir)."""
    rng = np.random.RandomState(seed)
    h, w = image_size
    image_dir = os.path.join(root, f"{name}_images")
    os.makedirs(image_dir, exist_ok=True)

    colors = (rng.rand(num_classes, 3) * 155 + 100).astype(np.uint8)
    images, annotations = [], []
    ann_id = 0
    for img_id in range(num_images):
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        for _ in range(rng.randint(1, max_objects + 1)):
            bw = rng.randint(10, max(11, w // 3))
            bh = rng.randint(10, max(11, h // 3))
            x = rng.randint(0, w - bw)
            y = rng.randint(0, h - bh)
            cls = rng.randint(0, num_classes)
            img[y : y + bh, x : x + bw] = colors[cls]
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cls + 1,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
        fname = f"img_{img_id:04d}.png"
        cv2.imwrite(os.path.join(image_dir, fname), img)
        images.append(
            {"id": img_id, "file_name": fname, "height": h, "width": w, "license": 1}
        )

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i + 1, "name": f"class_{i}"} for i in range(num_classes)
        ],
        "licenses": [{"id": 1, "name": "synthetic"}],
    }
    json_file = os.path.join(root, f"{name}_coco.json")
    with open(json_file, "w") as f:
        json.dump(coco, f)
    return json_file, image_dir


def register_synthetic(
    root: str, name: str = "synthetic", num_classes: int = 3, **kwargs
):
    json_file, image_dir = generate_synthetic_dataset(
        root, name, num_classes=num_classes, **kwargs
    )
    classes: List[str] = [f"class_{i}" for i in range(num_classes)]
    register_coco_instances(
        name, json_file, image_dir, classes, {i + 1: i for i in range(num_classes)}
    )
    return name


def synthetic_detections(coco: dict, num_classes: int, seed: int = 0,
                         miss_rate: float = 0.1, false_positives: int = 2) -> List[dict]:
    """Detection records in apply_net's schema (``cls_prob``, ``bbox_covar``
    in xywh) made from a COCO ground-truth dict: each box found with
    probability 1 - miss_rate, each coordinate jittered by a normal draw of
    1.5 px, with a random positive-definite covariance, its class likeliest
    but not certain, a duplicate one time in five, and `false_positives`
    random boxes per image: data on which every metric of the suite is
    finite and non-trivial."""
    rng = np.random.RandomState(seed)
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}

    def record(image_id, xywh, cls, hit_prob):
        probs = rng.uniform(0.0, 0.3, num_classes)
        probs[cls] = hit_prob
        std = rng.uniform(0.5, 4.0, 4)
        root = np.diag(std) + np.tril(rng.normal(0.0, 0.3, (4, 4)), -1)
        return {
            "image_id": image_id,
            "category_id": cls + 1,
            "bbox": [float(v) for v in xywh],
            "score": float(probs.max()),
            "cls_prob": probs.tolist(),
            "bbox_covar": (root @ root.T).tolist(),
        }

    out = []
    for ann in coco["annotations"]:
        if rng.rand() < miss_rate:
            continue
        for _ in range(1 + (rng.rand() < 0.2)):
            x, y, w, h = ann["bbox"]
            jitter = rng.normal(0.0, 1.5, 4)
            box = [x + jitter[0], y + jitter[1], max(w + jitter[2], 2.0), max(h + jitter[3], 2.0)]
            out.append(record(ann["image_id"], box, ann["category_id"] - 1,
                              rng.uniform(0.35, 0.99)))
    for image_id, (h, w) in sizes.items():
        for _ in range(false_positives):
            bw, bh = rng.uniform(8, max(9, w / 4)), rng.uniform(8, max(9, h / 4))
            box = [rng.uniform(0, w - bw), rng.uniform(0, h - bh), bw, bh]
            out.append(record(image_id, box, rng.randint(num_classes), rng.uniform(0.3, 0.9)))
    return out
