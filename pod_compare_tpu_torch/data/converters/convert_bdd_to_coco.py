"""BDD100k detection labels → COCO json
(reference: src/core/datasets/convert_bdd_to_coco.py).

Input: flat per-object label json (`labels/train.json`, `labels/val.json`)
where each record is {'name': <image file>, 'category': <class>,
'bbox': [x1, y1, x2, y2]}. BDD images have a fixed 1280x720 size
(reference: convert_bdd_to_coco.py:8-9).
"""

import argparse
import json
import os
from collections import defaultdict

from pod_compare_tpu_torch.data.converters.common import (
    BDD_CATEGORIES,
    annotation,
    category_mapper,
    write_coco_json,
)

IMAGE_WIDTH = 1280
IMAGE_HEIGHT = 720


def convert_split(input_labels, categories=BDD_CATEGORIES):
    mapper = category_mapper(categories)
    grouped = defaultdict(list)
    for obj in input_labels:
        grouped[obj["name"]].append(obj)

    images, annotations = [], []
    ann_id = 0
    for img_id, name in enumerate(grouped):
        images.append(
            {
                "id": img_id,
                "width": IMAGE_WIDTH,
                "height": IMAGE_HEIGHT,
                "file_name": name,
                "license": 1,
            }
        )
        for obj in grouped[name]:
            if obj.get("category") not in mapper:
                continue
            annotations.append(
                annotation(ann_id, img_id, mapper[obj["category"]], obj["bbox"])
            )
            ann_id += 1
    return images, annotations


def main(args):
    dataset_dir = os.path.expanduser(args.dataset_dir)
    output_dir = os.path.expanduser(
        args.output_dir or os.path.join(dataset_dir, "labels")
    )
    for split, out_name in [("train", "train_coco_format.json"),
                            ("val", "val_coco_format.json")]:
        with open(os.path.join(dataset_dir, "labels", f"{split}.json")) as f:
            labels = json.load(f)
        images, annotations = convert_split(labels)
        write_coco_json(
            os.path.join(output_dir, out_name), images, annotations,
            BDD_CATEGORIES,
        )
        print(f"Finished processing BDD {split} data!")
    print("Converted BDD to COCO format!")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-dir", required=True, type=str)
    parser.add_argument("--output-dir", required=False, type=str)
    main(parser.parse_args())
