"""KITTI object-detection labels → COCO json
(reference: src/core/datasets/convert_kitti_to_coco.py).

Reads `object/training/label_2/*.txt` for the image ids listed in
`object/train.txt` / `object/val.txt`; keeps Car/Pedestrian renamed to
car/person (reference: convert_kitti_to_coco.py:49-52,120-125). Image sizes
come from the actual png files.
"""

import argparse
import os

import cv2

from pod_compare_tpu_torch.data.converters.common import (
    KITTI_CATEGORIES,
    annotation,
    category_mapper,
    read_kitti_label_file,
    write_coco_json,
)

CLASS_RENAMES = {"Car": "car", "Pedestrian": "person"}
CATEGORIES_TO_USE = ("car", "pedestrian")


def convert_split(ids_list, image_dir, annotations_dir):
    mapper = category_mapper(KITTI_CATEGORIES)
    images, annotations = [], []
    ann_id = 0
    for image_id in ids_list:
        img = cv2.imread(os.path.join(image_dir, image_id) + ".png")
        if img is None:
            raise FileNotFoundError(os.path.join(image_dir, image_id) + ".png")
        images.append(
            {
                "id": image_id,
                "width": img.shape[1],
                "height": img.shape[0],
                "file_name": image_id + ".png",
                "license": 1,
            }
        )
        for raw_name, xyxy in read_kitti_label_file(
            os.path.join(annotations_dir, image_id) + ".txt"
        ):
            if raw_name.lower() not in CATEGORIES_TO_USE:
                continue
            name = CLASS_RENAMES.get(raw_name, raw_name)
            if name not in mapper:
                continue
            annotations.append(annotation(ann_id, image_id, mapper[name], xyxy))
            ann_id += 1
    return images, annotations


def main(args):
    dataset_dir = os.path.expanduser(args.dataset_dir)
    image_dir = os.path.join(dataset_dir, "object", "training", "image_2")
    annotations_dir = os.path.join(dataset_dir, "object", "training", "label_2")
    output_dir = os.path.expanduser(
        args.output_dir
        or os.path.join(dataset_dir, "object", "training", "label2-COCO-Format")
    )
    for split, out_name in [("train", "train_coco_format.json"),
                            ("val", "val_coco_format.json")]:
        ids_file = os.path.join(dataset_dir, "object", f"{split}.txt")
        with open(ids_file) as f:
            ids_list = f.read().splitlines()
        images, annotations = convert_split(ids_list, image_dir, annotations_dir)
        write_coco_json(
            os.path.join(output_dir, out_name), images, annotations,
            KITTI_CATEGORIES,
        )
        print(f"Finished processing KITTI {split} data!")
    print("Converted KITTI to COCO format!")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-dir", required=True, type=str)
    parser.add_argument("--output-dir", required=False, type=str)
    main(parser.parse_args())
