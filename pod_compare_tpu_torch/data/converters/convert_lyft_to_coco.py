"""Lyft (KITTI-format export) labels → COCO json with BDD class names
(reference: src/core/datasets/convert_lyft_to_coco.py).

Reads `train/label_2/*.txt` for every image under `train/image_2`; maps 6
lyft classes onto BDD names (car, bus, truck, pedestrian→person,
motorcycle→motor, bicycle→bike) and writes a val split json
(reference: convert_lyft_to_coco.py:55-64,115-121).
"""

import argparse
import os

import cv2

from pod_compare_tpu_torch.data.converters.common import (
    BDD_CATEGORIES,
    annotation,
    category_mapper,
    read_kitti_label_file,
    write_coco_json,
)

CATEGORIES_TO_USE = ("car", "truck", "bus", "pedestrian", "motorcycle", "bicycle")
CLASS_RENAMES = {
    "pedestrian": "person",
    "motorcycle": "motor",
    "bicycle": "bike",
}


def convert(image_dir, annotations_dir):
    mapper = category_mapper(BDD_CATEGORIES)
    ids_list = sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(image_dir)
        if f.endswith(".png")
    )
    images, annotations = [], []
    ann_id = 0
    for image_id in ids_list:
        label_path = os.path.join(annotations_dir, image_id) + ".txt"
        if not os.path.isfile(label_path):
            continue
        objects = read_kitti_label_file(label_path)
        if not objects:
            continue
        img = cv2.imread(os.path.join(image_dir, image_id) + ".png")
        images.append(
            {
                "id": image_id,
                "width": img.shape[1],
                "height": img.shape[0],
                "file_name": image_id + ".png",
                "license": 1,
            }
        )
        for raw_name, xyxy in objects:
            lname = raw_name.lower()
            if lname not in CATEGORIES_TO_USE:
                continue
            name = CLASS_RENAMES.get(lname, lname)
            if name not in mapper:
                continue
            annotations.append(annotation(ann_id, image_id, mapper[name], xyxy))
            ann_id += 1
    return images, annotations


def main(args):
    dataset_dir = os.path.expanduser(args.dataset_dir)
    image_dir = os.path.join(dataset_dir, "train", "image_2")
    annotations_dir = os.path.join(dataset_dir, "train", "label_2")
    output_dir = os.path.expanduser(
        args.output_dir
        or os.path.join(dataset_dir, "train", "label2-COCO-Format")
    )
    images, annotations = convert(image_dir, annotations_dir)
    write_coco_json(
        os.path.join(output_dir, "val_coco_format.json"), images, annotations,
        BDD_CATEGORIES,
    )
    print("Converted Lyft to COCO format!")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-dir", required=True, type=str)
    parser.add_argument("--output-dir", required=False, type=str)
    main(parser.parse_args())
