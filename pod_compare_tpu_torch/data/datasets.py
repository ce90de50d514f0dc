"""Dataset registry for COCO-instance-format datasets.

The port's copy of ``pod_compare_tpu/data/datasets.py`` (pure Python): the
same records from the same json. First-party replacement for detectron2's
DatasetCatalog/MetadataCatalog as exercised by the reference (reference:
src/core/datasets/setup_datasets.py; the directory layouts registered there
are API surface and preserved here).
"""

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pod_compare_tpu_torch.data import metadata


@dataclass
class DatasetInfo:
    name: str
    json_file: str
    image_root: str
    thing_classes: List[str]
    thing_dataset_id_to_contiguous_id: Dict[int, int]
    _records: Optional[List[dict]] = field(default=None, repr=False)

    def load(self) -> List[dict]:
        """Parse the COCO json into per-image records (cached).

        Record format: {file_name, image_id, height, width, annotations:
        [{bbox (xywh abs), category_id (contiguous), iscrowd}]}.
        """
        if self._records is None:
            with open(self.json_file, "r") as f:
                coco = json.load(f)
            id_map = self.thing_dataset_id_to_contiguous_id
            images = {im["id"]: im for im in coco["images"]}
            anns_per_image: Dict[int, List[dict]] = {i: [] for i in images}
            for ann in coco.get("annotations", []):
                if ann.get("iscrowd", 0):
                    continue
                cat = ann["category_id"]
                if cat not in id_map:
                    continue
                anns_per_image[ann["image_id"]].append(
                    {
                        "bbox": ann["bbox"],
                        "category_id": id_map[cat],
                        "iscrowd": 0,
                    }
                )
            self._records = [
                {
                    "file_name": os.path.join(self.image_root, im["file_name"]),
                    "image_id": im["id"],
                    "height": im["height"],
                    "width": im["width"],
                    "annotations": anns_per_image[im_id],
                }
                for im_id, im in sorted(images.items())
            ]
        return self._records


_REGISTRY: Dict[str, DatasetInfo] = {}


def register_coco_instances(
    name: str,
    json_file: str,
    image_root: str,
    thing_classes: List[str],
    id_map: Dict[int, int],
) -> None:
    _REGISTRY[name] = DatasetInfo(
        name=name,
        json_file=json_file,
        image_root=image_root,
        thing_classes=thing_classes,
        thing_dataset_id_to_contiguous_id=id_map,
    )


def get_dataset(name: str) -> DatasetInfo:
    if name not in _REGISTRY:
        raise KeyError(
            f"Dataset '{name}' is not registered. Registered: {list(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_datasets() -> List[str]:
    return list(_REGISTRY)


def setup_all_datasets(dataset_dir: str) -> None:
    """Register BDD/KITTI/Lyft with the reference's directory layouts
    (reference: setup_datasets.py:11-117)."""
    setup_bdd_dataset(dataset_dir)
    setup_kitti_dataset(dataset_dir)
    setup_lyft_dataset(dataset_dir)


def setup_bdd_dataset(dataset_dir: str) -> None:
    register_coco_instances(
        "bdd_train",
        os.path.join(dataset_dir, "labels", "train_coco_format.json"),
        os.path.join(dataset_dir, "images", "100k", "train"),
        metadata.BDD_THING_CLASSES,
        metadata.BDD_THING_DATASET_ID_TO_CONTIGUOUS_ID,
    )
    register_coco_instances(
        "bdd_val",
        os.path.join(dataset_dir, "labels", "val_coco_format.json"),
        os.path.join(dataset_dir, "images", "100k", "val"),
        metadata.BDD_THING_CLASSES,
        metadata.BDD_THING_DATASET_ID_TO_CONTIGUOUS_ID,
    )


def setup_kitti_dataset(dataset_dir: str) -> None:
    image_dir = os.path.join(dataset_dir, "object", "training", "image_2")
    label_dir = os.path.join(dataset_dir, "object", "training", "label2-COCO-Format")
    register_coco_instances(
        "kitti_train",
        os.path.join(label_dir, "train_coco_format.json"),
        image_dir,
        metadata.KITTI_THING_CLASSES,
        metadata.KITTI_THING_DATASET_ID_TO_CONTIGUOUS_ID,
    )
    register_coco_instances(
        "kitti_val",
        os.path.join(label_dir, "val_coco_format.json"),
        image_dir,
        metadata.KITTI_THING_CLASSES,
        metadata.KITTI_THING_DATASET_ID_TO_CONTIGUOUS_ID,
    )


def setup_lyft_dataset(dataset_dir: str) -> None:
    register_coco_instances(
        "lyft_val",
        os.path.join(dataset_dir, "train", "label2-COCO-Format", "val_coco_format.json"),
        os.path.join(dataset_dir, "train", "image_2"),
        metadata.BDD_THING_CLASSES,
        metadata.BDD_THING_DATASET_ID_TO_CONTIGUOUS_ID,
    )
