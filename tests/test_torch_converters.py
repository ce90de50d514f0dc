"""The port's dataset converters against the JAX package's.

Each converter's ``main`` runs in both packages on one tiny raw layout that
the test writes (BDD's per-object label json, KITTI's label_2 text files
and split lists, Lyft's KITTI-format export with images of two sizes); the
COCO json files must be equal byte for byte, and each port converter runs
as ``python -m``.
"""

import argparse
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from pod_compare_tpu.data.converters import convert_bdd_to_coco as jax_bdd
from pod_compare_tpu.data.converters import convert_kitti_to_coco as jax_kitti
from pod_compare_tpu.data.converters import convert_lyft_to_coco as jax_lyft
from pod_compare_tpu_torch.data.converters import (
    convert_bdd_to_coco,
    convert_kitti_to_coco,
    convert_lyft_to_coco,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_LINES = (
    "Car 0.0 0 1.5 10.0 20.0 110.0 70.0 1.5 1.6 3.8 1 1 10 0.5\n"
    "Pedestrian 0.0 0 1.5 5.0 5.0 25.0 65.0 1.7 0.6 0.7 1 1 10 0.5\n"
    "Cyclist 0.0 0 1.5 0.0 0.0 9.0 9.0 1.7 0.6 1.8 1 1 10 0.5\n"
    "DontCare -1 -1 -10 0 0 2 2 -1 -1 -1 -1000 -1000 -1000 -10\n"
)
LYFT_LINES = (
    "car 0 0 0 1.0 2.0 50.5 40.0 0 0 0 0 0 0 0\n"
    "pedestrian 0 0 0 3.0 4.0 13.0 24.0 0 0 0 0 0 0 0\n"
    "bicycle 0 0 0 7.0 8.0 17.0 18.0 0 0 0 0 0 0 0\n"
    "motorcycle 0 0 0 9.0 9.0 19.0 29.0 0 0 0 0 0 0 0\n"
    "emergency_vehicle 0 0 0 0.0 0.0 5.0 5.0 0 0 0 0 0 0 0\n"
)


def _bdd(root):
    labels = root / "labels"
    labels.mkdir(parents=True)
    objects = [
        {"name": "a.jpg", "category": "car", "bbox": [10, 20, 110, 70]},
        {"name": "a.jpg", "category": "person", "bbox": [5.5, 5, 25, 65.25]},
        {"name": "a.jpg", "category": "traffic light", "bbox": [0, 0, 5, 5]},
        {"name": "b.jpg", "category": "bus", "bbox": [100, 100, 300, 200]},
        {"name": "c.jpg", "category": "motor", "bbox": [1, 2, 3, 4]},
    ]
    (labels / "train.json").write_text(json.dumps(objects))
    (labels / "val.json").write_text(json.dumps(objects[1:]))
    return ["train_coco_format.json", "val_coco_format.json"]


def _kitti(root):
    image_dir = root / "object" / "training" / "image_2"
    label_dir = root / "object" / "training" / "label_2"
    image_dir.mkdir(parents=True)
    label_dir.mkdir(parents=True)
    for i, (iid, h) in enumerate([("000000", 375), ("000001", 370), ("000002", 375)]):
        cv2.imwrite(str(image_dir / f"{iid}.png"), np.full((h, 1242, 3), i, np.uint8))
        (label_dir / f"{iid}.txt").write_text(KITTI_LINES if i != 1 else KITTI_LINES[:60] + "\n")
    (root / "object" / "train.txt").write_text("000000\n000002\n")
    (root / "object" / "val.txt").write_text("000001\n")
    return ["train_coco_format.json", "val_coco_format.json"]


def _lyft(root):
    image_dir = root / "train" / "image_2"
    label_dir = root / "train" / "label_2"
    image_dir.mkdir(parents=True)
    label_dir.mkdir(parents=True)
    for iid, (h, w) in {"host-b": (60, 80), "host-a": (48, 96), "host-c": (40, 40)}.items():
        cv2.imwrite(str(image_dir / f"{iid}.png"), np.zeros((h, w, 3), np.uint8))
    (label_dir / "host-a.txt").write_text(LYFT_LINES)
    (label_dir / "host-b.txt").write_text(LYFT_LINES[:44])
    # host-c has no label file: skipped, as in the JAX converter
    return ["val_coco_format.json"]


CONVERTERS = {
    "bdd": (_bdd, convert_bdd_to_coco, jax_bdd, "labels"),
    "kitti": (_kitti, convert_kitti_to_coco, jax_kitti,
              os.path.join("object", "training", "label2-COCO-Format")),
    "lyft": (_lyft, convert_lyft_to_coco, jax_lyft, os.path.join("train", "label2-COCO-Format")),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_json_equals_jax(tmp_path, name):
    make, ours, theirs, default_out = CONVERTERS[name]
    root = tmp_path / "raw"
    files = make(root)
    for module, out in ((theirs, "jax"), (ours, "port")):
        module.main(argparse.Namespace(dataset_dir=str(root), output_dir=str(tmp_path / out)))
    for f in files:
        a = (tmp_path / "jax" / f).read_bytes()
        assert a == (tmp_path / "port" / f).read_bytes(), f
        coco = json.loads(a)
        assert coco["images"] and coco["annotations"], f
    # the default output directory is the one data/datasets.py registers
    ours.main(argparse.Namespace(dataset_dir=str(root), output_dir=None))
    for f in files:
        assert (root / default_out / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_runs_as_a_module(tmp_path, name):
    make, ours, _, _ = CONVERTERS[name]
    files = make(tmp_path / "raw")
    proc = subprocess.run(
        [sys.executable, "-m", ours.__name__, "--dataset-dir", str(tmp_path / "raw"),
         "--output-dir", str(tmp_path / "out")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path / "out")) == sorted(files)
