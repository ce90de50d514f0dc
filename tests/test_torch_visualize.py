"""The visualizer (``visualization/visualizer.py``,
``cli/visualize_predictions.py``), port against JAX.

Both draw with OpenCV in the same calls, so on the same images and json the
PNGs are equal pixel for pixel. A synthetic dataset of 5 images at 64x80,
3 classes, written by each package's own writer (byte-identical,
``test_torch_data.py``), and one json of ``synthetic_detections`` with
random positive-definite covariances, one of them degenerate."""

import json
import os

import cv2
import numpy as np
import pytest

from pod_compare_tpu.cli import visualize_predictions as jviz_cli
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from pod_compare_tpu.visualization import visualizer as jviz
from pod_compare_tpu_torch.cli import visualize_predictions as tviz_cli
from pod_compare_tpu_torch.config import setup_arg_parser
from pod_compare_tpu_torch.data import get_dataset, load_image_bgr
from pod_compare_tpu_torch.data.synthetic import register_synthetic, synthetic_detections
from pod_compare_tpu_torch.visualization import visualizer as tviz
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

NAME = "synth_viz"
NUM_CLASSES = 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz")
    kw = dict(num_images=5, image_size=(64, 80), num_classes=NUM_CLASSES)
    jax_register_synthetic(str(root / "jax"), NAME, **kw)
    register_synthetic(str(root / "port"), NAME, **kw)
    with open(get_dataset(NAME).json_file) as f:
        dets = synthetic_detections(json.load(f), NUM_CLASSES, seed=5)
    dets[0]["bbox_covar"] = [[0.0] * 4 for _ in range(4)]  # a zero-width ellipse
    predictions = root / "coco_instances_results.json"
    with open(predictions, "w") as f:
        json.dump(dets, f)
    return root, str(predictions)


@pytest.mark.parametrize("max_images", [50, 2])
@pytest.mark.parametrize("min_allowed_score", [0.0, 0.6])
def test_pngs_equal_jax_pixel_for_pixel(dataset, tmp_path, max_images, min_allowed_score):
    _, predictions = dataset
    ours = tviz_cli.visualize_dataset(NAME, str(tmp_path / "port"), predictions,
                                      min_allowed_score, max_images)
    theirs = jviz_cli.visualize_dataset(NAME, str(tmp_path / "jax"), predictions,
                                        min_allowed_score, max_images)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and names
    assert len(names) <= max_images
    for name in names:
        a, b = cv2.imread(os.path.join(ours, name)), cv2.imread(os.path.join(theirs, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_drawing_functions_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        root = rng.normal(0, 2, (2, 2))
        cov = root @ root.T
        assert tviz.cov_ellipse(cov) == jviz.cov_ellipse(cov)
        assert tviz.cov_ellipse(cov, q=0.9) == jviz.cov_ellipse(cov, q=0.9)
    for e in (0.0, 0.7, 1.9, 5.0):
        assert tviz.entropy_color(e) == jviz.entropy_color(e)
    probs = rng.dirichlet(np.ones(4), 6)
    np.testing.assert_array_equal(tviz_cli.categorical_entropy(probs),
                                  jviz_cli.categorical_entropy(probs))
    with pytest.raises(ValueError):
        tviz.cov_ellipse(np.eye(2), q=None, nsig=None)


def test_the_cli_main_draws_the_inference_json(dataset, tmp_path, monkeypatch):
    """``main`` as ``python -m pod_compare_tpu_torch.cli.visualize_predictions``
    calls it: the json under the inference directory of the config's
    OUTPUT_DIR, the PNGs in its ``viz/``, each differing from its image."""
    _, predictions = dataset
    monkeypatch.setenv("POD_COMPARE_DATA_DIR", str(tmp_path))
    train = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
    infer = "Inference/bayes_od_mc_dropout.yaml"
    out = tmp_path / "BDD-Detection" / "retinanet" / \
        "retinanet_R_50_FPN_1x_reg_cls_var_dropout" / "random_seed_0"
    inference_dir = out / "inference" / NAME / "bayes_od_mc_dropout"
    os.makedirs(inference_dir)
    with open(predictions) as src, open(inference_dir / "coco_instances_results.json", "w") as f:
        f.write(src.read())
    args = setup_arg_parser().parse_args(
        ["--config-file", train, "--inference-config", infer, "--test-dataset", NAME])
    viz = tviz_cli.main(args)
    assert viz == str(inference_dir / "viz")
    records = {r["image_id"]: r for r in get_dataset(NAME).load()}
    names = os.listdir(viz)
    assert len(names) == len(records)
    for name in names:
        drawn = cv2.imread(os.path.join(viz, name))
        source = load_image_bgr(records[int(name.split(".")[0])]["file_name"])
        assert drawn.shape == source.shape and (drawn != source).any(), name
