"""PDQ (``evaluation/pdq.py``), port against JAX: both are numpy and scipy,
so on the same json and ground truth every number agrees to 1e-12
relative.

The ground truth is six images of 72x96 with 0-6 boxes of 3 classes; the
detections come from ``synthetic_detections`` (jittered boxes, random
positive-definite covariances, duplicates, false positives), then: one
image with gt keeps no detection, one image has detections and no gt, one
detection has a non-finite covariance, one a category of -1, and one
image id is absent from the gt (its detections count as false
positives)."""

import json
import math

import numpy as np
import pytest

from pod_compare_tpu.evaluation import pdq as jpdq
from pod_compare_tpu_torch.data.synthetic import synthetic_detections
from pod_compare_tpu_torch.evaluation import pdq as tpdq
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

NUM_CLASSES = 3
W, H = 96, 72


def _gt(rng):
    images, annotations = [], []
    for image_id in range(1, 7):
        images.append({"id": image_id, "width": W, "height": H, "file_name": f"{image_id}.png"})
        for _ in range(0 if image_id == 5 else rng.randint(1, 7)):
            w, h = rng.uniform(6, 40), rng.uniform(6, 30)
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id,
                "category_id": int(rng.randint(1, NUM_CLASSES + 1)),
                "bbox": [rng.uniform(0, W - w), rng.uniform(0, H - h), w, h],
                "area": w * h, "iscrowd": 0,
            })
    categories = [{"id": c, "name": str(c)} for c in range(1, NUM_CLASSES + 1)]
    return {"images": images, "annotations": annotations, "categories": categories}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.RandomState(31)
    gt = _gt(rng)
    dets = [d for d in synthetic_detections(gt, NUM_CLASSES, seed=3) if d["image_id"] != 2]
    assert any(a["image_id"] == 2 for a in gt["annotations"])
    assert any(d["image_id"] == 5 for d in dets)
    dets[0]["bbox_covar"][1][1] = float("nan")
    dets[1]["category_id"] = -1
    dets.append(dict(dets[2], image_id=99))
    root = tmp_path_factory.mktemp("pdq")
    with open(root / "coco_instances_results.json", "w") as f:
        json.dump(dets, f)
    with open(root / "gt.json", "w") as f:
        json.dump(gt, f)
    return str(root), str(root / "gt.json")


@pytest.mark.parametrize("min_allowed_score", [0.0, 0.5])
def test_evaluate_pdq_matches_jax(case, min_allowed_score):
    root, gt_file = case
    mapping = {c: c - 1 for c in range(1, NUM_CLASSES + 1)}
    ours = tpdq.evaluate_pdq(root, gt_file, mapping, min_allowed_score, verbose=False)
    theirs = jpdq.evaluate_pdq(root, gt_file, mapping, min_allowed_score, verbose=False)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert math.isfinite(ours[k]), k
        np.testing.assert_allclose(ours[k], v, rtol=1e-12, atol=0, err_msg=k)
    assert 0.0 < ours["pdq"] < 1.0 and ours["tp"] > 0 and ours["fp"] > 0 and ours["fn"] > 0


def test_evaluate_pdq_prints_its_table(case, capsys):
    root, gt_file = case
    mapping = {c: c - 1 for c in range(1, NUM_CLASSES + 1)}
    out = tpdq.evaluate_pdq(root, gt_file, mapping)
    printed = capsys.readouterr().out
    assert "PDQ" in printed and f"{out['pdq']:.4f}" in printed


@pytest.mark.parametrize("rho", [0.0, 0.6, -0.95])
def test_corner_probabilities_match_jax(rho):
    box = np.array([20.3, 11.8, 61.2, 50.6])
    sx, sy = 2.5, 1.5
    cov = np.diag([sx ** 2, sy ** 2, 4.0, 9.0])
    cov[0, 1] = cov[1, 0] = rho * sx * sy
    np.testing.assert_allclose(tpdq.prob_in_map(box, cov, W, H),
                               jpdq.prob_in_map(box, cov, W, H), rtol=1e-12, atol=0)
    us, vs = np.arange(W) + 0.5, np.arange(H) + 0.5
    grid = tpdq.bivariate_cdf_grid(box[:2], cov[:2, :2], us, vs)
    np.testing.assert_allclose(grid, jpdq.bivariate_cdf_grid(box[:2], cov[:2, :2], us, vs),
                               rtol=1e-12, atol=0)
    assert grid.min() >= 0.0 and grid.max() <= 1.0 + 1e-12
