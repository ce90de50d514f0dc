"""The port's metric suite against the JAX package's.

* ``COCOEvaluator``: the three fixture pairs of ``tests/fixtures/cocoeval/``
  and seeded random scenes, each engine of the port (C++ and numpy) against
  the JAX numpy engine: the 12 stats and the optimal-F1 threshold equal to
  1e-12 (both compute in float64; only the order of sums may differ).
* The matching partitions, each engine against the JAX package's same
  engine: the same members, every gathered field identical, shapes and
  types too; the IoUs within 1e-12 (the two C++ builds differ in flags,
  and so in where the compiler fuses a multiply and an add).
* The scoring rules and the Gaussian functions behind them: the port runs
  them in torch float32, JAX in jnp float32, with the same conditioning;
  1e-5 relative covers float32 Cholesky factors and means taken in another
  order (the Gaussian log density element by element: 1e-4, see there).
* ``evaluate_average_precision``, ``evaluate_probabilistic_metrics`` and
  ``evaluate_calibration_errors`` on one results json written by the JAX
  package's writer, scored by each package in its own directory: the same
  ``mAP_res.txt`` and the same dicts to 1e-6 (the float32 scoring rules
  enter the NLL and entropy averages).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from pod_compare_tpu.data.datasets import register_coco_instances as jax_register
from pod_compare_tpu.evaluation import scoring as jax_scoring
from pod_compare_tpu.evaluation.average_precision import (
    evaluate_average_precision as jax_average_precision,
)
from pod_compare_tpu.evaluation.calibration_errors import (
    evaluate_calibration_errors as jax_calibration_errors,
)
from pod_compare_tpu.evaluation.coco_eval import COCOEvaluator as JaxEvaluator
from pod_compare_tpu.evaluation.coco_eval import optimal_score_threshold as jax_threshold
from pod_compare_tpu.evaluation.matching import match_predictions_to_groundtruth as jax_match
from pod_compare_tpu.evaluation.matching import preprocess_gt as jax_preprocess_gt
from pod_compare_tpu.evaluation.matching import (
    preprocess_predictions as jax_preprocess_predictions,
)
from pod_compare_tpu.evaluation.probabilistic_metrics import (
    evaluate_probabilistic_metrics as jax_probabilistic_metrics,
)
from pod_compare_tpu.ops import gaussian as jax_gaussian
from pod_compare_tpu_torch.data.datasets import register_coco_instances
from pod_compare_tpu_torch.data.synthetic import synthetic_detections
from pod_compare_tpu_torch.evaluation import scoring
from pod_compare_tpu_torch.evaluation.average_precision import (
    evaluate_average_precision,
    read_optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.calibration_errors import evaluate_calibration_errors
from pod_compare_tpu_torch.evaluation.coco_eval import COCOEvaluator, optimal_score_threshold
from pod_compare_tpu_torch.evaluation.matching import (
    match_predictions_to_groundtruth,
    preprocess_gt,
    preprocess_predictions,
)
from pod_compare_tpu_torch.evaluation.probabilistic_metrics import (
    evaluate_probabilistic_metrics,
)
from pod_compare_tpu_torch.ops import gaussian
from test_native_cocoeval import random_scenario as coco_scenario
from test_native_match import random_scenario as match_scenario

import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "cocoeval")
PAIRS = ("crowd_and_ignore", "dense_multiclass", "sparse_small_objects")
ENGINES = ("native", "numpy")


def _fixture(name):
    with open(os.path.join(FIXTURES, f"{name}_gt.json")) as f:
        gt = json.load(f)
    with open(os.path.join(FIXTURES, f"{name}_dt.json")) as f:
        dt = json.load(f)
    return gt, dt


def _cases():
    cases = [(f"fixture-{p}", *_fixture(p)) for p in PAIRS]
    for seed in range(4):
        gt, dt = coco_scenario(np.random.RandomState(seed), crowd=seed % 2 == 1)
        cases.append((f"random-{seed}", gt, dt))
    return cases


CASES = _cases()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_coco_evaluator_matches_jax(case, engine):
    _, gt, dt = case
    theirs = JaxEvaluator(gt, dt)
    their_stats = theirs.run(verbose=False, use_native=False)
    ours = COCOEvaluator(gt, dt)
    our_stats = ours.run(verbose=False, use_native=engine == "native")
    np.testing.assert_allclose(our_stats, their_stats, rtol=0, atol=1e-12)
    for key in ("precision", "recall", "scores"):
        np.testing.assert_allclose(ours.eval[key], theirs.eval[key], rtol=0, atol=1e-12)
    assert abs(optimal_score_threshold(ours) - jax_threshold(theirs)) <= 1e-12


def _assert_partitions_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for part in theirs:
        assert set(ours[part]) == set(theirs[part]), part
        for field in theirs[part]:
            a, b = np.asarray(ours[part][field]), np.asarray(theirs[part][field])
            assert a.shape == b.shape and a.dtype == b.dtype, (part, field)
            if field == "iou_with_ground_truth":  # computed, the rest is gathered
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{part}/{field}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", range(4))
def test_matching_partitions_match_jax(seed, engine):
    """Each engine against the JAX package's same engine: the two JAX
    engines already differ in the shapes and types of empty fields."""
    preds, gts = match_scenario(np.random.RandomState(seed))
    native = engine == "native"
    theirs = jax_match(preds, gts, 0.1, 0.7, use_native=native)
    ours = match_predictions_to_groundtruth(preds, gts, 0.1, 0.7, use_native=native)
    _assert_partitions_equal(ours, theirs)


def test_preprocessing_matches_jax():
    gt = json.loads(json.dumps(CASES[1][1]))
    dets = synthetic_detections(gt, num_classes=3, seed=1)
    dets[0]["category_id"] = -1
    dets[1]["bbox_covar"] = [1.0]  # not 4x4: an identity covariance
    for score in (0.0, 0.5):
        ours, theirs = preprocess_predictions(dets, score), jax_preprocess_predictions(dets, score)
        assert ours.keys() == theirs.keys()
        for img in theirs:
            for k in theirs[img]:
                np.testing.assert_array_equal(ours[img][k], theirs[img][k])
    ours, theirs = preprocess_gt(gt["annotations"]), jax_preprocess_gt(gt["annotations"])
    assert ours.keys() == theirs.keys()
    for img in theirs:
        for k in theirs[img]:
            np.testing.assert_array_equal(ours[img][k], theirs[img][k])


def _gaussian_inputs(seed, n=64):
    rng = np.random.RandomState(seed)
    root = np.tril(rng.normal(0.0, 1.0, (n, 4, 4)))
    root[:, range(4), range(4)] = np.abs(root[:, range(4), range(4)]) + 0.3
    covs = (root @ np.swapaxes(root, 1, 2) * rng.uniform(0.1, 30.0, (n, 1, 1))).astype(np.float32)
    means = rng.uniform(0, 500, (n, 4)).astype(np.float32)
    gts = (means + rng.normal(0, 5.0, (n, 4))).astype(np.float32)
    return means, covs, gts


@pytest.mark.parametrize("seed", range(3))
def test_scoring_rules_match_jax(seed):
    means, covs, gts = _gaussian_inputs(seed)
    ours = scoring.compute_reg_scores(means, covs, gts, device="cpu")
    theirs = jax_scoring.compute_reg_scores(means, covs, gts)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5)
    ours = scoring.compute_reg_scores_fn(covs, device="cpu")
    theirs = jax_scoring.compute_reg_scores_fn(covs)
    np.testing.assert_allclose(ours["total_entropy_mean"], theirs["total_entropy_mean"],
                               rtol=1e-5)
    p = np.random.RandomState(seed).uniform(0.01, 1.0, 50)
    assert scoring.compute_cls_scores(p) == jax_scoring.compute_cls_scores(p)
    empty = np.zeros((0, 4))
    assert scoring.compute_reg_scores(empty, np.zeros((0, 4, 4)), empty, device="cpu") == \
        jax_scoring.compute_reg_scores(empty, np.zeros((0, 4, 4)), empty)
    assert scoring.compute_reg_scores_fn(np.zeros((0, 4, 4)), device="cpu") == \
        jax_scoring.compute_reg_scores_fn(np.zeros((0, 4, 4)))
    assert scoring.compute_cls_scores(np.zeros(0)) == jax_scoring.compute_cls_scores(np.zeros(0))


def test_gaussian_functions_match_jax():
    means, covs, gts = _gaussian_inputs(7)
    t = torch.from_numpy
    # Element by element a float32 solve carries the covariance's condition
    # number (up to ~1e3 in these inputs) times float32's 6e-8: 1e-4
    # relative. The averages the scoring rules report hold 1e-5 (above).
    np.testing.assert_allclose(
        gaussian.mvn_log_prob(t(gts), t(means), t(covs)).numpy(),
        np.asarray(jax_gaussian.mvn_log_prob(jnp.asarray(gts), jnp.asarray(means),
                                             jnp.asarray(covs))), rtol=1e-4)
    np.testing.assert_allclose(
        gaussian.mvn_entropy(t(covs)).numpy(),
        np.asarray(jax_gaussian.mvn_entropy(jnp.asarray(covs))), rtol=1e-5)
    std = np.sqrt(covs[:, range(4), range(4)])
    np.testing.assert_allclose(
        gaussian.normal_cdf(t(gts), t(means), t(std)).numpy(),
        np.asarray(jax_gaussian.normal_cdf(jnp.asarray(gts), jnp.asarray(means),
                                           jnp.asarray(std))), rtol=1e-5, atol=1e-7)
    # a matrix that is not positive definite gives NaN in both
    bad = covs[:2].copy()
    bad[0] = -np.eye(4, dtype=np.float32)
    ours = gaussian.mvn_entropy(t(bad)).numpy()
    theirs = np.asarray(jax_gaussian.mvn_entropy(jnp.asarray(bad)))
    assert np.isnan(ours[0]) and np.isnan(theirs[0])
    np.testing.assert_allclose(ours[1], theirs[1], rtol=1e-5)


def test_scoring_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    means, covs, gts = _gaussian_inputs(0, n=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        scoring.compute_reg_scores(means, covs, gts)


def _assert_dicts_close(ours, theirs, rtol):
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(ours[k]), k
        else:
            np.testing.assert_allclose(ours[k], v, rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("min_allowed_score", [None, 0.0, 0.5])
def test_metric_suite_matches_jax_on_one_results_json(tmp_path, min_allowed_score, engine):
    """Each package scores the same results json in its own directory (the
    matched-results cache is per directory): first mAP (which writes the
    threshold the other two read when `min_allowed_score` is None), then the
    probabilistic metrics and the calibration errors."""
    gt, _ = _fixture("dense_multiclass")
    gt["images"] = [dict(im, height=480, width=640) for im in gt["images"]]
    num_classes = len(gt["categories"])
    results = synthetic_detections(gt, num_classes=num_classes, seed=11)
    gt_file = tmp_path / "gt.json"
    gt_file.write_text(json.dumps(gt))
    ids = {c["id"]: i for i, c in enumerate(sorted(gt["categories"], key=lambda c: c["id"]))}
    classes = [str(c) for c in ids]
    name = f"eval_suite_{engine}_{min_allowed_score}"
    jax_register(name, str(gt_file), str(tmp_path), classes, ids)
    register_coco_instances(name, str(gt_file), str(tmp_path), classes, ids)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        (dirs[side] / "coco_instances_results.json").write_text(json.dumps(results))

    their_stats, their_thr = jax_average_precision(str(dirs["jax"]), name, verbose=False)
    our_stats, our_thr = evaluate_average_precision(str(dirs["port"]), name, verbose=False,
                                                    use_native=engine == "native")
    np.testing.assert_allclose(our_stats, their_stats, rtol=0, atol=1e-12)
    assert (dirs["port"] / "mAP_res.txt").read_text() == (dirs["jax"] / "mAP_res.txt").read_text()
    assert read_optimal_score_threshold(str(dirs["port"])) == round(their_thr, 4)

    native = engine == "native"
    kw = dict(min_allowed_score=min_allowed_score, verbose=False)
    theirs = jax_probabilistic_metrics(str(dirs["jax"]), name, name, **kw)
    ours = evaluate_probabilistic_metrics(str(dirs["port"]), name, name, device="cpu",
                                          use_native=native, **kw)
    _assert_dicts_close(ours, theirs, rtol=1e-6)
    assert ours["num_true_positives"] > 0 and ours["num_false_positives"] > 0
    assert np.isfinite(ours["tp_reg_ignorance"]) and np.isfinite(ours["fp_reg_entropy"])

    theirs = jax_calibration_errors(str(dirs["jax"]), name, name, **kw)
    ours = evaluate_calibration_errors(str(dirs["port"]), name, name, use_native=native, **kw)
    _assert_dicts_close(ours, theirs, rtol=1e-6)
    assert all(np.isfinite(v) for v in ours.values())
