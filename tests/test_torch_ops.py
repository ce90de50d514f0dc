"""The port's geometry, Gaussian, NMS, fusion, core and mode functions
against the JAX package on the same numpy inputs.

Tolerances: float32 on both sides. Elementwise chains (decode, moments,
IoU) agree to a few ulp, so 1e-5 relative; results that pass through
Cholesky solves, 4x4 inverses or reductions taken in another order agree to
1e-4 relative (atol 1e-6 for entries near 0). NMS indices and validity
flags must match exactly, against JAX and against the numpy oracle of
torchvision's semantics, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.inference import core as jcore
from pod_compare_tpu.inference import modes as jmodes
from pod_compare_tpu.inference import postprocess as jpost
from pod_compare_tpu.models import build_anchor_generator as jax_anchor_generator
from pod_compare_tpu.ops import boxes as jboxes
from pod_compare_tpu.ops import fusion as jfusion
from pod_compare_tpu.ops import gaussian as jgauss
from pod_compare_tpu.ops import nms as jnms
from pod_compare_tpu_torch.config import get_cfg
from pod_compare_tpu_torch.inference import core as tcore
from pod_compare_tpu_torch.inference import modes as tmodes
from pod_compare_tpu_torch.inference import postprocess as tpost
from pod_compare_tpu_torch.models import build_anchor_generator
from pod_compare_tpu_torch.ops import boxes as tboxes
from pod_compare_tpu_torch.ops import fusion as tfusion
from pod_compare_tpu_torch.ops import gaussian as tgauss
from pod_compare_tpu_torch.ops import nms as tnms
from reference_pipeline_oracle import batched_nms_np, nms_np

T = torch.from_numpy
J = jnp.asarray
WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def close(ours, theirs, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol)


def random_boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2).astype(np.float32) * scale
    wh = (rng.rand(n, 2).astype(np.float32) + 0.05) * scale / 3
    return np.concatenate([xy, xy + wh], axis=1)


def random_psd(rng, n, scale=4.0):
    a = rng.randn(n, 4, 4).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4, dtype=np.float32)) * scale


# ------------------------------------------------------------ anchors
@pytest.mark.parametrize("image_size", [(64, 64), (96, 160), (736, 1280)])
def test_anchors_match(image_size):
    ours = build_anchor_generator(get_cfg())
    theirs = jax_anchor_generator(jax_get_cfg())
    for a, b in zip(ours.per_level(image_size), theirs.per_level(image_size)):
        np.testing.assert_array_equal(a, b)
    assert ours.num_anchors(image_size) == theirs.num_anchors(image_size)


# ------------------------------------------------------------ boxes
def test_pairwise_iou_and_transforms_match():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 30), random_boxes(rng, 40)
    a[3] = a[3, [2, 3, 0, 1]]  # an empty (inverted) box
    close(tboxes.pairwise_iou(T(a), T(b)), jboxes.pairwise_iou(J(a), J(b)))
    close(tboxes.clip_boxes(T(a), 60.0, 70.0), jboxes.clip_boxes(J(a), 60.0, 70.0))
    np.testing.assert_array_equal(tboxes.nonempty(T(a)).numpy(), jboxes.nonempty(J(a)))
    close(tboxes.scale_boxes(T(a), 1.5, 0.5), jboxes.scale_boxes(J(a), 1.5, 0.5))
    covs = random_psd(rng, 5)
    close(tboxes.scale_covariance(T(covs), 1.5, 0.5), jboxes.scale_covariance(J(covs), 1.5, 0.5))
    close(tboxes.covar_xyxy_to_xywh(T(covs)), jboxes.covar_xyxy_to_xywh(J(covs)), atol=1e-5)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), WEIGHTS])
def test_decode_deltas_match(weights):
    rng = np.random.RandomState(1)
    anchors = random_boxes(rng, 50)
    deltas = rng.randn(3, 50, 4).astype(np.float32)
    deltas[0, 0, 2] = 20.0  # above SCALE_CLAMP
    close(tboxes.decode_deltas(T(deltas), T(anchors), weights),
          jboxes.decode_deltas(J(deltas), J(anchors), weights), atol=1e-4)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), WEIGHTS])
def test_decoded_box_moments_match_and_share_their_mean(weights):
    rng = np.random.RandomState(2)
    anchors = random_boxes(rng, 60)
    deltas = (rng.randn(60, 4) * 0.3).astype(np.float32)
    chol = np.tril(rng.randn(60, 4, 4) * 0.2).astype(np.float32)
    chol[:2] *= 30.0  # saturate the variance clamp
    cov = chol @ chol.transpose(0, 2, 1)
    mean, covs = tboxes.decoded_box_moments(T(deltas), T(cov), T(anchors), weights)
    jmean, jcovs = jboxes.decoded_box_moments(J(deltas), J(cov), J(anchors), weights)
    close(mean, jmean, atol=1e-4)
    close(covs, jcovs, rtol=1e-4, atol=1e-3)
    diag = np.diagonal(cov, axis1=1, axis2=2).copy()
    only_mean = tboxes.decoded_box_mean(T(deltas), T(diag), T(anchors), weights)
    assert torch.equal(only_mean, mean)


# ------------------------------------------------------------ gaussian
@pytest.mark.parametrize("dims", [4, 10])
def test_covariance_output_to_cholesky_matches(dims):
    rng = np.random.RandomState(3)
    raw = rng.randn(20, dims).astype(np.float32)
    close(tgauss.covariance_output_to_cholesky(T(raw)),
          jgauss.covariance_output_to_cholesky(J(raw)))


def test_psd_inverse_and_sample_covariance_match():
    rng = np.random.RandomState(4)
    covs = random_psd(rng, 25)
    close(tgauss.inv4x4_psd(T(covs)), jgauss.inv4x4_psd(J(covs)), rtol=1e-4, atol=1e-6)
    samples = rng.randn(7, 12, 4).astype(np.float32)
    for ours, theirs in zip(tgauss.sample_mean_covariance(T(samples)),
                            jgauss.sample_mean_covariance(J(samples))):
        close(ours, theirs, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ NMS
def nms_case(seed, n=200, classes=4, ties=True):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, n, scale=60.0)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores[::7] = scores[3]  # equal scores: the lower index goes first
        boxes[10] = boxes[11]  # identical boxes: IoU exactly 1
    cls = rng.randint(0, classes, n)
    valid = rng.rand(n) > 0.1
    return boxes, scores, cls, valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_batched_nms_matches_jax_and_oracle(seed, thresh):
    boxes, scores, cls, valid = nms_case(seed)
    max_out = 60
    ours = tnms.batched_nms(T(boxes), T(scores), T(cls), T(valid), thresh, max_out)
    theirs = jnms.batched_nms(J(boxes), J(scores), J(cls), J(valid), thresh, max_out)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(theirs.valid))
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(theirs.indices))
    idx = np.flatnonzero(valid)
    oracle = idx[batched_nms_np(boxes[idx].astype(np.float64), scores[idx], cls[idx], thresh)]
    k = min(len(oracle), max_out)
    np.testing.assert_array_equal(ours.indices.numpy()[:k], oracle[:k])
    assert int(ours.valid.sum()) == k


def test_nms_equality_is_kept_and_ties_go_to_the_lower_index():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [5, 0, 15, 10], [20, 20, 30, 30]],
                     np.float32)
    scores = np.array([0.5, 0.5, 0.9, 0.1], np.float32)
    valid = np.ones(4, bool)
    iou_02 = 50.0 / 150.0
    ours = tnms.nms(T(boxes), T(scores), T(valid), iou_02, 4)
    theirs = jnms.nms(J(boxes), J(scores), J(valid), iou_02, 4)
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(theirs.indices))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(theirs.valid))
    # IoU(0, 2) == threshold: box 0 survives box 2; box 1 (same score,
    # higher index) is suppressed by box 0.
    assert ours.indices.tolist()[:3] == [2, 0, 3]
    np.testing.assert_array_equal(ours.indices.numpy()[:3], nms_np(boxes, scores, iou_02))


# ------------------------------------------------------------ fusion
def fusion_case(seed, c=6, n=30):
    rng = np.random.RandomState(seed)
    mask = rng.rand(c, n) > 0.6
    mask[0] = False  # an empty cluster
    return mask, random_boxes(rng, n), random_psd(rng, n), rng.rand(n, 3).astype(np.float32)


def test_bayesian_fusion_matches():
    mask, boxes, covs, _ = fusion_case(5)
    for ours, theirs in zip(tfusion.bayesian_fusion(T(mask), T(boxes), T(covs)),
                            jfusion.bayesian_fusion(J(mask), J(boxes), J(covs))):
        close(ours[1:], np.asarray(theirs)[1:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_covs", [False, True])
def test_cluster_statistics_matches(with_covs):
    mask, boxes, covs, probs = fusion_case(6)
    center = np.arange(6)
    counts = mask.sum(axis=1) + 1
    ours = tfusion.cluster_statistics(
        T(mask), T(boxes), T(probs), T(covs) if with_covs else None,
        center_idx=T(center), fallback_counts=T(counts.astype(np.float32)))
    theirs = jfusion.cluster_statistics(
        J(mask), J(boxes), J(probs), J(covs) if with_covs else None,
        center_idx=J(center), fallback_counts=J(counts.astype(np.float32)))
    for a, b in zip(ours, theirs):
        close(a, b, rtol=1e-4, atol=1e-4)


def test_greedy_sequential_clusters_matches():
    rng = np.random.RandomState(7)
    boxes = random_boxes(rng, 40, scale=30.0)
    iou = np.array(jboxes.pairwise_iou(J(boxes), J(boxes)))
    cls = rng.randint(0, 2, 40)
    valid = rng.rand(40) > 0.2
    ours = tfusion.greedy_sequential_clusters(T(iou), T(cls), T(valid), 0.3)
    theirs = jfusion.greedy_sequential_clusters(J(iou), J(cls), J(valid), 0.3)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ core + modes
def core_inputs(seed, level_sizes=(180, 45, 18, 9, 9), k=3, runs=4):
    rng = np.random.RandomState(seed)
    r = sum(level_sizes)
    anchors = random_boxes(rng, r, scale=64.0)
    anchors[1::2] = anchors[0::2][: r // 2] + rng.rand(r // 2, 4).astype(np.float32)  # overlaps
    box_cls = (rng.randn(r, k) * 2).astype(np.float32)
    box_cls[5] = box_cls[6]  # tied candidates
    return dict(
        anchors=anchors,
        box_cls=box_cls,
        box_delta=(rng.randn(r, 4) * 0.2).astype(np.float32),
        box_cls_var=(rng.randn(r, k) - 4).astype(np.float32),
        box_reg_var=(rng.randn(r, 4) * 0.5 - 3).astype(np.float32),
        run_deltas=(rng.randn(runs, r, 4) * 0.2).astype(np.float32),
    ), level_sizes


def test_classification_probs_analytic_matches():
    inputs, _ = core_inputs(8)
    ours = tcore.classification_probs(T(inputs["box_cls"]), T(inputs["box_cls_var"]))
    theirs = jcore.classification_probs(
        None, J(inputs["box_cls"]), J(inputs["box_cls_var"]), 0, impl="analytic")
    close(ours, theirs, rtol=1e-5, atol=1e-6)


def test_topk_ties_go_to_the_lower_index():
    scores = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    vals, idx = tcore.topk_candidates(T(scores), 4, None)
    jvals, jidx = jcore._topk_candidates(J(scores), 4, None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [1, 3, 0, 2]


def _run_cores(inputs, level_sizes, **kw):
    args = [inputs[k] for k in ("anchors", "box_cls", "box_delta", "box_cls_var",
                                "box_reg_var", "run_deltas")]
    common = dict(topk=40, score_thresh=0.05, box_reg_weights=WEIGHTS,
                  level_sizes=level_sizes, **kw)
    ours = tcore.probabilistic_inference_core(*[None if a is None else T(a) for a in args],
                                              **common)
    theirs = jcore.probabilistic_inference_core(
        jax.random.PRNGKey(0), *[None if a is None else J(a) for a in args], cls_num_samples=0,
        box_num_samples=0, cls_sampling="analytic", box_sampling="analytic", **common)
    return ours, theirs


@pytest.mark.parametrize("with_runs", [False, True])
@pytest.mark.parametrize("defer", [False, True])
def test_inference_core_matches(with_runs, defer):
    inputs, level_sizes = core_inputs(9)
    if not with_runs:
        inputs["run_deltas"] = None
    ours, theirs = _run_cores(inputs, level_sizes, defer_covariance=defer)
    assert ours.has_cov == theirs.has_cov
    np.testing.assert_array_equal(ours.anchor_idx.numpy(), np.asarray(theirs.anchor_idx))
    np.testing.assert_array_equal(ours.classes.numpy(), np.asarray(theirs.classes))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(theirs.valid))
    close(ours.scores, theirs.scores)
    close(ours.prob_vectors, theirs.prob_vectors)
    close(ours.boxes, theirs.boxes, atol=1e-4)
    close(ours.covs, theirs.covs, rtol=1e-4, atol=1e-3)


def _cmp_dets(ours, theirs):
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(theirs.valid))
    v = np.asarray(theirs.valid)
    np.testing.assert_array_equal(ours.classes.numpy()[v], np.asarray(theirs.classes)[v])
    for f in ("boxes", "covs", "scores", "prob_vectors"):
        close(getattr(ours, f).numpy()[v], np.asarray(getattr(theirs, f))[v],
              rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cls_merge", ["max_score", "bayesian_inference"])
@pytest.mark.parametrize("affinity", [0.5, 0.9])
def test_bayes_od_matches(cls_merge, affinity):
    inputs, level_sizes = core_inputs(10)
    ours_c, theirs_c = _run_cores(inputs, level_sizes)
    ours = tmodes.bayes_od(ours_c, 0.5, 20, affinity, "bayesian_inference", cls_merge)
    theirs = jmodes.bayes_od(theirs_c, 0.5, 20, affinity, "bayesian_inference", cls_merge)
    _cmp_dets(ours, theirs)
    if affinity == 0.5:
        assert int(ours.cluster_size[ours.valid].max()) >= 2


def test_standard_nms_with_deferred_covariance_matches():
    inputs, level_sizes = core_inputs(11)
    inputs["run_deltas"] = None
    ours_c, theirs_c = _run_cores(inputs, level_sizes, defer_covariance=True)
    ours = tmodes.standard_nms(ours_c, 0.5, 20)
    theirs = jmodes.standard_nms(theirs_c, 0.5, 20)
    ours = tcore.deferred_covariance(ours, T(inputs["box_delta"]), T(inputs["box_reg_var"]),
                                     T(inputs["anchors"]), WEIGHTS)
    theirs = jcore.deferred_covariance(theirs, J(inputs["box_delta"]),
                                       J(inputs["box_reg_var"]), J(inputs["anchors"]), WEIGHTS)
    _cmp_dets(ours, theirs)


def test_postprocess_and_json_match():
    inputs, level_sizes = core_inputs(12)
    ours_c, theirs_c = _run_cores(inputs, level_sizes)
    ours = tmodes.bayes_od(ours_c, 0.5, 20, 0.7, "bayesian_inference", "max_score")
    theirs = jmodes.bayes_od(theirs_c, 0.5, 20, 0.7, "bayesian_inference", "max_score")
    ours = tpost.detector_postprocess(ours, torch.tensor(64.0), torch.tensor(60.0),
                                      torch.tensor(128.0), torch.tensor(100.0))
    theirs = jpost.detector_postprocess(theirs, 64.0, 60.0, 128.0, 100.0)
    _cmp_dets(ours, theirs)
    ours_json = tpost.detections_to_json(ours, 7, cat_mapping={0: 3, 1: 5})
    theirs_json = jpost.detections_to_json(
        type(theirs)(*[None if f is None else np.asarray(f) for f in theirs]), 7,
        cat_mapping={0: 3, 1: 5})
    assert len(ours_json) == len(theirs_json) > 0
    for a, b in zip(ours_json, theirs_json):
        assert a.keys() == b.keys()
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        for key in ("bbox", "score", "cls_prob", "bbox_covar"):
            close(a[key], b[key], rtol=1e-4, atol=1e-3)
