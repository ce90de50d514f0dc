"""The port's matcher and losses against the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both sides. The matcher
must agree exactly: the labels are integers and the matched boxes are
copies of ground-truth boxes (JAX selects them with a one-hot product at
"highest" precision, the port with a gather). The deterministic losses run
the same float32 formulas in both frameworks, whose exp/log1p differ by an
ulp or so; they must agree within 1e-5 relative, and their gradients within
1e-5 of each gradient's largest magnitude. The 'threefry' sample bank draws
other normals than JAX's threefry, so it is held to the law: its estimator
converges to the exact expectation, and the batch-shared bank keeps each
image's loss a function of that image alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.ops import losses as JL
from pod_compare_tpu.ops.matcher import label_anchors_batch as jax_label_anchors_batch
from pod_compare_tpu.ops.pallas.focal import stochastic_focal_elem_pallas
from pod_compare_tpu_torch.ops import losses as L
from pod_compare_tpu_torch.ops.anchors import AnchorGenerator
from pod_compare_tpu_torch.ops.matcher import label_anchors, label_anchors_batch
from test_pallas_focal import _gauss_hermite_expected

NUM_CLASSES = 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _anchors(size=(64, 96)):
    gen = AnchorGenerator(
        sizes=[[32 * 2 ** (i + j / 3) for j in range(3)] for i in range(3)],
        aspect_ratios=[[0.5, 1.0, 2.0]] * 3, strides=[8, 16, 32],
    )
    return gen.concatenated(size).astype(np.float32)


def _ground_truth(rng, batch=4, g=6, size=(64, 96)):
    """Image 0: full; 1: padded; 2: no valid box; 3: tiny boxes whose best
    IoU is below the thresholds, so only low-quality forcing makes them
    positive."""
    h, w = size
    wh = rng.uniform(8, 60, (batch, g, 2))
    xy = rng.uniform(0, 1, (batch, g, 2)) * (np.array([w, h]) - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[3] = np.array([2, 2, 5, 6], np.float32) + rng.uniform(0, 40, (g, 1)).astype(np.float32)
    classes = rng.randint(0, NUM_CLASSES, (batch, g)).astype(np.int32)
    valid = np.ones((batch, g), bool)
    valid[1, 3:] = False
    boxes[1, 3:] = 0.0
    valid[2] = False
    return boxes, classes, valid


def _jax_labels(anchors, boxes, classes, valid):
    return jax_label_anchors_batch(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
        NUM_CLASSES,
    )


def test_matcher_labels_and_boxes_equal_jax(rng):
    anchors = _anchors()
    boxes, classes, valid = _ground_truth(rng)
    theirs = _jax_labels(anchors, boxes, classes, valid)
    ours = label_anchors_batch(_t(anchors), _t(boxes), _t(classes), _t(valid), NUM_CLASSES)
    np.testing.assert_array_equal(ours.gt_classes.numpy(), np.asarray(theirs.gt_classes))
    np.testing.assert_array_equal(ours.matched_boxes.numpy(), np.asarray(theirs.matched_boxes))
    labels = ours.gt_classes.numpy()
    # Padding and an image without ground truth: background or ignore only.
    assert set(np.unique(labels[2])) <= {NUM_CLASSES}
    # Every label kind occurs, and the tiny boxes of image 3 are positive.
    assert {-1, NUM_CLASSES} <= set(np.unique(labels)) and (labels[3] < NUM_CLASSES).any()


def test_low_quality_forcing_and_its_guard():
    anchors = _anchors()
    box = np.array([[[3.0, 3.0, 7.0, 7.0], [200.0, 200.0, 210.0, 210.0]]], np.float32)
    classes = np.array([[2, 4]], np.int32)
    valid = np.array([[True, True]])
    forced = label_anchors(_t(anchors), _t(box[0]), _t(classes[0]), _t(valid[0]), NUM_CLASSES)
    plain = label_anchors(_t(anchors), _t(box[0]), _t(classes[0]), _t(valid[0]), NUM_CLASSES,
                          allow_low_quality=False)
    # The small box reaches IoU < 0.4 with every anchor: only forcing makes
    # it a positive; the box outside the image overlaps nothing and forces
    # nothing (the highest_per_gt > 0 guard).
    assert (plain.gt_classes == 2).sum() == 0 and (forced.gt_classes == 2).sum() >= 1
    assert (forced.gt_classes == 4).sum() == 0
    theirs = _jax_labels(anchors, box, classes, valid)
    np.testing.assert_array_equal(forced.gt_classes.numpy(), np.asarray(theirs.gt_classes)[0])


def test_argmax_takes_the_first_maximum():
    """Two identical gt boxes: every anchor matches the first, as
    jnp.argmax picks it."""
    anchors = _anchors()
    box = np.array([[10.0, 10.0, 40.0, 40.0]] * 2, np.float32)
    labels = label_anchors(_t(anchors), _t(box), _t(np.array([1, 3])), _t(np.array([True, True])),
                           NUM_CLASSES)
    assert (labels.gt_classes == 1).any() and not (labels.gt_classes == 3).any()


def _loss_inputs(rng, b=2, r=50, k=NUM_CLASSES):
    return dict(
        logits=(rng.randn(b, r, k) * 3).astype(np.float32),
        log_vars=(rng.randn(b, r, k) * 2 - 1).astype(np.float32),
        targets=(rng.rand(b, r, k) > 0.8).astype(np.float32),
        valid=rng.rand(b, r) > 0.2,
        pos=rng.rand(b, r) > 0.6,
        pred=(rng.randn(b, r, 4) * 0.5).astype(np.float32),
        gt=(rng.randn(b, r, 4) * 0.5).astype(np.float32),
        cov4=(rng.randn(b, r, 4) * 4).astype(np.float32),
        cov10=np.concatenate([rng.randn(b, r, 4) * 4, rng.randn(b, r, 6) * 0.3],
                             -1).astype(np.float32),
    )


# (name, jax fn, port fn, argument keys, differentiable argument positions)
LOSSES = [
    ("focal", lambda a, b: JL.sigmoid_focal_loss(a, b).sum(),
     lambda a, b: L.sigmoid_focal_loss(a, b).sum(), ("logits", "targets"), (0,)),
    ("focal_alpha_off", lambda a, b: JL.sigmoid_focal_loss(a, b, -1.0, 1.5).sum(),
     lambda a, b: L.sigmoid_focal_loss(a, b, -1.0, 1.5).sum(), ("logits", "targets"), (0,)),
    ("smooth_l1_beta0", lambda a, b: JL.smooth_l1_loss(a, b).sum(),
     lambda a, b: L.smooth_l1_loss(a, b).sum(), ("pred", "gt"), (0,)),
    ("smooth_l1_beta05", lambda a, b: JL.smooth_l1_loss(a, b, 0.5).sum(),
     lambda a, b: L.smooth_l1_loss(a, b, 0.5).sum(), ("pred", "gt"), (0,)),
    ("masked_focal", JL.masked_sum_focal_loss, L.masked_sum_focal_loss,
     ("logits", "targets", "valid"), (0,)),
    ("masked_smooth_l1", lambda a, b, m: JL.masked_sum_smooth_l1(a, b, m, 0.1),
     lambda a, b, m: L.masked_sum_smooth_l1(a, b, m, 0.1), ("pred", "gt", "pos"), (0,)),
    ("nll", lambda a, b, s, m: JL.nll_box_loss(a, b, s, m, 0.0),
     lambda a, b, s, m: L.nll_box_loss(a, b, s, m, 0.0), ("pred", "gt", "cov4", "pos"), (0, 2)),
    ("mvn_nll", JL.mvn_nll_box_loss, L.mvn_nll_box_loss, ("pred", "gt", "cov10", "pos"), (0, 2)),
    ("smm_diagonal", JL.second_moment_matching_box_loss, L.second_moment_matching_box_loss,
     ("pred", "gt", "cov4", "pos"), (0, 2)),
    ("smm_full", JL.second_moment_matching_box_loss, L.second_moment_matching_box_loss,
     ("pred", "gt", "cov10", "pos"), (0, 2)),
]


@pytest.mark.parametrize("name, jfn, tfn, keys, diff", LOSSES, ids=[c[0] for c in LOSSES])
def test_deterministic_loss_and_gradient_match_jax(rng, name, jfn, tfn, keys, diff):
    data = _loss_inputs(rng)
    args = [data[k] for k in keys]
    theirs = float(jfn(*map(jnp.asarray, args)))
    targs = [_t(a).clone().requires_grad_(i in diff) for i, a in enumerate(args)]
    ours = tfn(*targs)
    np.testing.assert_allclose(float(ours.detach()), theirs, rtol=1e-5)
    ours.backward()
    jgrads = jax.grad(lambda *a: jfn(*a), argnums=diff)(*map(jnp.asarray, args))
    for i, jg in zip(diff, jgrads):
        jg = np.asarray(jg)
        scale = max(np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(targs[i].grad.numpy() / scale, jg / scale, atol=1e-5)


def test_annealing_and_normalizer_match_jax():
    for step in (0, 1, 2500, 40000, 80000, 100000):
        np.testing.assert_allclose(float(L.annealing_weight(step, 80000)),
                                   float(JL.annealing_weight(jnp.asarray(float(step)), 80000)),
                                   rtol=1e-6)
    for n, num_pos in ((100.0, 40.0), (100.0, 0.0), (3.5, 1e4)):
        np.testing.assert_allclose(
            float(L.ema_loss_normalizer(torch.tensor(n), torch.tensor(num_pos), 0.9)),
            float(JL.ema_loss_normalizer(jnp.asarray(n), jnp.asarray(num_pos), 0.9)), rtol=1e-6)


def test_pallas_impl_is_the_masked_sum_of_the_jax_kernel(rng):
    """impl='pallas' through the port's plain kernel equals the masked sum
    of the JAX kernel (interpret mode) on the same seed, with its gradient."""
    d = _loss_inputs(rng, b=2, r=700)
    seed = 1234
    jfn = lambda x, s: jnp.sum(jnp.where(
        jnp.asarray(d["valid"])[..., None],
        stochastic_focal_elem_pallas(x, s, jnp.asarray(d["targets"]), jnp.int32(seed), 10),
        0.0))
    theirs, (jgx, jgs) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(d["logits"]), jnp.asarray(d["log_vars"]))
    x = _t(d["logits"]).requires_grad_(True)
    s = _t(d["log_vars"]).requires_grad_(True)
    ours = L.stochastic_focal_loss(x, s, _t(d["targets"]), _t(d["valid"]), 10, seed,
                                   impl="pallas")
    np.testing.assert_allclose(float(ours.detach()), float(theirs), rtol=1e-5)
    ours.backward()
    for a, b in ((x.grad, jgx), (s.grad, jgs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy() / np.abs(b).max(), b / np.abs(b).max(), atol=1e-5)


def test_threefry_bank_converges_to_the_expectation(rng):
    """Mean over many samples: the estimator of the masked sum approaches
    the exact Gauss–Hermite expectation (6 standard errors)."""
    d = _loss_inputs(rng, b=1, r=200)
    valid = np.ones((1, 200), bool)
    expected = np.asarray(_gauss_hermite_expected(
        jnp.asarray(d["logits"].ravel()), jnp.asarray(d["log_vars"].ravel()),
        jnp.asarray(d["targets"].ravel()), 0.25, 2.0)).sum()
    draws = np.array([
        float(L.stochastic_focal_loss(_t(d["logits"]), _t(d["log_vars"]), _t(d["targets"]),
                                      _t(valid), 1, seed))
        for seed in range(400)
    ])
    se = draws.std() / np.sqrt(len(draws))
    assert abs(draws.mean() - expected) < 6 * se
    many = float(L.stochastic_focal_loss(_t(d["logits"]), _t(d["log_vars"]), _t(d["targets"]),
                                         _t(valid), 400, 7))
    assert abs(many - expected) < 6 * draws.std() / np.sqrt(400)


def test_threefry_bank_converges_to_deterministic_at_tiny_variance(rng):
    """As test_losses.py holds the JAX bank: log-variance -40 gives the
    plain focal loss."""
    d = _loss_inputs(rng, b=3, r=10)
    log_vars = np.full_like(d["logits"], -40.0)
    stoch = float(L.stochastic_focal_loss(_t(d["logits"]), _t(log_vars), _t(d["targets"]),
                                          _t(d["valid"][:, :10] | True), 4, 0))
    det = float(JL.masked_sum_focal_loss(jnp.asarray(d["logits"]), jnp.asarray(d["targets"]),
                                         jnp.ones((3, 10), bool)))
    np.testing.assert_allclose(stoch, det, rtol=1e-3)


def test_threefry_shared_batch_law(rng):
    """One (S, R, K) bank broadcast over the batch: at B=1 it is the iid
    bank, and at B>1 the total is the sum of per-image losses with the same
    bank (the law of tests/test_losses.py for the JAX bank)."""
    d = _loss_inputs(rng, b=3, r=11, k=2)
    args = [_t(d[k][:, :11]) for k in ("logits", "log_vars", "targets")]
    args[1] = args[1] * 0.1
    valid = _t(d["valid"][:, :11])
    call = lambda sl, shared: float(L.stochastic_focal_loss(
        *[a[sl] for a in args], valid[sl], 4, 5, shared_batch=shared))
    np.testing.assert_allclose(call(slice(0, 1), True), call(slice(0, 1), False), rtol=1e-6)
    total = call(slice(None), True)
    per_image = sum(call(slice(i, i + 1), True) for i in range(3))
    np.testing.assert_allclose(total, per_image, rtol=1e-5)
    assert total != call(slice(None), False)


def test_stochastic_focal_loss_respects_the_mask(rng):
    d = _loss_inputs(rng, b=2, r=6)
    for impl in ("threefry", "pallas"):
        empty = L.stochastic_focal_loss(_t(d["logits"][:, :6]), _t(d["log_vars"][:, :6]),
                                        _t(d["targets"][:, :6]), torch.zeros(2, 6, dtype=bool),
                                        3, 1, impl=impl)
        assert float(empty) == 0.0
    with pytest.raises(ValueError):
        L.stochastic_focal_loss(_t(d["logits"]), _t(d["log_vars"]), _t(d["targets"]),
                                _t(d["valid"]), 3, 1, impl="other")
