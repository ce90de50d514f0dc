"""The energy-score box loss (``ops/losses.py::energy_score_box_loss``,
BBOX_COV_LOSS 'energy_loss'), port against JAX.

The two packages draw their normals from different generators, so the loss
is held by law. Inputs: 2 images of 400 anchors, 300 positives in the first
(more than the 256 slots) and 40 in the second, diagonal (4-parameter) and
full (10-parameter) heads, 1000 draws, 8 seeds on each side, the standard
error measured from the 8 values:

* with the plain L1 distance (beta 0, the energy config's) the energy score
  has a closed form:
  only each dimension's marginal N(mu_i, sigma_i^2) enters,
  E|X - g| = sigma·sqrt(2/pi)·exp(-d^2/2sigma^2) + d·(1 - 2·Phi(-d/sigma))
  with d = mu - g, and E|X - X'| = 2·sigma/sqrt(pi). Both packages' means
  lie within 4 standard errors of it;
* with a smooth L1 (beta 0.1, detectron2's default) the two means lie
  within 4 standard errors of their difference.

The slot choice is exact: the first 256 positives in index order, the
indices of ``jax.lax.top_k`` on the 0/1 mask (``torch.topk`` breaks the
ties otherwise).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtr

import pod_compare_tpu.ops.losses as jlosses
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.train.loss import LossConfig as JaxLossConfig
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.ops import losses as tlosses
from pod_compare_tpu_torch.ops.gaussian import covariance_output_to_cholesky
from pod_compare_tpu_torch.ops.matcher import label_anchors_batch
from pod_compare_tpu_torch.train.loss import LossConfig, box_seed, compute_losses, encode_deltas
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

ENERGY_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_covar_energy.yaml"
SEEDS = range(8)
NUM_SAMPLES = 1000
R = 400
T = torch.from_numpy


def _inputs(dims: int):
    rng = np.random.RandomState(40 + dims)
    pred = rng.normal(0.0, 0.3, (2, R, 4)).astype(np.float32)
    gt = rng.normal(0.0, 0.3, (2, R, 4)).astype(np.float32)
    cov = np.concatenate([rng.uniform(-3.0, 1.0, (2, R, 4)),
                          rng.normal(0.0, 0.3, (2, R, dims - 4))], -1).astype(np.float32)
    mask = np.zeros((2, R), bool)
    mask[0, rng.choice(R, 300, replace=False)] = True
    mask[1, rng.choice(R, 40, replace=False)] = True
    return pred, gt, cov, mask


def _ours(inputs, beta, seed):
    pred, gt, cov, mask = inputs
    return float(tlosses.energy_score_box_loss(
        T(pred), T(gt), T(cov), T(mask), NUM_SAMPLES, beta,
        generator=torch.Generator().manual_seed(seed)))


def _theirs(inputs, beta, seed):
    pred, gt, cov, mask = inputs
    return float(jlosses.energy_score_box_loss(
        jax.random.PRNGKey(seed), jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(cov),
        jnp.asarray(mask), NUM_SAMPLES, beta))


def _mean_se(values):
    values = np.asarray(values, np.float64)
    return values.mean(), values.std(ddof=1) / math.sqrt(len(values))


def _closed_form(inputs):
    """The L1 energy score of the first 256 positives per image, float64."""
    pred, gt, cov, mask = (np.asarray(a, np.float64) for a in inputs)
    total = 0.0
    for b in range(2):
        idx = np.flatnonzero(mask[b])[:256]
        params = torch.from_numpy(cov[b, idx].copy())
        params[:, :4] = params[:, :4].clamp(-7.0, 7.0)
        chol = covariance_output_to_cholesky(params).numpy()
        sigma = np.sqrt(np.einsum("nij,nij->ni", chol, chol))  # sqrt(diag(L L^T))
        d = pred[b, idx] - gt[b, idx]
        attract = (sigma * math.sqrt(2 / math.pi) * np.exp(-d ** 2 / (2 * sigma ** 2))
                   + d * (1 - 2 * ndtr(-d / sigma)))
        total += (attract - 0.5 * 2 * sigma / math.sqrt(math.pi)).sum()
    return total


@pytest.mark.parametrize("dims", [4, 10])
def test_energy_score_meets_its_closed_form_in_both_packages(dims):
    inputs = _inputs(dims)
    exact = _closed_form(inputs)
    for name, fn in (("port", _ours), ("jax", _theirs)):
        mean, se = _mean_se([fn(inputs, 0.0, s) for s in SEEDS])
        assert abs(mean - exact) <= 4 * se, (name, mean, exact, se)
        assert 0 < se < 0.01 * abs(exact), (name, se)


@pytest.mark.parametrize("dims", [4, 10])
def test_energy_score_with_smooth_l1_agrees_with_jax_by_law(dims):
    inputs = _inputs(dims)
    ours = _mean_se([_ours(inputs, 0.1, s) for s in SEEDS])
    theirs = _mean_se([_theirs(inputs, 0.1, s) for s in SEEDS])
    assert abs(ours[0] - theirs[0]) <= 4 * math.hypot(ours[1], theirs[1]), (ours, theirs)


def test_slots_are_the_first_256_positives_as_jax_top_k_picks_them():
    _, _, _, mask = _inputs(4)
    idx, weight = tlosses.positive_slots(T(mask), 256)
    _, jidx = jax.lax.top_k(jnp.asarray(mask, jnp.float32), 256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx[0].numpy(), np.flatnonzero(mask[0])[:256])
    assert weight.sum(dim=1).tolist() == [256.0, 40.0]
    # The ties the issue names: lax.top_k keeps index order, torch.topk need not.
    _, small = jax.lax.top_k(jnp.asarray([1, 0, 1, 1, 0, 1], jnp.float32), 3)
    assert tlosses.positive_slots(torch.tensor([[1, 0, 1, 1, 0, 1]]).bool(), 3)[0].tolist() \
        == [np.asarray(small).tolist()] == [[0, 2, 3]]


def test_positives_beyond_the_slots_do_not_count():
    """The same draws with the mask cut to its first 256 positives give the
    same loss, whatever the dropped anchors hold."""
    pred, gt, cov, mask = _inputs(10)
    cut = mask.copy()
    cut[0, np.flatnonzero(mask[0])[256:]] = False
    far = pred.copy()
    far[0, np.flatnonzero(mask[0])[256:]] = 100.0
    a = _ours((pred, gt, cov, mask), 0.1, 3)
    assert a == _ours((pred, gt, cov, cut), 0.1, 3) == _ours((far, gt, cov, mask), 0.1, 3)


def test_energy_config_dispatches_the_energy_score():
    """The energy config's loss: NUM_SAMPLES read as in JAX, the energy term
    drawn from the generator seeded with `box_seed`, annealed like the NLL."""
    from pod_compare_tpu import configs_dir

    cfg = merge_configs(ENERGY_CFG, "", ["MODEL.RETINANET.NUM_CLASSES", 3,
                                         "MODEL.PROBABILISTIC_MODELING.ANNEALING_STEP", 10])
    lc = LossConfig.from_config(cfg)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(f"{configs_dir()}/{ENERGY_CFG}")
    jlc = JaxLossConfig.from_config(jcfg)
    assert (lc.bbox_cov_loss, lc.bbox_cov_num_samples, lc.smooth_l1_beta) == \
        (jlc.bbox_cov_loss, jlc.bbox_cov_num_samples, jlc.smooth_l1_beta) == \
        ("energy_loss", 1000, 0.0)

    rng = np.random.RandomState(9)
    anchors = torch.tensor([[x, y, x + s, y + s] for x in range(0, 64, 8) for y in range(0, 64, 8)
                            for s in (12.0, 24.0)], dtype=torch.float32)
    r = anchors.shape[0]
    outputs = {"box_cls": T(rng.normal(-2, 1, (2, r, 3)).astype(np.float32)),
               "box_delta": T(rng.normal(0, 0.2, (2, r, 4)).astype(np.float32)),
               "box_cls_var": T(rng.normal(-3, 1, (2, r, 3)).astype(np.float32)),
               "box_reg_var": T(rng.normal(-2, 0.5, (2, r, 4)).astype(np.float32))}
    gt_boxes = torch.tensor([[[4.0, 4.0, 20.0, 22.0], [30.0, 8.0, 60.0, 40.0]]] * 2)
    gt_classes = torch.tensor([[0, 2], [1, 1]])
    gt_valid = torch.tensor([[True, True], [True, False]])
    args = (outputs, anchors, gt_boxes, gt_classes, gt_valid, torch.tensor(100.0))
    seed = -12345
    without = LossConfig(**dict(vars(lc), bbox_cov_loss="none"))
    at = {step: compute_losses(*args, step, lc, seed)[0]["loss_box_reg"] for step in (0, 5)}
    standard, norm = compute_losses(*args, 5, without, seed)
    standard = standard["loss_box_reg"]
    assert torch.equal(at[0], standard)  # annealing weight 0 at step 0
    labels = label_anchors_batch(anchors, gt_boxes, gt_classes, gt_valid, 3, lc.iou_thresholds)
    pos = (labels.gt_classes >= 0) & (labels.gt_classes != 3)
    gt_deltas = torch.where(pos[..., None], encode_deltas(anchors[None], labels.matched_boxes),
                            torch.zeros(()))
    energy = tlosses.energy_score_box_loss(
        outputs["box_delta"], gt_deltas, outputs["box_reg_var"], pos, 1000, lc.smooth_l1_beta,
        generator=torch.Generator().manual_seed(box_seed(seed)))
    w = tlosses.annealing_weight(5, 10)
    expected = (1.0 - w) * standard + w * (energy / torch.clamp_min(norm, 1.0))
    torch.testing.assert_close(at[5], expected, rtol=1e-6, atol=0)
    assert box_seed(seed) != seed and 2 ** 32 <= box_seed(seed) < 2 ** 33
