"""The port's Monte-Carlo sampling and covariance-intersection pieces against
the JAX package and float64 numpy oracles.

* ``det4x4_psd``, ``decode_delta_samples``: the same inputs on both sides,
  elementwise chains within 1e-5 relative (a Cholesky in between: 1e-5 of
  the determinant).
* ``covariance_intersection_fusion``: the weights are differences of
  determinants and lose digits to cancellation in float32. Against the
  float64 oracle of ``tests/test_fusion.py`` (the reference's formula),
  over clusters of 1-60 members with box-scale covariances, both packages
  stay within 2e-5 of each output's scale (measured: at most 6.4e-6, the
  same for both); port against JAX within 1e-5 (measured 2.3e-6). Empty
  and one-member clusters stay finite.
* ``mvn_sample`` and the ``mc_iid`` / ``mc_shared`` banks draw their
  normals from a seed through the counter-based operator
  ``pod_compare_tpu_torch::normal`` (``ops/kernels/normal.py``), JAX from
  threefry: the bits differ, so they are held by law. Each band below is a
  number of the estimator's standard errors, computed from the sample
  count, with the seed fixed. The predictor draws one seed per image, or
  per (image, run) unit post-NMS, through ``seeds.draw_call_seeds``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.inference import core as jcore
from pod_compare_tpu.ops import boxes as jboxes
from pod_compare_tpu.ops import fusion as jfusion
from pod_compare_tpu.ops import gaussian as jgauss
from pod_compare_tpu_torch.inference import core as tcore
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds
from pod_compare_tpu_torch.ops.kernels import normal as knormal
from pod_compare_tpu_torch.ops import boxes as tboxes
from pod_compare_tpu_torch.ops import fusion as tfusion
from pod_compare_tpu_torch.ops import gaussian as tgauss
from test_fusion import oracle_covariance_intersection
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)
from test_torch_ops import WEIGHTS, core_inputs, random_boxes, random_psd

T = torch.from_numpy
J = jnp.asarray


def gen(seed):
    return torch.Generator().manual_seed(seed)


def seed_of(seed):
    """A bank's seed as the predictor passes it: an int64 0-d CPU tensor."""
    return torch.tensor(seed, dtype=torch.int64)


# ------------------------------------------------------------ primitives
def test_det4x4_psd_matches_jax_and_numpy():
    covs = random_psd(np.random.RandomState(1), 64)
    ours = tgauss.det4x4_psd(T(covs)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jgauss.det4x4_psd(J(covs))), rtol=1e-5)
    np.testing.assert_allclose(ours, np.linalg.det(covs.astype(np.float64)), rtol=1e-5)


def test_decode_delta_samples_matches_jax():
    rng = np.random.RandomState(2)
    anchors = random_boxes(rng, 50)
    samples = (rng.randn(7, 50, 4) * 0.3).astype(np.float32)
    samples[0, 0, 2] = 30.0  # past the scale clamp
    ours = tboxes.decode_delta_samples(T(samples), T(anchors), WEIGHTS)
    theirs = jboxes.decode_delta_samples(J(samples), J(anchors), WEIGHTS)
    assert ours.shape == (7, 50, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-4)
    # each sample row is the plain decode of that row
    np.testing.assert_array_equal(ours[3].numpy(),
                                  tboxes.decode_deltas(T(samples[3]), T(anchors), WEIGHTS).numpy())


def test_mvn_sample_law_and_replay():
    """Sample mean and covariance of 20,000 draws within 5 standard errors of
    N(mean, L L^T), like the JAX function's draws; the same seed replays
    the draws, another seed does not, and an offset draws further along the
    seed's stream."""
    rng = np.random.RandomState(3)
    mean = (rng.randn(3, 4) * 5).astype(np.float32)
    chol = np.linalg.cholesky(random_psd(rng, 3, scale=1.0)).astype(np.float32)
    cov = chol @ chol.transpose(0, 2, 1)
    s = 20_000
    ours = tgauss.mvn_sample(seed_of(0), T(mean), T(chol), s)
    assert ours.shape == (s, 3, 4) and ours.dtype == torch.float32
    assert torch.equal(ours, tgauss.mvn_sample(seed_of(0), T(mean), T(chol), s))
    assert not torch.equal(ours, tgauss.mvn_sample(seed_of(1), T(mean), T(chol), s))
    assert torch.equal(ours[1:], tgauss.mvn_sample(seed_of(0), T(mean), T(chol), s - 1, 12))
    theirs = np.asarray(jgauss.mvn_sample(jax.random.PRNGKey(0), J(mean), J(chol), s))
    var = np.diagonal(cov, axis1=1, axis2=2)
    for draws in (ours.numpy().astype(np.float64), theirs.astype(np.float64)):
        assert np.all(np.abs(draws.mean(0) - mean) < 5 * np.sqrt(var / s))
        resid = draws - draws.mean(0)
        emp = np.einsum("sni,snj->nij", resid, resid) / (s - 1)
        # se of a covariance entry: sqrt((S_ii S_jj + S_ij^2) / s)
        se = np.sqrt((np.einsum("ni,nj->nij", var, var) + cov ** 2) / s)
        assert np.all(np.abs(emp - cov) < 5 * se)


# ------------------------------------------------------------ covariance intersection
def ci_case(seed, sizes):
    """Clusters of the given sizes over near-identical box-scale covariances
    (5-50 px^2 times one shape, the members of one object), one extra empty
    cluster."""
    rng = np.random.RandomState(seed)
    n = sum(sizes)
    boxes = (rng.randn(n, 4) * 2 + 300).astype(np.float32)
    base = rng.randn(4, 4)
    base = base @ base.T + 4 * np.eye(4)
    covs = np.stack([base * rng.uniform(5, 50) + 0.5 * np.diag(rng.rand(4))
                     for _ in range(n)]).astype(np.float32)
    mask = np.zeros((len(sizes) + 1, n), bool)
    start = 0
    for c, k in enumerate(sizes):
        mask[c, start:start + k] = True
        start += k
    return mask, boxes, covs


@pytest.mark.parametrize("sizes", [(1, 2, 5), (20,), (60,)])
def test_covariance_intersection_matches_oracle_and_jax(sizes):
    for seed in range(4):
        mask, boxes, covs = ci_case(seed, sizes)
        ours = [t.numpy() for t in tfusion.covariance_intersection_fusion(
            T(mask), T(boxes), T(covs))]
        theirs = [np.asarray(t) for t in jfusion.covariance_intersection_fusion(
            J(mask), J(boxes), J(covs))]
        for out in ours:
            assert np.isfinite(out).all()  # the empty cluster too
        for c in range(len(sizes)):
            ref = oracle_covariance_intersection(boxes[mask[c]].astype(np.float64),
                                                 covs[mask[c]].astype(np.float64))
            for o, t, r in zip(ours, theirs, ref):
                scale = np.abs(r).max()
                assert np.abs(o[c] - r).max() <= 2e-5 * scale
                assert np.abs(t[c] - r).max() <= 2e-5 * scale
                assert np.abs(o[c] - t[c]).max() <= 1e-5 * scale
        # a one-member cluster is that member
        if sizes[0] == 1:
            np.testing.assert_allclose(ours[0][0], boxes[0], rtol=1e-5)
            np.testing.assert_allclose(ours[1][0], covs[0], rtol=1e-4, atol=1e-4)


def test_covariance_intersection_on_random_psd_matches_jax():
    """The JAX test's case (unit-scale PSD matrices, a singleton cluster)."""
    rng = np.random.RandomState(0)
    boxes = rng.randn(10, 4).astype(np.float32) * 10
    covs = random_psd(rng, 10, scale=1.0)
    mask = np.zeros((2, 10), bool)
    mask[0, [0, 2, 4]] = True
    mask[1, [5]] = True
    for ours, theirs in zip(tfusion.covariance_intersection_fusion(T(mask), T(boxes), T(covs)),
                            jfusion.covariance_intersection_fusion(J(mask), J(boxes), J(covs))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ sampling banks
@pytest.mark.parametrize("num_samples,num_candidates", [
    (1000, 4540), (1000, 100), (64, 9000), (997, 4540), (10, 1), (1000, 2 ** 20)])
def test_pick_chunk_matches_jax(num_samples, num_candidates):
    ours = tcore.pick_chunk(num_samples, num_candidates)
    assert ours == jcore._pick_chunk(num_samples, num_candidates)
    assert num_samples % ours == 0
    assert ours * num_candidates * 4 <= tcore.BOX_SAMPLE_CHUNK_ELEMS or ours == 1


def test_flagship_chunking():
    """~4,540 candidates per image at 736x1280 and S = 1000: 10 chunks of 100."""
    assert tcore.pick_chunk(1000, 4540) == 100


def _logits(seed, r=30, k=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(r, k) * 2).astype(np.float32), (rng.randn(r, k) * 0.5).astype(np.float32)


@pytest.mark.parametrize("impl", ["mc_iid", "mc_shared"])
def test_classification_banks_converge_to_analytic(impl):
    """Averaged over 200 seeds x 16 samples both banks give the
    Gauss-Hermite expectation, as the JAX banks do over 200 keys (the JAX
    test's band, 4 standard errors of a sigmoid mean)."""
    logits, log_var = _logits(4)
    exact = tcore.classification_probs(T(logits), T(log_var)).numpy()
    ours = np.mean([tcore.classification_probs(T(logits), T(log_var), impl, 16,
                                               seed_of(i)).numpy()
                    for i in range(200)], axis=0)
    f = jax.jit(lambda key: jcore.classification_probs(key, J(logits), J(log_var), 16, impl=impl))
    theirs = np.mean([np.asarray(f(jax.random.PRNGKey(i))) for i in range(200)], axis=0)
    np.testing.assert_allclose(ours, exact, atol=2.5e-2)
    np.testing.assert_allclose(theirs, exact, atol=2.5e-2)


def test_shared_bank_is_shared_across_anchors():
    """mc_shared draws one (S, 1, K) bank: anchors with the same logits and
    variances get the same estimate; mc_iid draws per anchor and does not."""
    logits = np.tile(np.array([[0.3, -1.0, 2.0]], np.float32), (50, 1))
    log_var = np.zeros_like(logits)
    shared = tcore.classification_probs(T(logits), T(log_var), "mc_shared", 10, seed_of(5))
    iid = tcore.classification_probs(T(logits), T(log_var), "mc_iid", 10, seed_of(5))
    # equal up to the rounding of a vectorised mean
    assert float((shared - shared[:1]).abs().max()) < 1e-6
    assert float((iid - iid[:1]).abs().max()) > 1e-2
    assert torch.equal(shared, tcore.classification_probs(T(logits), T(log_var), "mc_shared",
                                                          10, seed_of(5)))


def test_classification_bank_marginal_per_anchor():
    """One anchor's mc_iid and mc_shared estimates over 2,000 seeds:
    mean within 4 standard errors of the exact expectation and spread equal
    to the iid spread of 10 draws (the shared bank changes only the
    correlation across anchors)."""
    logits, log_var = _logits(6, r=4, k=2)
    exact = tcore.classification_probs(T(logits), T(log_var)).numpy()
    draws = {impl: np.stack([tcore.classification_probs(T(logits), T(log_var), impl, 10,
                                                        seed_of(i)).numpy()
                             for i in range(2000)])
             for impl in ("mc_iid", "mc_shared")}
    for impl, d in draws.items():
        se = d.std(axis=0) / np.sqrt(len(d))
        assert np.all(np.abs(d.mean(axis=0) - exact) < 4 * se + 1e-6), impl
    ratio = draws["mc_shared"].std(axis=0) / draws["mc_iid"].std(axis=0)
    assert np.all(np.abs(ratio - 1) < 0.15)


def _run_core(box_sampling, seed=None, box_num_samples=0, data=9, framework="torch"):
    """The core on `core_inputs(data)`; `seed` is the bank's seed (a JAX key
    for the JAX core)."""
    inputs, level_sizes = core_inputs(data)
    inputs["run_deltas"] = None
    args = [inputs[k] for k in ("anchors", "box_cls", "box_delta", "box_cls_var",
                                "box_reg_var", "run_deltas")]
    common = dict(topk=40, score_thresh=0.05, box_reg_weights=WEIGHTS, level_sizes=level_sizes)
    if framework == "jax":
        return jcore.probabilistic_inference_core(
            seed, *[None if a is None else J(a) for a in args], cls_num_samples=0,
            box_num_samples=box_num_samples, cls_sampling="analytic",
            box_sampling=box_sampling, **common)
    return tcore.probabilistic_inference_core(
        *[None if a is None else T(a) for a in args], box_sampling=box_sampling,
        box_num_samples=box_num_samples, seed=seed, **common)


def _cov_scale(covs):
    return np.sqrt(np.einsum("nii,njj->nij", covs, covs))


@pytest.mark.parametrize("impl", ["mc_iid", "mc_shared"])
def test_sampled_core_converges_to_analytic(impl):
    """At S = 4000 (chunks of `pick_chunk`) the sampled decode's means and
    covariances are within the JAX test's bands of the analytic core (mean
    0.5 px; covariance 0.08 of sqrt(S_ii S_jj)); the class path is untouched.
    JAX's sampled core at the same S lands in the same bands."""
    analytic = _run_core("analytic")
    sampled = _run_core(impl, seed_of(11), 4000)
    jsampled = _run_core(impl, jax.random.PRNGKey(11), 4000, framework="jax")
    v = analytic.valid.numpy()
    assert v.sum() >= 5
    np.testing.assert_array_equal(sampled.classes.numpy(), analytic.classes.numpy())
    np.testing.assert_array_equal(sampled.valid.numpy(), v)
    assert sampled.has_cov
    a_cov = analytic.covs.numpy()[v]
    scale = _cov_scale(a_cov)
    for boxes, covs in ((sampled.boxes.numpy(), sampled.covs.numpy()),
                        (np.asarray(jsampled.boxes), np.asarray(jsampled.covs))):
        np.testing.assert_allclose(boxes[v], analytic.boxes.numpy()[v], atol=0.5)
        np.testing.assert_allclose(covs[v] / scale, a_cov / scale, atol=0.08)


def test_box_shared_bank_marginal():
    """Per-candidate covariance under a shared z bank, averaged over 60
    seeds of 512 samples, within 0.05 of the analytic covariance's scale
    (the JAX test's band)."""
    analytic = _run_core("analytic")
    v = analytic.valid.numpy()
    mean_cov = np.mean([_run_core("mc_shared", seed_of(i), 512).covs.numpy()
                        for i in range(60)], axis=0)
    a_cov = analytic.covs.numpy()[v]
    scale = _cov_scale(a_cov)
    np.testing.assert_allclose(mean_cov[v] / scale, a_cov / scale, atol=0.05)


def test_sampled_core_replays_and_chunking_keeps_the_law():
    """The same seed replays the sampled core exactly; another seed does
    not. A bank drawn in 10 chunks takes 10 consecutive regions of the
    seed's stream, so it draws the normals of the bank drawn whole: their
    moments agree to float32 rounding (1e-4 of the covariances' scale), far
    inside the MC band (0.25) that held when chunks drew other normals."""
    a = _run_core("mc_iid", seed_of(3), 1000)
    b = _run_core("mc_iid", seed_of(3), 1000)
    assert not torch.equal(a.covs, _run_core("mc_iid", seed_of(4), 1000).covs)
    assert torch.equal(a.boxes, b.boxes) and torch.equal(a.covs, b.covs)
    assert tcore.pick_chunk(1000, 40) == 1000
    old = tcore.BOX_SAMPLE_CHUNK_ELEMS
    try:
        tcore.BOX_SAMPLE_CHUNK_ELEMS = 100 * 4 * 40  # 10 chunks of 100
        assert tcore.pick_chunk(1000, 40) == 100
        chunked = _run_core("mc_iid", seed_of(3), 1000)
    finally:
        tcore.BOX_SAMPLE_CHUNK_ELEMS = old
    v = a.valid.numpy()
    scale = _cov_scale(_run_core("analytic").covs.numpy()[v])
    np.testing.assert_allclose(chunked.covs.numpy()[v] / scale, a.covs.numpy()[v] / scale,
                               atol=1e-4)
    np.testing.assert_allclose(chunked.boxes.numpy()[v], a.boxes.numpy()[v], rtol=1e-5)


def test_sampled_box_normals_follow_the_anchor_not_the_rank():
    """The core keys a candidate's box normals by its anchor: the same
    candidates in another order (as two devices may rank near-tied scores)
    get the same moments, bit for bit, in that order."""
    inputs, _ = core_inputs(9)
    rng = np.random.RandomState(5)
    idx = torch.from_numpy(rng.choice(inputs["anchors"].shape[0], 40, replace=False))
    deltas = T(inputs["box_delta"])[idx]
    chol = tgauss.covariance_output_to_cholesky(T(inputs["box_reg_var"])[idx])
    anchors = T(inputs["anchors"])[idx]
    rows = inputs["anchors"].shape[0]
    perm = torch.from_numpy(rng.permutation(40))
    a = tcore.sampled_box_moments(seed_of(2), deltas, chol, anchors, 200, WEIGHTS,
                                  offset=16, index=idx, rows=rows)
    b = tcore.sampled_box_moments(seed_of(2), deltas[perm], chol[perm], anchors[perm], 200,
                                  WEIGHTS, offset=16, index=idx[perm], rows=rows)
    assert torch.equal(a[0][perm], b[0]) and torch.equal(a[1][perm], b[1])
    c = tcore.sampled_box_moments(seed_of(2), deltas[perm], chol[perm], anchors[perm], 200,
                                  WEIGHTS, offset=16)
    assert not torch.equal(a[1][perm], c[1])  # keyed by position instead: other normals


def test_unknown_sampling_impl_is_refused():
    logits, log_var = _logits(1)
    with pytest.raises(ValueError, match="CLS_SAMPLING"):
        tcore.classification_probs(T(logits), T(log_var), "mc_fancy", 4, seed_of(0))
    with pytest.raises(ValueError, match="BOX_SAMPLING"):
        _run_core("mc_fancy", seed_of(0), 10)
    with pytest.raises(ValueError, match="need a seed"):
        tcore.classification_probs(T(logits), T(log_var), "mc_iid", 4)


# ------------------------------------------------------------ the predictor
@pytest.fixture(scope="module")
def setup():
    from test_torch_modes import make_setup

    return make_setup()


def _sampling(cls_impl, box_impl, cls_samples, box_samples):
    return ["PROBABILISTIC_INFERENCE.CLS_SAMPLING", cls_impl,
             "PROBABILISTIC_INFERENCE.BOX_SAMPLING", box_impl,
             "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NUM_SAMPLES", cls_samples,
             "MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NUM_SAMPLES", box_samples]


@pytest.mark.parametrize("impl", ["mc_iid", "mc_shared"])
def test_sampled_box_decode_in_the_predictor_converges_to_analytic(setup, impl):
    """The flagship predictor (BayesOD + 3 injected MC-dropout runs) with the
    box bank at S = 4000 against the analytic predictor on the same masks
    (analytic class probabilities on both): the same detections, classes
    and scores; boxes within 0.5 px and covariances within 0.08 of
    sqrt(S_ii S_jj), the core's bands."""
    from test_torch_modes import port_detections

    extra = _sampling("analytic", impl, 0, 4000)
    sampled = port_detections(setup, "bayes_od_mc_dropout", extra)
    analytic = port_detections(setup, "bayes_od_mc_dropout")
    v = analytic.valid
    assert torch.equal(sampled.valid, v) and v.any(dim=1).all()
    assert torch.equal(sampled.classes[v], analytic.classes[v])
    assert torch.equal(sampled.scores[v], analytic.scores[v])
    np.testing.assert_allclose(sampled.boxes[v].numpy(), analytic.boxes[v].numpy(), atol=0.5)
    a_cov = analytic.covs[v].numpy()
    scale = _cov_scale(a_cov)
    np.testing.assert_allclose(sampled.covs[v].numpy() / scale, a_cov / scale, atol=0.08)


@pytest.mark.parametrize("impl", ["mc_iid", "mc_shared"])
def test_sampled_class_bank_in_the_predictor_converges_to_analytic(setup, impl):
    """The same with the class bank at S = 2000 (analytic boxes): a bank's
    probabilities differ from the quadrature by ~1e-3 here, enough to swap
    the NMS centre of two near-tied candidates, so the check is on the
    score distribution: as many detections per image, each image's best
    score within 0.005 and 90% of the detections' scores within 0.005 of
    the analytic ones."""
    from test_torch_modes import port_detections

    extra = _sampling(impl, "analytic", 2000, 0)
    sampled = port_detections(setup, "bayes_od_mc_dropout", extra)
    analytic = port_detections(setup, "bayes_od_mc_dropout")
    assert torch.equal(sampled.valid.sum(dim=1), analytic.valid.sum(dim=1))
    v = analytic.valid
    best = lambda d: torch.where(d.valid, d.scores, 0.0).amax(dim=1)
    assert float((best(sampled) - best(analytic)).abs().max()) < 5e-3
    close = (sampled.scores[v] - analytic.scores[v]).abs() < 5e-3
    assert float(close.float().mean()) >= 0.9


@pytest.mark.parametrize("case", ["bayes_od_mc_dropout", "mc_dropout_ensembles_post_nms"])
def test_sampled_predictor_replays_its_generator(setup, case):
    """The configs' own S (10 class, 1000 box samples) through `__call__`:
    one generator seed replays the detections exactly, another changes them;
    covariances PD. The pipeline itself refuses to sample without seeds."""
    from test_torch_modes import port_predictor

    extra = _sampling("mc_iid", "mc_iid", 10, 1000)
    predictor = port_predictor(setup, case, extra)
    assert predictor.sampled
    run = lambda seed: predictor(setup["images"], setup["input_sizes"], setup["output_sizes"],
                                 generator=gen(seed))
    a, b, c = run(4), run(4), run(5)
    for f in ("boxes", "covs", "scores", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.covs, c.covs)
    v = a.valid
    assert v.any(dim=1).all()
    assert (torch.linalg.eigvalsh(a.covs[v].double()) > 0).all()
    images = torch.from_numpy(setup["images"])
    sizes = torch.as_tensor(setup["input_sizes"], dtype=torch.float32)
    dropout_seeds, _ = draw_call_seeds(gen(4), predictor.num_runs, predictor.num_convs)
    with pytest.raises(ValueError, match="sampling_seeds of shape"):
        predictor.pipeline(images, sizes, sizes, dropout_seeds)


def test_post_nms_units_draw_independent_streams(setup):
    """A seed per (image, run) unit, as the JAX package splits each image's
    key into M: six distinct streams for 2 images x 3 runs, image b's
    streams seeded from image b's seed alone (the same for batch 1 and
    batch 2), and the pre-NMS image seeds are those image seeds. An
    analytic pipeline reads no seed."""
    from test_torch_modes import port_predictor

    extra = _sampling("mc_iid", "mc_iid", 10, 100)
    predictor = port_predictor(setup, "mc_dropout_ensembles_post_nms", extra)
    assert predictor.sampling_seeds_shape(2) == (2, predictor.num_runs) == (2, 3)
    seeds = draw_call_seeds(gen(0), 3, predictor.num_convs, 2, 3)[1]
    assert seeds.shape == (2, 3) and seeds.dtype == torch.int64
    x = torch.zeros(1)
    firsts = [float(knormal.normal(s, (1,), x)) for s in seeds.reshape(-1)]
    assert len(set(firsts)) == 6
    alone = draw_call_seeds(gen(0), 3, predictor.num_convs, 1, 3)[1]
    assert torch.equal(alone, seeds[:1])
    images = draw_call_seeds(gen(0), 3, predictor.num_convs, 2)[1]
    assert torch.equal(draw_call_seeds(gen(0), 3, predictor.num_convs, 1)[1], images[:1])
    for b in range(2):
        unit = torch.randint(0, 2 ** 63 - 1, (3,), generator=gen(int(images[b])),
                             dtype=torch.int64)
        assert torch.equal(seeds[b], unit)
    analytic = port_predictor(setup, "mc_dropout_ensembles_post_nms")
    assert not analytic.sampled
    assert analytic._sampling_seeds(None, 2) is None
