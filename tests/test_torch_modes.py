"""The inference modes of the port against the JAX package.

Part 1, the mode functions on identical candidates: the inputs of
``tests/golden/inference_core_v1.npz`` with two jittered copies of each
anchor (its 80 anchors barely overlap, so alone they form no cluster) go
through each package's analytic core (the golden file's own outputs used
``mc_iid`` threefry bits, so the comparison is with JAX, not with the
file), then ``anchor_statistics``,
``bayes_od`` with covariance intersection and ``black_box_merge`` (three
runs of perturbed deltas, per-run standard NMS, run-major concatenation).

Part 2, the predictor on the files of ``configs/Inference/`` that need no
ensemble (the single-model and MC-dropout ones, and ``bayes_od.yaml`` with
``BOX_MERGE_MODE covariance_intersection``); the ensembles and the
post-NMS merges are in ``tests/test_torch_ensembles.py``. The geometry is
``tests/test_torch_pipeline.py``'s: the flagship training config, 64x64,
3 classes, full R50 depth, M = 3 runs at float32, tempered reference
weights, and the same dropout masks injected on both sides.

Tolerances, as ``tests/test_torch_pipeline.py`` states them: classes and
`valid` exactly; boxes, covariances, scores and probabilities within 1e-4
relative and 1e-3 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu import configs_dir
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.inference import core as jcore
from pod_compare_tpu.inference import modes as jmodes
from pod_compare_tpu.inference.predictor import build_predictor as jax_build_predictor
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.inference import core as tcore
from pod_compare_tpu_torch.inference import modes as tmodes
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds
from pod_compare_tpu_torch.models import InjectedMasks
from test_full_model_parity import make_reference_state
from test_torch_pipeline import (
    IMAGE_SIZE,
    NUM_CLASSES,
    OVERRIDES,
    TRAIN_CFG,
    _fake_tower_dropout_masks,
    _masks,
    _temper,
    _tensors,
)

T = torch.from_numpy
J = jnp.asarray


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's torch work: pytest-xdist runs
    several workers on the machine's cores, and a worker's torch spinning
    on every core beside them makes these files ~5x slower (measured: 241 s
    against 45 s for the three mode files side by side on 8 cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inference_core_v1.npz")
GOLDEN_CORE = dict(topk=180, score_thresh=0.05)


def _cmp(ours, theirs, rtol=1e-4, atol=1e-3):
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(theirs.valid))
    v = np.asarray(theirs.valid)
    np.testing.assert_array_equal(ours.classes.numpy()[v], np.asarray(theirs.classes)[v])
    for f in ("boxes", "covs", "scores", "prob_vectors"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[v], np.asarray(getattr(theirs, f))[v],
                                   rtol=rtol, atol=atol, err_msg=f)


# ------------------------------------------------------------ part 1: mode functions
def golden_candidates(delta_noise=None):
    """Both packages' analytic candidates of the golden inputs, each anchor
    with two copies jittered by ~1 px (logits by ~0.1), 240 anchors."""
    g = np.load(GOLDEN)
    rng = np.random.RandomState(5)
    args = [np.concatenate([x] + [x + (rng.randn(*x.shape) * s).astype(np.float32)
                                  for _ in range(2)])
            for x, s in zip([g[f"inputs/{k}"] for k in ("anchors", "cls", "delta", "cvar", "rvar")],
                            (1.0, 0.1, 0.01, 0.1, 0.1))]
    if delta_noise is not None:
        args[2] = (args[2] + delta_noise).astype(np.float32)
    ours = tcore.probabilistic_inference_core(*[T(a) for a in args], None, **GOLDEN_CORE)
    theirs = jcore.probabilistic_inference_core(
        jax.random.PRNGKey(7), *[J(a) for a in args], None, cls_num_samples=0,
        box_num_samples=0, cls_sampling="analytic", box_sampling="analytic", **GOLDEN_CORE)
    return ours, theirs


@pytest.mark.parametrize("affinity", [0.5, 0.7, 0.9])
def test_anchor_statistics_matches_jax(affinity):
    ours_c, theirs_c = golden_candidates()
    ours = tmodes.anchor_statistics(ours_c, 0.5, 15, affinity)
    theirs = jmodes.anchor_statistics(theirs_c, 0.5, 15, affinity)
    _cmp(ours, theirs)
    v = ours.valid
    if affinity == 0.5:
        assert int(ours.cluster_size[v].max()) >= 2


def test_anchor_statistics_falls_back_on_raw_member_counts():
    """A center whose raw IoU cluster has two members but only itself of its
    class keeps the cluster statistics of that one member (its own box, a
    zero sample covariance plus its own covariance), not the center
    fallback: the count is taken before the class filter."""
    ours_c, theirs_c = golden_candidates()
    boxes = ours_c.boxes.clone()
    boxes[1] = boxes[0] + 0.01  # candidate 1 sits on candidate 0 ...
    classes = ours_c.classes.clone()
    classes[1] = (classes[0] + 1) % 5  # ... with another class
    valid = ours_c.valid.clone()
    valid[:2] = True
    ours_c = ours_c._replace(boxes=boxes, classes=classes, valid=valid)
    theirs_c = theirs_c._replace(boxes=J(boxes.numpy()), classes=J(classes.numpy()),
                                 valid=J(valid.numpy()))
    ours = tmodes.anchor_statistics(ours_c, 0.5, 15, 0.9)
    _cmp(ours, jmodes.anchor_statistics(theirs_c, 0.5, 15, 0.9))


@pytest.mark.parametrize("cls_merge", ["max_score", "bayesian_inference"])
@pytest.mark.parametrize("affinity", [0.5, 0.9])
def test_bayes_od_covariance_intersection_matches_jax(cls_merge, affinity):
    ours_c, theirs_c = golden_candidates()
    ours = tmodes.bayes_od(ours_c, 0.5, 15, affinity, "covariance_intersection", cls_merge)
    theirs = jmodes.bayes_od(theirs_c, 0.5, 15, affinity, "covariance_intersection", cls_merge)
    _cmp(ours, theirs)
    v = ours.valid
    assert torch.isfinite(ours.covs).all() and torch.isfinite(ours.boxes).all()
    assert (torch.linalg.eigvalsh(ours.covs[v].double()) > 0).all()
    if affinity == 0.5:
        assert int(ours.cluster_size[v].max()) >= 2


def test_bayes_od_refuses_an_unknown_box_merge():
    ours_c, _ = golden_candidates()
    with pytest.raises(ValueError, match="BOX_MERGE_MODE"):
        tmodes.bayes_od(ours_c, 0.5, 15, 0.9, "mean", "max_score")


def _run_detections(num_runs=3):
    """Per-run standard-NMS detections of the golden inputs with perturbed
    deltas (one perturbation per run), both packages."""
    rng = np.random.RandomState(17)
    ours, theirs = [], []
    for _ in range(num_runs):
        o, t = golden_candidates(rng.randn(240, 4).astype(np.float32) * 0.02)
        ours.append(tmodes.standard_nms(o, 0.5, 15))
        theirs.append(jmodes.standard_nms(t, 0.5, 15))
    return ours, theirs


def test_concatenate_detections_matches_jax():
    """Run-major: run m's detections fill rows 15m to 15m + 14."""
    ours, theirs = _run_detections()
    a = tmodes.concatenate_detections(ours)
    assert a.boxes.shape == (45, 4) and a.anchor_idx is None
    for m, run in enumerate(ours):
        for f in ("boxes", "covs", "scores", "classes", "prob_vectors", "valid"):
            assert torch.equal(getattr(a, f)[15 * m:15 * (m + 1)], getattr(run, f))
    _cmp(a, jmodes.concatenate_detections(theirs))


@pytest.mark.parametrize("affinity", [0.7, 0.9])
@pytest.mark.parametrize("is_generalized_rcnn", [False, True])
def test_black_box_merge_matches_jax(affinity, is_generalized_rcnn):
    ours, theirs = _run_detections()
    merged = tmodes.black_box_merge(tmodes.concatenate_detections(ours), 0.5, 15, affinity,
                                    is_generalized_rcnn)
    jmerged = jmodes.black_box_merge(jmodes.concatenate_detections(theirs), 0.5, 15, affinity,
                                     is_generalized_rcnn)
    _cmp(merged, jmerged)
    v = merged.valid
    assert v.any() and int(merged.cluster_size[v].max()) >= 2


def test_black_box_merge_depends_on_the_run_order():
    """The greedy clustering opens clusters in input order: member 0's
    detections first gives other clusters than member 2's first, in the port
    as in JAX."""
    ours, theirs = _run_detections()
    fwd = tmodes.black_box_merge(tmodes.concatenate_detections(ours), 0.5, 15, 0.7)
    rev = tmodes.black_box_merge(tmodes.concatenate_detections(ours[::-1]), 0.5, 15, 0.7)
    _cmp(rev, jmodes.black_box_merge(jmodes.concatenate_detections(theirs[::-1]), 0.5, 15, 0.7))
    assert not torch.equal(fwd.boxes[fwd.valid], rev.boxes[rev.valid])


# ------------------------------------------------------------ part 2: predictor configs
BASE_SEED = 21
CASES = {
    "standard_nms": ("Inference/standard_nms.yaml", []),
    "anchor_statistics": ("Inference/anchor_statistics.yaml", []),
    "bayes_od": ("Inference/bayes_od.yaml", []),
    "bayes_od_covariance_intersection": (
        "Inference/bayes_od.yaml",
        ["PROBABILISTIC_INFERENCE.BAYES_OD.BOX_MERGE_MODE", "covariance_intersection"]),
    "bayes_od_mc_dropout": ("Inference/bayes_od_mc_dropout.yaml", []),
    "mc_dropout_ensembles_pre_nms": ("Inference/mc_dropout_ensembles_pre_nms.yaml", []),
    "mc_dropout_ensembles_post_nms": ("Inference/mc_dropout_ensembles_post_nms.yaml", []),
    "ensembles_pre_nms": ("Inference/ensembles_pre_nms.yaml", []),
    "ensembles_post_nms": ("Inference/ensembles_post_nms.yaml", []),
}
# Two ensemble members keep the JAX side's time down; their seeds as
# ENSEMBLES.RANDOM_SEED_NUMS names them.
ENSEMBLE_OPTS = ["PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS", [0, 1000]]


def configs(case, extra=()):
    infer, opts = CASES[case]
    opts = list(OVERRIDES) + list(opts) + ENSEMBLE_OPTS + list(extra)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(f"{configs_dir()}/{TRAIN_CFG}")
    jcfg.merge_from_file(f"{configs_dir()}/{infer}")
    jcfg.merge_from_list(opts)
    return merge_configs(TRAIN_CFG, infer, opts), jcfg


def member(sd, seed):
    """Another ensemble member: the head's output biases moved a little (the
    members then agree on most objects, so post-NMS clusters form)."""
    rng = np.random.RandomState(seed)
    sd = dict(sd)
    for conv in ("cls_score", "bbox_pred", "cls_var", "bbox_cov"):
        b = sd[f"head.{conv}.bias"]
        sd[f"head.{conv}.bias"] = (b + rng.randn(*b.shape).astype(np.float32) * 0.05)
    return sd


def make_setup():
    rng = np.random.RandomState(BASE_SEED)
    images = (rng.rand(2, *IMAGE_SIZE, 3) * 255).astype(np.uint8)
    cfg, jcfg = configs("bayes_od_mc_dropout")
    sd = _temper(make_reference_state(rng, num_classes=NUM_CLASSES), cfg, images)
    masks = _masks(rng)
    template = init_model_params(jax_build_model(jcfg), IMAGE_SIZE, seed=0)
    return dict(
        images=images, masks=masks, members=[sd, member(sd, 1)], template=template,
        input_sizes=np.array([[64, 64], [60, 64]], np.float32),
        output_sizes=np.array([[128, 128], [90, 96]], np.float32),
    )


def jax_detections(setup, case, extra=()):
    cfg, jcfg = configs(case, extra)
    to_params = lambda sd: merge_into_params(setup["template"], convert_torch_state_dict(sd))
    if cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE == "ensembles":
        predictor = jax_build_predictor(
            jcfg, IMAGE_SIZE, params_list=[to_params(sd) for sd in setup["members"]])
    else:
        predictor = jax_build_predictor(jcfg, IMAGE_SIZE, params=to_params(setup["members"][0]))
    fake, calls = _fake_tower_dropout_masks(setup["masks"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dropout, "tower_dropout_masks", fake)
        dets = predictor(J(setup["images"]), setup["input_sizes"], setup["output_sizes"])
        dets = jax.tree_util.tree_map(np.asarray, dets)
    mc = cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE
    assert len(calls) == (8 if mc else 0)
    return dets


def port_predictor(setup, case, extra=(), members=None):
    cfg, _ = configs(case, extra)
    sds = [_tensors(sd) for sd in (members or setup["members"])]
    if cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE == "ensembles":
        return build_predictor(cfg, IMAGE_SIZE, device="cpu", state_dicts=sds)
    return build_predictor(cfg, IMAGE_SIZE, sds[0], device="cpu")


def port_detections(setup, case, extra=()):
    """The port's predictor with the setup's masks injected into its MC runs;
    a sampled config's banks draw from the seeds of a call with a generator
    seeded with 0 (`seeds.draw_call_seeds`)."""
    predictor = port_predictor(setup, case, extra)
    images = T(setup["images"])
    injected = [InjectedMasks([[[T(m) for m in layer] for layer in tower] for tower in run])
                for run in setup["masks"]]
    sizes = lambda s: torch.as_tensor(s)
    _, sampling_seeds = draw_call_seeds(torch.Generator().manual_seed(0), predictor.num_runs,
                                        predictor.num_convs, images.shape[0],
                                        predictor.num_runs if predictor.post_nms else 0)
    if predictor.post_nms:
        return predictor.detect_post_nms(predictor.run_outputs(images, tower_dropouts=injected),
                                         sizes(setup["input_sizes"]),
                                         sizes(setup["output_sizes"]), sampling_seeds)
    outs, run_deltas = predictor.head_outputs(images, tower_dropouts=injected)
    return predictor.detect(outs, run_deltas, sizes(setup["input_sizes"]),
                            sizes(setup["output_sizes"]), sampling_seeds)


def check_case(setup, case, extra=()):
    ours = port_detections(setup, case, extra)
    theirs = jax_detections(setup, case, extra)
    v = np.asarray(theirs.valid)
    assert v.sum(axis=1).min() >= 1
    _cmp(ours, theirs)
    return ours


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("case", ["standard_nms", "anchor_statistics", "bayes_od",
                                  "bayes_od_covariance_intersection", "bayes_od_mc_dropout",
                                  "mc_dropout_ensembles_pre_nms"])
def test_predictor_matches_jax(setup, case):
    ours = check_case(setup, case)
    if case != "standard_nms" and not case.startswith("mc_dropout"):
        # a cluster of several members in every image
        assert ((ours.cluster_size >= 2) & ours.valid).any(dim=1).all()


def test_pre_nms_mc_dropout_ensembles_is_standard_nms_on_the_bank(setup):
    """mc_dropout_ensembles pre_nms is standard NMS of the averaged bank with
    the run spread as epistemic covariance: equal, at the same masks, to
    standard_nms.yaml with the MC bank switched on, and positive definite."""
    dets = port_detections(setup, "mc_dropout_ensembles_pre_nms")
    same = port_detections(setup, "standard_nms", ["PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE",
                                                    True])
    for f in ("boxes", "covs", "scores", "classes", "valid"):
        assert torch.equal(getattr(dets, f), getattr(same, f))
    assert (torch.linalg.eigvalsh(dets.covs[dets.valid].double()) > 0).all()


def test_every_inference_config_is_accepted(setup):
    """Every file of configs/Inference/ builds a port predictor on the CPU and
    runs through its user entry point (`__call__`) with finite output."""
    files = sorted(f for f in os.listdir(os.path.join(configs_dir(), "Inference"))
                   if f.endswith(".yaml"))
    assert len(files) == 8
    for name in files:
        case = name[:-5]
        predictor = port_predictor(setup, case)
        dets = predictor(setup["images"], setup["input_sizes"], setup["output_sizes"],
                         generator=torch.Generator().manual_seed(1))
        assert dets.boxes.shape == (2, 12, 4)
        v = dets.valid
        assert v.any(dim=1).all(), name
        assert torch.isfinite(dets.boxes[v]).all() and torch.isfinite(dets.covs[v]).all(), name


@pytest.mark.parametrize("opts,match", [
    (["PROBABILISTIC_INFERENCE.INFERENCE_MODE", "nms_plus"], "Invalid inference mode"),
    (["PROBABILISTIC_INFERENCE.SPLIT_HEAD_PROGRAM", True], "SPLIT_HEAD_PROGRAM"),
    (["PROBABILISTIC_INFERENCE.ENSEMBLES_DROPOUT.BOX_MERGE_MODE", "post_nms",
      "PROBABILISTIC_INFERENCE.INFERENCE_MODE", "mc_dropout_ensembles",
      "PROBABILISTIC_INFERENCE.SPLIT_HEAD_PROGRAM", True], "SPLIT_HEAD_PROGRAM"),
])
def test_predictor_refuses_what_jax_refuses(setup, opts, match):
    """An unknown mode, and SPLIT_HEAD_PROGRAM on a single-run or post-NMS
    pipeline, raise ValueError in both packages."""
    cfg, jcfg = configs("standard_nms", opts)
    with pytest.raises(ValueError, match=match):
        build_predictor(cfg, IMAGE_SIZE, _tensors(setup["members"][0]), device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_build_predictor(jcfg, IMAGE_SIZE, params=setup["template"])


def test_split_head_program_is_accepted_on_the_mc_bank(setup):
    """On a multi-run pre-NMS pipeline the key changes nothing in the port."""
    extra = ["PROBABILISTIC_INFERENCE.SPLIT_HEAD_PROGRAM", True]
    a = port_detections(setup, "bayes_od_mc_dropout", extra)
    b = port_detections(setup, "bayes_od_mc_dropout")
    for f in ("boxes", "covs", "scores", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f))
