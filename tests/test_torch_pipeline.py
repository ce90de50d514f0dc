"""The whole flagship slice, port against JAX: BayesOD + MC-dropout inference.

Both packages merge the flagship configs
(retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml + bayes_od_mc_dropout.yaml),
cut to the small geometry of the JAX parity tests (64x64, 3 classes, full
R50 depth) and M = 3 runs at float32, with the default analytic sampling.
Weights are `make_reference_state`, with the output convs tempered to
trained-model magnitudes and wide boxes, so that BayesOD forms clusters of
several members. The same dropout masks go to both sides: the port through
`InjectedMasks`, the JAX predictor by monkeypatching `tower_dropout_masks`
for the length of the call (a `custom_vmap` hands each vmapped MC run its
own masks).

Tolerances: classes and `valid` must match exactly. Boxes and covariances
go through exp(), Cholesky inverses and sums taken in another order than
XLA's, from head outputs that already differ at ~1e-6 relative; we allow
1e-4 relative (and 1e-3 px / 1e-3 px^2 absolute), far below any change of a
detection.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.custom_batching import custom_vmap

import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.inference.postprocess import detections_to_json as jax_to_json
from pod_compare_tpu.inference.predictor import build_predictor as jax_build_predictor
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor, detections_to_json
from pod_compare_tpu_torch.models import InjectedMasks, build_model
from pod_compare_tpu_torch.ops.kernels import dropout as kdropout
from test_full_model_parity import make_reference_state

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
INFER_CFG = "Inference/bayes_od_mc_dropout.yaml"
IMAGE_SIZE = (64, 64)
NUM_CLASSES = 3
NUM_RUNS = 3
BATCH = 2
LEVEL_HW = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
OVERRIDES = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 100,
    "TEST.DETECTIONS_PER_IMAGE", 12,
    "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", NUM_RUNS,
    "PARALLEL.COMPUTE_DTYPE", "float32",
]


def _jax_cfg():
    from pod_compare_tpu import configs_dir

    cfg = jax_get_cfg()
    cfg.merge_from_file(f"{configs_dir()}/{TRAIN_CFG}")
    cfg.merge_from_file(f"{configs_dir()}/{INFER_CFG}")
    cfg.merge_from_list(list(OVERRIDES))
    return cfg


def _tensors(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _temper(sd, cfg, images):
    """Scale the random output convs so head outputs land in trained-model
    ranges, and widen the boxes (dw = dh = log 3) so neighbouring anchors
    overlap at IoU > 0.9. Output convs are linear in (W, b)."""
    model = build_model(cfg)
    model.load_state_dict(_tensors(sd))
    with torch.no_grad():
        probe = model(torch.from_numpy(images[:1]))
    targets = {"cls_score": ("box_cls", 2.0), "bbox_pred": ("box_delta", 0.2),
               "cls_var": ("box_cls_var", 1.0), "bbox_cov": ("box_reg_var", 0.5)}
    sd = dict(sd)
    for conv, (key, target) in targets.items():
        scale = target / float(probe[key].abs().max())
        sd[f"head.{conv}.weight"] = sd[f"head.{conv}.weight"] * scale
        sd[f"head.{conv}.bias"] = sd[f"head.{conv}.bias"] * scale
    cls_bias = sd["head.cls_score.bias"].reshape(-1, NUM_CLASSES)
    cls_bias[:, 0] += 1.5
    box_bias = sd["head.bbox_pred.bias"].reshape(-1, 4)
    box_bias[:, 2:] += math.log(3.0)
    sd["head.cls_var.bias"] = sd["head.cls_var.bias"] - 6.0
    sd["head.bbox_cov.bias"] = sd["head.bbox_cov.bias"] - 4.0
    return sd


def _masks(rng):
    """masks[run][tower][layer][level]: (H, W, 256) float32 scale masks."""
    keep = 0.8
    return [[[[np.where(rng.rand(h, w, 256) < keep, 1.0 / keep, 0.0).astype(np.float32)
               for (h, w) in LEVEL_HW] for _l in range(4)] for _t in range(2)]
            for _m in range(NUM_RUNS)]


def _fake_tower_dropout_masks(masks):
    """A stand-in for the JAX `tower_dropout_masks` that returns the given
    masks: call c of a head trace is (tower, layer) = divmod(c % 8, 4), and
    the vmap over MC runs receives the masks stacked over runs."""
    calls = []

    def fake(rng, shapes, rate, impl="bernoulli", dtype=None):
        tower, layer = divmod(len(calls) % 8, 4)
        calls.append(1)
        per_run = [[jnp.asarray(masks[m][tower][layer][lvl]) for lvl in range(len(shapes))]
                   for m in range(NUM_RUNS)]

        @custom_vmap
        def draw(key):
            return per_run[0]

        @draw.def_vmap
        def draw_vmap(axis_size, in_batched, key):
            assert axis_size == NUM_RUNS
            stacked = [jnp.stack([per_run[m][lvl] for m in range(NUM_RUNS)])
                       for lvl in range(len(shapes))]
            return stacked, [True] * len(shapes)

        return draw(rng)

    return fake, calls


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.RandomState(21)
    images = (rng.rand(BATCH, *IMAGE_SIZE, 3) * 255).astype(np.uint8)
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES)
    sd = _temper(make_reference_state(rng, num_classes=NUM_CLASSES), cfg, images)
    masks = _masks(rng)
    input_sizes = np.array([[64, 64], [60, 64]], np.float32)
    output_sizes = np.array([[128, 128], [90, 96]], np.float32)
    return cfg, sd, images, masks, input_sizes, output_sizes


@pytest.fixture(scope="module")
def jax_dets(slice_setup):
    cfg, sd, images, masks, input_sizes, output_sizes = slice_setup
    jcfg = _jax_cfg()
    params = merge_into_params(
        init_model_params(jax_build_model(jcfg), IMAGE_SIZE, seed=0),
        convert_torch_state_dict(sd),
    )
    predictor = jax_build_predictor(jcfg, IMAGE_SIZE, params=params)
    fake, calls = _fake_tower_dropout_masks(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dropout, "tower_dropout_masks", fake)
        dets = predictor(jnp.asarray(images), input_sizes, output_sizes)
        dets = jax.tree_util.tree_map(np.asarray, dets)
    assert len(calls) == 8
    return dets


@pytest.fixture(scope="module")
def torch_dets(slice_setup):
    cfg, sd, images, masks, input_sizes, output_sizes = slice_setup
    predictor = build_predictor(cfg, IMAGE_SIZE, _tensors(sd), device="cpu")
    injected = [InjectedMasks([[[torch.from_numpy(m) for m in layer] for layer in tower]
                               for tower in run]) for run in masks]
    outs, run_deltas = predictor.head_outputs(torch.from_numpy(images), tower_dropouts=injected)
    sizes = lambda s: torch.as_tensor(s)
    return predictor.detect(outs, run_deltas, sizes(input_sizes), sizes(output_sizes))


def test_configs_merge_to_the_flagship(slice_setup):
    cfg = slice_setup[0]
    pi = cfg.PROBABILISTIC_INFERENCE
    assert pi.INFERENCE_MODE == "bayes_od" and pi.MC_DROPOUT.ENABLE
    assert pi.BAYES_OD.CLS_MERGE_MODE == "max_score"
    assert pi.BAYES_OD.BOX_MERGE_MODE == "bayesian_inference"
    assert cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE == 0.2
    assert pi.CLS_SAMPLING == pi.BOX_SAMPLING == "analytic"
    assert cfg.to_dict() == _jax_cfg().to_dict()


def test_bayes_od_mc_dropout_classes_and_valid_match_jax(jax_dets, torch_dets):
    np.testing.assert_array_equal(torch_dets.valid.numpy(), jax_dets.valid)
    v = jax_dets.valid
    assert v.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(torch_dets.classes.numpy()[v], jax_dets.classes[v])
    # BayesOD fused several members into at least one detection per image.
    assert ((torch_dets.cluster_size.numpy() >= 2) & v).any(axis=1).all()


@pytest.mark.parametrize("field", ["boxes", "covs", "scores", "prob_vectors"])
def test_bayes_od_mc_dropout_values_match_jax(jax_dets, torch_dets, field):
    v = jax_dets.valid
    ours = getattr(torch_dets, field).numpy()[v]
    theirs = getattr(jax_dets, field)[v]
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-3)


def test_coco_json_matches_jax(jax_dets, torch_dets):
    for b in range(BATCH):
        pick = lambda d: type(d)(*[None if f is None else f[b] for f in d])
        ours = detections_to_json(pick(torch_dets), image_id=b)
        theirs = jax_to_json(pick(jax_dets), image_id=b)
        assert len(ours) == len(theirs) > 0
        for a, t in zip(ours, theirs):
            assert a.keys() == t.keys()
            assert a["category_id"] == t["category_id"]
            np.testing.assert_allclose(a["bbox"], t["bbox"], rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(a["bbox_covar"], t["bbox_covar"], rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(a["cls_prob"], t["cls_prob"], rtol=1e-4, atol=1e-6)


def test_predictor_call_runs_the_kernel_path_on_cpu(slice_setup):
    """The user entry point with the counter-based masks (plain version on
    the CPU): finite PSD output, replayed by the same generator seed,
    changed by another, and no kernel launch counted."""
    cfg, sd, images, _, input_sizes, output_sizes = slice_setup
    predictor = build_predictor(cfg, IMAGE_SIZE, _tensors(sd), device="cpu")
    before = kdropout.LAUNCHES
    run = lambda seed: predictor(images, input_sizes, output_sizes,
                                 generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert kdropout.LAUNCHES == before
    v = a.valid
    assert v.any(dim=1).all()
    assert torch.isfinite(a.boxes[v]).all() and torch.isfinite(a.covs[v]).all()
    assert (torch.linalg.eigvalsh(a.covs[v]) > 0).all()
    for f in ("boxes", "covs", "scores"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.boxes, c.boxes)


@pytest.mark.parametrize("shared", [True, False])
def test_mc_bank_masks_shared_or_per_image(slice_setup, shared):
    """Two identical images: batch-shared masks give them identical head
    outputs in every run, per-image masks do not."""
    cfg, sd, images, _, _, _ = slice_setup
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES)
    cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.BATCH_SHARED_MASKS = shared
    predictor = build_predictor(cfg, IMAGE_SIZE, _tensors(sd), device="cpu")
    twins = torch.from_numpy(np.stack([images[0], images[0]]))
    _, run_deltas = predictor.head_outputs(twins, torch.Generator().manual_seed(3))
    assert run_deltas.shape[0] == NUM_RUNS
    assert torch.equal(run_deltas[:, 0], run_deltas[:, 1]) == shared
    assert not torch.equal(run_deltas[0], run_deltas[1])


def test_predictor_refuses_an_unknown_head_quant():
    """HEAD_QUANT takes 'none' or 'int8' (tests/test_torch_quant.py); any
    other value raises, as the JAX package's TowerConv3 does, instead of
    running the float head."""
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES + [
        "PROBABILISTIC_INFERENCE.HEAD_QUANT", "int4"])
    state_dict = build_model(merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES)).state_dict()
    with pytest.raises(ValueError, match="Unknown head quantization mode 'int4'"):
        build_predictor(cfg, IMAGE_SIZE, state_dict, device="cpu")


def test_single_model_standard_nms_matches_jax(slice_setup):
    """The single-model path (no MC bank, standard NMS with deferred
    covariances) against the JAX predictor."""
    _, sd, images, _, input_sizes, output_sizes = slice_setup
    train, infer = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var.yaml", \
        "Inference/standard_nms.yaml"
    opts = OVERRIDES[:6] + OVERRIDES[8:]  # all but MC_DROPOUT.NUM_RUNS
    from pod_compare_tpu import configs_dir

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(f"{configs_dir()}/{train}")
    jcfg.merge_from_file(f"{configs_dir()}/{infer}")
    jcfg.merge_from_list(list(opts))
    params = merge_into_params(
        init_model_params(jax_build_model(jcfg), IMAGE_SIZE, seed=0),
        convert_torch_state_dict(sd),
    )
    theirs = jax.tree_util.tree_map(
        np.asarray,
        jax_build_predictor(jcfg, IMAGE_SIZE, params=params)(
            jnp.asarray(images), input_sizes, output_sizes),
    )
    predictor = build_predictor(merge_configs(train, infer, opts), IMAGE_SIZE, _tensors(sd),
                                device="cpu")
    ours = predictor(images, input_sizes, output_sizes)
    np.testing.assert_array_equal(ours.valid.numpy(), theirs.valid)
    v = theirs.valid
    assert v.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(ours.classes.numpy()[v], theirs.classes[v])
    for field in ("boxes", "covs", "scores", "prob_vectors"):
        np.testing.assert_allclose(getattr(ours, field).numpy()[v], getattr(theirs, field)[v],
                                   rtol=1e-4, atol=1e-3)
