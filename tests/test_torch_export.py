"""The port's serving export: a saved and loaded artifact against the live
predictor, against the JAX package's artifact, and on a host without the
model code.

It mirrors ``tests/test_export.py`` at its geometry (32x32 canvases, batch
2, 5 classes, TOPK 32, 10 detections, float32, full R50 depth):

* ``standard_nms`` through ``cli.export_model`` with ``--device cpu`` from a
  checkpoint of weights converted from the JAX package's parameters
  (``models/convert.py::from_jax_params``): the loaded artifact equals the
  live predictor bit for bit, and the JAX package's own artifact
  (``save_artifact(..., platforms=("cpu",))``) on the same weights within
  1e-4 of each field's scale (classes and `valid` exactly), as the float
  predictors already agree;
* an analytic program keeps four inputs (no sampling seeds) and its node
  count, an artifact whose manifest predates the sampled impls' export
  (no ``sampling_seeds_shape``) still loads and serves, and so does one
  whose program holds the plain NMS loop in place of the NMS operator;
* the refusal: members placed on two devices;
* the operators the program calls: ``pod_compare_tpu_torch::dropout``
  equals ``dropout_plain`` bit for bit, and the dropout, greedy-merge and
  normal operators pass ``torch.library.opcheck`` (their fake kernels give
  the real kernels' shapes, dtypes and strides).

The round trips of the multi-run pipelines (``bayes_od`` with MC dropout,
``ensembles`` pre-NMS) and the manifest are in
``tests/test_torch_export_runs.py``, the post-NMS merge and an artifact
served in a process without the model code in
``tests/test_torch_export_merges.py``, the Monte-Carlo sampling impls in
``tests/test_torch_export_sampled.py``: an export, save and load of the R50
pipeline takes 10-20 s on one core, and each file runs in under a minute
there. ``test_multi_platform_lowering`` has no counterpart
here: an ExportedProgram is made for one device, and an artifact exported
for CUDA is served on CUDA only (``tests/test_torch_export_cuda.py`` holds
the round trip on the card).
"""

import argparse
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pod_compare_tpu import configs_dir
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.inference import build_predictor as jax_build_predictor
from pod_compare_tpu.inference.export import load_artifact as jax_load_artifact
from pod_compare_tpu.inference.export import save_artifact as jax_save_artifact
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict
from pod_compare_tpu_torch.cli import export_model
from pod_compare_tpu_torch.config import get_cfg, merge_configs
from pod_compare_tpu_torch.inference import (
    build_predictor,
    load_artifact,
    save_artifact,
)
from pod_compare_tpu_torch.models import build_model, convert
from pod_compare_tpu_torch.ops.fusion import greedy_sequential_clusters
from pod_compare_tpu_torch.ops import nms as nms_module
from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import nms as knms
from pod_compare_tpu_torch.train.checkpoint import Checkpointer
from test_full_model_parity import make_reference_state
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

IMAGE_SIZE = (32, 32)
BATCH = 2
NUM_CLASSES = 5
TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var.yaml"
STD_INFER_CFG = "Inference/standard_nms.yaml"
OVERRIDES = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 32,
    "TEST.DETECTIONS_PER_IMAGE", 10,
    "PARALLEL.COMPUTE_DTYPE", "float32",
]
INPUT_SIZES = np.array([[32, 32], [30, 32]], np.float32)
OUTPUT_SIZES = np.array([[64, 64], [45, 48]], np.float32)


def make_cfg(mode="standard_nms", mc=False):
    """The port's counterpart of ``tests/test_export.py::make_cfg``."""
    cfg = get_cfg()
    cfg.MODEL.RETINANET.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE = 0.2 if mc else 0.0
    cfg.MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NAME = "loss_attenuation"
    cfg.MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NUM_SAMPLES = 3
    cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME = "negative_log_likelihood"
    cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NUM_SAMPLES = 20
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE = mode
    if mc:
        cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE = True
        cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS = 2
    return cfg


def seeded_state(cfg, seed=0):
    """Weights drawn from `seed`, the class-0 logits' bias raised so that
    every image keeps detections above the score threshold."""
    sd = build_model(cfg).init_weights(torch.Generator().manual_seed(seed)).state_dict()
    sd["head.cls_score.bias"].view(-1, NUM_CLASSES)[:, 0] += 5.0
    return sd


def tempered(sd, cfg, images):
    """The reference state with its output convs scaled so that the head's
    outputs land in trained-model ranges and the class-0 logits' bias
    raised, as ``tests/test_torch_pipeline.py::_temper`` does: every image
    then keeps finite detections above the score threshold."""
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        probe = model(torch.from_numpy(images[:1]))
    sd = dict(sd)
    for conv, key, target in (("cls_score", "box_cls", 2.0), ("bbox_pred", "box_delta", 0.2),
                              ("cls_var", "box_cls_var", 1.0), ("bbox_cov", "box_reg_var", 0.5)):
        scale = target / float(probe[key].abs().max())
        for p in ("weight", "bias"):
            sd[f"head.{conv}.{p}"] = sd[f"head.{conv}.{p}"] * scale
    sd["head.cls_score.bias"].reshape(-1, NUM_CLASSES)[:, 0] += 1.5
    sd["head.cls_var.bias"] = sd["head.cls_var.bias"] - 6.0
    sd["head.bbox_cov.bias"] = sd["head.bbox_cov.bias"] - 4.0
    return sd


def reference_state(cfg, seed=0):
    """`tempered` reference weights as the port's tensors: detections that
    follow the image, so that dropout runs and members agree on them."""
    sd = make_reference_state(np.random.RandomState(seed), num_classes=NUM_CLASSES)
    return {k: torch.from_numpy(v) for k, v in tempered(sd, cfg, example_batch()).items()}


def example_batch():
    rs = np.random.RandomState(3)
    return (rs.rand(BATCH, *IMAGE_SIZE, 3) * 255).astype(np.uint8)


def generator(seed):
    return torch.Generator().manual_seed(seed)


def round_trip(tmp_path_factory, name, predictor, **kwargs):
    """(directory, loaded artifact) of `predictor` saved at BATCH."""
    root = tmp_path_factory.mktemp(name)
    out = save_artifact(predictor, str(root / "artifact"), batch_size=BATCH, **kwargs)
    return root, load_artifact(out)


def assert_equal_detections(live, served):
    for name, a, b in zip(live._fields, live, served):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    assert bool(live.valid.any(dim=1).all())


# ------------------------------------------------------------ standard_nms, via the CLI
@pytest.fixture(scope="module")
def std(tmp_path_factory):
    """The JAX package's parameters from a reference state dict, the port's
    weights converted from them and written as the checkpoint that
    ``cli.export_model`` loads, and the artifact it writes."""
    root = tmp_path_factory.mktemp("std")
    cfg = merge_configs(TRAIN_CFG, STD_INFER_CFG, OVERRIDES)
    sd = make_reference_state(np.random.RandomState(0), num_classes=NUM_CLASSES)
    jax_params = convert_torch_state_dict(tempered(sd, cfg, example_batch()))
    state_dict = convert.from_jax_params(jax_params)
    args = argparse.Namespace(
        config_file=TRAIN_CFG, inference_config=STD_INFER_CFG, random_seed=0,
        dataset_dir="", test_dataset="", iou_min=0.1, iou_correct=0.7, min_allowed_score=0.0,
        resume=False, eval_only=False, num_devices=-1, opts=list(OVERRIDES), batch_size=BATCH,
        device="cpu", output_dir=str(root / "artifact"), canvas_height=IMAGE_SIZE[0],
        canvas_width=IMAGE_SIZE[1], random_init=False,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POD_COMPARE_DATA_DIR", str(root / "data"))
        out_dir = os.path.join(str(root / "data"), "BDD-Detection", "retinanet",
                               "retinanet_R_50_FPN_1x_reg_cls_var", "random_seed_0")
        Checkpointer(out_dir).save(0, {"model": state_dict})
        artifact = export_model.main(args)
    live = build_predictor(cfg, IMAGE_SIZE, state_dict, device="cpu")
    yield dict(artifact=artifact, served=load_artifact(artifact), live=live,
               jax_params=jax_params, args=args)
    shutil.rmtree(root, ignore_errors=True)


def test_standard_nms_round_trip_exact(std):
    images = example_batch()
    live = std["live"](images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    assert live.anchor_idx is not None and live.cluster_size is None
    assert_equal_detections(live, std["served"](images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))


def test_export_cli_writes_a_servable_artifact(std):
    m = std["served"].manifest
    assert m["train_config"] == TRAIN_CFG and m["inference_config"] == STD_INFER_CFG
    assert m["device"] == "cpu" and m["image_size"] == list(IMAGE_SIZE)
    assert m["batch_size"] == BATCH and m["inference_mode"] == "standard_nms"
    assert m["mc_runs"] == 0 and m["num_members"] == 1
    assert sorted(os.listdir(std["artifact"])) == ["manifest.json", "pipeline.pt2"]
    dets = std["served"](np.zeros((BATCH, *IMAGE_SIZE, 3), np.uint8), INPUT_SIZES, INPUT_SIZES)
    assert dets.boxes.shape == (BATCH, 10, 4) and dets.covs.shape == (BATCH, 10, 4, 4)


def test_export_cli_random_init_draws_weights_from_the_seed(std, tmp_path):
    """--random-init: weights drawn from the seed, one model per ensemble
    member seed for `ensembles` (the export itself is stubbed here)."""
    seeds = [3, 4]
    opts = OVERRIDES + ["PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS", seeds]
    args = argparse.Namespace(**{**vars(std["args"]), "random_init": True, "opts": opts,
                                 "inference_config": "Inference/ensembles_pre_nms.yaml"})
    written = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POD_COMPARE_DATA_DIR", str(tmp_path))
        mp.setattr(export_model, "save_artifact",
                   lambda predictor, out_dir, **kw: written.setdefault("predictor", predictor))
        export_model.main(args)
    members = written["predictor"].models
    cfg = merge_configs(TRAIN_CFG, args.inference_config, opts)
    for member, seed in zip(members, seeds):
        want = build_model(cfg).init_weights(generator(seed)).state_dict()
        assert torch.equal(member.head.cls_score.weight, want["head.cls_score.weight"])
    assert len(members) == 2
    assert not torch.equal(members[0].head.cls_score.weight, members[1].head.cls_score.weight)


def test_standard_nms_matches_the_jax_artifact(std, tmp_path):
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(f"{configs_dir()}/{TRAIN_CFG}")
    jcfg.merge_from_file(f"{configs_dir()}/{STD_INFER_CFG}")
    jcfg.merge_from_list(list(OVERRIDES))
    predictor = jax_build_predictor(jcfg, IMAGE_SIZE, params=std["jax_params"])
    served = jax_load_artifact(jax_save_artifact(predictor, str(tmp_path / "jax"),
                                                 batch_size=BATCH, platforms=("cpu",)))
    images = example_batch()
    theirs = served(images.astype(np.float32), INPUT_SIZES, OUTPUT_SIZES, jax.random.PRNGKey(7))
    ours = std["served"](images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    v = np.asarray(theirs.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    assert v.any(axis=1).all()
    np.testing.assert_array_equal(ours.classes.numpy()[v], np.asarray(theirs.classes)[v])
    for name in ("boxes", "covs", "scores", "prob_vectors"):
        a, b = getattr(ours, name).numpy()[v], np.asarray(getattr(theirs, name))[v]
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-4 * scale, (name, np.abs(a - b).max(), scale)


def test_a_cuda_artifact_is_refused_without_cuda(std, tmp_path):
    """No CPU fallback: a program exported for CUDA raises where CUDA is
    absent (on a card this would load the CPU program as a CUDA one, so
    the check is for a machine without one)."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    artifact = tmp_path / "cuda"
    shutil.copytree(std["artifact"], artifact)
    with open(artifact / "manifest.json") as f:
        manifest = json.load(f)
    with open(artifact / "manifest.json", "w") as f:
        json.dump({**manifest, "device": "cuda"}, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_artifact(str(artifact))


def test_an_analytic_program_keeps_four_inputs(std):
    """No sampling seeds in an analytic program: the four inputs, and 1325
    graph nodes: the 2340 of this program before the sampled impls exported,
    less the plain NMS loop's 264 of each image, plus the NMS operator's
    node and its two outputs' (one call an image), 1818; less the 542 nodes
    of the backbone's 53 FrozenBNs (9 each: the pair's add, rsqrt, three
    multiplies and subtract, two views, the add), 49 ReLUs and 16 residual
    adds, plus one FrozenBN epilogue node for each of its 49 convolutions
    (the 4 projection shortcuts' FrozenBNs inside conv3's)."""
    served = std["served"]
    assert served.manifest["sampling_seeds_shape"] is None
    assert len(served.program.graph_signature.user_inputs) == 4
    assert served.manifest["graph_nodes"] == len(served.program.graph.nodes) == 1325
    targets = [str(n.target) for n in served.program.graph.nodes]
    assert "pod_compare_tpu_torch.normal.default" not in targets
    assert targets.count("pod_compare_tpu_torch.batched_nms.default") == BATCH
    assert targets.count("pod_compare_tpu_torch.frozen_bn_act.default") == 49


def test_an_artifact_without_sampling_seeds_in_its_manifest_serves(std, tmp_path):
    """A manifest written before the sampled impls exported has no
    `sampling_seeds_shape`: its program takes four inputs, and it serves as
    the live predictor does."""
    artifact = tmp_path / "older"
    shutil.copytree(std["artifact"], artifact)
    with open(artifact / "manifest.json") as f:
        manifest = json.load(f)
    del manifest["sampling_seeds_shape"]
    with open(artifact / "manifest.json", "w") as f:
        json.dump(manifest, f)
    images = example_batch()
    assert_equal_detections(std["live"](images, INPUT_SIZES, OUTPUT_SIZES, generator(7)),
                            load_artifact(str(artifact))(images, INPUT_SIZES, OUTPUT_SIZES,
                                                         generator(7)))


def test_an_artifact_with_the_plain_nms_loop_serves(std, tmp_path):
    """Programs saved before NMS was one operator hold the plain loop's
    operations: such an artifact (exported here with the loop called in
    place of the operator) still loads and serves as the live predictor."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nms_module._knms, "batched_nms_op", knms.batched_nms_plain)
        artifact = save_artifact(std["live"], str(tmp_path / "plain"), batch_size=BATCH)
    served = load_artifact(artifact)
    targets = [str(n.target) for n in served.program.graph.nodes]
    assert "pod_compare_tpu_torch.batched_nms.default" not in targets
    assert len(targets) == 1847  # 2340 less the 493 that the FrozenBN epilogue saves
    images = example_batch()
    assert_equal_detections(std["live"](images, INPUT_SIZES, OUTPUT_SIZES, generator(7)),
                            served(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))


# ------------------------------------------------------------ refusals
def test_export_refuses_members_on_two_devices(tmp_path):
    cfg = make_cfg("ensembles")
    cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS = [0, 1]
    sd = seeded_state(cfg)
    predictor = build_predictor(cfg, IMAGE_SIZE, device="cpu", state_dicts=[sd, sd],
                                placement=["cpu", "meta"])
    with pytest.raises(ValueError, match="serve several cards by copying the artifact"):
        save_artifact(predictor, str(tmp_path / "a"), batch_size=BATCH)
    assert not (tmp_path / "a").exists()


# ------------------------------------------------------------ the operators
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_dropout_op_equals_the_plain_version(dtype, shared):
    x = torch.randn(2, 16, 6, 4, generator=generator(0)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    seed = 2 ** 62 + 12345
    args = (0.2, shared, 64, True)
    out = kd.dropout_op(x, torch.tensor(seed), *args)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(out.view(bits), kd.dropout_plain(x, seed, *args).view(bits))
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_operators_pass_opcheck():
    """Schemas, fake kernels against the real ones (shapes, dtypes,
    strides), and tracing through AOTAutograd."""
    x = torch.randn(2, 8, 4, 4, generator=generator(1)).contiguous(
        memory_format=torch.channels_last)
    dropout = torch.ops.pod_compare_tpu_torch.dropout.default
    torch.library.opcheck(dropout, (x, torch.tensor(5), 0.2, True, 0, True))
    torch.library.opcheck(dropout, (x.contiguous(), torch.tensor(5), 0.5, False, 8, False))
    rs = np.random.RandomState(2)
    boxes = torch.from_numpy(rs.rand(12, 2).astype(np.float32) * 20).repeat(1, 2)
    boxes[:, 2:] += 8.0
    from pod_compare_tpu_torch.ops.boxes import pairwise_iou

    iou = pairwise_iou(boxes, boxes)
    classes = torch.from_numpy(rs.randint(0, 2, 12))
    valid = torch.from_numpy(rs.rand(12) < 0.8)
    torch.library.opcheck(torch.ops.pod_compare_tpu_torch.greedy_sequential_clusters.default,
                          (iou, classes, valid, 0.3))
    centers, members = greedy_sequential_clusters(iou, classes, valid, 0.3)
    assert centers.shape == (12,) and members.shape == (12, 12)
    assert centers.dtype == members.dtype == torch.bool and bool(centers.any())
    normal = torch.ops.pod_compare_tpu_torch.normal.default
    torch.library.opcheck(normal, (torch.zeros(2), torch.tensor(9), [10, 7, 4], 4))
    torch.library.opcheck(normal, (torch.zeros(2, dtype=torch.bfloat16), torch.tensor(9), [5], 3))
