"""ResNeXt-101-32x8d-FPN, the port's grouped backbone, against the plain
reference ``tests/plain_resnext.py`` on the CPU.

The model is the one the port's entry points build from the flagship YAML
and the five opts that select the backbone (``X101_OPTS``), at its
published widths and depth, in float32, on seeded random weights
(``plain_resnext.random_state``), on small canvases. Tolerances:
  - features and head outputs: 1e-4 of the reference's largest value.
    Both sides compute float32; the port's activations are channels-last
    and the reference's contiguous, so the convolutions sum in other
    orders, which over 101 layers and the FPN reads 1e-6 to 4e-6. The
    reference on its weights rounded to bfloat16 reads 7e-3 to 1.1e-2
    (``test_bf16_weights_fail_the_tolerance`` asks for over 10x), so the
    bound tells float32 from the configuration's bfloat16 compute apart.
  - gradients: 1e-3 of each leaf's reference norm (the norm of the
    difference): the backward sums over batch and positions in other
    orders again, and a leaf of a few hundred elements whose terms cancel
    keeps less relative precision than a feature.
"""

import pickle

import numpy as np
import pytest
import torch

import plain_resnext as P
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.models import build_model, resnet
from pod_compare_tpu_torch.models.convert import (
    from_reference_state_dict,
    load_reference_checkpoint,
)
from pod_compare_tpu_torch.train import Trainer

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
X101_OPTS = [
    "MODEL.RESNETS.DEPTH", 101,
    "MODEL.RESNETS.NUM_GROUPS", 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
    "MODEL.RESNETS.STRIDE_IN_1X1", False,
    "MODEL.PIXEL_STD", [57.375, 57.120, 58.395],
]
FLOAT32 = ["PARALLEL.COMPUTE_DTYPE", "float32"]
NUM_CLASSES = 7
TOL = 1e-4
GRAD_TOL = 1e-3
LEVELS = ("p3", "p4", "p5", "p6", "p7")
STAGES = ("res3", "res4", "res5")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def x101():
    """(cfg, reference weights, the port's model on them, in eval mode)."""
    cfg = merge_configs(TRAIN_CFG, "", X101_OPTS + FLOAT32)
    sd = P.random_state(P.parameter_shapes(P.X101_32X8D, NUM_CLASSES), seed=101)
    model = build_model(cfg)
    model.load_state_dict(sd)
    return cfg, sd, model.eval()


def _images(canvas, batch, seed=0):
    rs = np.random.RandomState(seed)
    return torch.as_tensor((rs.rand(batch, *canvas, 3) * 255).astype(np.uint8))


def _port_features(model, images):
    x = model.normalize(images)
    feats = model.backbone.bottom_up(x)
    levels = model.backbone(x)
    return [feats[s] for s in STAGES] + [levels[lvl] for lvl in LEVELS]


def _reference_features(sd, images, arch=P.X101_32X8D):
    feats = P.resnet(sd, P.normalize(images, arch), arch)
    return [feats[s] for s in STAGES] + P.fpn(sd, feats)


def _gap(ours, ref):
    """The largest |ours - ref| over the reference's largest magnitude."""
    return float((ours - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("canvas,batch", [((64, 96), 2), ((128, 128), 1)])
def test_backbone_and_fpn_features_match(x101, canvas, batch):
    _, sd, model = x101
    images = _images(canvas, batch)
    with torch.no_grad():
        ours = _port_features(model, images)
        ref = _reference_features(sd, images)
    for name, a, b in zip(STAGES + LEVELS, ours, ref):
        assert a.shape == b.shape, name
        assert _gap(a, b) < TOL, (name, _gap(a, b))


def test_bf16_weights_fail_the_tolerance(x101):
    _, sd, model = x101
    images = _images((64, 96), 2)
    rounded = {k: v.bfloat16().float() for k, v in sd.items()}
    with torch.no_grad():
        ours = _port_features(model, images)
        ref = _reference_features(rounded, images)
    assert max(_gap(a, b) for a, b in zip(ours, ref)) > 10 * TOL


def test_backbone_gradients_match_and_freeze_at_2_trains_no_stem_or_res2(x101):
    _, sd, model = x101
    images = _images((64, 96), 1, seed=4)
    model.zero_grad(set_to_none=True)
    ours = _port_features(model, images)
    g = torch.Generator().manual_seed(5)
    weights = [torch.randn(f.shape, generator=g) for f in ours]
    sum(((f * w).sum() for f, w in zip(ours, weights))).backward()
    params = {k: v.clone().requires_grad_(P.trainable(k)) for k, v in sd.items()}
    ref = _reference_features(params, images)
    leaves = [k for k, v in params.items() if v.requires_grad and k.startswith("backbone.")]
    grads = torch.autograd.grad(sum((f * w).sum() for f, w in zip(ref, weights)),
                                [params[k] for k in leaves])
    named = dict(model.named_parameters())
    for k, want in zip(leaves, grads):
        got = named[k].grad
        assert got is not None, k
        gap = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert gap < GRAD_TOL, (k, gap)
    frozen = [k for k in named if k.startswith(("backbone.bottom_up.stem.",
                                                "backbone.bottom_up.res2."))]
    assert frozen and all(named[k].grad is None and not named[k].requires_grad for k in frozen)
    assert {k for k in named if k.startswith("backbone.") and named[k].requires_grad} == \
        set(leaves)


def test_head_outputs_through_the_trainer_and_the_predictor(x101, tmp_path):
    cfg, sd, _ = x101
    canvas, batch = (64, 96), 2
    images = _images(canvas, batch, seed=7)
    with torch.no_grad():
        ref = P.forward(sd, images, P.X101_32X8D, 4, NUM_CLASSES)

    class Feed:
        def __init__(self):
            self.canvas = canvas

    train_cfg = merge_configs(TRAIN_CFG, "", X101_OPTS + FLOAT32 + ["OUTPUT_DIR", str(tmp_path)])
    trainer = Trainer(train_cfg, Feed(), device="cpu")
    try:
        model = trainer.state.model
        model.load_state_dict(sd)
        with torch.no_grad():
            trained = model(images)  # no tower dropout: plain ReLU after each tower conv
    finally:
        trainer.close()
    infer_cfg = merge_configs(TRAIN_CFG, "Inference/standard_nms.yaml", X101_OPTS + FLOAT32)
    predictor = build_predictor(infer_cfg, canvas, sd, device="cpu")
    served, run_deltas = predictor.head_outputs(images)
    assert run_deltas is None
    for key, want in ref.items():
        for outs in (trained, served):
            assert outs[key].shape == want.shape, key
            assert _gap(outs[key], want) < TOL, (key, _gap(outs[key], want))


def test_defaults_build_r50_as_before():
    cfg = merge_configs(TRAIN_CFG, "", FLOAT32)
    assert (cfg.MODEL.RESNETS.NUM_GROUPS, cfg.MODEL.RESNETS.WIDTH_PER_GROUP) == (1, 64)
    model = build_model(cfg).eval()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == P.parameter_shapes(P.R50, NUM_CLASSES)
    convs = [m for m in model.backbone.bottom_up.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 53 and all(c.groups == 1 for c in convs)
    first = model.backbone.bottom_up.res3[0]
    assert first.conv1.stride == (2, 2) and first.conv2.stride == (1, 1)
    sd = P.random_state(P.parameter_shapes(P.R50, NUM_CLASSES), seed=50)
    model.load_state_dict(sd)
    images = _images((64, 96), 2, seed=9)
    calls = resnet.GROUPED_CONV_CALLS
    with torch.no_grad():
        ours = model(images)
        ref = P.forward(sd, images, P.R50, 4, NUM_CLASSES)
    assert resnet.GROUPED_CONV_CALLS == calls
    for key, want in ref.items():
        assert _gap(ours[key], want) < TOL, key


def test_x101_counts_its_grouped_convs(x101):
    _, _, model = x101
    calls = resnet.GROUPED_CONV_CALLS
    with torch.no_grad():
        model(_images((64, 64), 1))
    assert resnet.GROUPED_CONV_CALLS - calls == 3 + 4 + 23 + 3


def _detectron2_backbone(seed=3):
    """A bare X101 backbone as detectron2 names it in an ImageNet
    checkpoint (``stem.*``, ``res{S}.{B}.*``), numpy float32."""
    shapes = {k[len("backbone.bottom_up."):]: v
              for k, v in P.parameter_shapes(P.X101_32X8D, NUM_CLASSES).items()
              if k.startswith("backbone.bottom_up.")}
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


def test_convert_loads_a_detectron2_named_x101(x101, tmp_path):
    cfg, _, _ = x101
    state = _detectron2_backbone()
    assert state["res4.0.conv2.weight"].shape == (1024, 32, 3, 3)
    path = str(tmp_path / "X-101-32x8d.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": state, "__author__": "FAIR", "matching_heuristics": True}, f)
    converted = from_reference_state_dict(load_reference_checkpoint(path))
    assert set(converted) == {"backbone.bottom_up." + k for k in state}

    class Feed:
        canvas = (64, 64)

    train_cfg = merge_configs(TRAIN_CFG, "", X101_OPTS + FLOAT32 + [
        "OUTPUT_DIR", str(tmp_path / "out"), "MODEL.WEIGHTS", path])
    trainer = Trainer(train_cfg, Feed(), device="cpu")
    try:
        trainer.resume_or_load(resume=False)
        loaded = trainer.state.model.state_dict()
    finally:
        trainer.close()
    for k, v in state.items():
        np.testing.assert_array_equal(loaded["backbone.bottom_up." + k].numpy(), v, err_msg=k)
