"""The int8 head (``ops/quant.py``, PROBABILISTIC_INFERENCE.HEAD_QUANT int8),
port against JAX.

Part 1, ``quantized_conv3x3`` on shared inputs: the quantized codes, the
int32 sums and the dequantized float32 output equal to the JAX package's
bit for bit (JAX run op by op; the int32 sums are exact on both sides).

Part 2, the head and the predictor in the geometry of
``tests/test_torch_pipeline.py`` (flagship configs, 64x64, 3 classes, full
R50 depth, M = 3 runs at float32, tempered reference weights, the same
dropout masks injected on both sides):

* the head alone on shared FPN features, the JAX head run op by op
  (``jax.disable_jit``): every tower activation is then quantized from the
  same float32 values, so only the output convs round differently; outputs
  within 1e-5 of each output's scale;
* the whole predictor, JAX jitted as a user runs it. Two roundings differ
  there: the two backbones' FPN features (XLA's and oneDNN's convolutions)
  and, inside XLA's fused program, the dequantization (measured: up to one
  float32 ulp in ~15% of the elements against the op-by-op form). Either
  can move a value across a quantization step (a flip): one code off by one,
  which moves the conv's output at 9 positions. The flips of the first
  tower conv's codes between the two backbones' features are counted and
  bounded (at most 1e-3 of the codes; measured 6 of 44,032). Detections:
  `valid` and classes exactly, every value within 1e-2 of its field's scale
  (the largest absolute value; measured 2.6e-4 for the boxes, 6.0e-5 for
  the covariances, 9.7e-4 for the scores, 3.4e-3 for the class
  probabilities). The head test above holds the int8 head without flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu.inference.predictor import build_predictor as jax_build_predictor
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.ops import quant as jquant
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.models import InjectedMasks, build_model, convert
from pod_compare_tpu_torch.models import retinanet as tretinanet
from pod_compare_tpu_torch.ops import quant as tquant
from test_full_model_parity import make_reference_state
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)
from test_torch_pipeline import (
    BATCH,
    IMAGE_SIZE,
    INFER_CFG,
    NUM_CLASSES,
    NUM_RUNS,
    OVERRIDES,
    TRAIN_CFG,
    _fake_tower_dropout_masks,
    _jax_cfg,
    _masks,
    _temper,
    _tensors,
)

INT8 = ["PROBABILISTIC_INFERENCE.HEAD_QUANT", "int8"]
MAX_CODE_FLIPS = 1e-3
MAX_ERR_OF_SCALE = 1e-2

T = torch.from_numpy
nchw = lambda a: T(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ part 1
@pytest.mark.parametrize("shape", [(2, 9, 7, 16), (1, 1, 1, 8)])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("signed", [True, False])
def test_quantized_conv3x3_matches_jax_bit_for_bit(shape, channels_last, signed):
    """(1, 1, 1, 8) is P7 at 64x64: one row, padded for ``torch._int_mm``."""
    rng = np.random.RandomState(sum(shape) + 2 * channels_last + signed)
    x = rng.randn(*shape).astype(np.float32) * 3.0
    if not signed:
        x = np.maximum(x, 0.0)
    co = 24
    kernel = (rng.randn(3, 3, shape[-1], co) * 0.05).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    xt = nchw(x)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    wt = T(kernel).permute(3, 2, 0, 1).contiguous()

    x8, sx = tquant.quantize_act_per_image(xt, signed)
    jx8, jsx = jquant.quantize_act_per_image(jnp.asarray(x), signed)
    np.testing.assert_array_equal(nhwc(x8), np.asarray(jx8))
    np.testing.assert_array_equal(sx.numpy().ravel(), np.asarray(jsx).ravel())
    w8, sw = tquant.quantize_weight_per_channel(wt)
    jw8, jsw = jquant.quantize_weight_per_channel(jnp.asarray(kernel))
    np.testing.assert_array_equal(w8.permute(2, 3, 1, 0).numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))

    sums = tquant.int8_conv3x3(x8, w8)
    jsums = jax.lax.conv_general_dilated(
        jx8, jw8, (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))

    ours = tquant.quantized_conv3x3(xt, wt, T(bias), act_signed=signed)
    theirs = jquant.quantized_conv3x3(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                      act_signed=signed)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(nhwc(ours), np.asarray(theirs))


def test_int32_sums_are_exact_above_float32_integers():
    """Every code at 127 over 256 channels: each interior sum is
    9·256·127·127 = 37,161,216 > 2^24, exact in both packages."""
    x8 = torch.full((1, 256, 5, 5), 127, dtype=torch.int8)
    w8 = torch.full((256, 256, 3, 3), 127, dtype=torch.int8)
    sums = tquant.int8_conv3x3(x8, w8)
    assert int(sums[0, 2, 2, 0]) == 9 * 256 * 127 * 127 > 2 ** 24
    assert int(sums[0, 0, 0, 0]) == 4 * 256 * 127 * 127
    jsums = jax.lax.conv_general_dilated(
        jnp.asarray(nhwc(x8)), jnp.asarray(w8.permute(2, 3, 1, 0).numpy()), (1, 1),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))


# ------------------------------------------------------------ part 2
@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(21)
    images = (rng.rand(BATCH, *IMAGE_SIZE, 3) * 255).astype(np.uint8)
    sd = _temper(make_reference_state(rng, num_classes=NUM_CLASSES),
                 merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES), images)
    masks = _masks(rng)
    jcfg = _jax_cfg()
    jcfg.merge_from_list(list(INT8))
    jmodel = jax_build_model(jcfg, head_quant="int8")
    params = merge_into_params(init_model_params(jmodel, IMAGE_SIZE, seed=0),
                               convert_torch_state_dict(sd))
    return dict(images=images, sd=sd, masks=masks, jcfg=jcfg, jmodel=jmodel, params=params,
                cfg=merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES + INT8))


def _injected(masks):
    return [InjectedMasks([[[T(m) for m in layer] for layer in tower] for tower in run])
            for run in masks]


def _nonzero_scale(a):
    return float(np.abs(a).max())


def test_int8_path_reads_the_converted_float_weights(setup):
    """The predictor's int8 model keeps the tower convs' float32 tensors of
    ``from_jax_params`` (its other convs in the compute dtype), and
    quantizes them to the JAX package's codes."""
    params = jax.tree_util.tree_map(np.asarray, setup["params"])
    state_dict = convert.from_jax_params(params)
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, INT8 + ["MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES])
    assert cfg.PARALLEL.COMPUTE_DTYPE == "bfloat16"
    model = build_predictor(cfg, IMAGE_SIZE, state_dict, device="cpu").model
    assert model.head.quant == "int8"
    assert model.head.cls_score.weight.dtype == torch.bfloat16
    for t, tower in enumerate(("cls_subnet", "bbox_subnet")):
        for layer in range(4):
            conv = model.head._convs(t)[layer]
            key = f"head.{tower}.{2 * layer}"
            assert conv.weight.dtype == torch.float32
            assert torch.equal(conv.weight, state_dict[f"{key}.weight"])
            assert torch.equal(conv.bias, state_dict[f"{key}.bias"])
            kernel = params["head"][f"{tower}_conv{layer}"]["kernel"]
            codes, _ = tquant.quantize_weight_per_channel(conv.weight)
            np.testing.assert_array_equal(
                codes.permute(2, 3, 1, 0).numpy(),
                np.asarray(jquant.quantize_weight_per_channel(jnp.asarray(kernel))[0]))


def test_int8_head_matches_jax_on_shared_features(setup):
    """One MC run of the int8 head on shared FPN features, JAX op by op:
    outputs within 1e-5 of each output's scale."""
    rng = np.random.RandomState(5)
    jm, params = setup["jmodel"], setup["params"]
    feats = [(rng.randn(BATCH, h, w, 256) * 2.0).astype(np.float32)
             for h, w in [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]]
    fake, calls = _fake_tower_dropout_masks(setup["masks"])
    with jax.disable_jit(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dropout, "tower_dropout_masks", fake)
        prefix = jm.apply({"params": params}, [jnp.asarray(f) for f in feats],
                          method=jm.head_prefix)
        theirs = jm.apply({"params": params}, prefix, False, True,
                          method=jm.forward_head_rest, rngs={"dropout": jax.random.PRNGKey(0)})
    assert len(calls) == 8
    model = build_model(setup["cfg"], head_quant="int8")
    model.load_state_dict(_tensors(setup["sd"]))
    with torch.no_grad():
        ours = model.head.rest(model.head.prefix([nchw(f) for f in feats]),
                               _injected(setup["masks"])[0])
    for key, value in ours.items():
        ref = np.asarray(theirs[key])
        np.testing.assert_allclose(value.numpy(), ref, rtol=0,
                                   atol=1e-5 * _nonzero_scale(ref), err_msg=key)


def test_int8_predictor_matches_jax(setup):
    images, masks = setup["images"], setup["masks"]
    input_sizes = np.array([[64, 64], [60, 64]], np.float32)
    output_sizes = np.array([[128, 128], [90, 96]], np.float32)
    jpred = jax_build_predictor(setup["jcfg"], IMAGE_SIZE, params=setup["params"])
    fake, calls = _fake_tower_dropout_masks(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dropout, "tower_dropout_masks", fake)
        theirs = jax.tree_util.tree_map(
            np.asarray, jpred(jnp.asarray(images), input_sizes, output_sizes))
    assert len(calls) == 8

    predictor = build_predictor(setup["cfg"], IMAGE_SIZE, _tensors(setup["sd"]), device="cpu")
    outs, run_deltas = predictor.head_outputs(T(images), tower_dropouts=_injected(masks))
    ours = predictor.detect(outs, run_deltas, torch.as_tensor(input_sizes),
                            torch.as_tensor(output_sizes))

    jm = setup["jmodel"]
    jfeats = jm.apply({"params": setup["params"]}, jnp.asarray(images), method=jm.backbone)
    with torch.no_grad():
        tfeats = predictor.model.backbone_features(T(images))
    flips = total = 0
    for a, b in zip(jfeats, tfeats):
        codes = nhwc(tquant.quantize_act_per_image(b, True)[0])
        flips += int((codes != np.asarray(jquant.quantize_act_per_image(a, True)[0])).sum())
        total += codes.size
    assert flips <= MAX_CODE_FLIPS * total, (flips, total)

    v = theirs.valid
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    assert v.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(ours.classes.numpy()[v], theirs.classes[v])
    for field in ("boxes", "covs", "scores", "prob_vectors"):
        a, b = getattr(ours, field).numpy()[v], getattr(theirs, field)[v]
        err = np.abs(a - b).max() / _nonzero_scale(b)
        assert err <= MAX_ERR_OF_SCALE, (field, err)


def test_int8_mc_bank_runs_float32_dropout_through_the_entry_point(setup, monkeypatch):
    """The user entry point on the CPU: the MC bank's K1 calls (its plain
    version here), one per (run, tower, layer) over the five levels, all see
    float32 tower activations, and the detections are finite."""
    seen, calls = [], []
    real = tretinanet.dropout_levels

    def watched(xs, *args, **kwargs):
        calls.append(len(xs))
        seen.extend(x.dtype for x in xs)
        return real(xs, *args, **kwargs)

    monkeypatch.setattr(tretinanet, "dropout_levels", watched)
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, OVERRIDES[:-2] + INT8)
    assert cfg.PARALLEL.COMPUTE_DTYPE == "bfloat16"
    predictor = build_predictor(cfg, IMAGE_SIZE, _tensors(setup["sd"]), device="cpu")
    sizes = np.array([[64, 64]] * BATCH, np.float32)
    dets = predictor(setup["images"], sizes, sizes, generator=torch.Generator().manual_seed(1))
    assert seen == [torch.float32] * (NUM_RUNS * 2 * 4 * 5)
    assert calls == [5] * (NUM_RUNS * 2 * 4)
    v = dets.valid
    assert v.any(dim=1).all()
    assert torch.isfinite(dets.boxes[v]).all() and torch.isfinite(dets.covs[v]).all()
