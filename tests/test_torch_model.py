"""The port's model against the JAX model on the same weights and inputs.

Weights are the reference-namespace random state of
`test_full_model_parity.make_reference_state` (full R50 depth, 64x64 input,
3 classes), converted to the JAX tree by the JAX converter and back by the
port's `from_jax_params`. Tolerance: float32 on both sides; the two
frameworks sum the 3x3 and 1x1 convolutions in different orders, so outputs
agree to ~1e-6 relative, and we allow 2e-4 of each output's largest
magnitude, the bound the JAX package's own torch parity test uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.config import get_cfg
from pod_compare_tpu_torch.models import InjectedMasks, build_model
from pod_compare_tpu_torch.models.convert import from_jax_params
from test_full_model_parity import make_reference_state

IMAGE_SIZE = (64, 64)
NUM_CLASSES = 3
RATE = 0.2
KEYS = ("box_cls", "box_delta", "box_cls_var", "box_reg_var")


def _configure(cfg):
    cfg.MODEL.RETINANET.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE = RATE
    cfg.MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NAME = "loss_attenuation"
    cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME = "negative_log_likelihood"
    cfg.PARALLEL.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    sd = make_reference_state(rng, num_classes=NUM_CLASSES)
    jcfg = _configure(jax_get_cfg())
    jmodel = jax_build_model(jcfg)
    params = merge_into_params(
        init_model_params(jmodel, IMAGE_SIZE, seed=0), convert_torch_state_dict(sd)
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = build_model(_configure(get_cfg()))
    tmodel.load_state_dict(from_jax_params(params))
    tmodel.eval()
    images = (rng.rand(2, *IMAGE_SIZE, 3) * 255).astype(np.uint8)
    return sd, jmodel, params, tmodel, images


def _assert_outputs_close(ours, theirs):
    for key in KEYS:
        a = ours[key].numpy()
        b = np.asarray(theirs[key])
        assert a.shape == b.shape, key
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(
            a / scale, b / scale, atol=2e-4, err_msg=f"{key}: max abs {np.abs(a - b).max()}"
        )


def test_from_jax_params_inverts_the_jax_converter(setup):
    sd, _, params, _, _ = setup
    back = from_jax_params(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_state_dict_uses_the_reference_namespace(setup):
    sd = setup[0]
    model = build_model(_configure(get_cfg()))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(model.state_dict()) == set(sd)


def test_forward_without_dropout_matches_jax(setup):
    _, jmodel, params, tmodel, images = setup
    theirs = jmodel.apply({"params": params}, jnp.asarray(images), True)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(images))
    _assert_outputs_close(ours, theirs)


def _masks(features_hw, seed):
    """masks[tower][layer][level]: (H, W, 256) float32 scale masks."""
    rng = np.random.RandomState(seed)
    return [
        [
            [
                np.where(rng.rand(h, w, 256) < 1 - RATE, 1.0 / (1 - RATE), 0.0).astype(np.float32)
                for (h, w) in features_hw
            ]
            for _layer in range(4)
        ]
        for _tower in range(2)
    ]


def test_forward_with_injected_masks_matches_jax(setup, monkeypatch):
    _, jmodel, params, tmodel, images = setup
    hw = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    masks = _masks(hw, seed=5)
    calls = []

    def fake_tower_dropout_masks(rng, shapes, rate, impl="bernoulli", dtype=None):
        # The JAX head draws one mask set per (tower, layer), towers outer.
        tower, layer = divmod(len(calls), 4)
        calls.append(shapes)
        assert [tuple(s) for s in shapes] == [(h, w, 256) for h, w in hw]
        assert rate == RATE and dtype == jnp.float32
        return [jnp.asarray(m) for m in masks[tower][layer]]

    monkeypatch.setattr(jax_dropout, "tower_dropout_masks", fake_tower_dropout_masks)
    jimages = jnp.asarray(images)
    feats = jmodel.apply({"params": params}, jimages, method="backbone")
    theirs = jmodel.apply(
        {"params": params}, feats, False, True, method="forward_head",
        rngs={"dropout": jax.random.PRNGKey(0)},
    )
    assert len(calls) == 8
    with torch.no_grad():
        injected = InjectedMasks([[[torch.from_numpy(m) for m in layer] for layer in tower]
                                  for tower in masks])
        ours = tmodel(torch.from_numpy(images), injected)
        plain = tmodel(torch.from_numpy(images))
    _assert_outputs_close(ours, theirs)
    assert not np.allclose(ours["box_cls"].numpy(), plain["box_cls"].numpy())
