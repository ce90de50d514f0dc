"""The port's training slice against the JAX package: one train step of the
flagship training config (loss attenuation with the fused focal kernel,
annealed diagonal NLL, dropout after every tower conv), its optimizer,
schedule, trainable set and checkpoints.

Geometry: full R50 depth at 64x64, 3 classes, batch 2, float32 on both
sides, as tests/test_train.py sizes the JAX trainer's tests. Weights are the
JAX package's own initialisation (`init_model_params`), carried across by
`from_jax_params`. The same per-sample dropout masks go to both sides: the
port through `InjectedMasks`, the JAX model by monkeypatching
`tower_dropout_masks` inside the test. The classification loss takes the
fused-kernel path on both sides with one fixed seed: the port's 'pallas'
impl runs its plain K2, and JAX's `stochastic_focal_loss` is monkeypatched
to call `stochastic_focal_elem_pallas` (interpret mode) with that seed, as
its own TPU branch does; off the TPU its dispatch would fall back to
threefry.

Tolerances: the losses, normalizer and positive count within 1e-5
relative; every gradient within 1e-4 of its tensor's largest magnitude
(float32 convolutions and their backward sum in another order in the two
frameworks, through 50 layers); the optimizer update within 1e-6 relative.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pod_compare_tpu.ops.losses as jax_losses
import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.models import build_anchor_generator as jax_anchor_generator
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.ops.pallas.focal import stochastic_focal_elem_pallas
from pod_compare_tpu.train.loss import LossConfig as JaxLossConfig
from pod_compare_tpu.train.loss import compute_losses as jax_compute_losses
from pod_compare_tpu.train.optim import build_optimizer as jax_build_optimizer
from pod_compare_tpu.train.optim import trainable_mask as jax_trainable_mask
from pod_compare_tpu.train.optim import warmup_multistep_schedule as jax_schedule
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.models import InjectedMasks, build_anchor_generator, level_offsets
from pod_compare_tpu_torch.models.convert import from_jax_params
from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.train import (
    RandomBatches,
    Trainer,
    create_train_state,
    load_params,
    make_train_step,
    sibling_seed_dir,
    trainable_mask,
    warmup_multistep_schedule,
)
from pod_compare_tpu_torch.train.optim import is_trainable
from pod_compare_tpu_torch.train.trainer import batch_to_device

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
IMAGE_SIZE = (64, 64)
LEVEL_HW = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
NUM_CLASSES = 3
BATCH = 2
RATE = 0.2
STEP = 5  # annealing weight (100^0.5 - 1)/99 at ANNEALING_STEP 10
FOCAL_SEED = 4321
OVERRIDES = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
    "MODEL.PROBABILISTIC_MODELING.ANNEALING_STEP", 10,
    "SOLVER.IMS_PER_BATCH", BATCH,
]


def _jax_cfg(extra=()):
    from pod_compare_tpu import configs_dir

    cfg = jax_get_cfg()
    cfg.merge_from_file(f"{configs_dir()}/{TRAIN_CFG}")
    cfg.merge_from_list(list(OVERRIDES) + list(extra))
    return cfg


def _cfg(extra=()):
    return merge_configs(TRAIN_CFG, "", list(OVERRIDES) + list(extra))


def _batch(rng):
    images = (rng.rand(BATCH, *IMAGE_SIZE, 3) * 255).astype(np.uint8)
    g = 5
    wh = rng.uniform(10, 40, (BATCH, g, 2))
    xy = rng.uniform(0, 1, (BATCH, g, 2)) * (np.array(IMAGE_SIZE[::-1]) - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.randint(0, NUM_CLASSES, (BATCH, g)).astype(np.int64)
    valid = np.ones((BATCH, g), bool)
    valid[1, 3:] = False
    boxes[1, 3:] = 0.0
    return {"images": images, "gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}


def _masks(rng):
    """masks[tower][layer][level]: per-sample (B, H, W, 256) scale masks."""
    keep = 1.0 - RATE
    return [[[np.where(rng.rand(BATCH, h, w, 256) < keep, 1.0 / keep, 0.0).astype(np.float32)
              for (h, w) in LEVEL_HW] for _layer in range(4)] for _tower in range(2)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on one machine; PyTorch's CPU
    convolutions with a thread per core in each of them thrash. Two threads
    per worker keep this file's R50 steps near their unshared time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(5)
    jmodel = jax_build_model(_jax_cfg())
    params = jax.tree_util.tree_map(np.asarray, init_model_params(jmodel, IMAGE_SIZE, seed=0))
    return jmodel, params, _batch(rng), _masks(rng)


def _jax_step(setup, monkeypatch):
    """JAX losses, new normalizer and gradients of one train step with the
    masks and the focal seed injected."""
    jmodel, params, batch, masks = setup
    calls = []

    def fake_tower_dropout_masks(rng, shapes, rate, impl="bernoulli", dtype=None):
        tower, layer = divmod(len(calls) % 8, 4)
        calls.append(1)
        assert [tuple(s) for s in shapes] == [(BATCH, h, w, 256) for h, w in LEVEL_HW]
        return [jnp.asarray(m) for m in masks[tower][layer]]

    def fake_stochastic_focal_loss(rng, logits, log_vars, targets, valid, num_samples,
                                   alpha=0.25, gamma=2.0, shared_batch=False, impl="threefry"):
        assert impl == "pallas"
        targets_b = jnp.broadcast_to(targets, logits.shape).astype(jnp.float32)
        elem = stochastic_focal_elem_pallas(logits, log_vars, targets_b, jnp.int32(FOCAL_SEED),
                                            num_samples, alpha, gamma)
        return jnp.sum(jnp.where(valid[..., None], elem, 0.0))

    monkeypatch.setattr(jax_dropout, "tower_dropout_masks", fake_tower_dropout_masks)
    monkeypatch.setattr(jax_losses, "stochastic_focal_loss", fake_stochastic_focal_loss)
    jcfg = _jax_cfg()
    lc = JaxLossConfig.from_config(jcfg)
    anchors = jnp.asarray(jax_anchor_generator(jcfg).concatenated(IMAGE_SIZE))
    gt = [jnp.asarray(batch[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")]
    gt[1] = gt[1].astype(jnp.int32)

    def loss_fn(p):
        outputs = jmodel.apply({"params": p}, jnp.asarray(batch["images"]), False,
                               mask_shared_batch=False, rngs={"dropout": jax.random.PRNGKey(0)})
        losses, new_norm = jax_compute_losses(jax.random.PRNGKey(1), outputs, anchors, *gt,
                                              jnp.asarray(100.0), jnp.asarray(STEP), lc)
        return losses["loss_cls"] + losses["loss_box_reg"], (losses, new_norm)

    (total, (losses, new_norm)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    assert len(calls) == 8
    return float(total), {k: float(v) for k, v in losses.items()}, float(new_norm), grads


def _port_state(params, cfg=None):
    cfg = cfg or _cfg()
    state = create_train_state(cfg, "cpu", seed=0)
    state.model.load_state_dict(from_jax_params(params))
    return cfg, state


def _port_step(setup, tower_dropout=None, cfg=None):
    """The port's losses and gradients of one step with injected masks."""
    _, params, batch, masks = setup
    cfg, state = _port_state(params, cfg)
    state.step = STEP
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(IMAGE_SIZE))
    step = make_train_step(cfg, anchors)
    if tower_dropout is None:
        tower_dropout = InjectedMasks([[[torch.from_numpy(m) for m in layer] for layer in tower]
                                       for tower in masks])
    total, losses, new_norm = step.losses(state, batch_to_device(batch, "cpu"), None,
                                          FOCAL_SEED, tower_dropout)
    total.backward()
    return (state, float(total.detach()), {k: float(v.detach()) for k, v in losses.items()},
            float(new_norm))


def test_train_step_matches_jax(setup, monkeypatch):
    j_total, j_losses, j_norm, j_grads = _jax_step(setup, monkeypatch)
    state, total, losses, norm = _port_step(setup)
    for key in ("loss_cls", "loss_box_reg", "num_pos_anchors"):
        np.testing.assert_allclose(losses[key], j_losses[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(total, j_total, rtol=1e-5)
    np.testing.assert_allclose(norm, j_norm, rtol=1e-5)
    assert losses["num_pos_anchors"] > 0 and 0 < losses["loss_box_reg"]

    theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    assert set(theirs) == set(params) | {k for k in buffers if ".norm." in k}
    compared = 0
    for name, g in theirs.items():
        g = g.numpy()
        p = params.get(name)
        if p is None or not p.requires_grad:
            # FrozenBN tensors and frozen stages: zero in JAX, absent here.
            assert p is None or p.grad is None, name
            np.testing.assert_array_equal(g, 0.0, err_msg=name)
            continue
        scale = np.abs(g).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy() / scale, g / scale, atol=1e-4, err_msg=name)
        compared += 1
    assert compared == sum(p.requires_grad for p in params.values())


@pytest.mark.parametrize("shared", [False, True])
def test_kernel_dropout_path_equals_injected_masks_of_its_bits(setup, shared):
    """The trainer's own path (masks drawn by the dropout kernel's plain
    version, per sample or, with DROPOUT_SHARED_BATCH_TRAIN, one per batch,
    differentiated by its seed-replay backward) gives the losses and
    gradients of the injected-mask path fed the same masks."""
    _, params, batch, _ = setup
    seeds = [[101, 102, 103, 104], [201, 202, 203, 204]]
    shapes = [(BATCH, 256, h, w) for h, w in LEVEL_HW]
    feats = [torch.ones(s).contiguous(memory_format=torch.channels_last) for s in shapes]
    offsets = level_offsets(feats, batch_shared=shared)
    masks = [[[kd.dropout_levels([f], seeds[t][layer], RATE, shared, [o])[0].permute(0, 2, 3, 1)
               for f, o in zip(feats, offsets)] for layer in range(4)] for t in range(2)]
    if shared:
        assert torch.equal(masks[0][0][0][0], masks[0][0][0][1])
    cfg, state = _port_state(params, _cfg(
        ["MODEL.PROBABILISTIC_MODELING.DROPOUT_SHARED_BATCH_TRAIN", shared]))
    state.step = STEP
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(IMAGE_SIZE))
    step = make_train_step(cfg, anchors)
    dev_batch = batch_to_device(batch, "cpu")
    total, _, _ = step.losses(state, dev_batch, seeds, FOCAL_SEED)
    total.backward()
    kernel_grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                    if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    injected, _, _ = step.losses(state, dev_batch, None, FOCAL_SEED, InjectedMasks(masks))
    injected.backward()
    np.testing.assert_allclose(float(total.detach()), float(injected.detach()), rtol=1e-6)
    for n, p in state.model.named_parameters():
        if p.grad is not None:
            scale = float(p.grad.abs().max())
            np.testing.assert_allclose(kernel_grads[n].numpy(), p.grad.numpy(),
                                       atol=1e-6 * scale, err_msg=n)


def test_trainable_set_matches_jax_trainable_mask(setup):
    _, params, _, _ = setup
    mask = jax_trainable_mask(params, freeze_at=2)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32),
                                       mask, params)
    theirs = {k: bool(v.numpy().all()) for k, v in from_jax_params(as_arrays).items()}
    ours = trainable_mask(theirs, freeze_at=2)
    cfg, state = _port_state(params)
    params_t = dict(state.model.named_parameters())
    for name, trainable in theirs.items():
        if name in params_t:
            assert ours[name] == trainable == params_t[name].requires_grad, name
        else:
            assert not trainable and ".norm." in name, name  # FrozenBN: buffers here
    assert not is_trainable("backbone.bottom_up.res2.0.conv1.weight", 2)
    assert is_trainable("backbone.bottom_up.res2.0.conv1.weight", 1)
    assert not is_trainable("backbone.bottom_up.res4.0.conv1.weight", 4)


@pytest.mark.parametrize("count", [0, 1, 499, 999, 1000, 59999, 60000, 79999, 80000, 90000])
def test_schedule_matches_jax(count):
    ours = warmup_multistep_schedule(0.0025, (60000, 80000))(count)
    theirs = float(jax_schedule(0.0025, (60000, 80000))(count))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


@pytest.mark.parametrize("clip", [None, "value", "norm"])
def test_sgd_updates_match_the_optax_chain(setup, clip):
    """Two updates (momentum carried), frozen tensors untouched, weight
    decay on biases too; with clipping by value and by global norm."""
    _, params, _, _ = setup
    extra = ["SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 2]
    if clip:
        extra += ["SOLVER.CLIP_GRADIENTS.ENABLED", True, "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", clip,
                  "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.05 if clip == "value" else 1.0]
    cfg, state = _port_state(params, _cfg(extra))
    tx, _ = jax_build_optimizer(_jax_cfg(extra))
    jparams = params
    opt_state = tx.init(jparams)
    names = dict(state.model.named_parameters())
    rng = np.random.RandomState(3)
    step = make_train_step(cfg, torch.zeros(1, 4))
    for k in range(2):
        grads = {}
        for name, v in from_jax_params(params).items():
            trainable = name in names and names[name].requires_grad
            grads[name] = (rng.randn(*v.shape) * 0.1 * trainable).astype(np.float32)
        updates, opt_state = tx.update(convert_torch_state_dict(grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in names.items():
            p.grad = torch.from_numpy(grads[name]) if p.requires_grad else None
        if step.clip is not None:
            from pod_compare_tpu_torch.train.optim import clip_gradients

            clip_gradients([p for p in names.values() if p.requires_grad], *step.clip)
        for group in state.optimizer.param_groups:
            group["lr"] = step.schedule(k)
        state.optimizer.step()
    theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    before = from_jax_params(params)
    ours = state.model.state_dict()
    for name, v in theirs.items():
        np.testing.assert_allclose(ours[name].numpy(), v.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        moved = not np.array_equal(v.numpy(), before[name].numpy())
        assert moved == (name in names and names[name].requires_grad), name


def _trainer(tmp_path, name, max_iter=4, extra=()):
    cfg = _cfg(["OUTPUT_DIR", str(tmp_path / name), "SOLVER.CHECKPOINT_PERIOD", 2,
                "SOLVER.MAX_ITER", max_iter, "SOLVER.BASE_LR", 1e-4, "SOLVER.WARMUP_ITERS", 2,
                "SEED", 3, *extra])
    loader = RandomBatches(IMAGE_SIZE, BATCH, NUM_CLASSES, max_gt_boxes=8, seed=7)
    return Trainer(cfg, loader, device="cpu")


def _assert_states_equal(a, b):
    da, db = a.state_dict(), b.state_dict()
    assert da["step"] == db["step"]
    for k, v in da["model"].items():
        assert torch.equal(v, db["model"][k]), k
    for pid, s in da["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], db["optimizer"]["state"][pid]["momentum_buffer"])
    assert torch.equal(da["loss_normalizer"], db["loss_normalizer"])
    assert torch.equal(da["generator"], db["generator"])


@pytest.fixture
def ckpt_path(tmp_path):
    """`tmp_path`, emptied when the test ends: each checkpoint of the full
    R50-FPN with its momentum is 278 MB, the two tests below write five, and
    pytest keeps the temporary directories of its last three runs: left in
    place, 4.2 GB of the temporary directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_checkpoint_round_trip_and_frozen_stages(ckpt_path):
    tmp_path = ckpt_path
    trainer = _trainer(tmp_path, "a", max_iter=2)
    start = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    trainer.train(log_period=1)
    assert trainer.checkpointer.steps() == [2]
    end = trainer.state.model.state_dict()
    assert torch.equal(start["backbone.bottom_up.stem.conv1.weight"],
                       end["backbone.bottom_up.stem.conv1.weight"])
    assert torch.equal(start["backbone.bottom_up.res2.0.conv2.weight"],
                       end["backbone.bottom_up.res2.0.conv2.weight"])
    assert not torch.equal(start["head.cls_score.weight"], end["head.cls_score.weight"])
    assert float(trainer.state.loss_normalizer) != 100.0
    resumed = _trainer(tmp_path, "a", max_iter=2)
    resumed.resume_or_load(resume=True)
    _assert_states_equal(trainer.state, resumed.state)
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
    params = load_params(str(tmp_path / "a"))
    assert all(torch.equal(v, end[k]) for k, v in params.items())
    assert sibling_seed_dir(str(tmp_path / "a"), 1000) == str(tmp_path / "random_seed_1000")
    trainer.close()
    resumed.close()


def test_resumed_run_reproduces_an_uninterrupted_run(ckpt_path):
    tmp_path = ckpt_path
    whole = _trainer(tmp_path, "whole", max_iter=3)
    whole.train(log_period=2)
    first = _trainer(tmp_path, "split", max_iter=2)
    first.train(log_period=2)
    second = _trainer(tmp_path, "split", max_iter=3)
    second.resume_or_load(resume=True)
    assert second.state.step == 2
    second.train(log_period=2)
    _assert_states_equal(whole.state, second.state)


def test_warm_start_from_a_reference_backbone_pth(tmp_path, setup):
    """A .pth in the bare detectron2 backbone namespace (stem.*, res*)
    loads into the backbone and leaves the rest at its initialisation."""
    _, params, _, _ = setup
    sd = from_jax_params(params)
    backbone = {k[len("backbone.bottom_up."):]: v for k, v in sd.items()
                if k.startswith("backbone.bottom_up.")}
    path = str(tmp_path / "r50.pth")
    torch.save({"model": backbone}, path)
    trainer = _trainer(tmp_path, "warm", extra=["MODEL.WEIGHTS", path])
    head_before = trainer.state.model.head.cls_score.weight.detach().clone()
    trainer.resume_or_load(resume=False)
    ours = trainer.state.model.state_dict()
    for k, v in backbone.items():
        assert torch.equal(ours["backbone.bottom_up." + k], v), k
    assert torch.equal(ours["head.cls_score.weight"], head_before)
    torch.save({"model": {"backbone.unknown.weight": torch.zeros(1)}}, path)
    with pytest.raises(KeyError):
        trainer.resume_or_load(resume=False)


def test_random_batches_are_a_function_of_seed_and_index():
    a = RandomBatches(IMAGE_SIZE, BATCH, NUM_CLASSES, max_gt_boxes=100, seed=1)
    b = RandomBatches(IMAGE_SIZE, BATCH, NUM_CLASSES, max_gt_boxes=100, seed=1)
    first = next(a.iter_from(3))
    again = b.batch(3)
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])
    n = first["gt_valid"].sum(axis=1)
    assert ((n >= 1) & (n <= 30)).all()
    boxes = first["gt_boxes"][first["gt_valid"]]
    assert (boxes[:, 2:] > boxes[:, :2]).all() and (boxes[:, 2] <= IMAGE_SIZE[1]).all()
    assert first["images"].dtype == np.uint8 and first["images"].shape == (BATCH, 64, 64, 3)


def test_trainer_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device exists")
    cfg = _cfg(["OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, RandomBatches(IMAGE_SIZE, BATCH, NUM_CLASSES))
    assert not os.listdir(tmp_path)


def test_image_without_ground_truth_keeps_gradients_finite():
    """An image of the batch without ground truth: every gradient of the
    port stays finite and equals the JAX package's wherever that is finite;
    the JAX package's box-covariance gradient is NaN there (ROADMAP §3)."""
    rng = np.random.RandomState(0)
    b, r, k = 2, 50, NUM_CLASSES
    a = rng.rand(r, 2).astype(np.float32) * 60
    anchors = np.concatenate([a, a + 16], 1)
    outputs = {key: rng.randn(b, r, d).astype(np.float32) for key, d in
               (("box_cls", k), ("box_delta", 4), ("box_cls_var", k), ("box_reg_var", 4))}
    gt_boxes = np.zeros((b, 3, 4), np.float32)
    gt_boxes[0, 0] = [10, 10, 30, 30]
    gt_valid = np.zeros((b, 3), bool)
    gt_valid[0, 0] = True
    gt_classes = np.zeros((b, 3), np.int64)
    jcfg, cfg = _jax_cfg(), _cfg()

    def jax_total(o):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_losses, "stochastic_focal_loss",
                       lambda rng_, x, s, t, v, n, al=0.25, ga=2.0, shared_batch=False,
                       impl="threefry": jnp.sum(jnp.where(
                           v[..., None], stochastic_focal_elem_pallas(
                               x, s, jnp.broadcast_to(t, x.shape), jnp.int32(FOCAL_SEED), n,
                               al, ga), 0.0)))
            losses, _ = jax_compute_losses(
                jax.random.PRNGKey(0), o, jnp.asarray(anchors), jnp.asarray(gt_boxes),
                jnp.asarray(gt_classes, jnp.int32), jnp.asarray(gt_valid), jnp.asarray(100.0),
                jnp.asarray(STEP), JaxLossConfig.from_config(jcfg))
        return losses["loss_cls"] + losses["loss_box_reg"]

    theirs = jax.grad(jax_total)({key: jnp.asarray(v) for key, v in outputs.items()})
    ours = {key: torch.from_numpy(v).requires_grad_(True) for key, v in outputs.items()}
    from pod_compare_tpu_torch.train import LossConfig, compute_losses

    losses, _ = compute_losses(ours, torch.from_numpy(anchors), torch.from_numpy(gt_boxes),
                               torch.from_numpy(gt_classes), torch.from_numpy(gt_valid),
                               torch.tensor(100.0), STEP, LossConfig.from_config(cfg), FOCAL_SEED)
    (losses["loss_cls"] + losses["loss_box_reg"]).backward()
    assert not np.isfinite(np.asarray(theirs["box_reg_var"])).all()
    for key, t in ours.items():
        g, jg = t.grad.numpy(), np.asarray(theirs[key])
        assert np.isfinite(g).all(), key
        finite = np.isfinite(jg)
        scale = np.abs(jg[finite]).max()
        np.testing.assert_allclose(g[finite] / scale, jg[finite] / scale, atol=1e-5, err_msg=key)
