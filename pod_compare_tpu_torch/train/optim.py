"""Optimizer and learning-rate schedule.

Counterpart of ``pod_compare_tpu/train/optim.py`` (an optax chain there):
SGD with momentum 0.9 and no dampening, weight decay on every trainable
tensor (biases included, as ``optax.add_decayed_weights`` decays them),
detectron2's WarmupMultiStepLR evaluated at the step count before the
update (as ``optax.scale_by_schedule`` does), and optional gradient
clipping by value or by global norm, the latter as optax computes it.
Frozen tensors (stem and res2 at FREEZE_AT=2) are left out of the optimizer;
FrozenBN tensors are buffers.
"""

import re
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn


def warmup_multistep_schedule(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_iters: int = 1000,
) -> Callable[[int], float]:
    """detectron2's WarmupMultiStepLR: a linear warmup from
    base_lr·warmup_factor over `warmup_iters`, times gamma at each of `steps`."""

    def schedule(count: int) -> float:
        if count < warmup_iters:
            alpha = count / warmup_iters
            warmup = warmup_factor * (1.0 - alpha) + alpha
        else:
            warmup = 1.0
        decay = 1.0
        for s in steps:
            if count >= s:
                decay *= gamma
        return base_lr * warmup * decay

    return schedule


def make_schedule_fn(cfg) -> Callable[[int], float]:
    return warmup_multistep_schedule(
        base_lr=cfg.SOLVER.BASE_LR,
        steps=cfg.SOLVER.STEPS,
        gamma=cfg.SOLVER.GAMMA,
        warmup_factor=cfg.SOLVER.WARMUP_FACTOR,
        warmup_iters=cfg.SOLVER.WARMUP_ITERS,
    )


_STAGE = re.compile(r"backbone\.bottom_up\.(stem|res(\d))\.")


def is_trainable(name: str, freeze_at: int = 2) -> bool:
    """False for a parameter (detectron2 name) of a frozen stage: the stem
    when freeze_at >= 1, res{k} when freeze_at >= k."""
    m = _STAGE.match(name)
    if m is None:
        return True
    stage = 1 if m.group(1) == "stem" else int(m.group(2))
    return freeze_at < stage


def trainable_mask(names: Iterable[str], freeze_at: int = 2) -> Dict[str, bool]:
    """{name: trainable} by detectron2 name (cf. the JAX ``trainable_mask``)."""
    return {name: is_trainable(name, freeze_at) for name in names}


def trainable_parameters(model: nn.Module, freeze_at: int) -> List[Tuple[str, nn.Parameter]]:
    """The parameters the optimizer updates; raises when the model's
    requires_grad flags disagree with the mask."""
    out = []
    for name, p in model.named_parameters():
        if p.requires_grad != is_trainable(name, freeze_at):
            raise ValueError(f"{name}: requires_grad={p.requires_grad} at FREEZE_AT={freeze_at}")
        if p.requires_grad:
            out.append((name, p))
    return out


def build_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters; the learning rate is set before
    each step from `make_schedule_fn(cfg)`."""
    params = [p for _, p in trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)]
    return torch.optim.SGD(
        params, lr=cfg.SOLVER.BASE_LR, momentum=cfg.SOLVER.MOMENTUM, dampening=0.0,
        weight_decay=cfg.SOLVER.WEIGHT_DECAY, nesterov=False,
    )


def clip_gradients(params: Sequence[torch.Tensor], clip_type: str, clip_value: float) -> None:
    """In place, on the device, without a host read: 'value' clips each
    gradient to ±clip_value (optax.clip); 'norm' scales every gradient by
    clip_value/norm when the global norm reaches clip_value
    (optax.clip_by_global_norm; no epsilon is added to the norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if clip_type == "value":
        for g in grads:
            g.clamp_(-clip_value, clip_value)
    elif clip_type == "norm":
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for g in grads:
            g.copy_(torch.where(norm < clip_value, g, g / norm * clip_value))
    else:
        raise ValueError(
            f"SOLVER.CLIP_GRADIENTS.CLIP_TYPE must be 'value' or 'norm', got {clip_type!r}"
        )
