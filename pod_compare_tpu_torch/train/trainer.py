"""Training engine: the train step and the host loop.

Counterpart of ``pod_compare_tpu/train/trainer.py`` (detectron2's
DefaultTrainer/SimpleTrainer as the reference exercises it). One step runs
the forward (per-sample dropout through the dropout kernel, the stochastic
focal loss through the focal kernel when CLS_VAR_LOSS.IMPL is 'pallas'),
the backward (the dropout kernel's seed-replay backward) and the SGD update.

The state (step, model, optimizer, EMA loss normalizer, generator) is a
``TrainState``. The generator is a host-side ``torch.Generator``: the seeds
of a step's dropout masks and stochastic loss are drawn from it on the
host, so a step reads nothing back from the device; the losses stay on the
device until they are logged every ``log_period`` steps.

The trainer takes its batches from the caller: any object with a
``canvas`` (H, W) and ``iter_from(start)`` yielding dicts of the four
``TRAIN_BATCH_KEYS`` arrays (uint8 (B, H, W, 3) images, (B, G, 4) boxes,
(B, G) classes, (B, G) validity), as the JAX package's ``TrainLoader``
yields them; ``train.random_batches.RandomBatches`` is one.
"""

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pod_compare_tpu_torch.models import (
    ProbabilisticRetinaNet,
    TowerDropout,
    build_anchor_generator,
    build_model,
)
from pod_compare_tpu_torch.models.convert import from_reference_state_dict
from pod_compare_tpu_torch.train.checkpoint import Checkpointer, load_params, resume_or_load
from pod_compare_tpu_torch.train.loss import LossConfig, compute_losses
from pod_compare_tpu_torch.train.optim import build_optimizer, clip_gradients, make_schedule_fn
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.events import EventStorage
from pod_compare_tpu_torch.utils.logging import setup_logger

TRAIN_BATCH_KEYS = ("images", "gt_boxes", "gt_classes", "gt_valid")
_SEED_HIGH = 2 ** 63 - 1


@dataclass
class TrainState:
    step: int
    model: ProbabilisticRetinaNet
    optimizer: torch.optim.SGD
    loss_normalizer: torch.Tensor  # EMA of the positive-anchor count (init 100), on the device
    generator: torch.Generator  # host-side: seeds dropout masks and the stochastic loss

    def state_dict(self) -> Dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "loss_normalizer": self.loss_normalizer.detach().cpu(),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, saved: Dict) -> None:
        self.step = int(saved["step"])
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.loss_normalizer = saved["loss_normalizer"].to(self.loss_normalizer.device)
        self.generator.set_state(saved["generator"])


def create_train_state(cfg, device, seed: int = 0) -> TrainState:
    """A fresh model drawn from `seed` on the CPU (so that the weights do not
    depend on the device), moved to `device`, with its optimizer, a
    normalizer of 100 and a generator seeded from the same draw."""
    init = torch.Generator().manual_seed(seed)
    model = build_model(cfg).init_weights(init).to(device)
    model.train()
    generator = torch.Generator().manual_seed(
        int(torch.randint(0, _SEED_HIGH, (1,), generator=init))
    )
    return TrainState(
        step=0,
        model=model,
        optimizer=build_optimizer(cfg, model),
        loss_normalizer=torch.tensor(100.0, device=device),
        generator=generator,
    )


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The four train arrays as tensors on `device` (classes as int64)."""
    out = {k: torch.as_tensor(np.asarray(batch[k])) for k in TRAIN_BATCH_KEYS}
    out["gt_classes"] = out["gt_classes"].long()
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


class TrainStep:
    """Forward, losses, backward and the SGD update of one step."""

    def __init__(self, cfg, anchors: torch.Tensor):
        self.anchors = anchors
        self.lc = LossConfig.from_config(cfg)
        self.schedule = make_schedule_fn(cfg)
        self.num_convs = cfg.MODEL.RETINANET.NUM_CONVS
        self.shared_masks = bool(cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_SHARED_BATCH_TRAIN)
        clip = cfg.SOLVER.CLIP_GRADIENTS
        self.clip = (clip.CLIP_TYPE, clip.CLIP_VALUE) if clip.ENABLED else None

    def draw_seeds(self, generator: torch.Generator) -> Tuple[List[List[int]], int]:
        """seeds[tower][layer] of the dropout masks and the int32 seed of the
        stochastic loss, drawn on the host."""
        flat = torch.randint(0, _SEED_HIGH, (2 * self.num_convs,), generator=generator).tolist()
        loss_seed = int(torch.randint(-(2 ** 31), 2 ** 31 - 1, (1,), generator=generator))
        return [flat[: self.num_convs], flat[self.num_convs:]], loss_seed

    def losses(self, state: TrainState, batch, seeds, loss_seed: int,
               tower_dropout: Optional[TowerDropout] = None):
        """(total, {loss_cls, loss_box_reg, num_pos_anchors}, new normalizer)
        of one forward; `tower_dropout` replaces the kernel's masks."""
        model = state.model
        if tower_dropout is None:
            outputs = model.forward_train(batch["images"], seeds, self.shared_masks)
        else:
            outputs = model(batch["images"], tower_dropout)
        losses, new_norm = compute_losses(
            outputs, self.anchors, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
            state.loss_normalizer, state.step, self.lc, loss_seed,
        )
        return losses["loss_cls"] + losses["loss_box_reg"], losses, new_norm

    def __call__(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One step; returns its metrics, still on the device."""
        seeds, loss_seed = self.draw_seeds(state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        total, losses, new_norm = self.losses(state, batch, seeds, loss_seed)
        total.backward()
        if self.clip is not None:
            params = [p for group in state.optimizer.param_groups for p in group["params"]]
            clip_gradients(params, *self.clip)
        lr = self.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.loss_normalizer = new_norm.detach()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["lr"] = torch.tensor(lr)
        return metrics


def make_train_step(cfg, anchors: torch.Tensor) -> TrainStep:
    return TrainStep(cfg, anchors)


class Trainer:
    """Host-side training loop.

    Args:
        cfg: the training config.
        loader: the batch source (see the module's docstring).
        device: torch device; None means CUDA, and raises without it.

    On CUDA the constructor turns TF32 off for convolutions and products,
    process-wide, so that float32 runs in full float32 as on the CPU.
    """

    def __init__(self, cfg, loader, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.logger = setup_logger(name="pod_compare_tpu_torch.trainer")
        self.loader = loader
        self.canvas = tuple(int(s) for s in loader.canvas)
        self.anchors = torch.as_tensor(
            build_anchor_generator(cfg).concatenated(self.canvas), device=self.device
        )
        self.state = create_train_state(cfg, self.device, seed=max(cfg.SEED, 0))
        self.train_step = make_train_step(cfg, self.anchors)
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self.storage = EventStorage(cfg.OUTPUT_DIR)
        self.logger.info(
            f"canvas={self.canvas} anchors={self.anchors.shape[0]} device={self.device}"
        )

    def resume_or_load(self, resume: bool = False) -> None:
        """Resume from the latest checkpoint when `resume`, else warm-start
        from MODEL.WEIGHTS: a reference ``.pth`` state dict in the detectron2
        namespace (a whole model or a backbone; what it lacks stays at its
        initialisation) or an output directory of this trainer."""
        saved = resume_or_load(self.checkpointer, resume)
        if saved is not None:
            self.state.load_state_dict(saved)
            self.logger.info(f"Resumed from step {self.state.step}")
            return
        weights = self.cfg.MODEL.WEIGHTS
        if not weights:
            return
        if weights.endswith(".pth"):
            data = torch.load(weights, map_location="cpu", weights_only=True)
            state = from_reference_state_dict(data.get("model", data))
        elif os.path.isdir(weights):
            state = load_params(weights)
        else:
            raise ValueError(
                f"MODEL.WEIGHTS={weights}: the trainer takes a .pth state dict or an output "
                "directory; .pkl model-zoo files need the training CLI's converter"
            )
        missing, unexpected = self.state.model.load_state_dict(state, strict=False)
        if unexpected:
            raise KeyError(f"MODEL.WEIGHTS={weights}: tensors the model lacks: {unexpected}")
        self.logger.info(
            f"Warm-started from MODEL.WEIGHTS={weights} ({len(missing)} tensors left at init)"
        )

    def train(self, max_iter: Optional[int] = None, log_period: int = 20) -> None:
        """Run the loop from the state's step to `max_iter` (default
        SOLVER.MAX_ITER), logging every `log_period` steps and saving a
        checkpoint every SOLVER.CHECKPOINT_PERIOD steps and at the end."""
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER if max_iter is None else max_iter
        start = self.state.step
        # A resumed run consumes the batches an uninterrupted run would.
        data = self.loader.iter_from(start)
        self.logger.info(f"Starting training from iteration {start}")
        t0 = time.perf_counter()
        for it in range(start, max_iter):
            metrics = self.train_step(self.state, batch_to_device(next(data), self.device))
            self.storage.iter = it
            last = it == max_iter - 1
            if (it + 1) % log_period == 0 or last:
                host = {k: float(v) for k, v in metrics.items()}
                host["iter_time"] = (time.perf_counter() - t0) / log_period
                t0 = time.perf_counter()
                self.storage.put_scalars(**host)
                self.storage.write()
                self.logger.info(
                    f"iter {it + 1}/{max_iter} "
                    + " ".join(f"{k}={v:.4g}" for k, v in sorted(host.items()))
                )
            if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or last:
                self.checkpointer.save(it + 1, self.state.state_dict())
        self.logger.info("Training done.")

    def close(self) -> None:
        self.storage.close()
