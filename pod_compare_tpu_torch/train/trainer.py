"""Training engine: the train step and the host loop.

Counterpart of ``pod_compare_tpu/train/trainer.py`` (detectron2's
DefaultTrainer/SimpleTrainer as the reference exercises it). One step runs
the forward (per-sample dropout through the dropout kernel, the stochastic
focal loss through the focal kernel when CLS_VAR_LOSS.IMPL is 'pallas'),
the backward (the dropout kernel's seed-replay backward) and the SGD update.
While a profiler records, a step is the span ``pod.step`` around
``pod.forward`` (with the model's ``pod.backbone``), ``pod.loss`` (with
``pod.matcher``), ``pod.backward`` and ``pod.optimizer``
(``utils/profiling.span``); under PARALLEL.REMAT the backward's
recomputation opens ``pod.backbone`` again, inside ``pod.backward``.

The state (step, model, optimizer, EMA loss normalizer, generator) is a
``TrainState``. The generator is a host-side ``torch.Generator``: the seeds
of a step's dropout masks and stochastic loss are drawn from it on the
host, so a step reads nothing back from the device; the losses stay on the
device until they are logged every ``log_period`` steps.

The trainer reads DATASETS.TRAIN[0] through ``data.TrainLoader``, or takes
its batches from the caller: any object with a ``canvas`` (H, W) and
``iter_from(start)`` yielding dicts of the four ``TRAIN_BATCH_KEYS`` arrays
(uint8 (B, H, W, 3) images, (B, G, 4) boxes, (B, G) classes, (B, G)
validity), as ``TrainLoader`` yields them; ``train.random_batches.
RandomBatches`` is one. Every TEST.EVAL_PERIOD steps ``test`` scores the
current weights with standard NMS and COCO mAP.

In a process group (one process per card, ``parallel``), every process
holds the same state and takes its rows of each global batch of
SOLVER.IMS_PER_BATCH (``TrainLoader(process_index, process_count)``); the
model is wrapped in ``DistributedDataParallel``, the losses' positive count
is summed over the processes, and the dropout masks and stochastic draws
are the global batch's at the process's rows, so that a step equals the
one-process step over the global batch. Rank 0 alone writes checkpoints and
metrics; every process resumes from the same checkpoint, and ``test``
evaluates a shard of the test set per process and gathers.
"""

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from pod_compare_tpu_torch.cli import apply_net  # a module: apply_net imports train too
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.data.loader import TestLoader, TrainLoader
from pod_compare_tpu_torch.inference.predictor import build_predictor
from pod_compare_tpu_torch.models import (
    ProbabilisticRetinaNet,
    TowerDropout,
    build_anchor_generator,
    build_model,
)
from pod_compare_tpu_torch.models.convert import (
    from_reference_state_dict,
    load_reference_checkpoint,
)
from pod_compare_tpu_torch.parallel import (
    BatchShard,
    all_reduce_sum,
    check_process_count,
    is_main_process,
    local_device,
    process_count,
    process_index,
)
from pod_compare_tpu_torch.train.checkpoint import Checkpointer, load_params, resume_or_load
from pod_compare_tpu_torch.train.loss import LossConfig, compute_losses
from pod_compare_tpu_torch.train.optim import build_optimizer, clip_gradients, make_schedule_fn
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.events import EventStorage
from pod_compare_tpu_torch.utils.logging import setup_logger
from pod_compare_tpu_torch.utils.profiling import span, trace

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
        """Restore a trainer's checkpoint. One that holds the model alone
        (``cli/convert_torch_checkpoint.py`` writes such a step 0) sets the
        weights and leaves the rest of the state as it is."""
        self.model.load_state_dict(saved["model"])
        if set(saved) == {"model"}:
            return
        self.step = int(saved["step"])
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


class _TrainForward(nn.Module):
    """The model's training forward as a module's ``forward``, for
    ``DistributedDataParallel`` to wrap (it hooks ``forward`` only); with
    `remat` under ``torch.utils.checkpoint``, inside the wrapper, where
    ``DistributedDataParallel`` allows it."""

    def __init__(self, model: ProbabilisticRetinaNet, remat: bool):
        super().__init__()
        self.model = model
        self.remat = remat

    def forward(self, images, seeds, batch_shared, shard, tower_dropout=None):
        if tower_dropout is not None:
            fn, args = self.model, (images, tower_dropout)
        else:
            fn, args = self.model.forward_train, (images, seeds, batch_shared, shard)
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


class TrainStep:
    """Forward, losses, backward and the SGD update of one step.

    With PARALLEL.REMAT the model's forward runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the JAX step wraps its
    forward in ``jax.checkpoint``: its activations are recomputed in the
    backward instead of kept. The recomputation replays the dropout masks
    from the seeds drawn before the forward, and nothing inside it draws
    from a generator (``checkpoint`` restores only the default generators'
    states), so the gradients are the same.

    After ``data_parallel(model)`` in a process group of W processes, a
    batch is this process's rows of a global batch W times as large
    (``parallel.BatchShard``): the forward runs through
    ``DistributedDataParallel``, whose gradient all-reduce averages, so the
    backward takes W times this process's share of the global loss, and the
    gradients are the one-process step's. The metrics a step returns are
    this process's shares; ``global_metrics`` sums them over the processes."""

    def __init__(self, cfg, anchors: torch.Tensor):
        self.anchors = anchors
        self.remat = bool(cfg.PARALLEL.REMAT)
        self.lc = LossConfig.from_config(cfg)
        self.schedule = make_schedule_fn(cfg)
        self.num_convs = cfg.MODEL.RETINANET.NUM_CONVS
        self.shared_masks = bool(cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_SHARED_BATCH_TRAIN)
        clip = cfg.SOLVER.CLIP_GRADIENTS
        self.clip = (clip.CLIP_TYPE, clip.CLIP_VALUE) if clip.ENABLED else None
        self.ddp: Optional[DistributedDataParallel] = None

    def data_parallel(self, model: ProbabilisticRetinaNet) -> None:
        """Wrap `model` in ``DistributedDataParallel`` when the process group
        has more than one process. FrozenBN keeps no statistics, so no
        buffer is broadcast; the frozen stages have no gradient, so they
        are not reduced, and every trainable parameter takes part in every
        step (no search for unused ones)."""
        if process_count() == 1:
            return
        self.ddp = DistributedDataParallel(_TrainForward(model, self.remat),
                                           broadcast_buffers=False)

    def _shard(self, batch) -> Optional[BatchShard]:
        """This process's rows of the global batch; None on one process."""
        if self.ddp is None:
            return None
        return BatchShard.of(batch["images"].shape[0] * process_count())

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
        shard = self._shard(batch)
        forward = self.ddp if self.ddp is not None else _TrainForward(state.model, self.remat)
        with span("pod.forward"):
            outputs = forward(batch["images"], seeds, self.shared_masks, shard, tower_dropout)
        with span("pod.loss"):
            losses, new_norm = compute_losses(
                outputs, self.anchors, batch["gt_boxes"], batch["gt_classes"],
                batch["gt_valid"], state.loss_normalizer, state.step, self.lc, loss_seed, shard,
            )
        return losses["loss_cls"] + losses["loss_box_reg"], losses, new_norm

    def __call__(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One step; returns its metrics, still on the device."""
        with span("pod.step"):
            return self._step(state, batch)

    def _step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        seeds, loss_seed = self.draw_seeds(state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        total, losses, new_norm = self.losses(state, batch, seeds, loss_seed)
        with span("pod.backward"):
            # DistributedDataParallel averages the gradients over the processes.
            (total * process_count() if self.ddp is not None else total).backward()
        with span("pod.optimizer"):
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

    def global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's metrics for the global batch: the losses (this process's
        shares) summed over the processes; the positive count and the
        learning rate are global already. Collective after
        ``data_parallel``."""
        if self.ddp is None:
            return metrics
        keys = ("loss_cls", "loss_box_reg", "total_loss")
        summed = all_reduce_sum(torch.stack([metrics[k] for k in keys]))
        return dict(metrics, **dict(zip(keys, summed.unbind())))


def make_train_step(cfg, anchors: torch.Tensor) -> TrainStep:
    return TrainStep(cfg, anchors)


def resolve_weights_path(weights: str) -> str:
    """MODEL.WEIGHTS as a local path. The reference's ``detectron2://``
    model-zoo scheme (Base-BDD-RetinaNet.yaml:6) resolves against a local
    copy of the zoo under $DETECTRON2_CACHE, in fvcore's layout; nothing is
    downloaded, and a miss raises with the recipe."""
    scheme = "detectron2://"
    if not weights.startswith(scheme):
        return weights
    relative = weights[len(scheme):]
    cache = os.environ.get("DETECTRON2_CACHE")
    local = os.path.join(cache, relative) if cache else None
    if local is None or not os.path.isfile(local):
        where = f"{local} not found" if local else "DETECTRON2_CACHE is not set"
        raise FileNotFoundError(
            f"MODEL.WEIGHTS={weights}: detectron2:// URLs resolve against a local copy of "
            f"detectron2's model zoo under $DETECTRON2_CACHE ({where}); nothing is downloaded. "
            f"Copy {relative} there from a machine that has it (a detectron2 install keeps it "
            "in its iopath cache), or point MODEL.WEIGHTS at a local .pkl or .pth."
        )
    return local


class Trainer:
    """Host-side training loop.

    Args:
        cfg: the training config.
        loader: the batch source (see the module's docstring); None builds a
            ``TrainLoader`` over `dataset` (default DATASETS.TRAIN[0]) with
            the config's input sizes, seed, workers and flips, on `canvas`
            (default: the one the dataset's sizes need).
        device: torch device; None means CUDA (this process's card in a
            process group), and raises without it.

    On CUDA the constructor turns TF32 off for convolutions and products,
    process-wide, so that float32 runs in full float32 as on the CPU.
    ``close()`` releases the loaders the trainer built. In a process group
    a `loader` given by the caller must yield this process's rows of each
    global batch, as ``TrainLoader(process_index, process_count)`` does.
    """

    def __init__(self, cfg, loader=None, device=None, dataset=None, canvas=None):
        self.cfg = cfg
        check_process_count(cfg.PARALLEL.NUM_DEVICES)
        self.device = resolve_device(local_device(device))
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.logger = setup_logger(name="pod_compare_tpu_torch.trainer", rank=process_index())
        self._own_loader = loader is None
        if loader is None:
            loader = TrainLoader(
                dataset or get_dataset(cfg.DATASETS.TRAIN[0]),
                batch_size=cfg.SOLVER.IMS_PER_BATCH,
                min_size=tuple(cfg.INPUT.MIN_SIZE_TRAIN),
                max_size=cfg.INPUT.MAX_SIZE_TRAIN,
                divisibility=cfg.INPUT.SIZE_DIVISIBILITY,
                max_gt_boxes=cfg.INPUT.MAX_GT_BOXES,
                seed=max(cfg.SEED, 0),
                canvas=canvas,
                num_workers=cfg.DATALOADER.NUM_WORKERS,
                flip=cfg.INPUT.RANDOM_FLIP == "horizontal",
                worker_backend=cfg.DATALOADER.WORKER_BACKEND,
                process_index=process_index(),
                process_count=process_count(),
            )
        self.loader = loader
        self.canvas = tuple(int(s) for s in loader.canvas)
        self.anchors = torch.as_tensor(
            build_anchor_generator(cfg).concatenated(self.canvas), device=self.device
        )
        self.state = create_train_state(cfg, self.device, seed=max(cfg.SEED, 0))
        self.train_step = make_train_step(cfg, self.anchors)
        self.train_step.data_parallel(self.state.model)
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self.storage = EventStorage(cfg.OUTPUT_DIR if is_main_process() else None)
        # (dataset, batch) -> (loader, predictor), reused by every test()
        # call: periodic evaluation builds neither again, and evaluating
        # two splits in turn keeps both.
        self._eval_cache = {}
        self.logger.info(
            f"canvas={self.canvas} anchors={self.anchors.shape[0]} device={self.device} "
            f"processes={process_count()}"
        )

    def resume_or_load(self, resume: bool = False) -> None:
        """Resume from the latest checkpoint when `resume`, else warm-start
        from MODEL.WEIGHTS: a reference checkpoint in the detectron2
        namespace, a ``.pkl`` or a ``.pth`` (a whole model or a backbone;
        what it lacks stays at its initialisation), possibly named by a
        ``detectron2://`` URL (``resolve_weights_path``), or an output
        directory of this trainer."""
        saved = resume_or_load(self.checkpointer, resume)
        if saved is not None:
            self.state.load_state_dict(saved)
            self.logger.info(f"Resumed from step {self.state.step}")
            return
        weights = self.cfg.MODEL.WEIGHTS
        if not weights:
            return
        weights = resolve_weights_path(weights)
        if weights.endswith((".pth", ".pkl")):
            state = from_reference_state_dict(load_reference_checkpoint(weights))
        elif os.path.isdir(weights):
            state = load_params(weights)
        else:
            raise ValueError(
                f"MODEL.WEIGHTS={weights}: the trainer takes a .pkl or .pth reference "
                "checkpoint or an output directory"
            )
        missing, unexpected = self.state.model.load_state_dict(state, strict=False)
        if unexpected:
            raise KeyError(f"MODEL.WEIGHTS={weights}: tensors the model lacks: {unexpected}")
        self.logger.info(
            f"Warm-started from MODEL.WEIGHTS={weights} ({len(missing)} tensors left at init)"
        )

    def train(self, max_iter: Optional[int] = None, log_period: int = 20,
              profile_iters: Optional[Tuple[int, int]] = None) -> None:
        """Run the loop from the state's step to `max_iter` (default
        SOLVER.MAX_ITER), logging every `log_period` steps, saving a
        checkpoint every SOLVER.CHECKPOINT_PERIOD steps and at the end, and
        evaluating every TEST.EVAL_PERIOD steps (0: never).
        `profile_iters=(start, stop)` traces the steps in [start, stop) with
        ``torch.profiler`` into OUTPUT_DIR/profile."""
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER if max_iter is None else max_iter
        start = self.state.step
        # A resumed run consumes the batches an uninterrupted run would.
        data = self.loader.iter_from(start)
        self.logger.info(f"Starting training from iteration {start}")
        profiling = None
        t0 = time.perf_counter()
        try:
            for it in range(start, max_iter):
                if profile_iters is not None:
                    if it == profile_iters[0]:
                        profiling = trace(cfg.OUTPUT_DIR)
                        profiling.__enter__()
                    elif it == profile_iters[1] and profiling is not None:
                        profiling.__exit__(None, None, None)
                        profiling = None
                with span("pod.data"):
                    batch = batch_to_device(next(data), self.device)
                metrics = self.train_step(self.state, batch)
                self.storage.iter = it
                last = it == max_iter - 1
                if (it + 1) % log_period == 0 or last:
                    metrics = self.train_step.global_metrics(metrics)
                    host = {k: float(v) for k, v in metrics.items()}
                    host["iter_time"] = (time.perf_counter() - t0) / log_period
                    t0 = time.perf_counter()
                    self.storage.put_scalars(**host)
                    self.storage.write()
                    self.logger.info(
                        f"iter {it + 1}/{max_iter} "
                        + " ".join(f"{k}={v:.4g}" for k, v in sorted(host.items()))
                    )
                if ((it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or last) and is_main_process():
                    self.checkpointer.save(it + 1, self.state.state_dict())
                if cfg.TEST.EVAL_PERIOD > 0 and (it + 1) % cfg.TEST.EVAL_PERIOD == 0:
                    self.test()
        finally:
            if profiling is not None:
                profiling.__exit__(None, None, None)
        self.logger.info("Training done.")

    def test(self, test_dataset: Optional[str] = None, batch_size: Optional[int] = None):
        """Score the current weights on `test_dataset` (default
        DATASETS.TEST[0]) with standard NMS and COCO mAP, through
        ``run_inference``; `batch_size` defaults to SOLVER.IMS_PER_BATCH.

        The first call for a (dataset, batch) builds a test loader and a
        predictor, which later calls reuse: each call copies the training
        model's weights into the predictor's own model, which runs without
        dropout in eval mode; the training model, its mode and the
        generator that seeds its dropout are left as they were. Writes
        eval/mAP, eval/AP50 and eval/num_detections to the event storage.
        In a process group each process evaluates its shard of the test set;
        rank 0 scores the gathered json and writes, the others return
        ``run_inference``'s summary without metrics."""
        cfg = self.cfg.clone()
        cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE = "standard_nms"
        cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE = False
        cfg.freeze()
        test_dataset = test_dataset or cfg.DATASETS.TEST[0]
        batch_size = cfg.SOLVER.IMS_PER_BATCH if batch_size is None else batch_size
        key = (test_dataset, batch_size)
        if key not in self._eval_cache:
            loader = TestLoader(
                get_dataset(test_dataset),
                batch_size=batch_size,
                min_size=cfg.INPUT.MIN_SIZE_TEST,
                max_size=cfg.INPUT.MAX_SIZE_TEST,
                divisibility=cfg.INPUT.SIZE_DIVISIBILITY,
                num_workers=cfg.DATALOADER.NUM_WORKERS,
                worker_backend=cfg.DATALOADER.WORKER_BACKEND,
                process_index=process_index(),
                process_count=process_count(),
            )
            predictor = build_predictor(cfg, loader.canvas, self.state.model.state_dict(),
                                        device=self.device)
            self._eval_cache[key] = (loader, predictor)
        else:
            loader, predictor = self._eval_cache[key]
            predictor.model.load_state_dict(self.state.model.state_dict())
        summary = apply_net.run_inference(
            cfg, test_dataset, f"eval_iter_{self.state.step}", batch_size=batch_size,
            run_metrics=False, run_map=True, verbose=False, loader=loader,
            predictor=predictor, device=self.device,
        )
        if not summary.get("is_main_process", True):
            return summary
        self.storage.put_scalars(**{
            "eval/mAP": summary["mAP"],
            "eval/AP50": summary["AP50"],
            "eval/num_detections": summary["num_detections"],
        })
        self.storage.write()
        self.logger.info(f"eval @ iter {self.state.step}: mAP={summary['mAP']:.4f} "
                         f"AP50={summary['AP50']:.4f}")
        return summary

    def close(self) -> None:
        """Release the train loader the trainer built and every cached eval
        loader; the trainer is not used afterwards."""
        if self._own_loader:
            self.loader.close()
        for loader, _ in self._eval_cache.values():
            loader.close()
        self._eval_cache.clear()
        self.storage.close()
