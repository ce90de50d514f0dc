"""The training slice: losses, optimizer, checkpoints and the trainer."""

from pod_compare_tpu_torch.train.checkpoint import (
    Checkpointer,
    load_params,
    resume_or_load,
    sibling_seed_dir,
)
from pod_compare_tpu_torch.train.loss import LossConfig, compute_losses
from pod_compare_tpu_torch.train.optim import (
    build_optimizer,
    trainable_mask,
    warmup_multistep_schedule,
)
from pod_compare_tpu_torch.train.random_batches import RandomBatches
from pod_compare_tpu_torch.train.trainer import (
    TRAIN_BATCH_KEYS,
    Trainer,
    TrainState,
    TrainStep,
    create_train_state,
    make_train_step,
    resolve_weights_path,
)

__all__ = [
    "Checkpointer",
    "LossConfig",
    "RandomBatches",
    "TRAIN_BATCH_KEYS",
    "TrainState",
    "TrainStep",
    "Trainer",
    "build_optimizer",
    "compute_losses",
    "create_train_state",
    "load_params",
    "make_train_step",
    "resolve_weights_path",
    "resume_or_load",
    "sibling_seed_dir",
    "trainable_mask",
    "warmup_multistep_schedule",
]
