"""Checkpoints with ``torch.save`` in detectron2's directory layout.

Counterpart of ``pod_compare_tpu/train/checkpoint.py`` (orbax there):
periodic saves under ``<OUTPUT_DIR>/checkpoints/``, resume from the latest,
and ensemble members found in sibling ``random_seed_<seed>`` directories, a
layout other tools rely on. A checkpoint is one file per step holding a
dict; the trainer's holds the step, the model's state dict, the optimizer's
state, the loss normalizer and the state of the generator that seeds
dropout and the stochastic loss. Writes go to a temporary file that is
renamed into place, so a crash never leaves half a checkpoint.
"""

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt$")


class Checkpointer:
    """Save and restore dicts under `<output_dir>/checkpoints`."""

    def __init__(self, output_dir: str):
        self.directory = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def steps(self) -> List[int]:
        return sorted(
            int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m
        )

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def has_checkpoint(self) -> bool:
        return self.latest_step() is not None

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Dict[str, Any]:
        """The dict saved at `step` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)


def resume_or_load(checkpointer: Checkpointer, resume: bool) -> Optional[Dict[str, Any]]:
    """detectron2's resume_or_load: with `resume` and a checkpoint, the
    latest saved state; otherwise None (the caller warm-starts from
    MODEL.WEIGHTS)."""
    if resume and checkpointer.has_checkpoint():
        return checkpointer.restore()
    return None


def sibling_seed_dir(output_dir: str, seed: int) -> str:
    """data/<ds>/<model>/<config>/random_seed_<seed>: the sibling run of `seed`."""
    return os.path.join(os.path.dirname(output_dir), f"random_seed_{seed}")


def load_params(output_dir: str) -> Dict[str, torch.Tensor]:
    """The model state dict of the latest checkpoint under `output_dir`."""
    return Checkpointer(output_dir).restore()["model"]
