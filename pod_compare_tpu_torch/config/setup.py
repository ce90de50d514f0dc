"""Experiment setup: arg parsing, two-file config merge, output-dir layout.

Counterpart of ``pod_compare_tpu/config/setup.py``: the same CLI flags, the
same merge order (defaults <- train config (``_BASE_`` resolved) <-
inference config <- ``KEY VALUE`` overrides) and the same output directory,
data/<dataset>/<model>/<config>/random_seed_<seed>, whose seed siblings
ensemble inference reads. ``merge_configs`` is the merge alone, for callers
that need no output directory.
"""

import argparse
import os
import random
from shutil import copyfile
from typing import Optional, Sequence

import numpy as np
import torch

from pod_compare_tpu_torch.config.defaults import get_cfg
from pod_compare_tpu_torch.config.node import ConfigNode
from pod_compare_tpu_torch.parallel.mesh import process_index
from pod_compare_tpu_torch.utils.logging import setup_logger


def top_dir() -> str:
    """The repository's top directory."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__))))


def configs_dir() -> str:
    """The repository's bundled ``configs/`` directory."""
    return os.path.join(top_dir(), "configs")


def data_dir() -> str:
    """Experiment output directory: $POD_COMPARE_DATA_DIR, else data/ in the
    repository (git-ignored)."""
    return os.environ.get("POD_COMPARE_DATA_DIR", os.path.join(top_dir(), "data"))


def _resolve(path: str) -> str:
    if os.path.isabs(path) or os.path.isfile(path):
        return path
    return os.path.join(configs_dir(), path)


def merge_configs(
    config_file: str,
    inference_config: str = "",
    opts: Optional[Sequence] = None,
) -> ConfigNode:
    """Defaults, then the train config (``_BASE_`` resolved), then the
    inference config, then ``KEY VALUE`` overrides. Relative paths are
    looked up under ``configs/``. The result is not frozen."""
    cfg = get_cfg()
    cfg.merge_from_file(_resolve(config_file))
    if inference_config:
        cfg.merge_from_file(_resolve(inference_config))
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def setup_arg_parser() -> argparse.ArgumentParser:
    """Argument parser shared by the CLIs (the JAX package's flags)."""
    parser = argparse.ArgumentParser(description="pod_compare_tpu_torch")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument(
        "--num-devices", type=int, default=-1,
        help="processes, one per card (-1: every local card); parallel.launch spawns them",
    )
    parser.add_argument("--dataset-dir", type=str, default="")
    parser.add_argument("--random-seed", type=int, default=0)
    parser.add_argument("--inference-config", type=str, default="")
    parser.add_argument("--test-dataset", type=str, default="")
    parser.add_argument("--iou-min", type=float, default=0.1)
    parser.add_argument("--iou-correct", type=float, default=0.7)
    parser.add_argument("--min-allowed-score", type=float, default=0.0)
    parser.add_argument(
        "opts",
        default=None,
        nargs=argparse.REMAINDER,
        help="config overrides: KEY VALUE pairs",
    )
    return parser


def setup_config(args, random_seed=None, is_testing=False) -> ConfigNode:
    """Build the frozen experiment config, make its output directory, seed
    the host generators and register the datasets under --dataset-dir."""
    num_devices = getattr(args, "num_devices", -1)
    config_file = _resolve(args.config_file)
    cfg = merge_configs(config_file, getattr(args, "inference_config", ""),
                        getattr(args, "opts", None))

    model_name = os.path.basename(os.path.dirname(config_file))
    dataset_name = os.path.basename(os.path.dirname(os.path.dirname(config_file)))
    cfg.OUTPUT_DIR = os.path.join(
        data_dir(),
        dataset_name,
        model_name,
        os.path.splitext(os.path.basename(config_file))[0],
        "random_seed_" + str(random_seed),
    )
    if is_testing and not os.path.isdir(cfg.OUTPUT_DIR):
        raise NotADirectoryError(f"Checkpoint directory {cfg.OUTPUT_DIR} does not exist.")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    copyfile(config_file, os.path.join(cfg.OUTPUT_DIR, os.path.basename(config_file)))

    cfg.SEED = random_seed if random_seed is not None else -1
    if num_devices != -1:
        cfg.PARALLEL.NUM_DEVICES = num_devices
    cfg.freeze()

    setup_logger(output=cfg.OUTPUT_DIR, rank=process_index())

    # Host generators; the device's randomness comes from torch.Generators
    # seeded from cfg.SEED.
    if random_seed is not None:
        np.random.seed(random_seed)
        random.seed(random_seed)
        torch.manual_seed(random_seed)

    from pod_compare_tpu_torch.data.datasets import setup_all_datasets

    dataset_dir = os.path.expanduser(getattr(args, "dataset_dir", "") or "")
    if dataset_dir:
        setup_all_datasets(dataset_dir)
    return cfg


def inference_output_dir(cfg, test_dataset: str, inference_config: str) -> str:
    """Inference artifact directory."""
    name = os.path.splitext(os.path.basename(inference_config))[0]
    return os.path.join(cfg.OUTPUT_DIR, "inference", test_dataset, name)


def evaluation_cli(main_fn):
    """Standalone entry of an evaluation module (the reference's offline
    evaluation modules each carry their own): parse the flags, set up the
    config, and call ``main_fn(cfg, args, inference_dir)``."""
    args = setup_arg_parser().parse_args()
    cfg = setup_config(args, random_seed=args.random_seed, is_testing=True)
    return main_fn(cfg, args, inference_output_dir(cfg, args.test_dataset, args.inference_config))
