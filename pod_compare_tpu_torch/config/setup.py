"""Two-file config merge: defaults <- train config <- inference config.

Counterpart of the merge in ``pod_compare_tpu/config/setup.py``
(``setup_config``), without its output-directory layout, logger and
dataset registry, which come with the port's CLI.
"""

import os
from typing import Optional, Sequence

from pod_compare_tpu_torch.config.defaults import get_cfg
from pod_compare_tpu_torch.config.node import ConfigNode


def configs_dir() -> str:
    """The repository's bundled ``configs/`` directory."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__)))),
        "configs",
    )


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
