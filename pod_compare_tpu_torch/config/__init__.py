from pod_compare_tpu_torch.config.defaults import get_cfg
from pod_compare_tpu_torch.config.node import ConfigNode, load_yaml_with_base, parse_yaml
from pod_compare_tpu_torch.config.setup import (
    configs_dir,
    data_dir,
    evaluation_cli,
    inference_output_dir,
    merge_configs,
    setup_arg_parser,
    setup_config,
)

__all__ = [
    "ConfigNode",
    "configs_dir",
    "data_dir",
    "evaluation_cli",
    "get_cfg",
    "inference_output_dir",
    "load_yaml_with_base",
    "merge_configs",
    "parse_yaml",
    "setup_arg_parser",
    "setup_config",
]
