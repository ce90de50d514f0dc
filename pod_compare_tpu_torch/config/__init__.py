from pod_compare_tpu_torch.config.defaults import get_cfg
from pod_compare_tpu_torch.config.node import ConfigNode, load_yaml_with_base, parse_yaml
from pod_compare_tpu_torch.config.setup import configs_dir, merge_configs

__all__ = [
    "ConfigNode",
    "configs_dir",
    "get_cfg",
    "load_yaml_with_base",
    "merge_configs",
    "parse_yaml",
]
