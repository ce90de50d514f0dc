from pod_compare_tpu_torch.models.fpn import FPN, FPN_STRIDES
from pod_compare_tpu_torch.models.resnet import ResNet
from pod_compare_tpu_torch.models.retinanet import (
    InjectedMasks,
    KernelDropout,
    ProbabilisticRetinaNet,
    ProbabilisticRetinaNetHead,
    TowerDropout,
    build_anchor_generator,
    build_model,
    level_offsets,
)

__all__ = [
    "FPN",
    "FPN_STRIDES",
    "InjectedMasks",
    "KernelDropout",
    "ProbabilisticRetinaNet",
    "ProbabilisticRetinaNetHead",
    "ResNet",
    "TowerDropout",
    "build_anchor_generator",
    "build_model",
    "level_offsets",
]
