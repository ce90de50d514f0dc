"""ResNet and ResNeXt backbones (bottlenecks, FrozenBN) for RetinaNet-FPN.

Counterpart of ``pod_compare_tpu/models/resnet.py``; parameter names follow
detectron2's ``build_resnet_backbone`` (``stem.conv1``, ``res{2..5}.{i}``).
``freeze_at`` freezes the stem (>= 1) and res2..res{freeze_at} through
``requires_grad=False``, where the JAX package stops gradients at the stage
boundary; FrozenBN tensors are buffers and never train.

ResNeXt (Xie et al., arXiv 1611.05431) as detectron2 builds it from
MODEL.RESNETS.NUM_GROUPS and WIDTH_PER_GROUP: a bottleneck's width is
``num_groups * width_per_group`` at res2 and doubles each stage, and its
3x3 is grouped; the defaults (1, 64) are ResNet's. ``stride_in_1x1`` puts a
stage's stride in the first 1x1 (caffe/MSRA weights) or in the 3x3
(torchvision-style and FAIR's ResNeXt weights). The JAX package builds
ResNet only. ``GROUPED_CONV_CALLS`` counts the forward calls of grouped 3x3s
on the host.
"""

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pod_compare_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d

# depth -> blocks per stage (res2..res5)
RESNET_STAGES = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

STAGE_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}

GROUPED_CONV_CALLS = 0


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> Conv2d:
    return Conv2d(
        cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False, groups=groups,
        norm=FrozenBatchNorm2d(cout),
    )


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (in `num_groups` groups) -> 1x1, FrozenBN + ReLU, the
    stride in the first 1x1 or the 3x3, projection shortcut when the shape
    changes. Each convolution hands its raw output to its FrozenBN's `act`,
    one pass of the FrozenBN epilogue; conv3's also adds the identity
    shortcut, or the projection shortcut's raw output under its own
    FrozenBN, before the ReLU."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, stride_in_1x1: bool = True,
                 num_groups: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = _conv_bn(cin, cout, 1, stride) if (cin != cout or stride != 1) else None
        self.conv1 = _conv_bn(cin, cmid, 1, s1)
        self.conv2 = _conv_bn(cmid, cmid, 3, s3, num_groups)
        self.conv3 = _conv_bn(cmid, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global GROUPED_CONV_CALLS
        shortcut = self.shortcut.convolve(x) if self.shortcut is not None else None
        y = self.conv1.norm.act(self.conv1.convolve(x))
        if self.conv2.groups > 1:
            GROUPED_CONV_CALLS += 1
        y = self.conv2.norm.act(self.conv2.convolve(y))
        z = self.conv3.convolve(y)
        if shortcut is None:
            return self.conv3.norm.act(z, residual=x)
        return self.conv3.norm.act(z, shortcut=shortcut, shortcut_norm=self.shortcut.norm)


class Stem(nn.Module):
    """7x7/2 conv + FrozenBN + ReLU + 3x3/2 max pool."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv1 = _conv_bn(3, channels, 7, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1.norm.act(self.conv1.convolve(x)), 3, stride=2, padding=1)


class ResNet(nn.Module):
    """ResNet with FrozenBN returning a dict of stage features."""

    def __init__(
        self,
        depth: int = 50,
        out_features: Sequence[str] = ("res3", "res4", "res5"),
        stem_channels: int = 64,
        res2_out_channels: int = 256,
        stride_in_1x1: bool = True,
        freeze_at: int = 0,
        num_groups: int = 1,
        width_per_group: int = 64,
    ):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = Stem(stem_channels)
        cin, cout, cmid = stem_channels, res2_out_channels, num_groups * width_per_group
        self.stage_names = []
        for i, num_blocks in enumerate(RESNET_STAGES[depth]):
            name = f"res{i + 2}"
            blocks = []
            for b in range(num_blocks):
                stride = (1 if i == 0 else 2) if b == 0 else 1
                blocks.append(BottleneckBlock(cin, cout, cmid, stride, stride_in_1x1, num_groups))
                cin = cout
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            cout *= 2
            cmid *= 2
        frozen = ["stem"] * (freeze_at >= 1) + self.stage_names[: max(freeze_at - 1, 0)]
        for name in frozen:
            getattr(self, name).requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs

    @staticmethod
    def output_channels(res2_out: int = 256) -> Dict[str, int]:
        return {f"res{i + 2}": res2_out * 2 ** i for i in range(4)}
