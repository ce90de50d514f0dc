"""Feature Pyramid Network with RetinaNet's P6/P7 levels.

Counterpart of ``pod_compare_tpu/models/fpn.py``: laterals and a top-down
nearest-2x sum over res3..res5 give p3..p5; P6/P7 are two stride-2 3x3 convs
from res5 (detectron2's LastLevelP6P7). The module is detectron2's
``backbone``: it owns the ResNet as ``bottom_up``, so parameter names are
``backbone.fpn_lateral3``, ``backbone.top_block.p6`` and so on.
"""

from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pod_compare_tpu_torch.models.layers import Conv2d
from pod_compare_tpu_torch.models.resnet import ResNet

FPN_STRIDES = {"p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


def _upsample_nearest_2x(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample cropped to `like`'s spatial shape."""
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, : like.shape[2], : like.shape[3]]


class LastLevelP6P7(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.p6 = Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.p7 = Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        p6 = self.p6(x)
        return [p6, self.p7(F.relu(p6))]


class FPN(nn.Module):
    """ResNet bottom-up + FPN over (res3, res4, res5) + P6/P7 from res5."""

    def __init__(
        self,
        bottom_up: ResNet,
        in_features: Sequence[str] = ("res3", "res4", "res5"),
        out_channels: int = 256,
    ):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        channels = ResNet.output_channels()
        for f in self.in_features:
            lvl = f[-1]
            self.add_module(f"fpn_lateral{lvl}", Conv2d(channels[f], out_channels, 1))
            self.add_module(
                f"fpn_output{lvl}", Conv2d(out_channels, out_channels, 3, padding=1)
            )
        self.top_block = LastLevelP6P7(channels[self.in_features[-1]], out_channels)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        features = self.bottom_up(x)
        merged = {}
        prev = None
        for f in reversed(self.in_features):
            cur = getattr(self, f"fpn_lateral{f[-1]}")(features[f])
            if prev is not None:
                cur = cur + _upsample_nearest_2x(prev, cur)
            merged[f] = prev = cur
        outputs = {
            f"p{i + 3}": getattr(self, f"fpn_output{f[-1]}")(merged[f])
            for i, f in enumerate(self.in_features)
        }
        outputs["p6"], outputs["p7"] = self.top_block(features[self.in_features[-1]])
        return outputs
