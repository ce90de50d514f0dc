"""Shared layers: FrozenBN and the conv-with-norm of the detectron2 namespace.

Counterpart of ``pod_compare_tpu/models/layers.py``. Modules hold NCHW
tensors (channels_last in memory where the model asks for it).
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine parameters (detectron2's
    FrozenBatchNorm2d, eps 1e-5). The folded multiply-add is computed in
    float32 and cast to the input's dtype, as the JAX FrozenBatchNorm does."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        shape = (1, -1, 1, 1)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with an optional `norm` submodule applied after it (the
    detectron2 layout: `<name>.weight`, `<name>.norm.*`).

    The convolution computes in the input's dtype: float32 weights are cast
    to it in `forward`, as flax's `dtype=bfloat16, param_dtype=float32`
    convs do, so training keeps float32 parameters under bfloat16 compute.

    On the CPU a bfloat16 convolution runs in float32 on the bfloat16 values
    and rounds its output (and, through the casts, its gradients) to
    bfloat16 once, as XLA's CPU backend does: PyTorch's own bfloat16 CPU
    convolution returns uninitialised values in the weight gradient of taps
    that see only padding (a 3x3 conv on a 1x1 input, as P6 and P7 are at
    small sizes).
    """

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            bias = None if bias is None else bias.float()
            x = F.conv2d(x.float(), weight.float(), bias, self.stride, self.padding).to(x.dtype)
        else:
            x = F.conv2d(x, weight, bias, self.stride, self.padding)
        return self.norm(x) if self.norm is not None else x
