"""Shared layers: FrozenBN and the conv-with-norm of the detectron2 namespace.

Counterpart of ``pod_compare_tpu/models/layers.py``. Modules hold NCHW
tensors (channels_last in memory where the model asks for it).
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from pod_compare_tpu_torch.ops.kernels import frozen_bn as kfb


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`, with no cast where it has that dtype already (an
    exported program would record the no-op cast as two nodes)."""
    return t if t.dtype == dtype else t.to(dtype)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine parameters (detectron2's
    FrozenBatchNorm2d, eps 1e-5), folded into a per-channel pair: mul =
    weight·rsqrt(running_var + eps) and add = bias - running_mean·mul in the
    buffers' dtype (float32; bfloat16 once ``cast_convs`` has cast them with
    their convolution), each rounded to the input's dtype, as the JAX
    FrozenBatchNorm casts them; x·mul + add is computed in float32 from
    those values and rounded once to the input's dtype. The backbone calls
    `act`, which applies it with the ReLU and the residual or projection
    shortcut that follow it in a bottleneck, in one pass of the FrozenBN
    epilogue (``ops/kernels/frozen_bn.py``, the kernel K3 on the card); the
    module's own forward, the FrozenBN alone, is plain PyTorch. Its four
    buffers are what a checkpoint holds."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def act(self, z: torch.Tensor, residual: Optional[torch.Tensor] = None,
            shortcut: Optional[torch.Tensor] = None,
            shortcut_norm: Optional["FrozenBatchNorm2d"] = None) -> torch.Tensor:
        """relu(self(z) [+ residual | + shortcut_norm(shortcut)]) in one pass."""
        return kfb.frozen_bn_act(z, self, residual, shortcut, shortcut_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kfb.frozen_bn_plain(x, kfb.stats(self))


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

    def convolve(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution alone, without `norm`."""
        weight = cast(self.weight, x.dtype)
        bias = None if self.bias is None else cast(self.bias, x.dtype)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            bias = None if bias is None else bias.float()
            x = F.conv2d(x.float(), weight.float(), bias, self.stride, self.padding,
                         self.dilation, self.groups).to(x.dtype)
        else:
            x = F.conv2d(x, weight, bias, self.stride, self.padding, self.dilation, self.groups)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convolve(x)
        return self.norm(x) if self.norm is not None else x
