"""Int8 post-training quantization of the inference head's tower convs.

Counterpart of ``pod_compare_tpu/ops/quant.py``
(``PROBABILISTIC_INFERENCE.HEAD_QUANT int8``; training never quantizes):

  * weights: symmetric per-output-channel int8, scale_w[o] = max|W[o]|/127;
  * activations: symmetric per-image int8, scale_x[b] = max over (C, H, W)
    of |x| (of x for post-ReLU inputs, which are >= 0)/127; both scales at
    least 1e-12, values rounded half to even (``torch.round``, as
    ``jnp.round``);
  * the 3x3 convolution as one int8 product with int32 sums, then
    ``y.float() * (scale_x * scale_w) + bias`` in that order, so that the
    float32 rounding is the JAX package's.

The product is im2col, nine shifted slices of the zero-padded int8 NHWC
activations side by side as a (B·H·W, 9·C) matrix, times the (9·C, Co)
weight matrix through ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on
CUDA; exact on the CPU too). No float convolution can stand in for it: a
sum reaches 2304·127·127 ≈ 3.7e7, above float32's 2^24 of exact integers.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-12
# torch._int_mm on CUDA takes more than 16 rows; fewer are padded with zeros.
_INT_MM_MIN_ROWS = 17


def quantize_weight_per_channel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, float32 scale[Co]) of an OIHW conv weight, weight ≈
    weight_int8 · scale."""
    w = weight.float()
    scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, _EPS)
    return torch.round(w / scale[:, None, None, None]).to(torch.int8), scale


def quantize_act_per_image(x: torch.Tensor, signed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 x, float32 scale[B, 1, 1, 1]) of (B, C, H, W) activations, one
    scale per image; `signed=False` for post-ReLU inputs (x >= 0)."""
    xf = x.float()
    mag = xf.abs() if signed else xf
    scale = torch.clamp_min(mag.amax(dim=(1, 2, 3), keepdim=True) / 127.0, _EPS)
    return torch.round(xf / scale).to(torch.int8), scale


def int8_conv3x3(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The int32 sums of a 3x3 SAME conv of int8 (B, C, H, W) activations
    by an int8 OIHW weight, as a (B, H, W, Co) int32 tensor."""
    b, c, h, w = x8.shape
    co = w8.shape[0]
    padded = F.pad(x8.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # (B, H+2, W+2, C)
    cols = torch.cat(
        [padded[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)], dim=-1,
    ).reshape(b * h * w, 9 * c)
    rows = cols.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        cols = F.pad(cols, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    # (Co, 3, 3, C) row-major is the (9·C, Co) operand in column-major order,
    # the layout cuBLASLt's int8 GEMM takes for it.
    w_mat = w8.permute(0, 2, 3, 1).reshape(co, 9 * c)
    return torch._int_mm(cols, w_mat.t())[:rows].view(b, h, w, co)


def quantized_conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act_signed: bool = True,
) -> torch.Tensor:
    """3x3 SAME int8 conv of (B, C, H, W) x by an OIHW weight: quantize both,
    int32 sums, dequantize and add the float bias. Returns float32
    (B, Co, H, W), channels_last in memory."""
    w8, sw = quantize_weight_per_channel(weight)
    x8, sx = quantize_act_per_image(x, signed=act_signed)
    y = int8_conv3x3(x8, w8)
    out = y.float() * (sx.view(-1, 1, 1, 1) * sw) + bias.float()
    return out.permute(0, 3, 1, 2)
