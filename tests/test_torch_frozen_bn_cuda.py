"""The FrozenBN epilogue's CUDA kernel (``csrc/frozen_bn.cu``) against its
plain PyTorch version, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_frozen_bn_cuda.py

Forward and backward are held bit for bit against the plain version on the
card, in bfloat16 and float32, channels-last and NCHW, at the backbone's
own shapes: X101-32x8d at batch 16 and R50 at batch 4 on 736x1280, with no
side input, an identity residual and a projection shortcut; and with
FrozenBN buffers in bf16, as the predictor casts them. The wrapper refuses
other dtypes, strides and misaligned storage, bf16 buffers under float32
tensors, and a training step
of the backbone launches the kernel once a convolution forward and once a
trainable convolution backward.
"""

import pytest
import torch

from pod_compare_tpu_torch.models.layers import FrozenBatchNorm2d
from pod_compare_tpu_torch.models.resnet import ResNet
from pod_compare_tpu_torch.ops.kernels import frozen_bn as kfb


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# (name, shape, side): epilogues of the training step at 736x1280.
SHAPES = [
    ("x101_res2_conv1_b16", (16, 256, 184, 320), "none"),
    ("x101_res2_0_conv3_b16", (16, 256, 184, 320), "projection"),
    ("x101_res3_0_conv3_b16", (16, 512, 92, 160), "projection"),
    ("x101_res4_conv3_b16", (16, 1024, 46, 80), "residual"),
    ("x101_res5_conv2_b16", (16, 2048, 23, 40), "none"),
    ("r50_stem_b4", (4, 64, 368, 640), "none"),
    ("r50_res3_conv1_b4", (4, 128, 92, 160), "none"),
    ("r50_res4_conv3_b4", (4, 1024, 46, 80), "residual"),
    ("r50_res5_0_conv3_b4", (4, 2048, 23, 40), "projection"),
]


def random_norm(c: int, seed: int, dtype=torch.float32) -> FrozenBatchNorm2d:
    g = torch.Generator().manual_seed(seed)
    norm = FrozenBatchNorm2d(c)
    norm.weight.copy_(torch.randn(c, generator=g))
    norm.bias.copy_(torch.randn(c, generator=g) * 0.5)
    norm.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
    norm.running_var.copy_(torch.rand(c, generator=g) * 2 + 1e-3)
    return norm.to("cuda", dtype)


def _tensor(shape, dtype, fmt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(memory_format=fmt)


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,shape,side", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_bit_for_bit(name, shape, side, dtype, channels_last):
    _cuda()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    z = _tensor(shape, dtype, fmt, 1)
    n = kfb.stats(random_norm(shape[1], 2))
    residual = _tensor(shape, dtype, fmt, 3) if side == "residual" else None
    shortcut = _tensor(shape, dtype, fmt, 4) if side == "projection" else None
    ns = kfb.stats(random_norm(shape[1], 5)) if side == "projection" else None
    launches = kfb.LAUNCHES
    y = kfb.frozen_bn_act_cuda(z, n, residual, shortcut, ns)
    torch.cuda.synchronize()
    assert kfb.LAUNCHES == launches + 1
    assert y.is_contiguous(memory_format=fmt) and y.dtype == dtype
    expected = kfb.frozen_bn_act_plain(z, n, residual, shortcut, ns)
    assert torch.equal(y, expected), (y.float() - expected.float()).abs().max()
    assert (y > 0).any() and (y == 0).any()
    del z, residual, expected

    g = _tensor(shape, dtype, fmt, 6)
    side_grad = side != "none"
    ours = kfb.frozen_bn_act_backward_cuda(g, y, n, ns, True, side_grad)
    theirs = kfb.frozen_bn_act_backward_plain(g, y, n, ns, True, side_grad)
    torch.cuda.synchronize()
    assert kfb.LAUNCHES == launches + 2
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
        else:
            assert a.is_contiguous(memory_format=fmt) and torch.equal(a, b)


# Inference at batch 8: the predictor casts the FrozenBN buffers to bf16
# with their convolutions (``ProbabilisticRetinaNet.cast_convs``).
INFERENCE = [
    ("r50_stem_b8", (8, 64, 368, 640), "none"),
    ("r50_res4_conv3_b8", (8, 1024, 46, 80), "residual"),
    ("r50_res5_0_conv3_b8", (8, 2048, 23, 40), "projection"),
]


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("name,shape,side", INFERENCE, ids=[s[0] for s in INFERENCE])
def test_bfloat16_buffers_match_plain_bit_for_bit(name, shape, side, channels_last):
    """FrozenBN buffers in bf16: the pair's every operation rounded to bf16,
    as PyTorch's operations on them round."""
    _cuda()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    bf16 = torch.bfloat16
    z = _tensor(shape, bf16, fmt, 11)
    n = kfb.stats(random_norm(shape[1], 12, bf16))
    residual = _tensor(shape, bf16, fmt, 13) if side == "residual" else None
    shortcut = _tensor(shape, bf16, fmt, 14) if side == "projection" else None
    ns = kfb.stats(random_norm(shape[1], 15, bf16)) if side == "projection" else None
    y = kfb.frozen_bn_act_cuda(z, n, residual, shortcut, ns)
    assert torch.equal(y, kfb.frozen_bn_act_plain(z, n, residual, shortcut, ns))
    g = _tensor(shape, bf16, fmt, 16)
    ours = kfb.frozen_bn_act_backward_cuda(g, y, n, ns, True, side != "none")
    theirs = kfb.frozen_bn_act_backward_plain(g, y, n, ns, True, side != "none")
    for a, b in zip(ours, theirs):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_a_cotangent_in_the_other_format(dtype):
    """A backward whose cotangent arrives in NCHW for a channels-last
    output, at a shape whose H·W is not a multiple of 8."""
    _cuda()
    shape = (2, 64, 33, 17)
    z = _tensor(shape, dtype, torch.channels_last, 7)
    n = kfb.stats(random_norm(64, 8))
    y = kfb.frozen_bn_act_cuda(z, n)
    assert torch.equal(y, kfb.frozen_bn_act_plain(z, n))
    g = _tensor(shape, dtype, torch.contiguous_format, 9)
    gz, _ = kfb.frozen_bn_act_backward_cuda(g, y, n, None, True, False)
    ez, _ = kfb.frozen_bn_act_backward_plain(g, y, n, None, True, False)
    assert gz.is_contiguous(memory_format=torch.channels_last) and torch.equal(gz, ez)


@pytest.mark.parametrize("bad", ["float16", "strided", "formats", "misaligned", "buffers",
                                 "mixed_buffers", "bf16_buffers_f32_tensor"])
def test_kernel_refuses_what_it_does_not_take(bad):
    _cuda()
    z = _tensor((2, 16, 8, 8), torch.bfloat16, torch.channels_last, 0)
    norm, kw = random_norm(16, 0), {}
    if bad == "float16":
        z = z.half()
    elif bad == "strided":
        z = _tensor((2, 16, 8, 16), torch.bfloat16, torch.channels_last, 0)[..., ::2]
    elif bad == "formats":
        kw["residual"] = _tensor((2, 16, 8, 8), torch.bfloat16, torch.contiguous_format, 1)
    elif bad == "misaligned":
        z = _tensor((2 * 16 * 8 * 8 + 1,), torch.bfloat16, torch.contiguous_format, 0)[1:]
        z = z.view(2, 8, 8, 16).permute(0, 3, 1, 2)
    elif bad == "buffers":
        norm = norm.double()
    elif bad == "bf16_buffers_f32_tensor":
        z, norm = z.float(), random_norm(16, 0, torch.bfloat16)
    else:
        kw["shortcut"] = _tensor((2, 16, 8, 8), torch.bfloat16, torch.channels_last, 1)
        kw["ns"] = kfb.stats(random_norm(16, 1, torch.bfloat16))
    with pytest.raises((TypeError, ValueError)):
        kfb.frozen_bn_act_cuda(z, kfb.stats(norm), **kw)


@pytest.mark.parametrize("depth,groups,width,forwards,backwards",
                         [(50, 1, 64, 49, 39), (101, 32, 8, 100, 90)], ids=["R50", "X101_32x8d"])
def test_launches_a_training_step(depth, groups, width, forwards, backwards):
    """FREEZE_AT 2 at the configurations' widths: one launch a convolution
    forward (the projection shortcuts' FrozenBNs inside conv3's), one a
    trainable convolution backward, none for the stem and res2; an
    inference pass launches the forwards alone."""
    _cuda()
    net = ResNet(depth, freeze_at=2, num_groups=groups, width_per_group=width,
                 stride_in_1x1=depth == 50).cuda()
    x = torch.randn(2, 3, 256, 384, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    start = kfb.LAUNCHES
    out = net(x)
    assert kfb.LAUNCHES - start == forwards
    sum(o.float().sum() for o in out.values()).backward()
    torch.cuda.synchronize()
    assert kfb.LAUNCHES - start == forwards + backwards
    start = kfb.LAUNCHES
    with torch.no_grad():
        net(x)
    assert kfb.LAUNCHES - start == forwards
