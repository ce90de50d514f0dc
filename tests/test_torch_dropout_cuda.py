"""The CUDA dropout kernel against its plain PyTorch version, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dropout_cuda.py
"""

import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import dropout as kd


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_kernel_matches_plain_bit_for_bit(dtype, shared, relu):
    _cuda()
    x = torch.randn(2, 256, 24, 40, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    args = dict(seed=123456789, rate=0.2, batch_shared=shared, offset=1024, relu=relu)
    before = kd.LAUNCHES
    k = kd.dropout(x, **args)
    assert kd.LAUNCHES == before + 1
    assert k.is_contiguous(memory_format=torch.channels_last)
    p = kd.dropout_plain(x, **args)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(k.view(bits), p.view(bits))


@pytest.mark.parametrize("shape", [(3, 8), (1, 4096), (5, 24, 7, 9)])
def test_kernel_matches_plain_on_odd_shapes_and_large_seeds(shape):
    _cuda()
    x = torch.randn(shape, device="cuda")
    for seed in (0, 2 ** 64 - 1):
        k = kd.dropout(x, seed=seed, rate=0.5, offset=4 * 2 ** 33)
        assert torch.equal(k, kd.dropout_plain(x, seed=seed, rate=0.5, offset=4 * 2 ** 33))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_past_one_grid_pass(dtype):
    """The per-sample P3 level of a training step (batch 4 on 736x1280):
    1,884,160 chunks of 8, more than one pass of the launch's grid
    (132 x 32 blocks of 256 threads), so the grid-stride loops go round
    twice in the forward and in the backward."""
    _cuda()
    shape = (4, 256, 92, 160)
    assert shape[0] * shape[1] * shape[2] * shape[3] // 8 > 132 * 32 * 256
    x = torch.randn(shape, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, device="cuda").to(dtype)
    args = dict(seed=20240517, rate=0.2, offset=512, relu=True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    out = kd.dropout(x, **args)
    assert torch.equal(out.view(bits), kd.dropout_plain(x, **args).view(bits))
    k = kd.dropout_backward(g, out, **args)
    p = kd.dropout_backward_plain(g, out, **args)
    assert torch.equal(k.contiguous().view(bits), p.contiguous().view(bits))


def test_kernel_rejects_misaligned_storage():
    _cuda()
    x = torch.randn(4 * 1024 + 1, device="cuda")[1:].reshape(4, 1024)
    with pytest.raises(ValueError):
        kd.dropout(x, seed=0, rate=0.2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cotangent", ["channels_last", "nchw"])
def test_backward_kernel_matches_plain_bit_for_bit(dtype, shared, cotangent):
    """The backward replays the forward's mask on the cotangent, which is
    brought to the forward's (channels_last) memory order first."""
    _cuda()
    x = torch.randn(2, 256, 24, 40, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    args = dict(seed=987654321, rate=0.2, batch_shared=shared, offset=2048, relu=True)
    out = kd.dropout(x, **args)
    g = torch.randn(x.shape, device="cuda").to(dtype)
    if cotangent == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last)
    before = kd.LAUNCHES
    k = kd.dropout_backward(g, out, **args)
    assert kd.LAUNCHES == before + 1
    p = kd.dropout_backward_plain(g, out, **args)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(k.contiguous().view(bits), p.contiguous().view(bits))
    keep = kd.dropout(torch.ones_like(x), **dict(args, relu=False)) != 0
    expect = torch.where(keep & (x > 0), g * kd.keep_scale(0.2, dtype), torch.zeros_like(g))
    assert torch.equal(k.contiguous().view(bits), expect.contiguous().view(bits))


def test_autograd_dropout_launches_forward_and_backward_kernels():
    _cuda()
    x = torch.randn(2, 64, 8, 16, device="cuda").contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    before = kd.LAUNCHES
    y = kd.dropout_autograd(x, 5, 0.2, relu=True)
    y.backward(torch.ones_like(y))
    assert kd.LAUNCHES == before + 2
    keep = kd.dropout(torch.ones_like(x), 5, 0.2) != 0
    assert torch.equal(x.grad, (keep & (x > 0)) * 1.25)
