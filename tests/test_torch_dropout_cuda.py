"""The CUDA dropout kernel against its plain PyTorch version, on a card.

These tests skip where there is no CUDA device. The grouped kernel (one
launch per (run, tower, layer) over the five FPN levels) is held bit for
bit against its plain version at the level lists of the main paths: the
inference canvas 736x1280 and apply_net's 768x1344 at batch 2 with
batch-shared masks, the training canvas at batch 4 with per-sample and
batch-shared masks (whose 2.5 million chunks take the grid round its loop
about ten times), and a small canvas. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dropout_cuda.py
"""

import pytest
import torch

from pod_compare_tpu_torch.models import KernelDropout, level_offsets
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
    1,884,160 chunks of 8, more than 132 x 32 blocks of 256 threads and so
    several passes of the launch's grid (one wave of resident blocks), in
    the forward and in the backward."""
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


def _levels(canvas, batch, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((batch, 256, -(-canvas[0] // st), -(-canvas[1] // st)), generator=gen,
                        device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
            for st in (8, 16, 32, 64, 128)]


GROUPS = [((736, 1280), 2, True), ((768, 1344), 2, True), ((736, 1280), 4, False),
          ((736, 1280), 4, True), ((128, 128), 2, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("canvas,batch,shared", GROUPS)
def test_grouped_kernel_matches_plain_at_the_main_paths_levels(dtype, canvas, batch, shared):
    _cuda()
    xs = _levels(canvas, batch, dtype)
    offsets = level_offsets(xs, shared)
    args = (20240517, 0.2, shared, offsets, True)
    before = kd.LAUNCHES
    outs = kd.dropout_levels(xs, *args)
    assert kd.LAUNCHES == before + 1
    want = kd.dropout_levels_plain(xs, *args)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for o, w in zip(outs, want):
        assert o.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(o.view(bits), w.view(bits))
    gen = torch.Generator(device="cuda").manual_seed(1)
    gs = [torch.randn(x.shape, generator=gen, device="cuda").to(dtype) for x in xs]
    before = kd.LAUNCHES
    dxs = kd.dropout_levels_backward(gs, outs, *args)
    assert kd.LAUNCHES == before + 1
    for d, w in zip(dxs, kd.dropout_levels_backward_plain(gs, outs, *args)):
        assert torch.equal(d.contiguous().view(bits), w.contiguous().view(bits))


def test_grouped_kernel_equals_the_single_launches_and_the_operator():
    """A group of five equals the five one-level launches at their offsets,
    through the wrapper and through the operator."""
    _cuda()
    xs = _levels((736, 1280), 2, torch.bfloat16, seed=3)
    offsets = level_offsets(xs, True)
    singles = [kd.dropout_cuda(x, 77, 0.2, True, o, True) for x, o in zip(xs, offsets)]
    before = kd.LAUNCHES
    grouped = kd.dropout_levels_op(xs, torch.tensor(77), 0.2, True, offsets, True)
    assert kd.LAUNCHES == before + 1
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(grouped, singles))


def test_kernel_dropout_launches_once_per_tower_and_layer_each_way():
    """KernelDropout on the card: one forward launch per (tower, layer) over
    the levels, and one backward launch for each in autograd's pass."""
    _cuda()
    xs = [x.requires_grad_(True) for x in _levels((128, 128), 2, torch.float32, seed=4)]
    td = KernelDropout([[1, 2], [3, 4]], 0.2, level_offsets(xs, False), batch_shared=False)
    before = kd.LAUNCHES
    ys = td(xs, 0, 1)
    assert kd.LAUNCHES == before + 1
    sum(y.float().sum() for y in ys).backward()
    assert kd.LAUNCHES == before + 2
    for x, y, o in zip(xs, ys, td.level_offsets):
        keep = kd.dropout(torch.ones_like(x), 2, 0.2, False, o) != 0
        assert torch.equal(x.grad, (keep & (x > 0)) * 1.25)
        assert torch.equal(y, kd.dropout_plain(x.detach(), 2, 0.2, False, o, True))
