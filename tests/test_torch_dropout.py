"""The port's counter-based dropout (plain version here; the CUDA kernel on a
card) against its contract and against the JAX MC bank's masks.

The JAX Pallas kernel cannot be the reference on the CPU: under the
interpret mode of this JAX version its hardware-PRNG draw drops nothing. So
the JAX side is the dispatcher's statistical contract
(tests/test_pallas_dropout.py) and the premultiplied masks of
`tower_dropout_masks(..., dtype=f32)` + `apply_mask`, which the MC bank
uses. Statistical bands are 6 standard deviations of a binomial share.

The kernel's host entry is the group (``dropout_levels``: one launch per
(run, tower, layer) over the FPN levels on a card); a single tensor is the
group of one. A group is held bit for bit against ``dropout_plain`` of each
level at its offset, through its plain version, its operator and its
autograd form.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.ops.pallas.dropout import apply_mask, tower_dropout_masks
from pod_compare_tpu_torch.models import KernelDropout, level_offsets
from pod_compare_tpu_torch.ops.kernels import dropout as kd

RATE = 0.2


def _band(n, rate=RATE):
    return 6.0 * math.sqrt(rate * (1 - rate) / n)


def _one(x, seed, rate, batch_shared=False, offset=0, relu=False):
    """`dropout_levels` of x alone: the group of one."""
    return kd.dropout_levels([x], seed, rate, batch_shared, [offset], relu)[0]


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10 (counter words
    2 and 3 zero here, so the first vector and two of our own)."""
    words = kd.philox4x32_10(torch.tensor([0]), torch.tensor([0]), 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    # Equal to the scalar definition for large counters and keys.
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85

    def scalar(c, k):
        for r in range(10):
            if r:
                k = [(k[0] + w0) & 0xFFFFFFFF, (k[1] + w1) & 0xFFFFFFFF]
            p0, p1 = m0 * c[0], m1 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
                 p0 & 0xFFFFFFFF]
        return c

    for lo, hi, seed in [(0xFFFFFFFF, 0xFFFFFFFF, 2 ** 64 - 1), (12345, 7, 0xDEADBEEFCAFE)]:
        words = kd.philox4x32_10(torch.tensor([lo]), torch.tensor([hi]), seed)
        expect = scalar([lo, hi, 0, 0], [seed & 0xFFFFFFFF, seed >> 32])
        assert [int(w) for w in words] == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keep_share_scale_and_mean(dtype):
    x = torch.ones(4, 64, 32, 32, dtype=dtype)
    out = _one(x, seed=3, rate=RATE).float()
    dropped = float((out == 0).float().mean())
    assert abs(dropped - RATE) < _band(out.numel())
    np.testing.assert_array_equal(out[out != 0].numpy(), 1.25)
    assert abs(float(out.mean()) - 1.0) < 1.25 * _band(out.numel())


def test_expectation_over_seeds_is_the_input():
    """E[out] = x: the mean over many seeds of each element approaches x."""
    x = torch.randn(1, 8, 4, 8)
    outs = torch.stack([_one(x, seed=s, rate=RATE) for s in range(2000)])
    sd = x.abs() * math.sqrt(RATE / (1 - RATE)) / math.sqrt(outs.shape[0])
    assert ((outs.mean(dim=0) - x).abs() <= 6 * sd + 1e-6).all()


def test_distinct_seeds_distinct_masks_same_seed_replays():
    x = torch.ones(2, 16, 8, 8)
    a = _one(x, seed=1, rate=0.5)
    b = _one(x, seed=2, rate=0.5)
    assert not torch.equal(a, b)
    assert torch.equal(a, _one(x, seed=1, rate=0.5))
    # Seeds differing only in their high word give other masks too.
    assert not torch.equal(a, _one(x, seed=1 + (1 << 32), rate=0.5))


def test_batch_shared_mask_is_constant_over_the_batch():
    x = torch.ones(3, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    shared = _one(x, seed=9, rate=RATE, batch_shared=True)
    assert torch.equal(shared[0], shared[1]) and torch.equal(shared[0], shared[2])
    per_sample = _one(x, seed=9, rate=RATE)
    assert not torch.equal(per_sample[0], per_sample[1])
    # The shared mask is the per-sample mask of the first image.
    assert torch.equal(shared[0], per_sample[0])


def test_stream_index_runs_in_memory_order_with_offsets():
    """Element i of x in memory order uses stream index offset + i, so a
    channels_last tensor takes its mask in NHWC order, and one draw over
    several levels equals the per-level draws at their offsets."""
    x = torch.ones(1, 8, 4, 4)
    nhwc = _one(x.permute(0, 2, 3, 1).contiguous(), seed=4, rate=RATE)
    cl = _one(x.contiguous(memory_format=torch.channels_last), seed=4, rate=RATE)
    assert cl.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(cl.permute(0, 2, 3, 1), nhwc)
    flat = _one(torch.ones(1, 8 * 16 + 8 * 4), seed=4, rate=RATE)
    a = _one(torch.ones(1, 8 * 16), seed=4, rate=RATE)
    b = _one(torch.ones(1, 8 * 4), seed=4, rate=RATE, offset=8 * 16)
    assert torch.equal(flat, torch.cat([a, b], dim=1))


def test_fused_relu_is_relu_then_dropout():
    x = torch.randn(2, 16, 4, 4)
    fused = _one(x, seed=5, rate=RATE, relu=True)
    two_step = _one(torch.relu(x), seed=5, rate=RATE)
    assert torch.equal(fused, two_step)
    assert (fused >= 0).all()


def test_bf16_scale_is_rounded_to_the_dtype():
    assert kd.keep_scale(0.3, torch.bfloat16) == float(torch.tensor(1 / 0.7, dtype=torch.bfloat16))
    assert kd.keep_scale(0.2, torch.float32) == 1.25
    x = torch.randn(1, 64, dtype=torch.bfloat16)
    out = _one(x, seed=1, rate=0.3)
    kept = out != 0
    scale = torch.tensor(kd.keep_scale(0.3, torch.bfloat16), dtype=torch.bfloat16)
    assert torch.equal(out[kept], (x * scale)[kept])


def test_keep_threshold_law():
    assert kd.keep_threshold(0.2) == math.floor(0.8 * 2 ** 32)
    assert kd.keep_threshold(0.0) == 2 ** 32 - 1
    assert kd.keep_threshold(1.0) == 0


@pytest.mark.parametrize(
    "make, error",
    [
        (lambda: torch.ones(2, 8, dtype=torch.float16), TypeError),
        (lambda: torch.ones(2, 7), ValueError),
        (lambda: torch.ones(4, 8).t(), ValueError),
        (lambda: torch.ones(0, 8), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_cannot_take(make, error):
    with pytest.raises(error):
        _one(make(), seed=0, rate=RATE)


def test_offset_must_be_word_aligned_and_no_other_device():
    with pytest.raises(ValueError):
        _one(torch.ones(2, 8), seed=0, rate=RATE, offset=2)
    with pytest.raises(ValueError):
        _one(torch.ones(2, 8, device="meta"), seed=0, rate=RATE)
    with pytest.raises(ValueError):
        kd.dropout_levels_cuda([torch.ones(2, 8)], 0, RATE, False, [0])


def test_plain_path_counts_no_launch():
    before = kd.LAUNCHES
    _one(torch.ones(2, 8), seed=0, rate=RATE)
    assert kd.LAUNCHES == before


def test_kernel_masks_apply_like_the_jax_mc_bank():
    """Given the same keep mask, the port's output equals JAX's
    premultiplied scale mask (`tower_dropout_masks(..., dtype=f32)`) applied
    with `apply_mask`: relu(x) * mask, bit for bit."""
    shapes = [(8, 8, 256), (4, 4, 256)]
    jax_masks = tower_dropout_masks(jax.random.PRNGKey(0), shapes, RATE, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    xs = [rng.randn(2, 256, h, w).astype(np.float32) for (h, w, _) in shapes]
    for x, m in zip(xs, jax_masks):
        m = np.asarray(m)
        assert set(np.unique(m)) <= {0.0, np.float32(1.25)}
        theirs = np.asarray(apply_mask(jnp.asarray(np.maximum(x, 0)).transpose(0, 2, 3, 1),
                                       jnp.asarray(m), RATE))
        keep = torch.from_numpy(m != 0)
        ours = kd.apply_keep(torch.from_numpy(x).permute(0, 2, 3, 1), keep, RATE, relu=True)
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_kernel_dropout_draws_one_mask_per_tower_layer_over_all_levels():
    feats = [torch.ones(2, 16, 4, 4).contiguous(memory_format=torch.channels_last),
             torch.ones(2, 16, 2, 2).contiguous(memory_format=torch.channels_last)]
    offsets = level_offsets(feats, batch_shared=True)
    assert offsets == [0, 16 * 16]
    td = KernelDropout([[11, 12], [13, 14]], RATE, offsets, batch_shared=True)
    lvl0, lvl1 = td(feats, 1, 0)
    whole = _one(torch.ones(1, 16 * 16 + 16 * 4), seed=13, rate=RATE)
    joined = torch.cat([lvl0[0].permute(1, 2, 0).reshape(-1), lvl1[0].permute(1, 2, 0).reshape(-1)])
    assert torch.equal(joined, whole[0])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cotangent", ["channels_last", "nchw"])
def test_autograd_gradient_is_keep_scale_g_where_x_positive(shared, cotangent):
    """The backward replays the forward's mask from the seed on the
    cotangent: dx = keep·scale·g·(x > 0). The stream follows memory order,
    so an NCHW-contiguous cotangent is brought to the forward's
    channels_last order first; its mask must land on the same elements."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 4, 6, generator=gen).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    (y,) = kd.dropout_levels_autograd([x], 7, RATE, shared, [64], relu=True)
    g = torch.randn(2, 16, 4, 6, generator=gen)
    if cotangent == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last)
    else:
        assert g.is_contiguous() and not g.is_contiguous(memory_format=torch.channels_last)
    y.backward(g)
    ones = torch.ones_like(x).contiguous(memory_format=torch.channels_last)
    keep = _one(ones, 7, RATE, batch_shared=shared, offset=64) != 0
    expect = keep * kd.keep_scale(RATE, x.dtype) * g * (x > 0)
    assert torch.equal(x.grad, expect)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)


def test_autograd_without_relu_and_in_bf16():
    x = torch.randn(1, 8, 4, 4).to(torch.bfloat16).requires_grad_(True)
    (y,) = kd.dropout_levels_autograd([x], 3, 0.3, False, [0])
    y.backward(torch.ones_like(y))
    keep = _one(torch.ones_like(x), 3, 0.3) != 0
    scale = torch.tensor(kd.keep_scale(0.3, torch.bfloat16), dtype=torch.bfloat16)
    assert torch.equal(x.grad, torch.where(keep, scale, torch.zeros_like(scale)))
    # Without the fused ReLU the gate is not read: negative kept inputs pass.
    assert bool(((x < 0) & keep & (x.grad != 0)).any())


def test_backward_plain_replays_the_mask_like_the_forward():
    x = torch.randn(2, 8, 2, 4).contiguous(memory_format=torch.channels_last)
    out = _one(x, 11, RATE, offset=8, relu=True)
    g = torch.ones_like(x)
    (dx,) = kd.dropout_levels_backward([g], [out], 11, RATE, False, [8], relu=True)
    assert torch.equal(dx != 0, out > 0)
    assert torch.equal(dx, kd.dropout_backward_plain(g.contiguous(), out, 11, RATE, offset=8,
                                                      relu=True))
    with pytest.raises(ValueError):
        kd.dropout_levels_backward([g.to("meta")], [out.to("meta")], 11, RATE, False, [0])
    with pytest.raises(ValueError):
        kd.dropout_levels_backward_cuda([g], [out], 11, RATE, False, [0])


def test_kernel_dropout_is_differentiable_only_under_autograd():
    """KernelDropout takes the autograd form when the pass is recorded and
    the forward-only call otherwise (the MC bank), with the same output."""
    feats = torch.randn(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    td = KernelDropout([[1, 2], [3, 4]], RATE, [0], batch_shared=False)
    with torch.no_grad():
        (plain,) = td([feats], 0, 1)
    leaf = feats.clone().requires_grad_(True)
    (recorded,) = td([leaf], 0, 1)
    assert recorded.grad_fn is not None and plain.grad_fn is None
    assert torch.equal(recorded.detach(), plain)
    recorded.sum().backward()
    assert torch.equal(leaf.grad != 0, plain > 0)


def _levels(dtype, batch=2, channels=16, sizes=((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))):
    """Five channels_last levels and their offsets in one draw over them."""
    gen = torch.Generator().manual_seed(21)
    xs = [torch.randn(batch, channels, h, w, generator=gen).to(dtype)
          .contiguous(memory_format=torch.channels_last) for h, w in sizes]
    return xs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_levels_equal_per_level_dropout_at_the_offsets(dtype, shared, relu):
    """`dropout_levels_plain` and the operator `dropout_levels` give each
    level what `dropout_plain` gives it at its offset, bit for bit, with no
    launch on the CPU."""
    xs = _levels(dtype)
    offsets = level_offsets(xs, shared)
    want = [kd.dropout_plain(x, 77, RATE, shared, o, relu) for x, o in zip(xs, offsets)]
    before = kd.LAUNCHES
    plain = kd.dropout_levels_plain(xs, 77, RATE, shared, offsets, relu)
    op = kd.dropout_levels_op(xs, torch.tensor(77), RATE, shared, offsets, relu)
    dispatched = kd.dropout_levels(xs, 77, RATE, shared, offsets, relu)
    assert kd.LAUNCHES == before
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for got in (plain, op, dispatched):
        assert len(got) == len(xs)
        for g, w in zip(got, want):
            assert g.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(g.view(bits), w.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_grouped_autograd_backward_equals_the_per_level_backward(dtype, shared):
    """One backward over the levels (NCHW cotangents, as a conv's backward
    may hand them) equals each level's own group of one, bit for bit."""
    xs = _levels(dtype)
    offsets = level_offsets(xs, shared)
    gen = torch.Generator().manual_seed(5)
    gs = [torch.randn(x.shape, generator=gen).to(dtype) for x in xs]
    grouped = [x.clone().requires_grad_(True) for x in xs]
    ys = kd.dropout_levels_autograd(grouped, 9, RATE, shared, offsets, relu=True)
    torch.autograd.backward(ys, gs)
    for x, leaf, y, g, o in zip(xs, grouped, ys, gs, offsets):
        single = x.clone().requires_grad_(True)
        (y1,) = kd.dropout_levels_autograd([single], 9, RATE, shared, [o], relu=True)
        y1.backward(g)
        assert torch.equal(y.detach(), y1.detach())
        assert torch.equal(leaf.grad, single.grad)
        assert leaf.grad.is_contiguous(memory_format=torch.channels_last)
    dxs = kd.dropout_levels_backward(gs, [y.detach() for y in ys], 9, RATE, shared, offsets,
                                     True)
    assert all(torch.equal(d, leaf.grad) for d, leaf in zip(dxs, grouped))


def test_levels_operator_fake_kernel_and_opcheck():
    xs = _levels(torch.bfloat16)
    offsets = level_offsets(xs, True)
    torch.library.opcheck(torch.ops.pod_compare_tpu_torch.dropout_levels.default,
                          (xs, torch.tensor(3), RATE, True, offsets, True))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(x) for x in xs]
        outs = kd.dropout_levels_op(fakes, torch.tensor(3), RATE, True, offsets, True)
        assert [o.shape for o in outs] == [x.shape for x in xs]
        assert all(o.is_contiguous(memory_format=torch.channels_last) for o in outs)


def test_levels_refuse_what_one_launch_cannot_take():
    xs = _levels(torch.float32)
    offsets = level_offsets(xs, True)
    with pytest.raises(ValueError, match="1 to 8"):
        kd.dropout_levels(xs * 2, 1, RATE, True, offsets * 2)
    with pytest.raises(ValueError, match="offset each"):
        kd.dropout_levels(xs, 1, RATE, True, offsets[:-1])
    with pytest.raises(ValueError, match="one dtype"):
        kd.dropout_levels([xs[0], xs[1].to(torch.bfloat16)], 1, RATE, True, offsets[:2])
    with pytest.raises(ValueError, match="divisible"):
        kd.dropout_levels(xs[:2], 1, RATE, True, [0, 2])
    with pytest.raises(ValueError, match="CUDA"):
        kd.dropout_levels_cuda(xs, 1, RATE, True, offsets)
    with pytest.raises(ValueError, match="CUDA"):
        kd.dropout_levels_backward_cuda(xs, xs, 1, RATE, True, offsets)
    with pytest.raises(ValueError, match="no path"):
        kd.dropout_levels([x.to("meta") for x in xs], 1, RATE, True, offsets)
