"""The FrozenBN epilogue (``ops/kernels/frozen_bn.py``) on the CPU: its
plain version against the chain of separate PyTorch operations it replaces
(FrozenBN's ``x * mul + add``, ``+ shortcut``, ``F.relu``), its gradients
against autograd of that chain, and the backbone around it: which calls
take a backward, REMAT's recomputation, the state dict's names, and one
operator node a call in an exported program. The kernel itself is held
against the plain version on a card by ``tests/test_torch_frozen_bn_cuda.py``.
"""

import pytest
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

import plain_resnext
from pod_compare_tpu_torch.models.layers import FrozenBatchNorm2d, cast
from pod_compare_tpu_torch.models.resnet import BottleneckBlock, ResNet
from pod_compare_tpu_torch.ops.kernels import frozen_bn as kfb

KINDS = ("none", "residual", "projection")


def random_norm(c: int, seed: int) -> FrozenBatchNorm2d:
    """A FrozenBN with statistics away from the identity, some scales
    negative."""
    g = torch.Generator().manual_seed(seed)
    norm = FrozenBatchNorm2d(c)
    norm.weight.copy_(torch.randn(c, generator=g))
    norm.bias.copy_(torch.randn(c, generator=g) * 0.5)
    norm.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
    norm.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
    return norm


def chain_norm(x: torch.Tensor, norm: FrozenBatchNorm2d) -> torch.Tensor:
    """FrozenBN as separate operations in x's dtype: the pair in float32,
    cast, then a multiply and an add."""
    mul = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
    add = norm.bias - norm.running_mean * mul
    shape = (1, -1, 1, 1)
    return x * cast(mul, x.dtype).view(shape) + cast(add, x.dtype).view(shape)


def chain(z, norm, residual=None, shortcut=None, shortcut_norm=None):
    """The epilogue as separate operations, each rounded to z's dtype."""
    y = chain_norm(z, norm)
    if residual is not None:
        y = y + residual
    elif shortcut is not None:
        y = y + chain_norm(shortcut, shortcut_norm)
    return F.relu(y)


def case(kind: str, dtype=torch.float32, shape=(2, 16, 5, 7), channels_last=True, seed=0,
         grad=False):
    """(z, norm, kwargs) of one epilogue call: z and the side input drawn
    from a seed, in `dtype` and memory format."""
    g = torch.Generator().manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format

    def tensor():
        t = torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=fmt)
        return t.requires_grad_(grad)

    z, kwargs = tensor(), {}
    if kind == "residual":
        kwargs["residual"] = tensor()
    elif kind == "projection":
        kwargs["shortcut"], kwargs["shortcut_norm"] = tensor(), random_norm(shape[1], seed + 1)
    return z, random_norm(shape[1], seed), kwargs


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_float32_is_the_chain_bit_for_bit(kind, channels_last):
    z, norm, kw = case(kind, channels_last=channels_last)
    ours = kfb.frozen_bn_act(z, norm, **kw)
    assert torch.equal(ours, chain(z, norm, **kw))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert ours.is_contiguous(memory_format=fmt)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_module_alone_is_the_multiply_add_rounded_once(dtype, channels_last):
    """FrozenBatchNorm2d's own forward, without the ReLU: in float32 the
    separate multiply and add bit for bit, in bf16 their float32 result on
    the pair rounded to bf16, rounded once."""
    z, norm, _ = case("none", dtype, shape=(2, 32, 6, 5), channels_last=channels_last, seed=7)
    ours = norm(z)
    mul, add = (t.float().view(1, -1, 1, 1) for t in kfb.pair(kfb.stats(norm), dtype))
    assert ours.dtype == dtype and (ours < 0).any()
    assert torch.equal(ours, (z.float() * mul + add).to(dtype))
    if dtype == torch.float32:
        assert torch.equal(ours, chain_norm(z, norm))


@pytest.mark.parametrize("kind", KINDS)
def test_bfloat16_rounds_once(kind):
    """In bf16 the result is the float32 chain on the bf16 inputs and the
    pair rounded to bf16, rounded once: within half a bf16 ulp of it, and
    no farther from it than the chain of bf16 operations."""
    z, norm, kw = case(kind, torch.bfloat16, shape=(2, 64, 9, 11), seed=3)
    ours = kfb.frozen_bn_act(z, norm, **kw)
    mul, add = (t.float() for t in kfb.pair(kfb.stats(norm), torch.bfloat16))
    shape = (1, -1, 1, 1)
    exact = z.float() * mul.view(shape) + add.view(shape)
    if kind == "residual":
        exact = exact + kw["residual"].float()
    elif kind == "projection":
        ms, as_ = (t.float() for t in kfb.pair(kfb.stats(kw["shortcut_norm"]), torch.bfloat16))
        exact = exact + (kw["shortcut"].float() * ms.view(shape) + as_.view(shape))
    exact = torch.relu(exact)
    assert ours.dtype == torch.bfloat16
    assert torch.equal(ours, exact.to(torch.bfloat16))
    ulp = torch.where(exact == 0, torch.zeros_like(exact),
                      2.0 ** (torch.floor(torch.log2(exact.abs())) - 7))
    assert ((ours.float() - exact).abs() <= ulp / 2).all()
    twice = chain(z, norm, **kw).float()
    assert (ours.float() - exact).abs().max() <= (twice - exact).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_are_autograd_of_the_plain_chain(kind, dtype):
    """The Function's gradients (its backward operator) equal autograd
    through the plain version's operations, for z and the side input."""
    z, norm, kw = case(kind, dtype, seed=5, grad=True)
    side = kw.get("residual", kw.get("shortcut"))
    inputs = [z] + ([side] if side is not None else [])
    g = torch.randn(z.shape, generator=torch.Generator().manual_seed(9)).to(dtype)
    ours = torch.autograd.grad(kfb.frozen_bn_act(z, norm, **kw), inputs, g)
    ns = kfb.stats(kw["shortcut_norm"]) if kind == "projection" else None
    plain = kfb.frozen_bn_act_plain(z, kfb.stats(norm), kw.get("residual"), kw.get("shortcut"),
                                    ns)
    theirs = torch.autograd.grad(plain, inputs, g)
    for a, b in zip(ours, theirs):
        assert a.dtype == dtype and torch.equal(a, b)
    if dtype == torch.float32:
        for a, b in zip(ours, torch.autograd.grad(chain(z, norm, **kw), inputs, g)):
            assert torch.equal(a, b)


def test_only_the_gradients_asked_for(monkeypatch):
    seen = []
    real = kfb.frozen_bn_act_backward_impl

    def watched(g, y, n, ns, z_grad, side_grad):
        seen.append((z_grad, side_grad))
        return real(g, y, n, ns, z_grad, side_grad)

    monkeypatch.setattr(kfb, "frozen_bn_act_backward_impl", watched)
    z, norm, kw = case("residual", grad=False)
    kw["residual"].requires_grad_(True)
    (gr,) = torch.autograd.grad(kfb.frozen_bn_act(z, norm, **kw).sum(), [kw["residual"]])
    assert seen == [(False, True)] and gr.shape == z.shape
    seen.clear()
    z.requires_grad_(True)
    kw["residual"].requires_grad_(False)
    kfb.frozen_bn_act(z, norm, **kw).sum().backward()
    assert seen == [(True, False)]


def _tiny(depth: int, freeze_at: int = 2) -> ResNet:
    """The backbone's structure (blocks, shortcuts, freezing) at small
    widths, with FrozenBN statistics away from the identity."""
    net = ResNet(depth, stem_channels=16, res2_out_channels=32, freeze_at=freeze_at,
                 num_groups=4, width_per_group=4, stride_in_1x1=depth == 50)
    for i, m in enumerate(net.modules()):
        if isinstance(m, FrozenBatchNorm2d):
            m.load_state_dict(random_norm(m.weight.numel(), i).state_dict())
    return net


def _images(seed=0, size=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 3, size, size, generator=g).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("depth,forwards,backwards", [(50, 49, 39), (101, 100, 90)])
def test_calls_a_step_and_frozen_stages_take_no_backward(monkeypatch, depth, forwards,
                                                         backwards):
    """One epilogue a convolution (the projection shortcut's inside conv3's),
    a backward for each of the trainable stages' only: FREEZE_AT 2 leaves
    the stem and res2 without one."""
    fwd, bwd = [], []
    real_f, real_b = kfb.frozen_bn_act_impl, kfb.frozen_bn_act_backward_impl
    monkeypatch.setattr(kfb, "frozen_bn_act_impl", lambda *a: fwd.append(1) or real_f(*a))
    monkeypatch.setattr(kfb, "frozen_bn_act_backward_impl",
                        lambda *a: bwd.append(1) or real_b(*a))
    net = _tiny(depth)
    out = net(_images())
    sum(o.float().sum() for o in out.values()).backward()
    assert (len(fwd), len(bwd)) == (forwards, backwards)
    assert all(p.grad is None for p in net.res2.parameters())
    assert all(p.grad is not None for p in net.res3.parameters())


def test_bottleneck_in_float32_is_the_chain_of_operations():
    torch.manual_seed(0)
    net = _tiny(50)
    x = _images(1)
    y = net.stem(x)
    stem = F.max_pool2d(F.relu(chain_norm(net.stem.conv1.convolve(x), net.stem.conv1.norm)), 3,
                        stride=2, padding=1)
    assert torch.equal(y, stem)
    for block in list(net.res2) + list(net.res3):
        assert isinstance(block, BottleneckBlock)
        t = F.relu(chain_norm(block.conv1.convolve(y), block.conv1.norm))
        t = F.relu(chain_norm(block.conv2.convolve(t), block.conv2.norm))
        short = y if block.shortcut is None else chain_norm(block.shortcut.convolve(y),
                                                             block.shortcut.norm)
        expected = F.relu(chain_norm(block.conv3.convolve(t), block.conv3.norm) + short)
        y = block(y)
        assert torch.equal(y, expected)


def test_remat_recomputation_gives_the_same_gradients(monkeypatch):
    """Under ``torch.utils.checkpoint`` (PARALLEL.REMAT's wrapper) the
    backward recomputes every epilogue and the gradients are bit for bit
    the same."""
    calls = []
    real = kfb.frozen_bn_act_impl
    monkeypatch.setattr(kfb, "frozen_bn_act_impl", lambda *a: calls.append(1) or real(*a))
    net, x = _tiny(50), _images(2)

    def grads(remat):
        net.zero_grad()
        out = checkpoint(net, x, use_reentrant=False) if remat else net(x)
        sum(o.sum() for o in out.values()).backward()
        return {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}

    plain = grads(False)
    assert len(calls) == 49
    calls.clear()
    remat = grads(True)
    assert len(calls) == 2 * 49
    assert plain.keys() == remat.keys() and len(plain) > 0
    for n in plain:
        assert torch.equal(plain[n], remat[n]), n


@pytest.mark.parametrize("arch", [plain_resnext.R50, plain_resnext.X101_32X8D],
                         ids=["R50", "X101_32x8d"])
def test_state_dict_names_are_detectron2s(arch):
    with torch.device("meta"):
        net = ResNet(arch.depth, freeze_at=2, num_groups=arch.num_groups,
                     width_per_group=arch.width_per_group, stride_in_1x1=arch.stride_in_1x1)
    ours = {"backbone.bottom_up." + k: tuple(v.shape) for k, v in net.state_dict().items()}
    theirs = {k: v for k, v in plain_resnext.parameter_shapes(arch, 7).items()
              if k.startswith("backbone.bottom_up.")}
    assert ours == theirs


def test_export_records_one_operator_node_a_call():
    net = _tiny(50).eval()
    with torch.no_grad():
        program = torch.export.export(net, (_images(3, 32),))
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    ops = [t for t in targets if t == torch.ops.pod_compare_tpu_torch.frozen_bn_act.default]
    assert len(ops) == 49
    assert not [t for t in targets if "relu" in str(t) or "rsqrt" in str(t)]
    x = _images(4, 32)
    with torch.no_grad():
        served, eager = program.module()(x), net(x)
    for k in eager:
        assert torch.equal(served[k], eager[k])


@pytest.mark.parametrize("bad", ["dtype", "channels", "strides", "mismatch", "buffers"])
def test_kernel_wrapper_refuses_what_it_does_not_take(bad):
    """The CUDA wrapper's checks, which run before any launch: a float16
    tensor, C not a multiple of 8, non-dense strides, a side input in
    another memory format, bf16 FrozenBN buffers under float32 tensors."""
    z = torch.randn(2, 16, 4, 6).contiguous(memory_format=torch.channels_last)
    norm, kw = random_norm(16, 0), {}
    if bad == "dtype":
        z = z.half()
    elif bad == "channels":
        z, norm = torch.randn(2, 12, 4, 6), random_norm(12, 0)
    elif bad == "strides":
        z = torch.randn(2, 16, 4, 12)[..., ::2]
    elif bad == "mismatch":
        kw["residual"] = torch.randn(2, 16, 4, 6)
    else:
        norm = norm.to(torch.bfloat16)
    match = {"dtype": "float32 or bfloat16", "channels": "multiple of 8", "strides": "dense",
             "mismatch": "alike", "buffers": "float32 FrozenBN buffers"}[bad]
    with pytest.raises((TypeError, ValueError), match=match):
        kfb.frozen_bn_act_cuda(z, kfb.stats(norm), **kw)
