"""Counter-based dropout: the CUDA kernel ``csrc/dropout.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``pod_compare_tpu/ops/pallas/dropout.py``
(``hardware_dropout``). The TPU kernel draws bits from the chip's PRNG; here
they come from Philox4x32-10 keyed on (seed, element index), so a mask is a
pure function of its seed and the kernel and the plain version agree bit
for bit. Element ``i`` of ``x``, counted in memory order, uses the stream
index ``offset + i`` (per-sample) or ``offset + i % inner`` with ``inner =
x.numel() // x.shape[0]`` (``batch_shared``: one mask broadcast over the
batch, the MC bank's case). It is kept when its bits are below
``min(floor(keep·2^32), 2^32 - 1)`` and then scaled by ``1/keep`` rounded
to x's dtype, as the JAX MC bank's premultiplied scale masks are
(``tower_dropout_masks(..., dtype=...)`` + ``apply_mask``). ``relu=True``
applies ``x > 0 ? x : 0`` first.

The backward replays the mask from the same (seed, offset) on the
cotangent, as ``_hw_dropout_bwd`` does: ``dx = keep && (!relu || out > 0) ?
g·scale : 0`` with ``out`` the forward's output, so no mask is stored. The
cotangent is brought to the forward's memory format first, since the
stream index follows memory order.

``dropout`` and ``dropout_backward`` send CPU tensors to the plain version
and CUDA tensors to the kernel; anything else raises. ``dropout_autograd``
is the differentiable form. ``LAUNCHES`` counts kernel launches, forward
and backward alike.

``dropout_levels`` takes a list of up to ``MAX_LEVELS`` tensors ("levels")
with a stream offset each, under one seed, rate, mask kind and relu: the
head's mask draw of one (run, tower, layer) over the five FPN levels, one
launch (``pod_dropout_forward_levels``) where ``dropout`` per level takes
five. Its output is ``dropout`` of each level at its offset, bit for bit
(``dropout_levels_plain``); ``dropout_levels_backward`` and
``dropout_levels_autograd`` are its backward (one launch) and its
differentiable form. A single tensor is launched as the group of one.

``dropout_op`` is the forward registered as the PyTorch operator
``pod_compare_tpu_torch::dropout``, with the seed as an int64 0-d tensor on
the CPU: ``torch.export`` records it as one node whose seed is an input of
the program, as the Mosaic custom call is in the JAX package's StableHLO,
so every served call draws fresh masks. Its CPU kernel is the plain
version, its CUDA kernel ``dropout_cuda`` (the seed is read on the host,
with no device sync), and its fake kernel gives the output's shape.
``dropout_levels_op`` is ``dropout_levels`` as the operator
``pod_compare_tpu_torch::dropout_levels`` (a list in, a list out; one node
of a program per (run, tower, layer)), registered the same way.
"""

import ctypes
import functools
import math
from typing import List, Sequence

import torch

LAUNCHES = 0

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8  # tensors one launch takes (csrc/dropout.cu's kMaxLevels)


def keep_threshold(rate: float) -> int:
    """uint32 threshold: an element is kept when its bits are below it."""
    return min(math.floor((1.0 - rate) * 2.0 ** 32), _MASK32)


def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """1/keep rounded to `dtype` (exact as a Python float)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


# ------------------------------------------------------------ plain version
def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of m·b for m < 2^32 and int64 b in [0, 2^32),
    in int64 arithmetic that never overflows."""
    t = m * (b >> 16)  # < 2^48
    s = m * (b & 0xFFFF) + ((t & 0xFFFF) << 16)  # < 2^49
    return (t >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter_lo: torch.Tensor, counter_hi: torch.Tensor, seed: int):
    """Philox4x32-10 of counters (lo, hi, 0, 0) under key (seed lo, seed hi):
    four int64 tensors holding uint32 words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    c0, c1 = counter_lo, counter_hi
    c2 = torch.zeros_like(counter_lo)
    c3 = torch.zeros_like(counter_lo)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(inner: int, offset: int, seed: int, rate: float, device="cpu") -> torch.Tensor:
    """(inner,) bool keep decisions for stream indices offset .. offset+inner-1."""
    q = (offset >> 2) + torch.arange(inner // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(q & _MASK32, q >> 32, seed)
    bits = torch.stack(words, dim=1).reshape(-1)
    return bits < keep_threshold(rate)


def _memory_order(x: torch.Tensor) -> torch.Tensor:
    """A view of x whose logical order is x's memory order."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last
    ):
        return x.permute(0, 2, 3, 1)
    return x


def _restore_order(flat_like_mem: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    mem = _memory_order(x)
    out = flat_like_mem.reshape(mem.shape)
    return out.permute(0, 3, 1, 2) if mem is not x else out


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float, relu: bool = False):
    """x kept where `keep` (broadcasting) and scaled by 1/keep in x's dtype,
    0 elsewhere; with relu, elements not above 0 give 0 as well."""
    if relu:
        keep = keep & (x > 0)
    scaled = x * keep_scale(rate, x.dtype)
    return torch.where(keep, scaled, torch.zeros_like(scaled))


def dropout_plain(
    x: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device."""
    outer, inner = _layout(x, batch_shared, offset)
    keep = keep_mask(inner, offset, seed, rate, x.device)
    flat = _memory_order(x).reshape(outer, inner)
    return _restore_order(apply_keep(flat, keep, rate, relu), x)


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """channels_last when x's memory order is NHWC, else contiguous_format."""
    return torch.channels_last if _memory_order(x) is not x else torch.contiguous_format


def dropout_backward_plain(
    g: torch.Tensor,
    out: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """The backward kernel's function in PyTorch ops: the gradient of
    `dropout(x, ...)` for the cotangent g, given the forward's output."""
    g = g.contiguous(memory_format=memory_format(out))
    outer, inner = _layout(g, batch_shared, offset)
    keep = keep_mask(inner, offset, seed, rate, g.device)
    flat_g = _memory_order(g).reshape(outer, inner)
    if relu:
        keep = keep & (_memory_order(out).reshape(outer, inner) > 0)
    return _restore_order(apply_keep(flat_g, keep, rate), g)


def dropout_levels_plain(
    xs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """The grouped kernel's function in PyTorch ops: `dropout_plain` of
    each level at its offset."""
    _check_group(xs, offsets)
    return [dropout_plain(x, seed, rate, batch_shared, o, relu) for x, o in zip(xs, offsets)]


def dropout_levels_backward_plain(
    gs: Sequence[torch.Tensor],
    outs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """The grouped backward's function in PyTorch ops: `dropout_backward_plain`
    of each level at its offset."""
    _check_group(outs, offsets)
    return [dropout_backward_plain(g, out, seed, rate, batch_shared, o, relu)
            for g, out, o in zip(gs, outs, offsets)]


# ------------------------------------------------------------ kernel
def _check_group(xs: Sequence[torch.Tensor], offsets: Sequence[int]) -> None:
    """A group the kernel takes: 1 to MAX_LEVELS tensors of one dtype on one
    device, an offset each."""
    if not 1 <= len(xs) <= MAX_LEVELS or len(offsets) != len(xs):
        raise ValueError(f"dropout_levels takes 1 to {MAX_LEVELS} tensors with an offset each, "
                         f"got {len(xs)} tensors and {len(offsets)} offsets")
    if any(x.dtype != xs[0].dtype or x.device != xs[0].device for x in xs):
        raise ValueError("dropout_levels needs every level in one dtype on one device")


def _layout(x: torch.Tensor, batch_shared: bool, offset: int):
    """(outer, inner) of the launch; raises on what the kernel does not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dropout takes float32 or bfloat16, not {x.dtype}")
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("dropout needs a contiguous or channels_last tensor")
    if x.numel() == 0 or (batch_shared and x.dim() < 2):
        raise ValueError(f"dropout cannot take shape {tuple(x.shape)}")
    outer = x.shape[0] if batch_shared else 1
    inner = x.numel() // outer
    if inner % 8 or offset % 4 or offset < 0:
        raise ValueError(
            f"dropout needs a per-mask size divisible by 8 and an offset divisible by 4, "
            f"got {inner} and {offset}"
        )
    return outer, inner


class _Level(ctypes.Structure):
    """csrc/dropout.cu's PodDropoutLevel."""

    _fields_ = [("x", ctypes.c_void_p), ("gate", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("inner", ctypes.c_longlong), ("outer", ctypes.c_longlong),
                ("offset", ctypes.c_ulonglong)]


@functools.lru_cache(maxsize=None)
def _library():
    from pod_compare_tpu_torch.ops.kernels import _build

    lib = _build.load("dropout.cu")
    for fn in (lib.pod_dropout_forward_levels, lib.pod_dropout_backward_levels):
        fn.argtypes = [ctypes.POINTER(_Level), ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
                       ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(fn, levels, like: torch.Tensor, seed: int, rate: float, relu: bool) -> None:
    """Launch `fn` on a group of `levels` (x, gate, out pointers; inner,
    outer, offset) on like's device and PyTorch's current stream."""
    global LAUNCHES
    if any(p % 16 for level in levels for p in level[:3]):
        raise ValueError("dropout needs 16-byte aligned storage")
    group = (_Level * len(levels))(*(_Level(*level) for level in levels))
    with torch.cuda.device(like.device):
        err = fn(group, len(levels), _DTYPE_CODES[like.dtype], seed & 0xFFFFFFFFFFFFFFFF,
                 keep_threshold(rate), keep_scale(rate, like.dtype), int(relu),
                 torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1


def dropout_levels_cuda(
    xs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """One launch of the grouped forward of csrc/dropout.cu over `xs`, level
    l at stream offset `offsets[l]`."""
    _check_group(xs, offsets)
    if xs[0].device.type != "cuda":
        raise ValueError(f"dropout_levels_cuda needs CUDA tensors, got {xs[0].device}")
    outs, levels = [], []
    for x, offset in zip(xs, offsets):
        outer, inner = _layout(x, batch_shared, offset)
        out = torch.empty_like(x)
        outs.append(out)
        levels.append((x.data_ptr(), 0, out.data_ptr(), inner, outer, offset))
    _launch(_library().pod_dropout_forward_levels, levels, xs[0], seed, rate, relu)
    return outs


def dropout_levels_backward_cuda(
    gs: Sequence[torch.Tensor],
    outs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """One launch of the grouped backward of csrc/dropout.cu on the
    cotangents `gs`, each brought to the memory format of its level's
    forward output in `outs`."""
    _check_group(outs, offsets)
    if len(gs) != len(outs):
        raise ValueError(f"{len(gs)} cotangents for {len(outs)} levels")
    device = outs[0].device
    if device.type != "cuda" or any(g.device != device for g in gs):
        raise ValueError(f"dropout_levels_backward_cuda needs CUDA tensors, got "
                         f"{[str(g.device) for g in gs]} and {device}")
    # The cotangents in their outputs' memory formats are held in `held`
    # until the launch is queued: one freed earlier could be handed to the
    # next level's copy before the kernel reads it.
    dxs, held, levels = [], [], []
    for g, out, offset in zip(gs, outs, offsets):
        if out.shape != g.shape or out.dtype != g.dtype:
            raise ValueError("dropout_backward needs the cotangent and the forward's output alike")
        g = g.contiguous(memory_format=memory_format(out))
        outer, inner = _layout(g, batch_shared, offset)
        _layout(out, batch_shared, offset)
        dx = torch.empty_like(g)
        held.append(g)
        dxs.append(dx)
        levels.append((g.data_ptr(), out.data_ptr(), dx.data_ptr(), inner, outer, offset))
    _launch(_library().pod_dropout_backward_levels, levels, outs[0], seed, rate, relu)
    return dxs


def dropout_cuda(
    x: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Launch the forward of csrc/dropout.cu on one tensor: the group of one."""
    if x.device.type != "cuda":
        raise ValueError(f"dropout_cuda needs a CUDA tensor, got {x.device}")
    return dropout_levels_cuda([x], seed, rate, batch_shared, [offset], relu)[0]


def dropout_backward_cuda(
    g: torch.Tensor,
    out: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Launch the backward of csrc/dropout.cu on the cotangent g, brought to
    the memory format of the forward's output `out`: the group of one."""
    if g.device.type != "cuda" or out.device != g.device:
        raise ValueError(f"dropout_backward_cuda needs CUDA tensors, got {g.device}, {out.device}")
    return dropout_levels_backward_cuda([g], [out], seed, rate, batch_shared, [offset], relu)[0]


def dropout(
    x: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Dropout (with an optional fused ReLU) of x under `seed`: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, batch_shared, offset, relu)
    if x.device.type == "cuda":
        return dropout_cuda(x, seed, rate, batch_shared, offset, relu)
    raise ValueError(f"dropout has no path for device {x.device}")


# The forward as the PyTorch operator pod_compare_tpu_torch::dropout,
# registered through torch.library.Library rather than custom_op: custom_op
# runs its kernels under torch._disable_dynamo, whose first call in a process
# imports torch._dynamo and whose every call adds host time to the launch.
_LIB = torch.library.Library("pod_compare_tpu_torch", "FRAGMENT")
_LIB.define("dropout(Tensor x, Tensor seed, float rate, bool batch_shared=False, "
            "int offset=0, bool relu=False) -> Tensor")


def _dropout_op_cpu(x, seed, rate, batch_shared=False, offset=0, relu=False):
    return dropout_plain(x, int(seed), rate, batch_shared, offset, relu)


def _dropout_op_cuda(x, seed, rate, batch_shared=False, offset=0, relu=False):
    if seed.device.type != "cpu":
        raise ValueError(f"dropout_op reads its seed on the host; got one on {seed.device}")
    return dropout_cuda(x, int(seed), rate, batch_shared, offset, relu)


_LIB.impl("dropout", _dropout_op_cpu, "CPU")
_LIB.impl("dropout", _dropout_op_cuda, "CUDA")


@torch.library.register_fake("pod_compare_tpu_torch::dropout")
def _dropout_op_fake(x, seed, rate, batch_shared=False, offset=0, relu=False):
    return torch.empty_like(x)


def dropout_op(
    x: torch.Tensor,
    seed: torch.Tensor,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """`dropout` through the operator, its seed an int64 0-d CPU tensor: the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    return torch.ops.pod_compare_tpu_torch.dropout.default(x, seed, rate, batch_shared, offset,
                                                           relu)


def dropout_backward(
    g: torch.Tensor,
    out: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """The gradient of `dropout(x, seed, rate, ...)` for the cotangent g,
    given the forward's output `out`: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if g.device.type == "cpu":
        return dropout_backward_plain(g, out, seed, rate, batch_shared, offset, relu)
    if g.device.type == "cuda":
        return dropout_backward_cuda(g, out, seed, rate, batch_shared, offset, relu)
    raise ValueError(f"dropout_backward has no path for device {g.device}")


def dropout_autograd(
    x: torch.Tensor,
    seed: int,
    rate: float,
    batch_shared: bool = False,
    offset: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """`dropout` with a backward that replays the mask from the seed: the
    group of one of `dropout_levels_autograd`."""
    return dropout_levels_autograd([x], seed, rate, batch_shared, [offset], relu)[0]


# ------------------------------------------------------------ grouped levels
def dropout_levels(
    xs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """`dropout` of each level of `xs` at its offset under one seed: the
    plain version for CPU tensors, one launch of the grouped kernel for CUDA
    tensors."""
    _check_group(xs, offsets)
    if xs[0].device.type == "cpu":
        return dropout_levels_plain(xs, seed, rate, batch_shared, offsets, relu)
    if xs[0].device.type == "cuda":
        return dropout_levels_cuda(xs, seed, rate, batch_shared, offsets, relu)
    raise ValueError(f"dropout_levels has no path for device {xs[0].device}")


def dropout_levels_backward(
    gs: Sequence[torch.Tensor],
    outs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """The gradients of `dropout_levels` for the cotangents `gs`, given the
    forward's outputs: the plain version for CPU tensors, one launch of the
    grouped backward for CUDA tensors."""
    _check_group(outs, offsets)
    if outs[0].device.type == "cpu":
        return dropout_levels_backward_plain(gs, outs, seed, rate, batch_shared, offsets, relu)
    if outs[0].device.type == "cuda":
        return dropout_levels_backward_cuda(gs, outs, seed, rate, batch_shared, offsets, relu)
    raise ValueError(f"dropout_levels_backward has no path for device {outs[0].device}")


_LIB.define("dropout_levels(Tensor[] xs, Tensor seed, float rate, bool batch_shared, "
            "int[] offsets, bool relu) -> Tensor[]")


def _dropout_levels_op_cpu(xs, seed, rate, batch_shared, offsets, relu):
    return dropout_levels_plain(xs, int(seed), rate, batch_shared, offsets, relu)


def _dropout_levels_op_cuda(xs, seed, rate, batch_shared, offsets, relu):
    if seed.device.type != "cpu":
        raise ValueError(f"dropout_levels_op reads its seed on the host; got one on {seed.device}")
    return dropout_levels_cuda(xs, int(seed), rate, batch_shared, offsets, relu)


_LIB.impl("dropout_levels", _dropout_levels_op_cpu, "CPU")
_LIB.impl("dropout_levels", _dropout_levels_op_cuda, "CUDA")


@torch.library.register_fake("pod_compare_tpu_torch::dropout_levels")
def _dropout_levels_op_fake(xs, seed, rate, batch_shared, offsets, relu):
    return [torch.empty_like(x) for x in xs]


def dropout_levels_op(
    xs: Sequence[torch.Tensor],
    seed: torch.Tensor,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """`dropout_levels` through the operator, its seed an int64 0-d CPU
    tensor: one node of an exported program."""
    return torch.ops.pod_compare_tpu_torch.dropout_levels.default(
        list(xs), seed, rate, batch_shared, [int(o) for o in offsets], relu)


class _DropoutLevels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seed, rate, batch_shared, offsets, relu, *xs):
        outs = dropout_levels(xs, seed, rate, batch_shared, offsets, relu)
        ctx.save_for_backward(*outs)
        ctx.args = (seed, rate, batch_shared, offsets, relu)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        dxs = dropout_levels_backward(gs, ctx.saved_tensors, *ctx.args)
        return (None,) * 5 + tuple(dxs)


def dropout_levels_autograd(
    xs: Sequence[torch.Tensor],
    seed: int,
    rate: float,
    batch_shared: bool,
    offsets: Sequence[int],
    relu: bool = False,
) -> List[torch.Tensor]:
    """`dropout_levels` with a backward that replays every level's mask from
    the seed in one launch."""
    return list(_DropoutLevels.apply(seed, rate, batch_shared, list(offsets), relu, *xs))
