"""K3, the FrozenBN epilogue of a backbone convolution: the CUDA kernel
``csrc/frozen_bn.cu`` and its plain PyTorch version, as the operator
``pod_compare_tpu_torch::frozen_bn_act``.

Replaces no Pallas kernel: the JAX package's FrozenBatchNorm
(``pod_compare_tpu/models/layers.py``) is a multiply-add that XLA fuses.
One call computes

    y = relu(z·mul + add [+ r | + (zs·ms + as)])

for a convolution's raw output z, its FrozenBN's per-channel pair (mul,
add), and an identity shortcut r or a projection shortcut's raw output zs
with its own FrozenBN's pair (ms, as). The pair is
detectron2's fold, ``mul = weight·rsqrt(running_var + eps)``, ``add = bias -
running_mean·mul``, computed in the buffers' dtype (float32; bfloat16 in a
model cast for bfloat16 inference, whose activations are bfloat16 too) as
PyTorch's operations on them compute it, each then rounded to z's dtype
(the JAX package's ``astype(self.dtype)``); the chain runs in float32 from
those values in that order and is rounded once to z's dtype. In float32
that is the arithmetic, in its order, of ``x * mul + add``, ``+ shortcut``
and ``F.relu`` as separate operations. A FrozenBN is passed as any object with
``weight``, ``bias``, ``running_mean``, ``running_var`` (C each) and ``eps``.

The backward reads the cotangent g and the forward's output y: ``gm =
threshold_backward(g, y, 0)``, ``gz = gm·mul``, ``gr = gm`` or ``gzs =
gm·ms``, each rounded once; it computes only the gradients asked for.

``frozen_bn_act`` sends CPU tensors to the plain version and CUDA tensors
to the kernel (bfloat16 or float32, 4-D, dense channels-last or NCHW alike,
C a multiple of 8, 16-byte aligned, float32 FrozenBN buffers under float32
tensors; anything else raises, there is no fallback). When autograd
records the call it is a ``torch.autograd.Function`` whose backward is
``frozen_bn_act_backward``; otherwise it is the operator, whose fake
kernel gives the output's shape, so ``torch.export`` records one node a
call. ``pod_compare_tpu_torch::frozen_bn_act_backward`` is the
backward as an operator. ``LAUNCHES`` counts kernel launches, forward and
backward alike.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPE = (1, -1, 1, 1)

# A FrozenBN as the operators take it: (weight, bias, running_mean,
# running_var, eps).
Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]


def stats(norm) -> Stats:
    """A FrozenBN module's buffers and eps, as the operators take them."""
    return norm.weight, norm.bias, norm.running_mean, norm.running_var, float(norm.eps)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


# ------------------------------------------------------------ plain version
def _scale(n: Stats) -> torch.Tensor:
    weight, _, _, var, eps = n
    return weight * torch.rsqrt(var + eps)


def pair(n: Stats, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mul, add) of a FrozenBN, each rounded to `dtype`."""
    mul = _scale(n)
    add = n[1] - n[2] * mul
    return _cast(mul, dtype), _cast(add, dtype)


def _affine(z: torch.Tensor, n: Stats) -> torch.Tensor:
    """z·mul + add in float32, the pair rounded to z's dtype."""
    mul, add = pair(n, z.dtype)
    return z.float() * mul.float().view(_SHAPE) + add.float().view(_SHAPE)


def frozen_bn_plain(z: torch.Tensor, n: Stats) -> torch.Tensor:
    """A FrozenBN alone, without the ReLU: z·mul + add rounded once."""
    return _cast(_affine(z, n), z.dtype)


def frozen_bn_act_plain(
    z: torch.Tensor,
    n: Stats,
    residual: Optional[torch.Tensor] = None,
    shortcut: Optional[torch.Tensor] = None,
    ns: Optional[Stats] = None,
) -> torch.Tensor:
    """The kernel's function in PyTorch operations, on any device."""
    y = _affine(z, n)
    if residual is not None:
        y = y + residual.float()
    elif shortcut is not None:
        y = y + _affine(shortcut, ns)
    return _cast(torch.relu(y), z.dtype)


def frozen_bn_act_backward_plain(
    g: torch.Tensor,
    y: torch.Tensor,
    n: Stats,
    ns: Optional[Stats],
    z_grad: bool,
    side_grad: bool,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernel's function in PyTorch operations: (gz, gside),
    None where not asked for; gside is gm·ms with `ns`, else gm."""
    gm = torch.ops.aten.threshold_backward(g, y, 0)
    gz = gm * _cast(_scale(n), g.dtype).view(_SHAPE) if z_grad else None
    gside = None
    if side_grad:
        gside = gm if ns is None else gm * _cast(_scale(ns), g.dtype).view(_SHAPE)
    return gz, gside


# ------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def _library():
    from pod_compare_tpu_torch.ops.kernels import _build

    lib = _build.load("frozen_bn.cu")
    p, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    lib.pod_frozen_bn_forward_launch.argtypes = [i, i, i, p, p, i, p, p, p, p, p, f, p, p, p, p,
                                                 f, ll, i, ll, p]
    lib.pod_frozen_bn_forward_launch.restype = ctypes.c_int
    lib.pod_frozen_bn_backward_launch.argtypes = [i, i, i, p, p, p, p, p, p, f, p, p, f, ll, i,
                                                  ll, p]
    lib.pod_frozen_bn_backward_launch.restype = ctypes.c_int
    return lib


def _format(x: torch.Tensor) -> torch.memory_format:
    """x's dense memory format; raises on what the kernel does not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"frozen_bn_act takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4 or x.shape[1] % 8:
        raise ValueError(f"frozen_bn_act takes (N, C, H, W) with C a multiple of 8, got "
                         f"{tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if x.is_contiguous():
        return torch.contiguous_format
    raise ValueError(f"frozen_bn_act needs dense channels-last or NCHW memory, got strides "
                     f"{x.stride()}")


def _alike(x: torch.Tensor, t: Optional[torch.Tensor], fmt: torch.memory_format) -> int:
    """t's pointer, after checking it is laid out as x (0 for None)."""
    if t is None:
        return 0
    if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
            or not t.is_contiguous(memory_format=fmt)):
        raise ValueError(f"frozen_bn_act needs its tensors alike: {tuple(t.shape)} {t.dtype} "
                         f"{t.device} {t.stride()} against {tuple(x.shape)} {x.dtype} "
                         f"{x.device} {x.stride()}")
    ptr = t.data_ptr()
    if ptr % 16:
        raise ValueError("frozen_bn_act needs 16-byte aligned storage")
    return ptr


def _buffers(n: Optional[Stats], x: torch.Tensor, fields, dtype: torch.dtype) -> list:
    """Pointers of the FrozenBN buffers `fields` (indices into Stats), and
    its eps; zeros for None."""
    if n is None:
        return [0] * len(fields) + [0.0]
    out = []
    for k in fields:
        b = n[k]
        if (b.dtype != dtype or b.shape != (x.shape[1],) or b.device != x.device
                or not b.is_contiguous()):
            raise ValueError(f"frozen_bn_act needs FrozenBN buffers of {x.shape[1]} elements in "
                             f"{dtype} on {x.device}, got {b.dtype} {tuple(b.shape)} on "
                             f"{b.device}")
        out.append(b.data_ptr())
    return out + [n[4]]


def _stats_dtype(n: Stats, x: torch.Tensor) -> torch.dtype:
    """The FrozenBN buffers' dtype: float32, or bfloat16 in a model cast for
    bfloat16 inference, whose activations x are bfloat16 too."""
    if n[0].dtype != torch.float32 and n[0].dtype != x.dtype:
        raise TypeError(f"frozen_bn_act takes float32 FrozenBN buffers, or bfloat16 ones under "
                        f"bfloat16 tensors, not {n[0].dtype} under {x.dtype}")
    return n[0].dtype


def _launch(fn, x: torch.Tensor, *args) -> None:
    global LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"frozen_bn_act's kernel needs CUDA tensors, got {device}")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frozen_bn kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1


def frozen_bn_act_cuda(
    z: torch.Tensor,
    n: Stats,
    residual: Optional[torch.Tensor] = None,
    shortcut: Optional[torch.Tensor] = None,
    ns: Optional[Stats] = None,
) -> torch.Tensor:
    """One launch of csrc/frozen_bn.cu's forward on z's CUDA device, on
    PyTorch's current stream."""
    fmt = _format(z)
    if residual is not None and shortcut is not None:
        raise ValueError("frozen_bn_act takes a residual or a shortcut, not both")
    if shortcut is not None and ns is None:
        raise ValueError("frozen_bn_act needs the shortcut's FrozenBN")
    side = residual if residual is not None else shortcut
    side_kind = 0 if side is None else (1 if residual is not None else 2)
    sd = _stats_dtype(n, z)
    pointers = (_alike(z, z, fmt), _alike(z, side, fmt))
    norms = (*_buffers(n, z, range(4), sd),
             *_buffers(ns if side_kind == 2 else None, z, range(4), sd))
    y = torch.empty_like(z, memory_format=fmt)
    if z.numel():
        _launch(_library().pod_frozen_bn_forward_launch, z, _DTYPE_CODES[z.dtype],
                _DTYPE_CODES[sd], int(fmt == torch.channels_last), *pointers, side_kind,
                y.data_ptr(), *norms, z.numel(), z.shape[1], z.shape[2] * z.shape[3])
    return y


def frozen_bn_act_backward_cuda(
    g: torch.Tensor,
    y: torch.Tensor,
    n: Stats,
    ns: Optional[Stats],
    z_grad: bool,
    side_grad: bool,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of csrc/frozen_bn.cu's backward on the cotangent g,
    brought to the memory format of the forward's output y."""
    fmt = _format(y)
    g = g.contiguous(memory_format=fmt)
    pointers = (_alike(y, g, fmt), _alike(y, y, fmt))
    sd = _stats_dtype(n, y)
    norms = (*_buffers(n, y, (0, 3), sd), *_buffers(ns, y, (0, 3), sd))
    gz = torch.empty_like(y, memory_format=fmt) if z_grad else None
    gside = torch.empty_like(y, memory_format=fmt) if side_grad else None
    if (z_grad or side_grad) and y.numel():
        _launch(_library().pod_frozen_bn_backward_launch, y, _DTYPE_CODES[y.dtype],
                _DTYPE_CODES[sd], int(fmt == torch.channels_last), *pointers,
                0 if gz is None else gz.data_ptr(), 0 if gside is None else gside.data_ptr(),
                *norms, y.numel(), y.shape[1], y.shape[2] * y.shape[3])
    return gz, gside


# ------------------------------------------------------------ dispatch
def frozen_bn_act_impl(z, n, residual=None, shortcut=None, ns=None) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if z.device.type == "cpu":
        return frozen_bn_act_plain(z, n, residual, shortcut, ns)
    if z.device.type == "cuda":
        return frozen_bn_act_cuda(z, n, residual, shortcut, ns)
    raise ValueError(f"frozen_bn_act has no path for device {z.device}")


def frozen_bn_act_backward_impl(g, y, n, ns, z_grad, side_grad):
    """The backward's plain version for CPU tensors, its kernel for CUDA ones."""
    if y.device.type == "cpu":
        return frozen_bn_act_backward_plain(g, y, n, ns, z_grad, side_grad)
    if y.device.type == "cuda":
        return frozen_bn_act_backward_cuda(g, y, n, ns, z_grad, side_grad)
    raise ValueError(f"frozen_bn_act_backward has no path for device {y.device}")


# The operators, registered through torch.library.Library as the dropout
# operator is (ops/kernels/dropout.py). A FrozenBN's buffers are separate
# arguments; the shortcut's are None without a projection shortcut.
_LIB = torch.library.Library("pod_compare_tpu_torch", "FRAGMENT")
_LIB.define("frozen_bn_act(Tensor z, Tensor weight, Tensor bias, Tensor running_mean, "
            "Tensor running_var, float eps, Tensor? residual, Tensor? shortcut, "
            "Tensor? weight_s, Tensor? bias_s, Tensor? running_mean_s, Tensor? running_var_s, "
            "float eps_s) -> Tensor")
_LIB.define("frozen_bn_act_backward(Tensor grad, Tensor out, Tensor weight, Tensor running_var, "
            "float eps, Tensor? weight_s, Tensor? running_var_s, float eps_s, bool z_grad, "
            "bool side_grad) -> Tensor[]")


def _op_stats(weight, bias, mean, var, eps) -> Optional[Stats]:
    return None if weight is None else (weight, bias, mean, var, eps)


def _frozen_bn_act_op(z, weight, bias, mean, var, eps, residual, shortcut, weight_s, bias_s,
                      mean_s, var_s, eps_s):
    return frozen_bn_act_impl(z, (weight, bias, mean, var, eps), residual, shortcut,
                              _op_stats(weight_s, bias_s, mean_s, var_s, eps_s))


def _frozen_bn_act_backward_op(grad, out, weight, var, eps, weight_s, var_s, eps_s, z_grad,
                               side_grad):
    # The backward reads only the scale's buffers, weight and running_var.
    gz, gside = frozen_bn_act_backward_impl(
        grad, out, (weight, None, None, var, eps), _op_stats(weight_s, None, None, var_s, eps_s),
        z_grad, side_grad)
    return [t for t in (gz, gside) if t is not None]


for _key in ("CPU", "CUDA"):
    _LIB.impl("frozen_bn_act", _frozen_bn_act_op, _key)
    _LIB.impl("frozen_bn_act_backward", _frozen_bn_act_backward_op, _key)


@torch.library.register_fake("pod_compare_tpu_torch::frozen_bn_act")
def _frozen_bn_act_fake(z, weight, bias, mean, var, eps, residual, shortcut, weight_s, bias_s,
                        mean_s, var_s, eps_s):
    return torch.empty_like(z)


@torch.library.register_fake("pod_compare_tpu_torch::frozen_bn_act_backward")
def _frozen_bn_act_backward_fake(grad, out, weight, var, eps, weight_s, var_s, eps_s, z_grad,
                                 side_grad):
    return [torch.empty_like(out) for _ in range(int(z_grad) + int(side_grad))]


class _FrozenBNAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, residual, shortcut, n, ns):
        y = frozen_bn_act_impl(z, n, residual, shortcut, ns)
        ctx.save_for_backward(y)
        ctx.args = (n, ns)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        n, ns = ctx.args
        z_grad, r_grad, s_grad = ctx.needs_input_grad[:3]
        side = (None, None, 1e-5) if ns is None else (ns[0], ns[3], ns[4])
        grads = torch.ops.pod_compare_tpu_torch.frozen_bn_act_backward.default(
            g, y, n[0], n[3], n[4], *side, z_grad, r_grad or s_grad)
        gz = grads.pop(0) if z_grad else None
        gside = grads.pop(0) if (r_grad or s_grad) else None
        return gz, gside if r_grad else None, gside if s_grad else None, None, None


def frozen_bn_act(
    z: torch.Tensor,
    norm,
    residual: Optional[torch.Tensor] = None,
    shortcut: Optional[torch.Tensor] = None,
    shortcut_norm=None,
) -> torch.Tensor:
    """relu(norm(z) [+ residual | + shortcut_norm(shortcut)]) in one pass:
    the autograd Function when autograd records the call, else the
    operator."""
    n = stats(norm)
    ns = stats(shortcut_norm) if shortcut is not None else None
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (z, residual, shortcut)):
        return _FrozenBNAct.apply(z, residual, shortcut, n, ns)
    return torch.ops.pod_compare_tpu_torch.frozen_bn_act.default(
        z, *n, residual, shortcut, *(ns or (None, None, None, None, 1e-5)))
