"""Counter-based standard normals: the CUDA kernel ``csrc/normal.cu`` and its
plain PyTorch version, as the operator ``pod_compare_tpu_torch::normal``.

Replaces no TPU kernel: the JAX package draws its Monte-Carlo sampling
banks with ``jax.random.normal`` (XLA's threefry) from a key that is an
input of its exported program. The port's served program cannot take a
``torch.Generator``, so its banks draw from a seed tensor instead, through
this operator. Element ``i`` of the output, counted in memory order, is
stream index ``offset + i`` of the seed's stream: Philox4x32-10 (the
dropout kernel's, ``dropout.philox4x32_10``) keyed on the seed's two 32-bit
words with counter ``(offset + i) // 4`` gives four words; each pair of
words gives two normals by Box–Muller,

    u1, u2 = ((w >> 8) + 1) / 2^24 of each word     (in (0, 1])
    r, t   = sqrt(-2 log u1), 2pi u2
    normals r cos t, r sin t

in float32, rounded once to the output's dtype. So a stream can be drawn
from any offset, and a draw at offset k equals the matching slice of a
longer draw. A caller that draws several banks from one seed gives each a
region of the stream (``stream_span`` rounds a region up to whole Philox
blocks of four).

With ``index`` (C int64 row numbers in [0, rows), on like's device), the
output is (S, C, 4) rows of an (S, rows, 4) bank that is never drawn
whole: element (s, c, j) is stream index offset + 4 (s rows + index[c]) + j,
one Philox block a row. The sampled box decode draws its candidates'
normals so, keyed by their anchors (``inference/core.py``), so that a
candidate's normals do not depend on its rank among the candidates.

``normal(seed, shape, like, offset)`` calls the operator, whose tensors are
``like`` (the output takes its dtype and device, so that a CUDA ``like``
dispatches to the CUDA kernel) and ``seed``, an int64 0-d tensor on the
CPU, read on the host: ``torch.export`` records the seed as an input of the
program, so every served call draws what the live call draws. Its CPU
kernel is the plain version, its CUDA kernel ``normal_cuda`` (float32 and
bfloat16; anything else raises, there is no fallback), and its fake kernel
gives the output's shape. ``LAUNCHES`` counts kernel launches.
"""

import ctypes
import functools
import math

import torch

from pod_compare_tpu_torch.ops.kernels.dropout import philox4x32_10

LAUNCHES = 0

_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586  # rounded to float32 where it multiplies a float32 tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stream_span(n: int) -> int:
    """Stream indices a region of `n` normals takes, rounded up to whole
    Philox blocks of four."""
    return -(-int(n) // 4) * 4


# ------------------------------------------------------------ plain version
def u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 uniforms in (0, 1]: the top 24 bits,
    + 1, over 2^24 (exact)."""
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def box_muller(a: torch.Tensor, b: torch.Tensor):
    """(r cos t, r sin t) of two word tensors: r = sqrt(-2 log u01(a)),
    t = 2pi u01(b), in float32."""
    r = torch.sqrt(-2.0 * torch.log(u01(a)))
    t = u01(b) * _TWO_PI
    return r * torch.cos(t), r * torch.sin(t)


def _block_normals(q: torch.Tensor, seed: int) -> torch.Tensor:
    """(..., 4) float32 normals of Philox blocks q (int64) under `seed`."""
    w = philox4x32_10(q & _MASK32, q >> 32, seed)
    z0, z1 = box_muller(w[0], w[1])
    z2, z3 = box_muller(w[2], w[3])
    return torch.stack((z0, z1, z2, z3), dim=-1)


def normal_plain(shape, seed: int, offset: int = 0, dtype=torch.float32,
                 device="cpu", index=None, rows: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device: normals of
    stream indices offset .. offset + numel - 1 under `seed`, or with
    `index` the rows of an (S, rows, 4) bank (module docstring)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    _check(n, offset)
    if index is not None:
        _check_rows(shape, offset, index, rows)
        s = torch.arange(shape[0], dtype=torch.int64, device=device)
        q = (offset >> 2) + s[:, None] * rows + index.to(device=device, dtype=torch.int64)[None]
        return _block_normals(q, seed).to(dtype)
    if n == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    q_first = offset >> 2
    q = q_first + torch.arange(((offset + n - 1) >> 2) - q_first + 1, dtype=torch.int64,
                               device=device)
    z = _block_normals(q, seed).reshape(-1)
    start = offset & 3
    return z[start:start + n].to(dtype, copy=True).reshape(shape)


# ------------------------------------------------------------ kernel
def _check(n: int, offset: int) -> None:
    if offset < 0 or n < 0:
        raise ValueError(f"normal needs a size and an offset >= 0, got {n} and {offset}")


def _check_rows(shape, offset: int, index: torch.Tensor, rows: int) -> None:
    if (len(shape) != 3 or shape[2] != 4 or index.dim() != 1 or index.shape[0] != shape[1]
            or offset % 4 or rows <= 0):
        raise ValueError(f"normal by rows needs a shape (S, C, 4) for C = len(index), an "
                         f"offset divisible by 4 and rows > 0, got {shape}, "
                         f"{tuple(index.shape)}, {offset} and {rows}")


@functools.lru_cache(maxsize=None)
def _library():
    from pod_compare_tpu_torch.ops.kernels import _build

    lib = _build.load("normal.cu")
    lib.pod_normal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.pod_normal.restype = ctypes.c_int
    lib.pod_philox_words.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                                     ctypes.c_ulonglong, ctypes.c_void_p]
    lib.pod_philox_words.restype = ctypes.c_int
    lib.pod_normal_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.pod_normal_rows.restype = ctypes.c_int
    return lib


def philox_words_cuda(blocks: int, q_first: int, seed: int, device="cuda") -> torch.Tensor:
    """(blocks, 4) int64 Philox words of blocks q_first .. q_first + blocks
    - 1 under `seed`, drawn on the card by csrc/normal.cu's device function:
    to hold against ``dropout.philox4x32_10``. Not a launch of the normal
    kernel (``LAUNCHES`` does not count it)."""
    out = torch.empty((blocks, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        err = _library().pod_philox_words(out.data_ptr(), blocks, q_first,
                                          seed & 0xFFFFFFFFFFFFFFFF,
                                          torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox words kernel launch failed with cudaError_t {err}")
    return out.to(torch.int64) & _MASK32


def normal_cuda(shape, seed: int, offset: int, like: torch.Tensor, index=None,
                rows: int = 0) -> torch.Tensor:
    """Launch csrc/normal.cu: normals of `shape` in like's dtype on like's
    CUDA device, on PyTorch's current stream (with `index`, the rows of an
    (S, rows, 4) bank: ``pod_normal_rows``)."""
    global LAUNCHES
    if like.device.type != "cuda":
        raise ValueError(f"normal_cuda needs a CUDA tensor, got {like.device}")
    if like.dtype not in _DTYPE_CODES:
        raise TypeError(f"normal_cuda gives float32 or bfloat16, not {like.dtype}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    _check(n, offset)
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    if index is not None:
        _check_rows(shape, offset, index, rows)
        if index.device != like.device:
            raise ValueError(f"normal_cuda needs the index on {like.device}, got {index.device}")
        index = index.to(torch.int64).contiguous()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(like.device).cuda_stream
    with torch.cuda.device(like.device):
        if index is None:
            err = _library().pod_normal(out.data_ptr(), _DTYPE_CODES[like.dtype], n, offset,
                                        seed & 0xFFFFFFFFFFFFFFFF, stream)
        else:
            err = _library().pod_normal_rows(out.data_ptr(), index.data_ptr(),
                                             _DTYPE_CODES[like.dtype], shape[0], shape[1], rows,
                                             offset, seed & 0xFFFFFFFFFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"normal kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out


# The operator pod_compare_tpu_torch::normal, registered through
# torch.library.Library as the dropout operator is (ops/kernels/dropout.py).
_LIB = torch.library.Library("pod_compare_tpu_torch", "FRAGMENT")
_LIB.define("normal(Tensor like, Tensor seed, int[] shape, int offset=0, Tensor? index=None, "
            "int rows=0) -> Tensor")


def _seed_on_host(seed: torch.Tensor) -> int:
    if seed.device.type != "cpu":
        raise ValueError(f"normal reads its seed on the host; got one on {seed.device}")
    return int(seed)


def _normal_op_cpu(like, seed, shape, offset=0, index=None, rows=0):
    return normal_plain(shape, _seed_on_host(seed), offset, like.dtype, like.device, index, rows)


def _normal_op_cuda(like, seed, shape, offset=0, index=None, rows=0):
    return normal_cuda(shape, _seed_on_host(seed), offset, like, index, rows)


_LIB.impl("normal", _normal_op_cpu, "CPU")
_LIB.impl("normal", _normal_op_cuda, "CUDA")


@torch.library.register_fake("pod_compare_tpu_torch::normal")
def _normal_op_fake(like, seed, shape, offset=0, index=None, rows=0):
    return like.new_empty(shape)


def normal(seed, shape, like: torch.Tensor, offset: int = 0, index=None,
           rows: int = 0) -> torch.Tensor:
    """Standard normals of `shape` in like's dtype and on like's device:
    stream indices offset .. offset + numel - 1 of `seed` (an int64 0-d CPU
    tensor, or an int), or with `index` the rows of an (S, rows, 4) bank
    (module docstring), through the operator: the plain version for a CPU
    `like`, the CUDA kernel for a CUDA one."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(int(seed), dtype=torch.int64)
    return torch.ops.pod_compare_tpu_torch.normal.default(
        like, seed, [int(s) for s in shape], int(offset), index, int(rows))
