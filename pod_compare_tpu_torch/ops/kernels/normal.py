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
    r      = sqrt(-2 ln u1)
    normals r cos(2pi u2), r sin(2pi u2)

in float32, rounded once to the output's dtype, by the arithmetic of
``csrc/normal.cu``: ``-2 ln u1`` from u1's exponent and a degree-7
polynomial of its mantissa (``neg2_log``), the correctly rounded square
root, and the cosine and sine from the angle in turns, reduced exactly to
a quadrant and a fraction f in [-1/2, 1/2] with polynomials in f^2
(``cos_sin_turn``). Every FMA of the kernel is an exact ``fma`` here (the
product in float64, the sum rounded once to float32), so the plain
version gives the kernel's bits on any device. Against float64
Box–Muller of the same words every normal of magnitude 1e-3 or more lies
within 3.3 ulps, and the smaller ones within 1.5e-10 (``MAX_ULPS``,
``tests/test_torch_normal.py``). So a stream can be drawn
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
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's float32 constants (csrc/normal.cu), each a float32 value
# written exactly: q(t) of -2 ln(1 + t) = t (-2 + t q(t)) from its constant
# term up; -2 ln 2 over 2^23; sin(pi f / 2) = f SIN_HI + f (SIN_LO + s P(s))
# and cos(pi f / 2) = 1 + s Q(s) for s = f^2.
_LOG_Q = (0.9999997019767761, -0.6666659116744995, 0.5000836253166199, -0.4001132845878601,
          0.3296448588371277, -0.28168338537216187, 0.3009038269519806, -0.27204057574272156)
_NEG2_LN2_OVER_2P23 = -1.6525916635146132e-07
_SIN_HI, _SIN_LO = 1.5707963705062866, -4.371138828673793e-08
_SIN_P = (-0.6459640264511108, 0.07968701422214508, -0.004621904343366623)
_COS_Q = (-1.2337005138397217, 0.253669410943985, -0.020861517637968063, 0.0009067110368050635)
_ROUND_MAGIC = 12582912.0  # 1.5 * 2^23: adding it rounds to an integer
# Against float64 Box-Muller of the same words, for normals of magnitude
# MAX_ULPS_ABOVE or more (a sample of 12.5 million normals holding the 1500
# worst u1 of all 2^24 against the 1500 worst u2: 3.3); the smaller ones
# within MAX_ABS_BELOW (1.5e-10).
MAX_ULPS, MAX_ULPS_ABOVE, MAX_ABS_BELOW = 4.0, 1e-3, 2e-10


def stream_span(n: int) -> int:
    """Stream indices a region of `n` normals takes, rounded up to whole
    Philox blocks of four."""
    return -(-int(n) // 4) * 4


# ------------------------------------------------------------ plain version
def u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 uniforms in (0, 1]: the top 24 bits,
    + 1, over 2^24 (exact)."""
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else float(v)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as the card's FMA: the product is
    exact in float64, and the float64 sum, rounded again to float32, can
    differ from one rounding only where it lands on a float32 midpoint;
    there the sum's exact error (TwoSum) decides. a, b, c: float32 tensors
    or floats holding float32 values; at least one a tensor."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    r = s.to(torch.float32)
    d = s - r.double()
    inf = torch.full_like(r, math.inf)
    toward = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    beyond = (d != 0) & (2 * d == toward.double() - r.double()) & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(beyond, toward, r)


def neg2_log(u: torch.Tensor) -> torch.Tensor:
    """-2 ln u of float32 u in (0, 1], as the kernel computes it: u = 2^e m
    with m in [2/3, 4/3), t = m - 1 (exact), t (-2 + t q(t)) + e (-2 ln 2)."""
    bits = u.view(torch.int32).to(torch.int64)
    e_bits = (bits - 0x3F2AAAAB) & ~0x7FFFFF
    t = (bits - e_bits).to(torch.int32).view(torch.float32) - 1.0
    q = torch.full_like(t, _LOG_Q[7])
    for k in range(6, -1, -1):
        q = fma(q, t, _LOG_Q[k])
    return fma(e_bits.to(torch.float32), _NEG2_LN2_OVER_2P23, t * fma(t, q, -2.0))


def cos_sin_turn(u: torch.Tensor):
    """(cos 2pi u, sin 2pi u) of float32 u = m / 2^24, as the kernel
    computes them: 4u = k + f exactly, the polynomials at f, and the
    quadrant k mod 4 swapping the two and setting their signs."""
    j = fma(u, 4.0, _ROUND_MAGIC)
    f = fma(u, 4.0, -(j - _ROUND_MAGIC))
    quadrant = j.view(torch.int32)
    s = f * f
    p = fma(fma(_SIN_P[2], s, _SIN_P[1]), s, _SIN_P[0])
    sn = fma(f, _SIN_HI, f * fma(s, p, _SIN_LO))
    q = fma(fma(fma(_COS_Q[3], s, _COS_Q[2]), s, _COS_Q[1]), s, _COS_Q[0])
    cs = fma(s, q, 1.0)
    odd = (quadrant & 1) == 1
    a, b = torch.where(odd, cs, sn), torch.where(odd, sn, cs)
    return (torch.where(((quadrant + 1) & 2) != 0, -b, b),
            torch.where((quadrant & 2) != 0, -a, a))


def box_muller(a: torch.Tensor, b: torch.Tensor):
    """(r cos t, r sin t) of two word tensors: r = sqrt(-2 ln u01(a)),
    t = 2pi u01(b), in float32, bit for bit as the kernel's."""
    # The correctly rounded square root, as __fsqrt_rn: through float64,
    # whose one rounding back to float32 is exact for a square root; torch's
    # float32 sqrt on the CPU is not always the nearest float.
    r = torch.sqrt(neg2_log(u01(a)).double()).to(torch.float32)
    c, s = cos_sin_turn(u01(b))
    return r * c, r * s


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
