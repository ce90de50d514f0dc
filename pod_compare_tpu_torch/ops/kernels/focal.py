"""Stochastic (loss-attenuation) focal loss: the CUDA kernel ``csrc/focal.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``pod_compare_tpu/ops/pallas/focal.py``
(``stochastic_focal_elem_pallas``). Per element of float32 logits ``x``,
log-variances ``s`` and targets ``t`` it returns three planes: the mean over
``num_samples`` draws of the focal loss at ``y = x + exp(clip(s, ±10)/2)·z``,
and its mean derivatives with respect to ``x`` and ``s`` (the latter zero
where the clamp is active). The normals ``z`` come from Box–Muller on
24-bit uniforms whose bits are the JAX package's CPU definition
(``_hash_bits``, lowbias32, keyed per 65536-element block as its interpret
mode keys them), so the plain version matches the JAX kernel run in
interpret mode to float32 rounding, and the CUDA kernel matches the plain
version on the card. Element ``i`` of the flat arrays draws at stream index
``index_base + i``: 0 for a whole batch; a process of a data-parallel step
passes the flat index of its first element in the global batch, and so
draws what one process draws for those elements.

``focal`` sends a CPU tensor to the plain version and a CUDA tensor to the
kernel; anything else raises. ``stochastic_focal_elem`` wraps it in an
``autograd.Function`` whose backward multiplies the cotangent by the saved
gradient planes. ``LAUNCHES`` counts kernel launches.
"""

import ctypes
import functools
import math

import torch

LAUNCHES = 0

LOG_VAR_CLAMP = 10.0
BLOCK = 65536  # the TPU kernel's 128 x 512 block: part of the stream's key
_MASK32 = 0xFFFFFFFF
_DRAW_STEP = 0x9E3779B9
_SEED_STEP = 0x85EBCA6B
_TWO_PI = 2.0 * math.pi


# ------------------------------------------------------------ plain version
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, without int64
    overflow: c is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer hash of int64 tensors holding uint32 words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_keys(n: int, seed: int, device="cpu", index_base: int = 0) -> torch.Tensor:
    """(n,) int64 hash keys of stream indices index_base .. index_base+n-1
    under the int32 `seed`: local + (seed + block)·0x85EBCA6B mod 2^32,
    block = i // 65536, local = i % 65536."""
    i = torch.arange(index_base, index_base + n, dtype=torch.int64, device=device)
    block_seed = ((seed & _MASK32) + i // BLOCK) & _MASK32
    return (i % BLOCK + _mul32(block_seed, _SEED_STEP)) & _MASK32


def uniforms(keys: torch.Tensor, draw: int) -> torch.Tensor:
    """float32 uniforms in (0, 1] of one draw: the top 24 bits of the hash,
    plus one, over 2^24."""
    bits = lowbias32((keys + (draw * _DRAW_STEP & _MASK32)) & _MASK32)
    return ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))


def focal_terms(y: torch.Tensor, t: torch.Tensor, alpha: float, gamma: float):
    """Elementwise focal loss and its derivative in the logit `y`:
    q = |t - p|, loss = alpha_t·ce·q^gamma,
    dloss/dy = -(2t-1)·alpha_t·q^(gamma-1)·(q^2 + gamma·p·(1-p)·ce)."""
    p = torch.sigmoid(y)
    ce = torch.clamp_min(y, 0.0) - y * t + torch.log1p(torch.exp(-y.abs()))
    q = (t - p).abs()
    if gamma == 2.0:
        q_gm1, q_g = q, q * q
    else:
        q_gm1 = torch.pow(q, gamma - 1.0)
        q_g = q_gm1 * q
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = alpha_t * ce * q_g
    dldy = -(2.0 * t - 1.0) * alpha_t * q_gm1 * (q * q + gamma * p * (1.0 - p) * ce)
    return loss, dldy


def focal_plain(x, s, t, seed: int, num_samples: int, alpha: float = 0.25,
                gamma: float = 2.0, index_base: int = 0):
    """The kernel's function in PyTorch ops, on any device: (loss, gx, gs)
    shaped like x."""
    _check(x, s, t, num_samples, index_base)
    shape = x.shape
    x, s, t = (a.reshape(-1) for a in (x, s, t))
    keys = stream_keys(x.numel(), seed, x.device, index_base)
    sc = torch.clamp(s, -LOG_VAR_CLAMP, LOG_VAR_CLAMP)
    std = torch.exp(0.5 * sc)
    gate = ((s > -LOG_VAR_CLAMP) & (s < LOG_VAR_CLAMP)).to(torch.float32)
    acc_l = torch.zeros_like(x)
    acc_gx = torch.zeros_like(x)
    acc_gz = torch.zeros_like(x)
    for pair in range((num_samples + 1) // 2):
        u1 = uniforms(keys, 2 * pair)
        u2 = uniforms(keys, 2 * pair + 1)
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = _TWO_PI * u2
        zs = (r * torch.cos(theta), r * torch.sin(theta))
        take = 2 if 2 * pair + 2 <= num_samples else 1
        for z in zs[:take]:
            loss, dldy = focal_terms(x + std * z, t, alpha, gamma)
            acc_l = acc_l + loss
            acc_gx = acc_gx + dldy
            acc_gz = acc_gz + dldy * z
    inv_n = 1.0 / num_samples
    return (
        (acc_l * inv_n).reshape(shape),
        (acc_gx * inv_n).reshape(shape),
        (acc_gz * (0.5 * inv_n) * std * gate).reshape(shape),
    )


# ------------------------------------------------------------ kernel
def _check(x, s, t, num_samples: int, index_base: int = 0) -> None:
    """Raises on what the kernel does not take."""
    for name, a in (("logits", x), ("log-variances", s), ("targets", t)):
        if a.dtype != torch.float32:
            raise TypeError(f"focal takes float32 {name}, not {a.dtype}")
        if a.shape != x.shape or a.device != x.device:
            raise ValueError(f"focal needs {name} of x's shape and device, got "
                             f"{tuple(a.shape)} on {a.device}")
    if x.numel() == 0 or num_samples < 1 or index_base < 0:
        raise ValueError(f"focal cannot take {x.numel()} elements, {num_samples} samples and "
                         f"index base {index_base}")


@functools.lru_cache(maxsize=None)
def _library():
    from pod_compare_tpu_torch.ops.kernels import _build

    fn = _build.load("focal.cu").pod_focal_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _int32(seed: int) -> int:
    """`seed` as the int32 the JAX kernel takes (two's complement wrap)."""
    seed &= _MASK32
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def focal_cuda(x, s, t, seed: int, num_samples: int, alpha: float = 0.25,
               gamma: float = 2.0, index_base: int = 0):
    """Launch csrc/focal.cu on x's device and PyTorch's current stream."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"focal_cuda needs CUDA tensors, got {x.device}")
    _check(x, s, t, num_samples, index_base)
    x, s, t = x.contiguous(), s.contiguous(), t.contiguous()
    loss, gx, gs = (torch.empty_like(x) for _ in range(3))
    fn = _library()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), s.data_ptr(), t.data_ptr(), loss.data_ptr(), gx.data_ptr(),
            gs.data_ptr(), x.numel(), index_base, _int32(seed), num_samples, alpha, gamma,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"focal kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return loss, gx, gs


def focal(x, s, t, seed: int, num_samples: int, alpha: float = 0.25, gamma: float = 2.0,
          index_base: int = 0):
    """(loss, gx, gs) of the stochastic focal loss under the int32 `seed`,
    element i at stream index `index_base` + i: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return focal_plain(x, s, t, _int32(seed), num_samples, alpha, gamma, index_base)
    if x.device.type == "cuda":
        return focal_cuda(x, s, t, seed, num_samples, alpha, gamma, index_base)
    raise ValueError(f"focal has no path for device {x.device}")


class _StochasticFocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, t, seed, num_samples, alpha, gamma, index_base):
        loss, gx, gs = focal(x, s, t, seed, num_samples, alpha, gamma, index_base)
        ctx.save_for_backward(gx, gs)
        return loss

    @staticmethod
    def backward(ctx, ct):
        gx, gs = ctx.saved_tensors
        return ct * gx, ct * gs, None, None, None, None, None, None


def stochastic_focal_elem(x, s, t, seed: int, num_samples: int, alpha: float = 0.25,
                          gamma: float = 2.0, index_base: int = 0) -> torch.Tensor:
    """Per-element mean-over-samples attenuated focal loss, differentiable in
    `x` and `s` (the counterpart of ``stochastic_focal_elem_pallas``)."""
    return _StochasticFocal.apply(x, s, t, seed, num_samples, alpha, gamma, index_base)
