"""The counter-based bits and host seeds the program draws, frozen.

Frozen copies, at commit b304412 of this repository, of:
  - the Philox4x32-10 keep decisions of the dropout kernel K1
    (``pod_compare_tpu_torch/ops/kernels/dropout.py``: ``philox4x32_10``,
    ``keep_mask``, ``keep_threshold``, ``keep_scale``; the level offsets of
    ``models/retinanet.py::level_offsets``);
  - the lowbias32 stream and Box-Muller normals of the focal kernel K2
    (``ops/kernels/focal.py``: ``lowbias32``, ``stream_keys``,
    ``uniforms``);
  - the seeds an inference call and a train step draw on the host
    (``inference/seeds.py::draw_call_seeds``,
    ``train/trainer.py::TrainStep.draw_seeds``).

They are the bits of the function the kernels compute, not of their
implementation; a later change to the program that changes them changes
the function, and this copy holds it to the old one.
"""

import math
from typing import List, Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
SEED_HIGH = 2 ** 63 - 1
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_FOCAL_BLOCK = 65536
_DRAW_STEP = 0x9E3779B9
_SEED_STEP = 0x85EBCA6B


# ------------------------------------------------------------ K1's masks
def keep_threshold(rate: float) -> int:
    return min(math.floor((1.0 - rate) * 2.0 ** 32), MASK32)


def keep_scale(rate: float, dtype: torch.dtype = torch.float32) -> float:
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _mulhilo(m: int, b: torch.Tensor):
    t = m * (b >> 16)
    s = m * (b & 0xFFFF) + ((t & 0xFFFF) << 16)
    return (t >> 16) + (s >> 32), s & MASK32


def philox4x32_10(counter_lo: torch.Tensor, counter_hi: torch.Tensor, seed: int):
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    c0, c1 = counter_lo, counter_hi
    c2 = torch.zeros_like(counter_lo)
    c3 = torch.zeros_like(counter_lo)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & MASK32
            k1 = (k1 + _PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(count: int, offset: int, seed: int, rate: float, device) -> torch.Tensor:
    """(count,) keep decisions of stream indices offset .. offset + count - 1
    (offset and count multiples of 4)."""
    q = (offset >> 2) + torch.arange(count // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(q & MASK32, q >> 32, seed)
    return torch.stack(words, dim=1).reshape(-1) < keep_threshold(rate)


def level_offsets(shapes: Sequence[Sequence[int]], batch_shared: bool) -> List[int]:
    """Stream offset of each level of one (tower, layer) draw over NCHW
    `shapes`: per image when the mask is shared by the batch, else per
    batch."""
    offsets, total = [], 0
    for n, c, h, w in shapes:
        offsets.append(total)
        total += c * h * w * (1 if batch_shared else n)
    return offsets


def keep_nchw(shape, offset: int, seed: int, rate: float, batch_shared: bool, device):
    """Keep decisions of one level as an NCHW bool tensor ((1, C, H, W)
    when shared by the batch). The stream follows the channels-last memory
    order the program's activations have: (n, h, w, c)."""
    n, c, h, w = shape
    rows = 1 if batch_shared else n
    keep = keep_mask(rows * h * w * c, offset, seed, rate, device)
    return keep.reshape(rows, h, w, c).permute(0, 3, 1, 2)


# ------------------------------------------------------------ K2's normals
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def focal_normals(n: int, seed: int, num_samples: int, device) -> torch.Tensor:
    """(num_samples, n) float32 normals of stream indices 0 .. n - 1 under
    the int32 `seed`: Box-Muller pairs on 24-bit uniforms of lowbias32."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    block_seed = ((seed & MASK32) + i // _FOCAL_BLOCK) & MASK32
    keys = (i % _FOCAL_BLOCK + _mul32(block_seed, _SEED_STEP)) & MASK32

    def uniforms(draw):
        bits = _lowbias32((keys + (draw * _DRAW_STEP & MASK32)) & MASK32)
        return ((bits >> 8).to(torch.float32) + 1.0) * (1.0 / (1 << 24))

    zs = []
    for pair in range((num_samples + 1) // 2):
        r = torch.sqrt(-2.0 * torch.log(uniforms(2 * pair)))
        theta = 2.0 * math.pi * uniforms(2 * pair + 1)
        zs += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(zs[:num_samples])


# ------------------------------------------------------------ host seeds
def draw_seeds(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, SEED_HIGH, shape, generator=generator, dtype=torch.int64)


def call_dropout_seeds(call_seed: int, num_runs: int, num_convs: int) -> torch.Tensor:
    """The (M, 2, num_convs) mask seeds of an inference call whose CPU
    generator was seeded with `call_seed`."""
    dropout_seed, _ = draw_seeds(torch.Generator().manual_seed(call_seed), (2,)).tolist()
    return draw_seeds(torch.Generator().manual_seed(dropout_seed), (num_runs, 2, num_convs))


def step_seeds(generator: torch.Generator, num_convs: int) -> Tuple[List[List[int]], int]:
    """seeds[tower][layer] of one step's masks and its int32 loss seed."""
    flat = torch.randint(0, SEED_HIGH, (2 * num_convs,), generator=generator).tolist()
    loss_seed = int(torch.randint(-(2 ** 31), 2 ** 31 - 1, (1,), generator=generator))
    return [flat[:num_convs], flat[num_convs:]], loss_seed
