"""The CUDA normal kernel (``csrc/normal.cu``) against its plain PyTorch
version, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_normal_cuda.py

The Philox words are held bit for bit. The normals are held bit for bit
against the plain version, on the card and on the CPU: the kernel's
arithmetic is FMAs, a correctly rounded square root and multiplies, written
out so that nvcc contracts nothing, and the plain version does each FMA
exactly (``normal.fma``). Against float64 Box-Muller of the same words, at
the flagship's class bank, every normal of magnitude 1e-3 or more lies
within ``normal.MAX_ULPS`` (4) ulps and the smaller ones within
``normal.MAX_ABS_BELOW``; the test of the CPU within 8 ulps predates the
bit-for-bit contract and still holds.
"""

import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import normal as kn

MAX_ULPS = 8


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps of the larger magnitude (a, b float32)."""
    a, b = a.double(), b.double()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(torch.maximum(a.abs(), b.abs()))[1] - 24)
    return (a - b).abs() / ulp


@pytest.mark.parametrize("seed,q_first", [(0, 0), (123456789, 77), (2 ** 64 - 1, 2 ** 33 - 3)])
def test_philox_words_match_the_plain_version_bit_for_bit(seed, q_first):
    _cuda()
    blocks = 300_000  # past one pass of the grid (one wave: at most 132 x 8 blocks of 256)
    got = kn.philox_words_cuda(blocks, q_first, seed).cpu()
    q = q_first + torch.arange(blocks, dtype=torch.int64)
    want = torch.stack(kd.philox4x32_10(q & 0xFFFFFFFF, q >> 32, seed), dim=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 6, 4 * 2 ** 33 + 1])
@pytest.mark.parametrize("shape", [(10, 1766, 7), (100, 454, 4), (3,), (4, 1, 7)])
def test_kernel_matches_plain_on_the_card_bit_for_bit(dtype, offset, shape):
    _cuda()
    like = torch.zeros(1, dtype=dtype, device="cuda")
    seed = 2 ** 62 + 12345
    before = kn.LAUNCHES
    k = kn.normal(torch.tensor(seed), shape, like, offset)
    assert kn.LAUNCHES == before + 1
    assert k.shape == shape and k.dtype == dtype and k.device.type == "cuda"
    p = kn.normal_plain(shape, seed, offset, dtype, "cuda")
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(k.view(bits), p.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_by_index_match_plain_on_the_card_bit_for_bit(dtype):
    """A box chunk's rows keyed by anchors (100 samples, 4540 of 176580)."""
    _cuda()
    like = torch.zeros(1, dtype=dtype, device="cuda")
    gen = torch.Generator().manual_seed(4)
    index = torch.randperm(176580, generator=gen)[:4540].cuda()
    before = kn.LAUNCHES
    k = kn.normal(torch.tensor(77), (100, 4540, 4), like, 4 * 12345, index, 176580)
    assert kn.LAUNCHES == before + 1
    p = kn.normal_plain((100, 4540, 4), 77, 4 * 12345, dtype, "cuda", index, 176580)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(k.view(bits), p.view(bits))


@pytest.mark.parametrize("shape", [(10, 176580, 7), (100, 4540, 4)])
def test_kernel_against_the_cpu_plain_version_within_ulps(shape):
    """The flagship's class bank and one box chunk, float32."""
    _cuda()
    seed = 987654321
    k = kn.normal(seed, shape, torch.zeros(1, device="cuda"), 0).cpu()
    p = kn.normal_plain(shape, seed, 0)
    ulps = _ulps(k, p)
    differ = int((k != p).sum())
    print(f"{shape}: {differ} of {k.numel()} normals differ from the CPU's, "
          f"at most {float(ulps.max()):.1f} ulps")
    assert float(ulps.max()) <= MAX_ULPS


def test_kernel_draws_on_the_current_stream_of_its_device():
    _cuda()
    stream = torch.cuda.Stream()
    like = torch.zeros(1, device="cuda")
    with torch.cuda.stream(stream):
        k = kn.normal(5, (1000, 4), like)
    stream.synchronize()
    assert torch.equal(k, kn.normal_plain((1000, 4), 5, 0, torch.float32, "cuda"))


@pytest.mark.parametrize("shape,keyed", [((10, 176580, 7), False), ((100, 4540, 4), False),
                                         ((100, 4540, 4), True)])
def test_kernel_equals_the_cpu_plain_version_bit_for_bit(shape, keyed):
    """The class bank and a box chunk, that chunk also with its rows keyed
    by 4540 anchors of 176580, as the mc_iid flagship draws it."""
    _cuda()
    seed = 987654321
    index = torch.randperm(176580, generator=torch.Generator().manual_seed(4))[:4540]
    index, rows = (index, 176580) if keyed else (None, 0)
    k = kn.normal(seed, shape, torch.zeros(1, device="cuda"), 0,
                  None if index is None else index.cuda(), rows).cpu()
    p = kn.normal_plain(shape, seed, 0, torch.float32, "cpu", index, rows)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


def test_class_bank_within_the_stated_ulps_of_float64_box_muller():
    """The mc_iid flagship's class bank (10, 176580, 7) float32 against
    Box-Muller of its words in float64, on the card."""
    _cuda()
    shape, seed, offset = (10, 176580, 7), 2 ** 61 + 99, 4 * 12345
    n = 10 * 176580 * 7
    z = kn.normal(seed, shape, torch.zeros(1, device="cuda"), offset).reshape(-1).double()
    q = offset // 4 + torch.arange(n // 4, dtype=torch.int64, device="cuda")
    w = torch.stack(kd.philox4x32_10(q & 0xFFFFFFFF, q >> 32, seed), dim=1)
    u = ((w >> 8) + 1).double() / 2 ** 24
    r = torch.sqrt(-2 * torch.log(u[:, 0::2]))
    t = 2 * torch.pi * u[:, 1::2]
    want = torch.stack([r * torch.cos(t), r * torch.sin(t)], dim=2).reshape(-1)
    big = want.abs() >= kn.MAX_ULPS_ABOVE
    top = torch.frexp(torch.maximum(z.abs(), want.abs()))[1]
    ulp = torch.ldexp(torch.ones_like(want), top - 24)
    worst = float(((z - want).abs() / ulp)[big].max())
    small = float((z - want).abs()[~big].max())
    print(f"{int(big.sum())} normals of magnitude >= 1e-3 within {worst:.3f} ulps of float64, "
          f"{int((~big).sum())} below within {small:.3e}")
    assert worst <= kn.MAX_ULPS and small <= kn.MAX_ABS_BELOW
