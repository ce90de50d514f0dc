"""The CUDA normal kernel (``csrc/normal.cu``) against its plain PyTorch
version, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_normal_cuda.py

The Philox words are held bit for bit. The normals are held bit for bit
against the plain version run on the card, whose torch.log, torch.sqrt,
torch.sin and torch.cos call CUDA's logf, sqrtf, sinf and cosf as the
kernel does. Against the plain version on the CPU, whose transcendentals
are another library's, they may differ in the last bits: at most 8 ulps
of float32 (logf within 1 ulp, sinf and cosf within 2, on either side),
and the count of differing elements is printed.
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
    blocks = 300_000  # past one pass of the grid (132 x 32 blocks of 256 threads)
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
