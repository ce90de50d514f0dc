"""The port's counter-based normals (``ops/kernels/normal.py``: the plain
version here, the CUDA kernel of ``csrc/normal.cu`` on a card, in
``tests/test_torch_normal_cuda.py``) against their contract.

* The bits are the dropout kernel's Philox4x32-10 (whose Random123 known
  answers ``tests/test_torch_dropout.py`` pins), keyed on the seed, one
  block of four words per four stream indices; each pair of words gives two
  normals by Box-Muller, which the test recomputes in float64 from the words
  (float32 within 1e-5 of it).
* The kernel's arithmetic (``csrc/normal.cu``: -2 ln u1 from u1's exponent
  and a polynomial, the cosine and sine from the angle in turns), which the
  plain version follows FMA for FMA (``normal.fma``: one rounding, checked
  against exact rationals), within ``MAX_ULPS`` (4) of float64 Box-Muller
  for normals of magnitude 1e-3 or more and within ``MAX_ABS_BELOW`` below,
  over a seeded bank of a million normals; its parts over every 7th of the
  2^24 uniforms: the radius within 2.1 and the cosine and sine within 1.5
  units of 2^-24 relative (the float32 rounding of the result alone is up
  to 1), the quarter turns exact.
* A draw at offset k is the matching slice of a longer draw, whatever k.
* Seeds give their own streams.
* The law on 10^6 draws, float32 and bfloat16: the mean within 5 standard
  errors (1/sqrt(n)) of 0, the variance within 5 of 1 (sqrt(2/n)), the
  shares beyond 1, 2 and 3 within 5 binomial standard errors of the
  normal's, and no draw beyond sqrt(-2 log 2^-24), the largest 24-bit
  uniforms can give; neighbours (a Box-Muller pair, two words of one block)
  uncorrelated within 5 standard errors.
* Rows drawn by index are the rows of the bank drawn whole.
* The operator: the CPU kernel is the plain version bit for bit, the fake
  kernel gives the shape and dtype, ``torch.library.opcheck`` passes.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import normal as kn
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

SEED = 0x0123456789ABCDEF


def _box_muller64(words):
    """Normals of (n, 4) uint32 words in float64: (r cos t, r sin t) of each
    pair."""
    u = ((words >> 8) + 1).astype(np.float64) / 2 ** 24
    r = np.sqrt(-2.0 * np.log(u[:, 0::2]))
    t = 2.0 * np.pi * u[:, 1::2]
    z = np.empty(words.shape, np.float64)
    z[:, 0::2], z[:, 1::2] = r * np.cos(t), r * np.sin(t)
    return z.reshape(-1)


@pytest.mark.parametrize("seed,q_first", [(0, 0), (SEED, 12345), (2 ** 64 - 1, 2 ** 33 - 3)])
def test_normals_are_box_muller_of_the_dropout_kernels_philox_words(seed, q_first):
    """The words are `dropout.philox4x32_10`'s of counters q_first, ...; the
    normals are their Box-Muller pairs: float32 within 1e-5 absolute of the
    float64 formula, and bit for bit the plain formula on those words."""
    blocks = 1000
    q = q_first + torch.arange(blocks, dtype=torch.int64)
    words = torch.stack(kd.philox4x32_10(q & 0xFFFFFFFF, q >> 32, seed), dim=1)
    z = kn.normal_plain((4 * blocks,), seed, 4 * q_first)
    np.testing.assert_allclose(z.numpy(), _box_muller64(words.numpy()), rtol=0, atol=1e-5)
    a, b = kn.box_muller(words[:, 0], words[:, 1])
    assert torch.equal(z.view(blocks, 4)[:, 0], a) and torch.equal(z.view(blocks, 4)[:, 1], b)
    if (seed, q_first) == (0, 0):
        # Random123's known answer for counter 0 under key 0.
        assert words[0].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_uniforms_are_exact_and_never_zero():
    bits = torch.tensor([0, 255, 256, 2 ** 32 - 1], dtype=torch.int64)
    u = kn.u01(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [2 ** -24, 2 ** -24, 2 * 2 ** -24, 1.0]


@pytest.mark.parametrize("offset", [0, 1, 3, 4, 13, 4 * 2 ** 33 + 2])
def test_a_draw_at_an_offset_is_a_slice_of_a_longer_draw(offset):
    base = offset - offset % 4
    long = kn.normal_plain((4096,), SEED, base)
    k = offset - base
    for n in (1, 7, 1000):
        short = kn.normal_plain((n,), SEED, offset)
        assert torch.equal(short, long[k:k + n])
    # and through the operator, in any shape
    x = torch.zeros(1)
    assert torch.equal(kn.normal(SEED, (5, 3, 2), x, offset).reshape(-1), long[k:k + 30])


def test_seeds_give_their_own_streams():
    x = torch.zeros(1)
    draws = [kn.normal(s, (10_000,), x) for s in (0, 1, 2 ** 32, 2 ** 62 + 7)]
    assert torch.equal(draws[0], kn.normal(0, (10_000,), x))
    for i in range(len(draws)):
        for j in range(i):
            assert float((draws[i] == draws[j]).float().mean()) < 1e-3, (i, j)
    # the 2^32 seed differs from seed 0 only in its high word
    assert not torch.equal(draws[0], draws[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_law_on_a_million_draws(dtype):
    n = 1_000_000
    z32 = kn.normal_plain((n,), SEED, 8, torch.float32)
    z = kn.normal(torch.tensor(SEED), (n,), torch.zeros(1, dtype=dtype), 8)
    assert z.dtype == dtype and z.shape == (n,)
    assert torch.equal(z, z32.to(dtype))  # one rounding of the float32 normals
    d = z.double().numpy()
    assert abs(d.mean()) < 5 / math.sqrt(n)
    assert abs(d.var() - 1.0) < 5 * math.sqrt(2.0 / n)
    for cut, share in ((1.0, 0.31731050786291415), (2.0, 0.04550026389635842),
                       (3.0, 0.0026997960632601866)):
        got = float((np.abs(d) > cut).mean())
        assert abs(got - share) < 5 * math.sqrt(share * (1 - share) / n), (cut, got)
    assert np.abs(d).max() <= math.sqrt(-2.0 * math.log(2.0 ** -24)) + 0.02
    pairs = d.reshape(-1, 4)
    for i, j in ((0, 1), (1, 2), (0, 2)):  # one pair; across pairs of a block
        corr = np.corrcoef(pairs[:, i], pairs[:, j])[0, 1]
        assert abs(corr) < 5 / math.sqrt(len(pairs)), (i, j, corr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_cpu_dispatch_is_the_plain_version(dtype):
    like = torch.zeros(3, dtype=dtype)
    before = kn.LAUNCHES
    got = kn.normal(torch.tensor(SEED), (7, 5), like, 6)
    assert kn.LAUNCHES == before  # the plain version launches nothing
    want = kn.normal_plain((7, 5), SEED, 6, dtype)
    assert got.dtype == dtype and got.device == like.device and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(kn.normal(SEED, (7, 5), like, 6), want)  # an int seed as well


def test_fake_kernel_gives_the_shape_and_dtype():
    with FakeTensorMode() as mode:
        like = mode.from_tensor(torch.zeros(2, dtype=torch.bfloat16))
        out = torch.ops.pod_compare_tpu_torch.normal.default(like, torch.tensor(5), [3, 4, 7], 8)
        assert out.shape == (3, 4, 7) and out.dtype == torch.bfloat16
        assert out.device == like.device
    for args in ((torch.zeros(3), torch.tensor(3), [5, 4], 6),
                 (torch.zeros(1, dtype=torch.bfloat16), torch.tensor(2 ** 62), [3, 5], 0),
                 (torch.zeros(1), torch.tensor(1), [0, 4], 4)):
        torch.library.opcheck(torch.ops.pod_compare_tpu_torch.normal.default, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_by_index_are_rows_of_the_whole_bank(dtype):
    """With an index, (S, C, 4) rows of the (S, rows, 4) bank drawn whole:
    each row's normals follow its index, whatever the order or repeats."""
    like = torch.zeros(1, dtype=dtype)
    index = torch.tensor([17, 0, 3, 3, 29, 8])
    for offset in (0, 44):
        whole = kn.normal(SEED, (5, 30, 4), like, offset)
        rows = kn.normal(torch.tensor(SEED), (5, 6, 4), like, offset, index, 30)
        assert rows.dtype == dtype and torch.equal(rows, whole[:, index])
        perm = torch.tensor([4, 2, 0, 5, 1, 3])
        assert torch.equal(kn.normal(SEED, (5, 6, 4), like, offset, index[perm], 30),
                           rows[:, perm])
    torch.library.opcheck(torch.ops.pod_compare_tpu_torch.normal.default,
                          (like, torch.tensor(3), [5, 6, 4], 8, index, 30))


def test_refusals():
    with pytest.raises(ValueError, match="offset"):
        kn.normal_plain((4,), 1, -4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kn.normal_cuda((4,), 1, 0, torch.zeros(1))
    with pytest.raises(ValueError, match="on the host"):
        kn._seed_on_host(torch.tensor(1, device="meta"))
    assert kn.stream_span(0) == 0 and kn.stream_span(1) == 4 and kn.stream_span(8) == 8
    index = torch.tensor([1, 2])
    for shape, offset in (((3, 2, 2), 0), ((3, 5, 4), 0), ((3, 2, 4), 2)):
        with pytest.raises(ValueError, match="by rows"):
            kn.normal_plain(shape, 1, offset, index=index, rows=4)


def _ulps(a: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|a - want| in float32 ulps of the larger magnitude."""
    m = np.maximum(np.abs(a.astype(np.float64)), np.abs(want))
    return np.abs(a.astype(np.float64) - want) / np.ldexp(1.0, np.frexp(m)[1] - 24)


def test_plain_normals_within_the_stated_ulps_of_float64_box_muller():
    blocks = 2 ** 18  # a million normals
    q = 77 + torch.arange(blocks, dtype=torch.int64)
    words = torch.stack(kd.philox4x32_10(q & 0xFFFFFFFF, q >> 32, SEED), dim=1).numpy()
    z = kn.normal_plain((4 * blocks,), SEED, 4 * 77).numpy()
    want = _box_muller64(words)
    big = np.abs(want) >= kn.MAX_ULPS_ABOVE
    worst = float(_ulps(z[big], want[big]).max())
    small = float(np.abs(z[~big] - want[~big]).max())
    print(f"{big.sum()} normals of magnitude >= 1e-3 within {worst:.3f} ulps, "
          f"{(~big).sum()} below within {small:.3e}")
    assert worst <= kn.MAX_ULPS and small <= kn.MAX_ABS_BELOW


def test_parts_on_a_stride_of_every_uniform():
    m = torch.arange(1, 2 ** 24 + 1, 7, dtype=torch.int64)
    m = torch.unique(torch.cat([m, torch.tensor([2 ** 22, 2 ** 23, 3 * 2 ** 22, 2 ** 24])]))
    u = m.to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(kn.neg2_log(u)).double()
    r_want = torch.sqrt(-2 * torch.log(m.double() / 2 ** 24))
    inside = m < 2 ** 24
    assert float(((r - r_want).abs() / r_want)[inside].max()) <= 2.1 * 2.0 ** -24
    assert float(r[~inside].max()) == 0.0  # u = 1
    cos, sin = kn.cos_sin_turn(u)
    turns = 4 * m.double() / 2 ** 24
    k = torch.round(turns)
    t = math.pi / 2 * (turns - k)  # the exact quadrant, then float64 at the reduced angle
    quadrant = k.long() % 4
    c0, s0 = torch.cos(t), torch.sin(t)
    want = {"cos": torch.stack([c0, -s0, -c0, s0])[quadrant, torch.arange(len(m))],
            "sin": torch.stack([s0, c0, -s0, -c0])[quadrant, torch.arange(len(m))]}
    for name, got in (("cos", cos), ("sin", sin)):
        w = want[name]
        nonzero = w != 0
        rel = ((got.double() - w).abs() / w.abs())[nonzero]
        assert float(rel.max()) <= 1.5 * 2.0 ** -24, name
        assert bool((got[~nonzero] == 0).all()), name
    assert int((cos == 0).sum()) == 2 and int((sin == 0).sum()) == 2  # the quarter turns


def test_fma_rounds_once():
    """`normal.fma` is the correctly rounded a * b + c of float32 values:
    against exact rationals on seeded triples, and where a float64 sum lands
    on a float32 midpoint that the exact sum passes or falls short of."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(400, generator=gen)
    b = torch.randn(400, generator=gen) * torch.logspace(-8, 0, 400)
    c = torch.randn(400, generator=gen) * torch.logspace(-12, 0, 400)
    got = kn.fma(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = [float(v) for v in (torch.nextafter(got[i], torch.tensor(-math.inf)), got[i],
                                   torch.nextafter(got[i], torch.tensor(math.inf)))]
        errs = [abs(Fraction(v) - exact) for v in near]
        assert errs[1] == min(errs), i
    one = torch.tensor([1.0 + 2 ** -23])
    # 1 + 2^-23 + 2^-24 is a midpoint: ties to even, 1 + 2^-22
    assert float(kn.fma(one, 1.0, 2.0 ** -24)) == 1.0 + 2 ** -22
    # a midpoint in float64 that the exact sum passes: 1 + 2^-24 + 2^-60 rounds up
    assert float(kn.fma(torch.tensor([1.0]), 1.0 + 2 ** -23, 2.0 ** -24 + 2.0 ** -60
                        - 2.0 ** -23)) == 1.0 + 2 ** -23
