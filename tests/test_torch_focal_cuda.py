"""The CUDA stochastic focal kernel against its plain PyTorch version, on a
card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_focal_cuda.py

Tolerance: each plane agrees within 1e-5 of its largest magnitude. The
kernel and the plain version compute the same function in float32, but the
kernel takes the sigmoid and the cross-entropy's softplus from approximate
exp2, log2 and reciprocal instructions (absolute errors of ~1e-7) and sin
and cos from its own polynomials (within 1.5 ulp), so they differ by a few
ulp; the edge cases below are where such differences grow: a standard
deviation of e^5 magnifies an error in the sampled normal 148 times.
"""

import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import focal as kf


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(shape, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda") * 2.0
    s = torch.randn(shape, generator=gen, device="cuda") * 3.0 - 1.0
    t = (torch.rand(shape, generator=gen, device="cuda") < 0.2).float()
    return x, s, t


def _assert_planes_close(kernel, plain):
    for name, a, b in zip(("loss", "gx", "gs"), kernel, plain):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"{name}: max abs {err}, scale {scale}"


@pytest.mark.parametrize("num_samples", [1, 3, 10])
@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1])
def test_kernel_matches_plain(num_samples, seed):
    _cuda()
    # Three 65536-element blocks and a ragged end: the block ids enter the key.
    x, s, t = _inputs((3, 65536 + 333, 1))
    before = kf.LAUNCHES
    k = kf.focal(x, s, t, seed, num_samples)
    torch.cuda.synchronize()
    assert kf.LAUNCHES == before + 1
    _assert_planes_close(k, kf.focal_plain(x, s, t, seed, num_samples))


def test_kernel_matches_plain_at_other_alpha_and_gamma():
    _cuda()
    x, s, t = _inputs((4, 5000, 7), seed=1)
    _assert_planes_close(kf.focal(x, s, t, 3, 4, 0.4, 1.5),
                         kf.focal_plain(x, s, t, 3, 4, 0.4, 1.5))


def test_clamp_gates_the_variance_gradient_on_the_card():
    _cuda()
    x = torch.zeros(4096, device="cuda")
    s = torch.full((4096,), 12.0, device="cuda")
    _, _, gs = kf.focal(x, s, torch.zeros_like(x), 0, 4)
    assert bool((gs == 0).all())


def test_autograd_on_the_card_multiplies_the_saved_planes():
    _cuda()
    x, s, t = _inputs((2, 1000, 7), seed=2)
    x.requires_grad_(True)
    s.requires_grad_(True)
    loss = kf.stochastic_focal_elem(x, s, t, 11, 10)
    ct = torch.rand_like(loss)
    loss.backward(ct)
    _, gx, gs = kf.focal(x.detach(), s.detach(), t, 11, 10)
    assert torch.equal(x.grad, ct * gx) and torch.equal(s.grad, ct * gs)


def test_kernel_rejects_other_dtypes():
    _cuda()
    x = torch.zeros(16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kf.focal(x, x, x, 0, 2)


def _edge_inputs(n, seed=0):
    """x over [-60, 60] (saturated sigmoids, large cross-entropies), s over
    [-10, 10] with 2% of the elements at each clamp edge (std up to e^5),
    targets 0 and 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, generator=gen, device="cuda") * 120.0 - 60.0
    s = torch.rand(n, generator=gen, device="cuda") * 20.0 - 10.0
    s[: n // 50] = 10.0
    s[n // 50: n // 25] = -10.0
    t = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    return x, s, t


@pytest.mark.parametrize("num_samples", [1, 3, 10])
def test_kernel_matches_plain_at_the_edges(num_samples):
    _cuda()
    n = 1 << 22
    x, s, t = _edge_inputs(n)
    seed = 77
    if num_samples == 10:
        # The stream reaches u1 within 2^-20 of 1, where the Box-Muller radius
        # sqrt(-2 log u1) is small and log must stay accurate (expected 20
        # times at this size: n * 5 pairs * 2^-20).
        keys = kf.stream_keys(n, seed, "cuda")
        near_one = sum(int((kf.uniforms(keys, 2 * pair) > 1.0 - 2.0 ** -20).sum())
                       for pair in range(5))
        assert near_one >= 1
    _assert_planes_close(kf.focal(x, s, t, seed, num_samples),
                         kf.focal_plain(x, s, t, seed, num_samples))


@pytest.mark.parametrize("num_samples", [1, 3, 10])
@pytest.mark.parametrize("layout", ["misaligned", "ragged"])
def test_kernel_matches_plain_off_the_vector_path(layout, num_samples):
    """Inputs that start 4 bytes into their storage take the one-element
    kernel; a length that is not a multiple of 4 takes the 16-byte kernel's
    tail."""
    _cuda()
    n = 3 * 65536 + 333
    x, s, t = (a[1:] for a in _edge_inputs(n + 1, seed=5))
    if layout == "misaligned":
        assert x.data_ptr() % 16 != 0
    else:
        x, s, t = x.clone(), s.clone(), t.clone()
        assert x.data_ptr() % 16 == 0 and n % 4 != 0
    _assert_planes_close(kf.focal(x, s, t, 9, num_samples),
                         kf.focal_plain(x, s, t, 9, num_samples))


@pytest.mark.parametrize("num_samples", [3, 10])
@pytest.mark.parametrize("first", [1, 3])
def test_index_base_draws_the_full_draw_s_rows(first, num_samples):
    """A data-parallel process's rows [first:] of the training path's
    (4, R, 7) logits, launched with ``index_base`` at their first element,
    give the full launch's rows bit for bit, and match the plain version
    with the same base. At base 0 the kernel is the one it was: the smoke's
    focal phase, given ``--parent`` (a checkout of the commit before
    ``index_base``), holds the two bit for bit."""
    _cuda()
    x, s, t = _inputs((4, 176580, 7), seed=first)
    full = kf.focal(x, s, t, 123, num_samples)
    base = first * x[0].numel()
    rows = [a[first:].clone() for a in (x, s, t)]
    part = kf.focal(*rows, 123, num_samples, index_base=base)
    for a, b in zip(part, full):
        assert torch.equal(a, b[first:])
    _assert_planes_close(part, kf.focal_plain(*rows, 123, num_samples, index_base=base))
    assert all(torch.equal(a, b) for a, b in zip(kf.focal(x, s, t, 123, num_samples,
                                                          index_base=0), full))
    with pytest.raises(ValueError, match="index base"):
        kf.focal(x, s, t, 123, num_samples, index_base=-1)
