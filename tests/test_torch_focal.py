"""The port's stochastic focal kernel (its plain version here; the CUDA
kernel on a card) against the JAX Pallas kernel run in interpret mode.

The port draws its normals from the JAX package's own CPU bit source
(`_hash_bits`, keyed per 65536-element block as the interpret mode keys
it), so on the same seed and inputs the two compute the same float32
arithmetic: loss, gx and gs must agree within 1e-5 of each plane's largest
magnitude (element by element the planes are sums with cancellation, and
XLA's and PyTorch's exp/log/sin/cos differ by an ulp or so). The other
tests mirror tests/test_pallas_focal.py: the expectation against
Gauss–Hermite, an odd sample count, finite differences, the clamp gate,
seed determinism, padding, and autograd.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.ops.pallas.focal import _fwd as jax_focal_fwd
from pod_compare_tpu_torch.ops.kernels import focal as kf
from test_pallas_focal import _example, _gauss_hermite_expected


def _torch_example(n=4096, seed=0):
    return tuple(torch.from_numpy(np.array(a)) for a in _example(n, seed))


def _assert_planes_match(ours, theirs, tol=1e-5):
    for name, a, b in zip(("loss", "gx", "gs"), ours, theirs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= tol * scale, f"{name}: max abs {err}, scale {scale}"


@pytest.mark.parametrize("num_samples", [1, 3, 10])
@pytest.mark.parametrize("seed", [17, -5, 2 ** 31 - 3])
def test_plain_matches_the_jax_kernel_in_interpret_mode(num_samples, seed):
    """n > 65536, so the block id enters the stream key, and n not a
    multiple of 512, so JAX pads; some log-variances beyond both clamps."""
    rs = np.random.RandomState(0)
    shape = (2, 35166, 1)  # 70,332 elements
    x = (rs.randn(*shape) * 2).astype(np.float32)
    s = (rs.randn(*shape) * 1.5 - 1).astype(np.float32)
    s.reshape(-1)[:64] = 12.0
    s.reshape(-1)[64:128] = -11.0
    t = (rs.rand(*shape) < 0.3).astype(np.float32)
    loss, (gx, gs) = jax_focal_fwd(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t),
                                   jnp.int32(seed), num_samples, 0.25, 2.0)
    ours = kf.focal(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(t), seed,
                    num_samples)
    _assert_planes_match(ours, (loss, gx, gs))


def test_plain_matches_the_jax_kernel_at_other_alpha_and_gamma():
    x, s, t = _example(n=3000, seed=4)
    loss, (gx, gs) = jax_focal_fwd(x, s, t, jnp.int32(8), 4, 0.4, 1.5)
    ours = kf.focal(*map(lambda a: torch.from_numpy(np.array(a)), (x, s, t)), 8, 4, 0.4, 1.5)
    _assert_planes_match(ours, (loss, gx, gs))


def test_forward_matches_expectation():
    x, s, t = _torch_example()
    loss, _, _ = kf.focal(x, s, t, 17, 128)
    expected = np.asarray(_gauss_hermite_expected(
        jnp.asarray(x.numpy()), jnp.asarray(s.numpy()), jnp.asarray(t.numpy()), 0.25, 2.0))
    assert bool(torch.isfinite(loss).all())
    np.testing.assert_allclose(float(loss.mean()), float(expected.mean()), rtol=2e-2)
    per_elem_se = float(expected.std()) / np.sqrt(128)
    assert float(np.abs(loss.numpy() - expected).max()) < 6 * (per_elem_se + 0.05)


def test_odd_sample_count():
    x, s, t = _torch_example(n=512)
    loss3, _, _ = kf.focal(x, s, t, 3, 3)
    assert bool(torch.isfinite(loss3).all())
    expected = np.asarray(_gauss_hermite_expected(
        jnp.asarray(x.numpy()), jnp.asarray(s.numpy()), jnp.asarray(t.numpy()), 0.25, 2.0))
    np.testing.assert_allclose(float(loss3.mean()), float(expected.mean()), rtol=0.25)


def test_gradients_match_finite_differences():
    """Same seed, same samples: the loss is smooth in (x, s), and the
    directional derivatives match the analytic gradient planes."""
    x, s, t = (a.double() for a in _torch_example(n=1024, seed=3))
    x, s, t = x.float(), s.float(), t.float()
    total = lambda a, b: float(kf.focal(a, b, t, 5, 8)[0].double().sum())
    _, gx, gs = kf.focal(x, s, t, 5, 8)
    rs = np.random.RandomState(0)
    for which in (0, 1):
        v = torch.from_numpy(rs.randn(1024).astype(np.float32))
        eps = 1e-3
        if which == 0:
            numeric = (total(x + eps * v, s) - total(x - eps * v, s)) / (2 * eps)
            analytic = float((gx * v).sum())
        else:
            numeric = (total(x, s + eps * v) - total(x, s - eps * v)) / (2 * eps)
            analytic = float((gs * v).sum())
        np.testing.assert_allclose(analytic, numeric, rtol=2e-2, atol=2e-2)


def test_clamp_gates_variance_gradient():
    x = torch.zeros(256)
    s = torch.full((256,), 12.0, requires_grad=True)
    kf.stochastic_focal_elem(x, s, torch.zeros(256), 0, 4).sum().backward()
    assert bool((s.grad == 0).all())


def test_seed_determinism_and_streams():
    x, s, t = _torch_example(n=512)
    a = kf.focal(x, s, t, 9, 4)[0]
    assert torch.equal(a, kf.focal(x, s, t, 9, 4)[0])
    assert float((a - kf.focal(x, s, t, 10, 4)[0]).abs().max()) > 0.0
    # Seeds equal modulo 2^32 are the same int32 seed.
    assert torch.equal(a, kf.focal(x, s, t, 9 + 2 ** 32, 4)[0])


def test_multirank_shapes_and_padding():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 333, 7).astype(np.float32))
    s = torch.from_numpy((rs.randn(2, 333, 7) - 1.0).astype(np.float32))
    loss, gx, gs = kf.focal(x, s, torch.zeros(2, 333, 7), 2, 4)
    assert loss.shape == gx.shape == gs.shape == (2, 333, 7)
    assert all(bool(torch.isfinite(p).all()) for p in (loss, gx, gs))
    # An element's value depends on its flat index, not on the shape.
    flat = kf.focal(x.reshape(-1), s.reshape(-1), torch.zeros(2 * 333 * 7), 2, 4)[0]
    assert torch.equal(flat, loss.reshape(-1))


def test_autograd_multiplies_the_saved_planes():
    x, s, t = _torch_example(n=2000, seed=2)
    x.requires_grad_(True)
    s.requires_grad_(True)
    loss = kf.stochastic_focal_elem(x, s, t, 11, 10)
    ct = torch.rand(loss.shape, generator=torch.Generator().manual_seed(0))
    loss.backward(ct)
    _, gx, gs = kf.focal(x.detach(), s.detach(), t, 11, 10)
    assert torch.equal(x.grad, ct * gx) and torch.equal(s.grad, ct * gs)
    assert t.grad is None


def test_hash_is_lowbias32():
    """The plain hash against a scalar lowbias32 over wrapping uint32."""
    def scalar(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    vals = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x12345678]
    assert kf.lowbias32(torch.tensor(vals)).tolist() == [scalar(v) for v in vals]


@pytest.mark.parametrize(
    "make, error",
    [
        (lambda: [torch.zeros(8, dtype=torch.float64)] * 3, TypeError),
        (lambda: [torch.zeros(8), torch.zeros(8), torch.zeros(9)], ValueError),
        (lambda: [torch.zeros(0)] * 3, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_cannot_take(make, error):
    with pytest.raises(error):
        kf.focal(*make(), 0, 2)


def test_no_other_device_and_no_launch_on_the_cpu():
    with pytest.raises(ValueError):
        kf.focal(*[torch.zeros(8, device="meta")] * 3, 0, 2)
    with pytest.raises(ValueError):
        kf.focal_cuda(*[torch.zeros(8)] * 3, 0, 2)
    before = kf.LAUNCHES
    kf.focal(*[torch.zeros(8)] * 3, 0, 2)
    assert kf.LAUNCHES == before
