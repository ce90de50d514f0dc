"""The CUDA stochastic focal kernel against its plain PyTorch version, on a
card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_focal_cuda.py

Tolerance: the kernel and the plain version compute the same float32
arithmetic, but CUDA's expf/logf/sinf/cosf/log1pf differ from PyTorch's by
a few ulp and the compiler contracts multiply-adds, so each plane agrees
within 1e-5 of its largest magnitude.
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
