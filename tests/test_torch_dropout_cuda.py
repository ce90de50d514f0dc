"""The CUDA dropout kernel against its plain PyTorch version, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dropout_cuda.py
"""

import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import dropout as kd


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_kernel_matches_plain_bit_for_bit(dtype, shared, relu):
    _cuda()
    x = torch.randn(2, 256, 24, 40, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    args = dict(seed=123456789, rate=0.2, batch_shared=shared, offset=1024, relu=relu)
    before = kd.LAUNCHES
    k = kd.dropout(x, **args)
    assert kd.LAUNCHES == before + 1
    assert k.is_contiguous(memory_format=torch.channels_last)
    p = kd.dropout_plain(x, **args)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(k.view(bits), p.view(bits))


@pytest.mark.parametrize("shape", [(3, 8), (1, 4096), (5, 24, 7, 9)])
def test_kernel_matches_plain_on_odd_shapes_and_large_seeds(shape):
    _cuda()
    x = torch.randn(shape, device="cuda")
    for seed in (0, 2 ** 64 - 1):
        k = kd.dropout(x, seed=seed, rate=0.5, offset=4 * 2 ** 33)
        assert torch.equal(k, kd.dropout_plain(x, seed=seed, rate=0.5, offset=4 * 2 ** 33))


def test_kernel_rejects_misaligned_storage():
    _cuda()
    x = torch.randn(4 * 1024 + 1, device="cuda")[1:].reshape(4, 1024)
    with pytest.raises(ValueError):
        kd.dropout(x, seed=0, rate=0.2)
