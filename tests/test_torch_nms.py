"""The NMS operator ``pod_compare_tpu_torch::batched_nms`` on the CPU.

Its CPU kernel is the plain loop (``ops/kernels/nms.py::batched_nms_plain``):
``ops/nms.py::batched_nms`` through the operator equals the loop called
directly on every case that ``tests/test_torch_nms_cuda.py`` holds the CUDA
kernel to (the JAX parity of the port's NMS is in ``tests/test_torch_ops.py``).
The fake kernel gives the outputs' shapes and dtypes, the operator passes
``torch.library.opcheck``, a CPU call launches nothing, and the CUDA wrapper
refuses what the kernel does not take.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pod_compare_tpu_torch.ops import nms as tnms
from pod_compare_tpu_torch.ops.kernels import nms as knms
from test_torch_nms_cuda import CASES, nms_case, tensors


@pytest.mark.parametrize("name", [c for c in CASES if c not in ("global_20000", "global_max")])
def test_the_operator_on_the_cpu_is_the_plain_loop(name):
    args, threshold, max_out = tensors(nms_case(name, 3), "cpu")
    before = knms.LAUNCHES
    got = tnms.batched_nms(*args, threshold, max_out)
    assert knms.LAUNCHES == before  # the plain version launches nothing
    want = knms.batched_nms_plain(*args, threshold, max_out)
    assert isinstance(got, tnms.NMSResult)
    assert torch.equal(got.indices, want[0]) and torch.equal(got.valid, want[1])
    assert got.indices.dtype == torch.int64 and got.valid.dtype == torch.bool


def test_the_fake_kernel_gives_shapes_and_dtypes():
    args, threshold, _ = tensors(nms_case("merge_500"), "cpu")
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        idx, ok = knms.batched_nms_op(*fake, threshold, 37)
    assert idx.shape == ok.shape == (37,)
    assert idx.dtype == torch.int64 and ok.dtype == torch.bool


def test_the_operator_passes_opcheck():
    args, threshold, max_out = tensors(nms_case("fewer_than_slots"), "cpu")
    torch.library.opcheck(torch.ops.pod_compare_tpu_torch.batched_nms.default,
                          (*args, threshold, max_out))


def test_the_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    args, threshold, max_out = tensors(nms_case("merge_500"), "cpu")
    boxes, scores, classes, valid = args
    with pytest.raises(ValueError, match="CUDA"):
        knms.batched_nms_cuda(*args, threshold, max_out)
    with pytest.raises(TypeError):
        knms._check(boxes.double(), scores, classes, valid, max_out)
    with pytest.raises(TypeError):
        knms._check(boxes, scores, classes.int(), valid, max_out)
    with pytest.raises(TypeError):
        knms._check(boxes, scores, classes, valid.to(torch.uint8), max_out)
    with pytest.raises(ValueError):
        knms._check(boxes[:, :3], scores, classes, valid, max_out)
    with pytest.raises(ValueError):
        knms._check(boxes, scores[:-1], classes, valid, max_out)
    with pytest.raises(ValueError):
        knms._check(boxes.t().contiguous().t(), scores, classes, valid, max_out)
    with pytest.raises(ValueError):
        knms._check(boxes, scores, classes, valid, 0)
    big = knms.MAX_CANDIDATES + 1
    with pytest.raises(ValueError):
        knms._check(torch.zeros(big, 4), torch.zeros(big), torch.zeros(big, dtype=torch.int64),
                    torch.zeros(big, dtype=torch.bool), max_out)
    assert knms._check(boxes, scores, classes, valid, max_out) == 500
