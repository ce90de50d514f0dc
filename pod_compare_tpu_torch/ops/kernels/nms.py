"""Class-aware greedy NMS: the CUDA kernel ``csrc/nms.cu`` and its plain
PyTorch version, as the operator ``pod_compare_tpu_torch::batched_nms``.

Replaces no Pallas kernel: the JAX package's NMS is a ``lax.scan``
(``pod_compare_tpu/ops/nms.py``). The plain version is that scan as a
Python loop of ``max_out`` steps of (argmax over the live scores, suppress
one IoU row), about 24 PyTorch operations a step, so every shape is static
and the output is padded with a validity mask; nothing reads a value back
to the host. Ties go to the lower index, as ``jnp.argmax`` breaks them.
The kernel does the whole call in one launch of one thread block, with the
plain version's float32 operations in its order, and gives its indices and
validity bit for bit (``csrc/nms.cu``'s note).

The operator's CPU kernel is the plain version, its CUDA kernel
``batched_nms_cuda`` (float32 boxes and scores, int64 classes, bool valid,
contiguous; anything else raises, there is no fallback), and its fake
kernel gives the outputs' shapes, so ``torch.export`` records one node a
call. ``LAUNCHES`` counts kernel launches.
"""

import ctypes
import functools
from typing import Tuple

import torch

LAUNCHES = 0
# csrc/nms.cu's kMaxGlobal: the most candidates a launch takes.
MAX_CANDIDATES = 49152

_NEG_INF = -1e10


# ------------------------------------------------------------ plain version
def nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-agnostic greedy NMS over padded candidates: (indices (max_out,)
    int64 in score-descending order, valid (max_out,) bool).

    Args:
        boxes: (N, 4) XYXY; scores: (N,), higher kept first; valid: (N,)
            bool, padded entries never selected.
        iou_threshold: suppress boxes with IoU > threshold (equality kept).
        max_out: output size.
    """
    cur = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    # The corners and areas of every box, once: a step picks one row of each
    # and computes the IoU of that box against all, with the same operations
    # in the same order as one box's row alone. Each step is ~24 operations.
    lo, hi = boxes[:, 0:2], boxes[:, 2:4]
    areas = (boxes[:, 2] - boxes[:, 0]).clamp_min(0.0) * (boxes[:, 3] - boxes[:, 1]).clamp_min(0.0)
    indices, oks = [], []
    for _ in range(max_out):
        # One-element index tensors throughout: indexing with a 0-d tensor
        # would read it back to the host at every step.
        idx = torch.argmax(cur).reshape(1)
        ok = cur.index_select(0, idx) > _NEG_INF / 2
        rb = torch.minimum(hi.index_select(0, idx), hi)
        lt = torch.maximum(lo.index_select(0, idx), lo)
        wh = (rb - lt).clamp_min(0.0)
        inter = wh[:, 0] * wh[:, 1]
        union = areas.index_select(0, idx) + areas - inter
        pos = union > 0
        iou = torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)
        cur = torch.where(ok & (iou > iou_threshold), _NEG_INF, cur).index_fill(0, idx, _NEG_INF)
        indices.append(idx)
        oks.append(ok)
    return torch.cat(indices), torch.cat(oks)


def batched_nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS through per-class coordinate offsets: boxes of
    different classes never suppress each other. The kernel's function in
    PyTorch operations, on any device."""
    max_coord = torch.where(valid[:, None], boxes, 0.0).max() + 1.0
    offsets = classes.to(boxes.dtype)[:, None] * max_coord
    return nms_plain(boxes + offsets, scores, valid, iou_threshold, max_out)


# ------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def _library():
    from pod_compare_tpu_torch.ops.kernels import _build

    lib = _build.load("nms.cu")
    lib.pod_batched_nms.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.pod_batched_nms.restype = ctypes.c_int
    lib.pod_nms_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.pod_nms_chain.restype = ctypes.c_int
    return lib


def _check(boxes, scores, classes, valid, max_out: int) -> int:
    """The number of candidates, N; raises on what the kernel does not take."""
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"batched_nms takes float32 boxes and scores, not {boxes.dtype} and "
                        f"{scores.dtype}")
    if classes.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"batched_nms takes int64 classes and bool valid, not {classes.dtype} "
                        f"and {valid.dtype}")
    n = boxes.shape[0] if boxes.dim() == 2 else -1
    if (boxes.dim() != 2 or boxes.shape[1] != 4
            or any(t.shape != (n,) for t in (scores, classes, valid))):
        raise ValueError(f"batched_nms takes boxes (N, 4) and scores, classes and valid (N,), "
                         f"got {tuple(boxes.shape)}, {tuple(scores.shape)}, "
                         f"{tuple(classes.shape)} and {tuple(valid.shape)}")
    if not 1 <= n <= MAX_CANDIDATES or max_out < 1:
        raise ValueError(f"batched_nms takes 1 to {MAX_CANDIDATES} candidates and max_out >= 1, "
                         f"got {n} and {max_out}")
    if not all(t.is_contiguous() for t in (boxes, scores, classes, valid)):
        raise ValueError("batched_nms needs contiguous tensors")
    return n


def batched_nms_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/nms.cu on the boxes' CUDA device, on PyTorch's current
    stream: (indices (max_out,) int64, valid (max_out,) bool). The threshold
    goes to the kernel as float32, as the plain version's comparison of a
    float32 IoU with a Python float rounds it."""
    global LAUNCHES
    device = boxes.device
    if device.type != "cuda" or any(t.device != device for t in (scores, classes, valid)):
        raise ValueError(f"batched_nms_cuda needs every tensor on one CUDA device, got "
                         f"{device}, {scores.device}, {classes.device} and {valid.device}")
    n = _check(boxes, scores, classes, valid, max_out)
    indices = torch.empty(max_out, dtype=torch.int64, device=device)
    keep = torch.empty(max_out, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = _library().pod_batched_nms(
            boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), valid.data_ptr(), n,
            max_out, iou_threshold, indices.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return indices, keep


def chain_cuda(steps: int, n: int, device="cuda") -> torch.Tensor:
    """Launch csrc/nms.cu's pod_nms_chain: `steps` steps of the block argmax
    and barrier of the instance that `n` candidates take, with no
    candidates (the kernel's latency floor). Not counted in ``LAUNCHES``."""
    out = torch.empty(1, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = _library().pod_nms_chain(steps, n, out.data_ptr(),
                                       torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms chain kernel launch failed with cudaError_t {err}")
    return out


# The operator pod_compare_tpu_torch::batched_nms, registered through
# torch.library.Library as the dropout operator is (ops/kernels/dropout.py).
_LIB = torch.library.Library("pod_compare_tpu_torch", "FRAGMENT")
_LIB.define("batched_nms(Tensor boxes, Tensor scores, Tensor classes, Tensor valid, "
            "float iou_threshold, int max_out) -> (Tensor, Tensor)")
_LIB.impl("batched_nms", batched_nms_plain, "CPU")
_LIB.impl("batched_nms", batched_nms_cuda, "CUDA")


@torch.library.register_fake("pod_compare_tpu_torch::batched_nms")
def _batched_nms_fake(boxes, scores, classes, valid, iou_threshold, max_out):
    return (boxes.new_empty((max_out,), dtype=torch.int64),
            boxes.new_empty((max_out,), dtype=torch.bool))


def batched_nms_op(boxes, scores, classes, valid, iou_threshold: float, max_out: int):
    """Class-aware NMS through the operator (the plain version for CPU
    tensors, the kernel for CUDA ones): one node of an exported program."""
    return torch.ops.pod_compare_tpu_torch.batched_nms.default(
        boxes, scores, classes, valid, float(iou_threshold), int(max_out))
