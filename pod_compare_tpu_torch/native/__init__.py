"""The port's C++ engines, built with g++ and bound with ctypes.

The port's own copies of ``pod_compare_tpu/native``: the COCO evaluation
engine (``cocoeval.cpp``) and the matching engine of the uncertainty
metrics (``match_engine.cpp``). ``g++ -O3 -shared -fPIC`` compiles the two
into one library under the repository's git-ignored ``build/``, named by a hash
of the sources and the flags, at first use; nothing is built at import.

There is no fallback: a failed build or load raises. The evaluators run
their numpy engines only where the caller asks for them
(``use_native=False``).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from pod_compare_tpu_torch.ops.kernels._build import BUILD_DIR

SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("cocoeval.cpp", "match_engine.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()  # the build, the load, and the match engine's per-call state
_LIB = None

_i64 = ctypes.POINTER(ctypes.c_int64)
_f64 = ctypes.POINTER(ctypes.c_double)
_u8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "cocoeval_run": [
        _i64, _i64, _f64, _f64, ctypes.c_int64,
        _i64, _i64, _f64, _f64, _u8, _u8, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        _f64, ctypes.c_int64, _f64, ctypes.c_int64, _f64, ctypes.c_int64,
        _i64, ctypes.c_int64,
        _f64, _f64, _f64,
    ],
    "match_engine_run": [
        _f64, _f64, _f64, _i64, _i64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, _i64,
    ],
    "match_engine_fetch": [_i64, _i64, _f64, _i64, _i64, _f64, _i64, _i64],
}


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for source in SOURCES:
        with open(os.path.join(SOURCE_DIR, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless their library is current; returns its
    path. Raises RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(SOURCE_DIR, s) for s in SOURCES), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build the native library: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each install a whole library
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _arrays(*pairs):
    """The (array, dtype) pairs as contiguous arrays of those types (copies
    only where needed; the caller keeps them alive) and their pointers."""
    held = [np.ascontiguousarray(a, dtype=t) for a, t in pairs]
    ptrs = [h.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(h.dtype)))
            for h in held]
    return held, ptrs


def _check(ret: int, name: str) -> None:
    if ret != 0:
        raise RuntimeError(f"{name} returned {ret}")


def cocoeval_run(
    det_img, det_cat, det_bbox, det_score,
    gt_img, gt_cat, gt_bbox, gt_area, gt_iscrowd, gt_ignore,
    num_images: int, num_cats: int,
    iou_thrs, rec_thrs, area_rngs, max_dets,
):
    """Run the C++ COCO evaluation engine.

    Returns (precision, recall, scores) of shapes (T,R,K,A,M), (T,K,A,M),
    (T,R,K,A,M) in pycocotools' layout, -1 where undefined."""
    lib = load()
    T, R = len(iou_thrs), len(rec_thrs)
    K, A, M = num_cats, len(area_rngs), len(max_dets)
    if len(det_bbox) != len(det_img) or len(gt_bbox) != len(gt_img):
        raise ValueError("box and index arrays differ in length")
    precision = -np.ones((T, R, K, A, M), np.float64)
    recall = -np.ones((T, K, A, M), np.float64)
    scores = -np.ones((T, R, K, A, M), np.float64)
    held, p = _arrays(
        (det_img, np.int64), (det_cat, np.int64), (det_bbox, np.float64),
        (det_score, np.float64),
        (gt_img, np.int64), (gt_cat, np.int64), (gt_bbox, np.float64),
        (gt_area, np.float64), (gt_iscrowd, np.uint8), (gt_ignore, np.uint8),
        (iou_thrs, np.float64), (rec_thrs, np.float64),
        (np.asarray(area_rngs, np.float64).reshape(-1), np.float64),
        (max_dets, np.int64), (precision, np.float64), (recall, np.float64),
        (scores, np.float64),
    )
    ret = lib.cocoeval_run(
        p[0], p[1], p[2], p[3], len(det_img),
        p[4], p[5], p[6], p[7], p[8], p[9], len(gt_img),
        num_images, num_cats,
        p[10], T, p[11], R, p[12], A, p[13], M,
        p[14], p[15], p[16],
    )
    _check(ret, "cocoeval_run")
    del held
    return precision, recall, scores


def match_engine_run(
    det_boxes, det_scores, gt_boxes, det_off, gt_off, iou_min: float, iou_correct: float
):
    """Run the C++ matching engine.

    Returns a dict of index arrays into the flat det/gt arrays: tp_det,
    tp_gt, tp_iou, dup_det, dup_gt, dup_iou, fp_det, fn_gt."""
    lib = load()
    counts = np.zeros(4, np.int64)
    held, p = _arrays(
        (det_boxes, np.float64), (det_scores, np.float64), (gt_boxes, np.float64),
        (det_off, np.int64), (gt_off, np.int64), (counts, np.int64),
    )
    keys = ("tp_det", "tp_gt", "tp_iou", "dup_det", "dup_gt", "dup_iou", "fp_det", "fn_gt")
    with _LOCK:  # the engine keeps its results between the two calls
        _check(lib.match_engine_run(p[0], p[1], p[2], p[3], p[4], len(det_off) - 1,
                                    iou_min, iou_correct, p[5]), "match_engine_run")
        n_tp, n_dup, n_fp, n_fn = (int(c) for c in counts)
        sizes = dict(tp_det=n_tp, tp_gt=n_tp, tp_iou=n_tp, dup_det=n_dup, dup_gt=n_dup,
                     dup_iou=n_dup, fp_det=n_fp, fn_gt=n_fn)
        out = {k: np.zeros(sizes[k], np.float64 if k.endswith("iou") else np.int64)
               for k in keys}
        _, ptrs = _arrays(*[(out[k], out[k].dtype) for k in keys])
        _check(lib.match_engine_fetch(*ptrs), "match_engine_fetch")
    del held
    return out

