"""The CUDA NMS kernel (``csrc/nms.cu``) against its plain PyTorch version,
on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_nms_cuda.py

The kernel's indices and validity are held bit for bit, every slot, the
padded ones included, against the plain version on the card and on the CPU:
the flagship's pre-NMS shape over several seeds, the post-NMS merge's
shapes, past the on-chip instances (the global-memory one), one candidate,
fewer candidates than slots, none valid, equal scores, an IoU exactly at the
threshold, duplicate boxes across classes and NaN scores. A predictor call
launches the kernel once an image. ``nms_case`` also feeds the CPU tests of
the operator (``tests/test_torch_nms.py``).
"""

import numpy as np
import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import nms as knms

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def clustered_boxes(rs, n: int, objects: int, canvas=(736.0, 1280.0)) -> np.ndarray:
    """(n, 4) float32 XYXY boxes jittered around `objects` objects on the
    canvas, as a detector's candidates crowd around what it sees."""
    h, w = canvas
    side = np.exp(rs.uniform(np.log(16.0), np.log(400.0), (objects, 2)))
    centre = rs.rand(objects, 2) * (w, h)
    which = rs.randint(0, objects, n)
    s = side[which] * np.exp(rs.normal(0.0, 0.15, (n, 2)))
    c = centre[which] + rs.normal(0.0, 0.1, (n, 2)) * side[which]
    return np.concatenate([c - s / 2, c + s / 2], axis=1).astype(np.float32)


def nms_case(name: str, seed: int = 0):
    """(boxes, scores, classes, valid, threshold, max_out) as numpy arrays
    and numbers, for one named case."""
    rs = np.random.RandomState(seed)
    n, max_out, threshold, num_classes = 4540, 100, 0.5, 7
    if name == "merge_1000":
        n = 1000
    elif name == "merge_500":
        n = 500
    elif name in ("global_6000", "global_20000"):
        n = int(name.split("_")[1])
    elif name == "global_max":
        n = knms.MAX_CANDIDATES
    elif name == "one":
        n = 1
    elif name == "fewer_than_slots":
        n = 37
    elif name == "iou_at_threshold":
        n = 4
    boxes = clustered_boxes(rs, n, max(n // 15, 1))
    scores = rs.rand(n).astype(np.float32)
    classes = rs.randint(0, num_classes, n).astype(np.int64)
    valid = scores > 0.05
    if name == "none_valid":
        valid[:] = False
    elif name == "one":
        valid[:] = True
    elif name == "equal_scores":
        scores[:] = np.float32(0.5)
        scores[::3] = np.float32(0.75)
    elif name == "iou_at_threshold":
        # IoU(0, 2) is the threshold (50 / 150): box 0 survives box 2, and
        # box 1 (box 0's score and box, a higher index) goes
        boxes[:] = [[0, 0, 10, 10], [0, 0, 10, 10], [5, 0, 15, 10], [20, 20, 30, 30]]
        scores[:] = [0.5, 0.5, 0.9, 0.1]
        classes[:] = 0
        valid[:] = True
        threshold = 50.0 / 150.0
    elif name == "duplicates_across_classes":
        boxes[n // 2:] = boxes[:n - n // 2]
        classes[n // 2:] = (classes[:n - n // 2] + 1) % num_classes
    elif name == "nan_score":
        scores[rs.randint(0, n, 5)] = np.nan
        valid[:] = True
    elif name == "negative_coordinates":
        boxes -= 2000.0
        valid[:] = True
    return boxes, scores, classes, valid, threshold, max_out


CASES = ["flagship", "merge_1000", "merge_500", "global_6000", "global_20000", "global_max",
         "one", "fewer_than_slots", "none_valid", "equal_scores", "iou_at_threshold",
         "duplicates_across_classes", "nan_score", "negative_coordinates"]


def tensors(case, device):
    boxes, scores, classes, valid, threshold, max_out = case
    return ([torch.from_numpy(a).to(device) for a in (boxes, scores, classes, valid)],
            threshold, max_out)


def assert_kernel_matches_plain(case):
    args, threshold, max_out = tensors(case, "cuda")
    before = knms.LAUNCHES
    idx, ok = knms.batched_nms_op(*args, threshold, max_out)
    torch.cuda.synchronize()
    assert knms.LAUNCHES == before + 1
    assert idx.shape == ok.shape == (max_out,)
    assert idx.dtype == torch.int64 and ok.dtype == torch.bool and idx.device.type == "cuda"
    plain_idx, plain_ok = knms.batched_nms_plain(*args, threshold, max_out)
    assert torch.equal(idx, plain_idx) and torch.equal(ok, plain_ok)
    cpu_args, _, _ = tensors(case, "cpu")
    cpu_idx, cpu_ok = knms.batched_nms_plain(*cpu_args, threshold, max_out)
    assert torch.equal(idx.cpu(), cpu_idx) and torch.equal(ok.cpu(), cpu_ok)
    return idx.cpu(), ok.cpu()


@pytest.mark.parametrize("seed", range(5))
def test_flagship_shape_matches_plain_bit_for_bit(seed):
    _cuda()
    idx, ok = assert_kernel_matches_plain(nms_case("flagship", seed))
    assert int(ok.sum()) > 50  # the case suppresses, and keeps many


@pytest.mark.parametrize("name", CASES[1:])
def test_case_matches_plain_bit_for_bit(name):
    _cuda()
    idx, ok = assert_kernel_matches_plain(nms_case(name, 3))
    if name == "none_valid":
        assert not bool(ok.any()) and idx.tolist() == [0] * len(idx)
    if name == "iou_at_threshold":
        assert idx.tolist()[:3] == [2, 0, 3] and ok.tolist()[:4] == [True, True, True, False]


def test_threshold_is_rounded_to_float32():
    """A threshold a hair above float32(1/3), which the plain version's
    comparison rounds down to it: the IoU at float32(1/3) is kept on both."""
    _cuda()
    boxes, scores, classes, valid, _, max_out = nms_case("iou_at_threshold", 1)
    case = (boxes, scores, classes, valid, float(np.float32(1 / 3)) + 1e-12, max_out)
    assert_kernel_matches_plain(case)


def test_wrong_inputs_raise_on_the_card():
    _cuda()
    args, threshold, max_out = tensors(nms_case("merge_500"), "cuda")
    boxes, scores, classes, valid = args
    with pytest.raises(TypeError):
        knms.batched_nms_cuda(boxes.double(), scores, classes, valid, threshold, max_out)
    with pytest.raises(TypeError):
        knms.batched_nms_cuda(boxes, scores, classes.int(), valid, threshold, max_out)
    with pytest.raises(ValueError):
        knms.batched_nms_cuda(boxes.t().contiguous().t(), scores, classes, valid, threshold,
                              max_out)
    with pytest.raises(ValueError):
        knms.batched_nms_cuda(boxes, scores, classes, valid.cpu(), threshold, max_out)


def test_a_predictor_call_launches_once_an_image():
    """standard_nms, pre-NMS: one NMS launch for each image of the batch."""
    _cuda()
    from pod_compare_tpu_torch.config import get_cfg
    from pod_compare_tpu_torch.inference import build_predictor
    from pod_compare_tpu_torch.models import build_model

    cfg = get_cfg()
    cfg.MODEL.RETINANET.NUM_CLASSES = 5
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE = "standard_nms"
    sd = build_model(cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    size, batch = (64, 96), 3
    predictor = build_predictor(cfg, size, sd, device="cuda")
    images = torch.randint(0, 256, (batch, *size, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3)).cuda()
    sizes = np.array([size] * batch, np.float32)
    before = knms.LAUNCHES
    dets = predictor(images, sizes, sizes, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    assert knms.LAUNCHES == before + batch
    assert dets.valid.shape == (batch, 10)
