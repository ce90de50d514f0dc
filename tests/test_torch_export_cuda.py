"""The serving export on a card: artifacts exported for CUDA, saved, loaded
and served bit for bit as the live predictor, the dropout and NMS kernels
and (with the Monte-Carlo sampling impls) the normal kernel launched as
often as in the live call; and refused by a process without CUDA.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_export_cuda.py
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pod_compare_tpu_torch.config import get_cfg
from pod_compare_tpu_torch.inference import build_predictor, load_artifact, save_artifact
from pod_compare_tpu_torch.models import build_model
from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import nms as knms
from pod_compare_tpu_torch.ops.kernels import normal as kn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_SIZE = (64, 96)
BATCH = 2
NUM_CLASSES = 5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_cfg(mode, merge=None, sampling="analytic"):
    """bf16, 2 MC-dropout runs, 5 classes, TOPK 32, 10 detections; the class
    and box banks `sampling` (3 and 20 samples)."""
    cfg = get_cfg()
    cfg.MODEL.RETINANET.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE = 0.2
    cfg.MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NAME = "loss_attenuation"
    cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME = "negative_log_likelihood"
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.PARALLEL.COMPUTE_DTYPE = "bfloat16"
    cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE = mode
    cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE = True
    cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS = 2
    cfg.PROBABILISTIC_INFERENCE.AFFINITY_THRESHOLD = 0.5
    if merge:
        cfg.PROBABILISTIC_INFERENCE.ENSEMBLES_DROPOUT.BOX_MERGE_MODE = merge
    cfg.PROBABILISTIC_INFERENCE.CLS_SAMPLING = sampling
    cfg.PROBABILISTIC_INFERENCE.BOX_SAMPLING = sampling
    cfg.MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NUM_SAMPLES = 3
    cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NUM_SAMPLES = 20
    return cfg


def same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def export_and_serve(cfg, path):
    sd = build_model(cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    sd["head.cls_score.bias"].view(-1, NUM_CLASSES)[:, 0] += 5.0
    live = build_predictor(cfg, IMAGE_SIZE, sd, device="cuda")
    images = torch.randint(0, 256, (BATCH, *IMAGE_SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3)).cuda()
    sizes = np.array([IMAGE_SIZE] * BATCH, np.float32)
    served = load_artifact(save_artifact(live, str(path), batch_size=BATCH))
    counts = []
    for predictor in (live, served):
        kd.LAUNCHES = kn.LAUNCHES = knms.LAUNCHES = 0
        dets = predictor(images, sizes, sizes, torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        counts.append((kd.LAUNCHES, kn.LAUNCHES, knms.LAUNCHES))
        yield dets
    # runs x towers x convs: one launch over the five levels each
    assert counts[0][0] == counts[1][0] == 2 * 2 * 4
    # per image, or per (image, run) unit post-NMS: a class bank and a box chunk
    units = BATCH * (2 if live.post_nms else 1)
    assert counts[0][1] == counts[1][1] == (2 * units if live.sampled else 0)
    # an NMS a unit, and post-NMS the merge's an image
    assert counts[0][2] == counts[1][2] == units + (BATCH if live.post_nms else 0)


@pytest.mark.parametrize("mode,merge,sampling", [
    ("bayes_od", None, "analytic"), ("mc_dropout_ensembles", "post_nms", "analytic"),
    ("bayes_od", None, "mc_iid"), ("bayes_od", None, "mc_shared"),
    ("mc_dropout_ensembles", "post_nms", "mc_iid")])
def test_round_trip_on_the_card(tmp_path, mode, merge, sampling):
    _cuda()
    live, served = export_and_serve(make_cfg(mode, merge, sampling), tmp_path / "artifact")
    differ = [name for name, a, b in zip(live._fields, live, served) if not same_bits(a, b)]
    assert not differ, differ
    assert served.boxes.device.type == "cuda" and bool(served.valid.any())


def test_a_cuda_artifact_is_refused_without_cuda(tmp_path):
    _cuda()
    list(export_and_serve(make_cfg("bayes_od"), tmp_path / "artifact"))
    script = textwrap.dedent(f"""
        from pod_compare_tpu_torch.inference.export import load_artifact
        try:
            load_artifact({str(tmp_path / "artifact")!r})
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("OK")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr
