"""The port's ``pod.*`` spans (``utils/profiling.span``) on the CPU.

Under ``torch.profiler`` a predictor call of the BayesOD MC-dropout
configuration and one of standard NMS, and one ``TrainStep`` call, leave
their stages' spans in the Chrome trace, each nested in its parent and
opened once per image or per step. With no profiler, ``span`` never
enters ``record_function``. The flagship training config at full R50-FPN
depth in float32, 3 classes, batch 2, on a 64x64 canvas (inference, two
MC runs) and a 64x96 one (training).
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.models import build_model
from pod_compare_tpu_torch.train import RandomBatches, Trainer
from pod_compare_tpu_torch.train.trainer import batch_to_device
from pod_compare_tpu_torch.utils import profiling

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
NUM_CLASSES = 3
BATCH = 2
IMAGE_SIZE = (64, 64)
CANVAS = (64, 96)
OPTS = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 100,
    "TEST.DETECTIONS_PER_IMAGE", 12,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 2,
]
TRAIN_OPTS = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TRAIN", (64,),
    "SOLVER.IMS_PER_BATCH", BATCH,
    "SOLVER.BASE_LR", 1e-4,
    "SOLVER.WARMUP_ITERS", 2,
]
INFERENCE = {"bayes_od_mc": "Inference/bayes_od_mc_dropout.yaml",
             "standard_nms": "Inference/standard_nms.yaml"}
PER_IMAGE = ("pod.core", "pod.mode", "pod.nms", "pod.rescale")
STEP_PARTS = ("pod.forward", "pod.loss", "pod.backward", "pod.optimizer")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _tempered(cfg):
    """Weights drawn from a seed, the output convs scaled so that the
    head's outputs land in trained-model ranges and the class-0 logits'
    bias raised, as ``tests/test_torch_export.py::tempered`` does: every
    image keeps detections above the score threshold."""
    model = build_model(cfg).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        probe = model(torch.as_tensor(_images()[:1]))
    sd = model.state_dict()
    for conv, key, target in (("cls_score", "box_cls", 2.0), ("bbox_pred", "box_delta", 0.2),
                              ("cls_var", "box_cls_var", 1.0), ("bbox_cov", "box_reg_var", 0.5)):
        scale = target / float(probe[key].abs().max())
        for p in ("weight", "bias"):
            sd[f"head.{conv}.{p}"] = sd[f"head.{conv}.{p}"] * scale
    sd["head.cls_score.bias"].view(-1, NUM_CLASSES)[:, 0] += 1.5
    sd["head.cls_var.bias"] -= 6.0
    sd["head.bbox_cov.bias"] -= 4.0
    return sd


@pytest.fixture(scope="module")
def predictors():
    """A predictor of each configuration on `_tempered` weights."""
    out = {}
    for name, inference in INFERENCE.items():
        cfg = merge_configs(TRAIN_CFG, inference, OPTS)
        out[name] = build_predictor(cfg, IMAGE_SIZE, _tempered(cfg), device="cpu")
    return out


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tracing"))
    cfg = merge_configs(TRAIN_CFG, "", TRAIN_OPTS + ["OUTPUT_DIR", out])
    loader = RandomBatches(CANVAS, BATCH, NUM_CLASSES)
    trainer = Trainer(cfg, loader, device="cpu")
    yield trainer, batch_to_device(next(loader.iter_from(0)), "cpu")
    trainer.close()


def _images():
    rs = np.random.RandomState(3)
    return (rs.rand(BATCH, *IMAGE_SIZE, 3) * 255).astype(np.uint8)


def _call(predictor):
    sizes = np.array([list(IMAGE_SIZE)] * BATCH, np.float32)
    return predictor(_images(), sizes, sizes, generator=torch.Generator().manual_seed(1))


def _spans(fn, tmp_path):
    """The `pod.*` user annotations of `fn`'s Chrome trace under a CPU
    profiler, as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("pod.")]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


@pytest.mark.parametrize("name", sorted(INFERENCE))
def test_a_predictor_call_opens_its_stages_once_per_image(predictors, name, tmp_path):
    spans = _spans(lambda: _call(predictors[name]), tmp_path)
    counts = Counter(n for n, _, _ in spans)
    assert counts["pod.detect"] == 1 and counts["pod.stack"] == 1
    assert counts["pod.seeds"] == counts["pod.head_bank"] == 1
    assert counts["pod.backbone"] == counts["pod.head_runs"] == 1
    for stage in PER_IMAGE:
        assert counts[stage] == BATCH, stage
    assert counts["pod.fusion"] == (BATCH if name == "bayes_od_mc" else 0)
    detect = next(s for s in spans if s[0] == "pod.detect")
    bank = next(s for s in spans if s[0] == "pod.head_bank")
    for s in spans:
        if s[0] in PER_IMAGE + ("pod.fusion", "pod.stack"):
            assert _inside(s, detect), s
        if s[0] in ("pod.backbone", "pod.head_runs"):
            assert _inside(s, bank), s
    modes = [s for s in spans if s[0] == "pod.mode"]
    for s in spans:
        if s[0] in ("pod.nms", "pod.fusion"):
            assert any(_inside(s, m) for m in modes), s


def test_a_train_step_opens_its_parts_once(trainer, tmp_path):
    tr, batch = trainer
    spans = _spans(lambda: tr.train_step(tr.state, batch), tmp_path)
    counts = Counter(n for n, _, _ in spans)
    assert counts == Counter({"pod.step": 1, "pod.matcher": 1, **dict.fromkeys(STEP_PARTS, 1)})
    by_name = {n: (n, s, e) for n, s, e in spans}
    for part in STEP_PARTS:
        assert _inside(by_name[part], by_name["pod.step"]), part
    assert _inside(by_name["pod.matcher"], by_name["pod.loss"])
    parts = sorted((by_name[p] for p in STEP_PARTS), key=lambda s: s[1])
    assert [p[0] for p in parts] == list(STEP_PARTS)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


def test_without_a_profiler_span_enters_no_record_function(predictors, trainer, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for predictor in predictors.values():
        assert bool(_call(predictor).valid.any())
    tr, batch = trainer
    assert torch.isfinite(tr.train_step(tr.state, batch)["total_loss"])
    with pytest.raises(AssertionError, match="pod.x"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("pod.x"):
                pass
