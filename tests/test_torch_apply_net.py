"""``run_inference`` end to end, port against JAX, on the CPU.

A synthetic dataset of 8 images at 64x80, 3 classes, written by each
package's own writer (the two are byte-identical, ``test_torch_data.py``),
is run through each package's ``run_inference``: loader (resized to 72x90
on a 96x96 canvas by MIN_SIZE_TEST 72), predictor at full R50-FPN depth in
float32, ``coco_instances_results.json``, ``mAP_res.txt``, the probabilistic
metrics and the calibration errors. The weights are one random reference
state dict, tempered as ``test_torch_pipeline.py`` tempers it, carried to
the port by ``from_jax_params`` and, for the port, read back from a
checkpoint under OUTPUT_DIR by ``load_params``. Two configurations:

* deterministic ``standard_nms`` without dropout
  (``retinanet_R_50_FPN_1x_reg_cls_var.yaml``);
* the flagship BayesOD with MC-dropout (3 runs), the same masks injected on
  both sides as ``test_torch_pipeline.py`` injects them (the JAX predictor
  traces once, so every batch sees the same masks; the port's predictor is
  wrapped to give each batch those masks).

Tolerances, as ``test_torch_pipeline.py`` states them: the detections per
image, their classes and order exactly; boxes and covariances 1e-4
relative (1e-3 absolute), class probabilities 1e-4 relative (1e-6
absolute). Every metric: 1e-6 relative; PDQ (``run_pdq``): 1e-4 relative,
since its spatial quality, an exponential of a sum of log-probabilities over
each box's pixels, carries the detections' own 1e-4 (on one json the two
packages' PDQ agree to 1e-12, ``test_torch_pdq.py``).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import pod_compare_tpu.ops.pallas.dropout as jax_dropout
from pod_compare_tpu.cli.apply_net import run_inference as jax_run_inference
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.cli.apply_net import main, run_inference
from pod_compare_tpu_torch.config import merge_configs, setup_arg_parser
from pod_compare_tpu_torch.data.synthetic import register_synthetic
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.models import InjectedMasks
from pod_compare_tpu_torch.models.convert import from_jax_params
from pod_compare_tpu_torch.train.checkpoint import Checkpointer
from test_full_model_parity import make_reference_state
from test_torch_pipeline import NUM_RUNS, _fake_tower_dropout_masks, _temper

NAME = "synth_apply"
NUM_CLASSES = 3
CANVAS = (96, 96)
LEVEL_HW = [(12, 12), (6, 6), (3, 3), (2, 2), (1, 1)]
CONFIGS = {
    "standard_nms": ("BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var.yaml",
                     "Inference/standard_nms.yaml"),
    "bayes_od_mc_dropout": (
        "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml",
        "Inference/bayes_od_mc_dropout.yaml"),
}
OVERRIDES = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 100,
    "TEST.DETECTIONS_PER_IMAGE", 12,
    "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", NUM_RUNS,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "DATASETS.TRAIN", (NAME,),
    "DATASETS.TEST", (NAME,),
    "INPUT.MIN_SIZE_TEST", 72,
    "DATALOADER.NUM_WORKERS", 2,
    "SEED", 0,
]


def _cfgs(mode, out_dir):
    train, infer = CONFIGS[mode]
    opts = OVERRIDES + ["OUTPUT_DIR", str(out_dir)]
    from pod_compare_tpu import configs_dir

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(f"{configs_dir()}/{train}")
    jcfg.merge_from_file(f"{configs_dir()}/{infer}")
    jcfg.merge_from_list(list(opts))
    return merge_configs(train, infer, opts), jcfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("apply")
    kw = dict(num_images=8, image_size=(64, 80), num_classes=NUM_CLASSES)
    jax_register_synthetic(str(root / "jax"), NAME, **kw)
    register_synthetic(str(root / "port"), NAME, **kw)
    rng = np.random.RandomState(23)
    cfg, jcfg = _cfgs("bayes_od_mc_dropout", root)
    probe = (rng.rand(1, *CANVAS, 3) * 255).astype(np.uint8)
    sd = _temper(make_reference_state(rng, num_classes=NUM_CLASSES), cfg, probe)
    # prefer class 1 (category 2) over _temper's class 0: the metric suite
    # scores the categories [1, 3] only, as the reference does
    sd["head.cls_score.bias"].reshape(-1, NUM_CLASSES)[:, 1] += 2.0
    params = merge_into_params(
        init_model_params(jax_build_model(jcfg), CANVAS, seed=0), convert_torch_state_dict(sd))
    params = jax.tree_util.tree_map(np.asarray, params)
    keep = 0.8
    masks = [[[[np.where(rng.rand(h, w, 256) < keep, 1.0 / keep, 0.0).astype(np.float32)
                for (h, w) in LEVEL_HW] for _l in range(4)] for _t in range(2)]
             for _m in range(NUM_RUNS)]
    yield root, params, from_jax_params(params), masks
    shutil.rmtree(root, ignore_errors=True)  # two full R50 checkpoints among them


class _InjectedPredictor:
    """The port's predictor with the given masks on every call."""

    def __init__(self, predictor, masks):
        self.predictor = predictor
        self.masks = [InjectedMasks([[[torch.from_numpy(m) for m in layer] for layer in tower]
                                     for tower in run]) for run in masks]

    def __call__(self, images, input_sizes, output_sizes, generator=None):
        outs, run_deltas = self.predictor.head_outputs(
            torch.as_tensor(images), tower_dropouts=self.masks)
        size = lambda s: torch.as_tensor(s, dtype=torch.float32)
        return self.predictor.detect(outs, run_deltas, size(input_sizes), size(output_sizes))


def _run_both(setup, mode):
    root, params, state_dict, masks = setup
    cfg, jcfg = _cfgs(mode, root / mode / "port")
    jcfg.OUTPUT_DIR = str(root / mode / "jax")
    # standard_nms scores above the optimal-F1 threshold read back from
    # mAP_res.txt; the flagship scores every detection, so that the random
    # weights' detections meet the ground truth and the metrics are numbers.
    kw = dict(batch_size=3, verbose=False, run_pdq=True,
              min_allowed_score=None if mode == "standard_nms" else 0.0)
    if mode == "standard_nms":
        theirs = jax_run_inference(jcfg, NAME, mode, params=params, **kw)
        Checkpointer(cfg.OUTPUT_DIR).save(0, {"model": state_dict})
        ours = run_inference(cfg, NAME, mode, device="cpu", **kw)
    else:
        fake, calls = _fake_tower_dropout_masks(masks)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_dropout, "tower_dropout_masks", fake)
            theirs = jax_run_inference(jcfg, NAME, mode, params=params, **kw)
        assert len(calls) == 8
        predictor = build_predictor(cfg, CANVAS, state_dict, device="cpu")
        ours = run_inference(cfg, NAME, mode, device="cpu",
                             predictor=_InjectedPredictor(predictor, masks), **kw)
    return ours, theirs


def _gt_annotations(summary):
    from pod_compare_tpu_torch.data.datasets import get_dataset

    with open(get_dataset(NAME).json_file) as f:
        return json.load(f)["annotations"]


def _results(summary):
    with open(os.path.join(summary["inference_output_dir"], "coco_instances_results.json")) as f:
        return json.load(f)


def _assert_metrics_close(ours, theirs, rtol=1e-6):
    assert ours.keys() - {"evaluation_seconds", "pdq_seconds"} == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, dict):
            _assert_metrics_close(ours[k], v, 1e-4 if k == "pdq" else rtol)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(ours[k]), k
        elif k not in ("inference_output_dir", "images_per_second"):
            np.testing.assert_allclose(ours[k], v, rtol=rtol, atol=0, err_msg=k)


@pytest.fixture(scope="module", params=list(CONFIGS))
def both(setup, request):
    return request.param, _run_both(setup, request.param)


def test_results_json_matches_jax(both):
    mode, (ours, theirs) = both
    a, b = _results(ours), _results(theirs)
    assert ours["num_images"] == theirs["num_images"] == 8
    assert len(a) == len(b) > 0
    assert [(r["image_id"], r["category_id"]) for r in a] == \
        [(r["image_id"], r["category_id"]) for r in b]
    for x, y in zip(a, b):
        assert set(x) == set(y) == {"image_id", "category_id", "bbox", "score", "cls_prob",
                                    "bbox_covar"}
        np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(x["bbox_covar"], y["bbox_covar"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(x["cls_prob"], y["cls_prob"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(x["score"], y["score"], rtol=1e-4, atol=1e-6)
    if mode == "bayes_od_mc_dropout":
        assert any(np.abs(np.asarray(r["bbox_covar"])).max() > 0 for r in a)


def test_metrics_match_jax(both):
    _, (ours, theirs) = both
    for name in ("coco_instances_results.json", "mAP_res.txt"):
        assert os.path.isfile(os.path.join(ours["inference_output_dir"], name))
    _assert_metrics_close(ours, theirs)


def test_run_inference_needs_a_device_without_cuda(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    cfg, _ = _cfgs("standard_nms", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference(cfg, NAME, "standard_nms", params=setup[2], verbose=False)


@pytest.mark.parametrize("what,kw,opts", [
    ("more than one process or device", {}, ["PARALLEL.NUM_DEVICES", 4]),
])
def test_unported_options_are_refused(tmp_path, what, kw, opts):
    """More than one process runs now, one per card, started by
    ``--num-devices`` or a launcher (``tests/test_torch_parallel.py``); a
    config that asks for more processes than the run has is refused."""
    cfg, _ = _cfgs("standard_nms", tmp_path)
    cfg.merge_from_list(opts)
    with pytest.raises(ValueError, match="asks for 4 processes, but this run has 1"):
        run_inference(cfg, NAME, "standard_nms", device="cpu", **kw)


@pytest.mark.parametrize("batch_size", ["auto", 0, None])
def test_auto_batch_size_on_the_cpu_raises(setup, tmp_path, batch_size):
    """The automatic batch measures peak memory on the card: on the CPU it
    raises before anything is loaded or written."""
    cfg, _ = _cfgs("standard_nms", tmp_path)
    with pytest.raises(ValueError, match="auto"):
        run_inference(cfg, NAME, "standard_nms", device="cpu", params=setup[2],
                      batch_size=batch_size)
    assert not os.path.exists(tmp_path / "inference")


def test_run_pdq_scores_the_json(both):
    """PDQ on the json of each configuration: in the summary, in [0, 1],
    with true positives, scored at the threshold the other metrics use."""
    mode, (ours, _) = both
    pdq = ours["pdq"]
    assert 0.0 < pdq["pdq"] <= 1.0 and pdq["tp"] > 0
    assert pdq["tp"] + pdq["fn"] == sum(
        1 for _ in _gt_annotations(ours)), "every gt box is a TP or an FN"
    assert ours["pdq_seconds"] > 0


def test_profile_traces_the_inference_loop(setup, tmp_path):
    """``profile=True`` writes a torch.profiler trace of the loop into the
    inference directory's ``profile/`` and changes nothing else."""
    cfg, _ = _cfgs("standard_nms", tmp_path)
    summary = run_inference(cfg, NAME, "standard_nms", device="cpu", params=setup[2],
                            batch_size=4, profile=True, run_map=False, run_metrics=False)
    assert summary["num_images"] == 8
    traces = os.listdir(os.path.join(summary["inference_output_dir"], "profile"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")


def test_resume_false_is_refused(tmp_path):
    """No accepted argument is ignored: there is no fresh run to resume from."""
    cfg, _ = _cfgs("standard_nms", tmp_path)
    with pytest.raises(ValueError, match="resume=False"):
        run_inference(cfg, NAME, "standard_nms", device="cpu", resume=False)


def test_the_cli_main_runs_on_the_cpu(setup, tmp_path, monkeypatch):
    """``main`` as ``python -m pod_compare_tpu_torch.cli.apply_net`` calls it:
    the output directory under $POD_COMPARE_DATA_DIR holds the checkpoint,
    and the summary's files are written beside the inference config."""
    monkeypatch.setenv("POD_COMPARE_DATA_DIR", str(tmp_path))
    train, infer = CONFIGS["standard_nms"]
    out = tmp_path / "BDD-Detection" / "retinanet" / "retinanet_R_50_FPN_1x_reg_cls_var"
    Checkpointer(str(out / "random_seed_0")).save(0, {"model": setup[2]})
    args = setup_arg_parser().parse_args(
        ["--config-file", train, "--inference-config", infer, "--test-dataset", NAME,
         *map(str, OVERRIDES[:2] + OVERRIDES[8:18])])
    summary = main(args, batch_size=4, device="cpu")
    assert summary["num_images"] == 8
    files = set(os.listdir(summary["inference_output_dir"]))
    assert {"coco_instances_results.json", "mAP_res.txt", "standard_nms.yaml"} <= files
    # --num-devices asks for processes, one per card: more than the cards
    # there are is refused before anything starts.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"2 CUDA devices, but torch.cuda.device_count\(\) is 1"):
        main(setup_arg_parser().parse_args(
            ["--config-file", train, "--inference-config", infer, "--num-devices", "2"]))
    shutil.rmtree(out, ignore_errors=True)
