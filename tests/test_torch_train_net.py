"""``cli.train_net`` from a dataset on disk, ``Trainer.test``, the reference
checkpoint routes and ``cli.convert_torch_checkpoint``, on the CPU.

One synthetic dataset of 8 images at 64x80, 3 classes, written by each
package's own writer (the files are byte-identical, ``test_torch_data.py``)
and registered under one name in both registries, serves as train and test
set; the flagship training config runs at full R50-FPN depth in float32,
batch 2 on the 64x96 canvas (MIN_SIZE_TRAIN 64), tested on the same canvas
(MIN_SIZE_TEST 64). One module-scoped run of ``train_net.main`` (2 steps,
a checkpoint and an evaluation after each) feeds most tests.

Tolerances: a resumed run equals the uninterrupted one bit for bit (the
same CPU kernels on the same inputs); ``Trainer.test`` against the JAX
``Trainer.test`` on the same weights as ``tests/test_torch_apply_net.py``
holds ``run_inference``: the detections per image, their classes and order
exactly, boxes 1e-4 relative (1e-3 absolute), scores 1e-4 relative (1e-6
absolute), every metric 1e-6 relative; weights loaded from a ``.pkl``
exactly equal to those of the JAX package's ``merge_into_params`` route.
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from pod_compare_tpu.parallel.mesh import create_mesh
from pod_compare_tpu.train.torch_convert import (
    convert_torch_state_dict,
    load_reference_checkpoint as jax_load_reference_checkpoint,
    merge_into_params,
)
from pod_compare_tpu.train.trainer import Trainer as JaxTrainer
from pod_compare_tpu_torch.cli import convert_torch_checkpoint, train_net
from pod_compare_tpu_torch.cli.apply_net import run_inference
from pod_compare_tpu_torch.config import merge_configs, setup_arg_parser
from pod_compare_tpu_torch.data.synthetic import register_synthetic
from pod_compare_tpu_torch.models.convert import from_jax_params
from pod_compare_tpu_torch.train import RandomBatches, Trainer, resolve_weights_path
from pod_compare_tpu_torch.train import trainer as trainer_module
from pod_compare_tpu_torch.train.checkpoint import Checkpointer, load_params
from pod_compare_tpu_torch.utils.logging import setup_logger
from test_full_model_parity import make_reference_state
from test_torch_apply_net import _assert_metrics_close, _results
from test_torch_pipeline import _temper
from test_torch_train import _assert_states_equal

NAME = "synth_train_net"
TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
NUM_CLASSES = 3
CANVAS = (64, 96)
OPTS = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 100,
    "TEST.DETECTIONS_PER_IMAGE", 12,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "DATASETS.TRAIN", (NAME,),
    "DATASETS.TEST", (NAME,),
    "INPUT.MIN_SIZE_TRAIN", (64,),
    "INPUT.MIN_SIZE_TEST", 64,
    "SOLVER.IMS_PER_BATCH", 2,
    "SOLVER.BASE_LR", 1e-4,
    "SOLVER.WARMUP_ITERS", 2,
    "DATALOADER.NUM_WORKERS", 2,
]
RUN_OPTS = ["SOLVER.MAX_ITER", 2, "SOLVER.CHECKPOINT_PERIOD", 1, "TEST.EVAL_PERIOD", 1]


def _argv(*flags, opts=()):
    return setup_arg_parser().parse_args(
        ["--config-file", TRAIN_CFG, "--random-seed", "0", *flags,
         *map(str, list(OPTS) + list(opts))])


def _output_dir(data_dir):
    return os.path.join(data_dir, "BDD-Detection", "retinanet",
                        os.path.splitext(os.path.basename(TRAIN_CFG))[0], "random_seed_0")


def _jax_cfg(out_dir):
    from pod_compare_tpu import configs_dir

    cfg = jax_get_cfg()
    cfg.merge_from_file(f"{configs_dir()}/{TRAIN_CFG}")
    cfg.merge_from_list([str(v) if isinstance(v, tuple) else v for v in OPTS])
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 0
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """As in test_torch_train.py: two intra-op threads per suite worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    kw = dict(num_images=8, image_size=(64, 80), num_classes=NUM_CLASSES)
    jax_register_synthetic(str(root / "jax"), NAME, **kw)
    register_synthetic(str(root / "port"), NAME, **kw)
    return root


@pytest.fixture(scope="module")
def jax_trainer(datasets, tmp_path_factory):
    trainer = JaxTrainer(_jax_cfg(tmp_path_factory.mktemp("jax_trainer")), mesh=create_mesh(1))
    yield trainer
    trainer.close()


@pytest.fixture(scope="module")
def runs(datasets, tmp_path_factory):
    """The uninterrupted run (2 steps) and a run resumed from its step-1
    checkpoint, both through ``train_net.main`` on the CPU; the test loaders
    and predictors each builds are counted. The directory, with its 278 MB
    checkpoints, is removed at the end."""
    root = tmp_path_factory.mktemp("train_net")
    built = {"TestLoader": 0, "predictor": 0}

    def counted(name, fn):
        def build(*args, **kwargs):
            built[name] += 1
            return fn(*args, **kwargs)
        return build

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POD_COMPARE_DATA_DIR", str(root / "data"))
        mp.setattr(trainer_module, "TestLoader", counted("TestLoader", trainer_module.TestLoader))
        mp.setattr(trainer_module, "build_predictor",
                   counted("predictor", trainer_module.build_predictor))
        whole = train_net.main(_argv(opts=RUN_OPTS), device="cpu")
        whole_built = dict(built)
        checkpointer = Checkpointer(_output_dir(str(root / "data")))
        steps = checkpointer.steps()
        with open(os.path.join(checkpointer.directory, os.pardir, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        os.remove(checkpointer.path(2))
        resumed = train_net.main(_argv("--resume", opts=RUN_OPTS), device="cpu")
        yield dict(root=root, whole=whole, resumed=resumed, built=whole_built, steps=steps,
                   events=events, output_dir=_output_dir(str(root / "data")))
    shutil.rmtree(root, ignore_errors=True)


def test_train_net_trains_from_disk_and_evaluates_every_period(runs):
    whole = runs["whole"]
    assert whole.state.step == 2 and whole.canvas == CANVAS
    assert runs["steps"] == [1, 2]
    losses = [e for e in runs["events"] if "total_loss" in e]
    evals = [e for e in runs["events"] if "eval/mAP" in e]
    assert {e["iteration"] for e in evals} == {0, 1}
    for e in evals:
        assert np.isfinite(e["eval/mAP"]) and np.isfinite(e["eval/AP50"])
    assert losses and all(np.isfinite(e["total_loss"]) for e in losses)
    for step in (1, 2):
        assert os.path.isfile(os.path.join(runs["output_dir"], "inference", NAME,
                                           f"eval_iter_{step}", "coco_instances_results.json"))
    # training went on with dropout after the evaluations: the model is
    # still in training mode and the loader's pool was released
    assert whole.state.model.training
    assert whole.loader._pool._pool._shutdown and not whole._eval_cache


def test_eval_cache_builds_one_loader_and_one_predictor(runs):
    assert runs["built"] == {"TestLoader": 1, "predictor": 1}


def test_resumed_run_equals_the_uninterrupted_run(runs):
    assert runs["resumed"].state.step == 2
    _assert_states_equal(runs["whole"].state, runs["resumed"].state)


def test_trainer_test_matches_jax(jax_trainer, tmp_path):
    """The same tempered weights in both trainers: ``Trainer.test`` gives the
    JAX ``Trainer.test``'s detections and summary; it leaves the training
    model and its dropout generator as they were, and a second call reuses
    the cached predictor with the current weights."""
    theirs = jax_trainer
    cfg = merge_configs(TRAIN_CFG, "", list(OPTS) + ["OUTPUT_DIR", str(tmp_path / "port"),
                                                    "SEED", 0])
    ours = Trainer(cfg, device="cpu")
    rng = np.random.RandomState(31)
    probe = (rng.rand(1, *CANVAS, 3) * 255).astype(np.uint8)
    sd = _temper(make_reference_state(rng, num_classes=NUM_CLASSES), cfg, probe)
    params = merge_into_params(jax.device_get(theirs.state.params), convert_torch_state_dict(sd))
    theirs.state = theirs.state._replace(params=params)
    ours.state.model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    generator = ours.state.generator.get_state()

    b = theirs.test(NAME, batch_size=3)
    a = ours.test(NAME, batch_size=3)
    assert ours.state.model.training
    assert torch.equal(ours.state.generator.get_state(), generator)
    x, y = _results(a), _results(b)
    assert a["num_images"] == 8 and len(x) == len(y) > 0
    assert [(r["image_id"], r["category_id"]) for r in x] == \
        [(r["image_id"], r["category_id"]) for r in y]
    for p, q in zip(x, y):
        np.testing.assert_allclose(p["bbox"], q["bbox"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(p["score"], q["score"], rtol=1e-4, atol=1e-6)
    _assert_metrics_close(a, b)
    assert ours.storage.latest()["eval/num_detections"] == len(x)

    # A second call: the cached predictor gets the current weights.
    (_, predictor), = ours._eval_cache.values()
    with torch.no_grad():
        ours.state.model.head.cls_score.bias.add_(-20.0)
    again = ours.test(NAME, batch_size=3)
    assert ours._eval_cache[(NAME, 3)][1] is predictor
    assert torch.equal(predictor.model.head.cls_score.bias, ours.state.model.head.cls_score.bias)
    assert again["num_detections"] < a["num_detections"]
    ours.close()


def test_eval_only_checks_expected_results(runs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POD_COMPARE_DATA_DIR", str(runs["root"] / "data"))
        results = train_net.main(_argv("--eval-only", opts=[
            "TEST.EXPECTED_RESULTS", "[['AP50', 0.0, 1.0]]"]), device="cpu")
    assert results["num_images"] == 8 and np.isfinite(results["mAP"])
    assert results["inference_output_dir"].endswith(os.path.join(NAME, "standard_nms_eval"))
    logger = setup_logger(name="test_torch_train_net")
    check = lambda expected: train_net.verify_results(
        merge_configs(TRAIN_CFG, "", ["TEST.EXPECTED_RESULTS", expected]), results, logger)
    assert check(f"[['mAP', {results['mAP']}, 1e-9], ['AP50', {results['AP50']}, 1e-9]]")
    assert check("[]")
    assert not check(f"[['mAP', {results['mAP'] + 1.0}, 0.5]]")
    assert not check("[['AP75', 0.0, 1.0]]")  # a key the results lack


def _backbone(tmp_path):
    """A seeded bare R-50 backbone (detectron2's stem.*, res{2-5}.* names)
    as a model-zoo style .pkl: numpy arrays under "model", Python 2's
    protocol."""
    rng = np.random.RandomState(3)
    sd = {k: v for k, v in make_reference_state(rng, num_classes=NUM_CLASSES).items()
          if k.startswith("backbone.bottom_up.")}
    backbone = {k[len("backbone.bottom_up."):]: v for k, v in sd.items()}
    path = tmp_path / "ImageNetPretrained" / "MSRA" / "R-50.pkl"
    path.parent.mkdir(parents=True)
    with open(path, "wb") as f:
        pickle.dump({"model": backbone, "__author__": "test"}, f, protocol=2)
    return str(path)


def test_pkl_warm_start_equals_the_jax_route(jax_trainer, tmp_path, monkeypatch):
    """MODEL.WEIGHTS as a detectron2:// URL resolved under $DETECTRON2_CACHE:
    the weights the trainer loads equal the JAX package's
    load_reference_checkpoint -> convert_torch_state_dict ->
    merge_into_params route, and what the .pkl lacks keeps its init."""
    pkl = _backbone(tmp_path)
    url = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    monkeypatch.delenv("DETECTRON2_CACHE", raising=False)
    with pytest.raises(FileNotFoundError, match="DETECTRON2_CACHE is not set"):
        resolve_weights_path(url)
    monkeypatch.setenv("DETECTRON2_CACHE", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        resolve_weights_path(url)
    monkeypatch.setenv("DETECTRON2_CACHE", str(tmp_path))
    assert resolve_weights_path(url) == pkl
    assert resolve_weights_path("/x/y.pth") == "/x/y.pth"

    cfg = merge_configs(TRAIN_CFG, "", list(OPTS) + [
        "OUTPUT_DIR", str(tmp_path / "out"), "MODEL.WEIGHTS", url])
    trainer = Trainer(cfg, RandomBatches(CANVAS, 2, NUM_CLASSES), device="cpu")
    head = trainer.state.model.head.cls_score.weight.detach().clone()
    trainer.resume_or_load(resume=False)
    ours = trainer.state.model.state_dict()

    merged = merge_into_params(jax.device_get(jax_trainer.state.params),
                               convert_torch_state_dict(jax_load_reference_checkpoint(pkl)))
    theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, merged))
    with open(pkl, "rb") as f:
        names = {"backbone.bottom_up." + k for k in pickle.load(f)["model"]}
    assert names == {k for k in theirs if k.startswith("backbone.bottom_up.")}
    for k in names:
        assert torch.equal(ours[k], theirs[k]), k
    assert torch.equal(ours["head.cls_score.weight"], head)
    trainer.close()


def test_convert_torch_checkpoint_writes_what_run_inference_and_resume_load(
        datasets, tmp_path, monkeypatch):
    """A whole reference model as a .pth becomes the step-0 checkpoint of
    the config's output directory: run_inference scores it and a resumed
    trainer starts from it at step 0."""
    rng = np.random.RandomState(4)
    sd = make_reference_state(rng, num_classes=NUM_CLASSES)
    pth = str(tmp_path / "model_final.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    monkeypatch.setenv("POD_COMPARE_DATA_DIR", str(tmp_path / "data"))
    parser = setup_arg_parser()
    parser.add_argument("--checkpoint", required=True)
    args = parser.parse_args(["--config-file", TRAIN_CFG, "--random-seed", "0",
                              "--checkpoint", pth, *map(str, OPTS)])
    path = convert_torch_checkpoint.main(args)
    out = _output_dir(str(tmp_path / "data"))
    assert path == Checkpointer(out).path(0)
    loaded = load_params(out)
    for k, v in sd.items():
        assert torch.equal(loaded[k], torch.from_numpy(v)), k

    cfg = merge_configs(TRAIN_CFG, "", list(OPTS) + ["OUTPUT_DIR", out])
    summary = run_inference(cfg, NAME, "standard_nms", batch_size=4, run_metrics=False,
                            verbose=False, device="cpu")
    assert summary["num_images"] == 8 and np.isfinite(summary["mAP"])
    trainer = Trainer(cfg, RandomBatches(CANVAS, 2, NUM_CLASSES), device="cpu")
    trainer.resume_or_load(resume=True)
    assert trainer.state.step == 0
    assert torch.equal(trainer.state.model.state_dict()["head.cls_score.weight"],
                       torch.from_numpy(sd["head.cls_score.weight"]))
    trainer.close()
    shutil.rmtree(tmp_path / "data", ignore_errors=True)


def test_profile_iters_write_a_trace_with_the_ports_spans(tmp_path):
    cfg = merge_configs(TRAIN_CFG, "", list(OPTS) + [
        "OUTPUT_DIR", str(tmp_path / "out"), "SOLVER.CHECKPOINT_PERIOD", 100])
    trainer = Trainer(cfg, RandomBatches(CANVAS, 2, NUM_CLASSES), device="cpu")
    trainer.checkpointer.save = lambda step, state: None  # 278 MB each, not needed here
    trainer.train(max_iter=2, log_period=1, profile_iters=(1, 2))
    trainer.close()
    traces = os.listdir(tmp_path / "out" / "profile")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "out" / "profile" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pod.data", "pod.step", "pod.forward", "pod.backward"} <= names
