"""The port's serving export of the multi-run pipelines: ``bayes_od`` with
2 MC-dropout runs (the dropout operator inside the program, its seeds an
input: fresh masks from each generator) and ``ensembles`` with the pre-NMS
merge and 2 members, each saved, loaded and served bit for bit as the live
predictor; the manifest.

Beside ``tests/test_torch_export.py``, whose geometry and helpers it uses
(32x32, batch 2, 5 classes, TOPK 32, 10 detections, float32, full R50
depth), so that each file runs in under a minute on one core.
"""

import os
import shutil

import pytest
import torch

from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.inference.export import REQUIRED_OPS
from test_torch_export import (
    BATCH,
    IMAGE_SIZE,
    INPUT_SIZES,
    NUM_CLASSES,
    OUTPUT_SIZES,
    assert_equal_detections,
    example_batch,
    generator,
    make_cfg,
    round_trip,
    seeded_state,
)
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)


@pytest.fixture(scope="module")
def bayes(tmp_path_factory):
    cfg = make_cfg("bayes_od", mc=True)
    predictor = build_predictor(cfg, IMAGE_SIZE, seeded_state(cfg), device="cpu")
    root, served = round_trip(tmp_path_factory, "bayes", predictor,
                              extra_manifest={"train_config": "unit-test"})
    yield predictor, served, str(root / "artifact")
    shutil.rmtree(root, ignore_errors=True)


def test_bayes_od_mc_dropout_round_trip_exact(bayes):
    """The dropout seeds are an input of the program: each generator seed
    draws its own masks, the same in the artifact as in the live call."""
    live, served, _ = bayes
    images = example_batch()
    outs = {}
    for seed in (7, 8):
        outs[seed] = live(images, INPUT_SIZES, OUTPUT_SIZES, generator(seed))
        assert_equal_detections(outs[seed], served(images, INPUT_SIZES, OUTPUT_SIZES,
                                                   generator(seed)))
    assert not torch.equal(outs[7].boxes, outs[8].boxes)
    assert outs[7].cluster_size is not None
    ops = {str(n.target) for n in served.program.graph.nodes}
    assert "pod_compare_tpu_torch.dropout.default" in ops


def test_manifest_contents(bayes):
    _, served, out = bayes
    m = served.manifest
    assert m["format"] == "pod_compare_tpu_torch.serving/1"
    assert m["inference_mode"] == "bayes_od"
    assert m["image_size"] == list(IMAGE_SIZE)
    assert m["batch_size"] == BATCH
    assert m["device"] == "cpu"
    assert m["mc_runs"] == 2 and m["num_members"] == 1 and m["num_convs"] == 4
    assert m["num_params"] > 1_000_000  # R50 + FPN + head
    assert m["train_config"] == "unit-test"
    assert m["config"]["NUM_CLASSES"] == NUM_CLASSES
    assert m["config"]["CLS_SAMPLING"] == m["config"]["BOX_SAMPLING"] == "analytic"
    assert m["detections_fields"] == ["boxes", "covs", "scores", "classes", "prob_vectors",
                                      "valid", "cluster_size"]
    assert m["required_ops"] == list(REQUIRED_OPS)
    assert m["torch_version"] == torch.__version__
    assert m["graph_nodes"] == len(served.program.graph.nodes) and m["export_seconds"] > 0
    assert os.path.getsize(os.path.join(out, "pipeline.pt2")) > 4 * m["num_params"]


def test_ensembles_pre_nms_round_trip_exact(tmp_path_factory):
    cfg = make_cfg("ensembles")
    cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.BOX_MERGE_MODE = "pre_nms"
    cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS = [0, 1]
    live = build_predictor(cfg, IMAGE_SIZE, device="cpu",
                           state_dicts=[seeded_state(cfg, s) for s in (0, 1)])
    root, served = round_trip(tmp_path_factory, "ensembles", live)
    assert served.manifest["num_members"] == 2 and served.manifest["mc_runs"] == 0
    images = example_batch()
    assert_equal_detections(live(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)),
                            served(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))
    shutil.rmtree(root, ignore_errors=True)
