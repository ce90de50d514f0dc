"""The port's serving export of the Monte-Carlo sampling impls: the banks'
normals come from per-image seeds, a fifth input of the program, through
the operator ``pod_compare_tpu_torch::normal``, so a served call equals the
live call bit for bit.

Beside ``tests/test_torch_export.py``, whose geometry and helpers it uses
(32x32, batch 2, 5 classes, TOPK 32, 10 detections, float32, full R50
depth; the configs' samples cut to 3 for the class bank and 20 for the
box bank), so that each file runs in under a minute on one core:

* ``standard_nms`` with CLS_SAMPLING and BOX_SAMPLING ``mc_iid``, and
  ``bayes_od`` with both ``mc_shared``: saved, loaded and served bit for
  bit as the live predictor, one normal launch for each image's class bank
  and one for each of its box chunks;
* two generator seeds give two served outputs, each the live call's;
* the manifest records the seeds' shape, and the program takes five inputs.

The post-NMS paths, whose seeds are per (image, run) unit, are in
``tests/test_torch_export_units.py``.
"""

import shutil

import pytest
import torch

from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.inference.core import pick_chunk
from pod_compare_tpu_torch.inference.export import REQUIRED_OPS
from test_torch_export import (
    BATCH,
    IMAGE_SIZE,
    INPUT_SIZES,
    OUTPUT_SIZES,
    assert_equal_detections,
    example_batch,
    generator,
    make_cfg,
    round_trip,
    seeded_state,
)
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

NORMAL_OP = "pod_compare_tpu_torch.normal.default"
CASES = {"mc_iid": "standard_nms", "mc_shared": "bayes_od"}


def sampled_cfg(mode, impl, mc=False):
    cfg = make_cfg(mode, mc=mc)
    cfg.PROBABILISTIC_INFERENCE.CLS_SAMPLING = impl
    cfg.PROBABILISTIC_INFERENCE.BOX_SAMPLING = impl
    return cfg


def normal_launches(served) -> int:
    return [str(n.target) for n in served.program.graph.nodes].count(NORMAL_OP)


@pytest.fixture(scope="module", params=sorted(CASES))
def sampled(request, tmp_path_factory):
    cfg = sampled_cfg(CASES[request.param], request.param)
    predictor = build_predictor(cfg, IMAGE_SIZE, seeded_state(cfg), device="cpu")
    root, served = round_trip(tmp_path_factory, request.param, predictor)
    yield request.param, predictor, served
    shutil.rmtree(root, ignore_errors=True)


def test_sampled_pre_nms_round_trip_exact(sampled):
    impl, live, served = sampled
    images = example_batch()
    want = live(images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    assert_equal_detections(want, served(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))
    # per image: the class bank, then the box bank's chunks
    topk = live.core_kwargs["topk"]
    candidates = sum(min(topk, n) for n in live.level_sizes)
    chunks = live.core_kwargs["box_num_samples"] // pick_chunk(
        live.core_kwargs["box_num_samples"], candidates)
    assert normal_launches(served) == BATCH * (1 + chunks)


def test_two_generator_seeds_give_two_served_outputs(sampled):
    """The seeds are an input: each generator seed draws its own normals, in
    the artifact as in the live call."""
    _, live, served = sampled
    images = example_batch()
    outs = {}
    for seed in (7, 8):
        outs[seed] = served(images, INPUT_SIZES, OUTPUT_SIZES, generator(seed))
        assert_equal_detections(live(images, INPUT_SIZES, OUTPUT_SIZES, generator(seed)),
                                outs[seed])
    assert not torch.equal(outs[7].covs, outs[8].covs)
    assert not torch.equal(outs[7].prob_vectors, outs[8].prob_vectors)


def test_sampled_program_takes_the_seeds_as_a_fifth_input(sampled):
    impl, _, served = sampled
    m = served.manifest
    assert m["sampling_seeds_shape"] == [BATCH]
    assert m["config"]["CLS_SAMPLING"] == m["config"]["BOX_SAMPLING"] == impl
    assert m["required_ops"] == list(REQUIRED_OPS) and "pod_compare_tpu_torch::normal" in m[
        "required_ops"]
    assert len(served.program.graph_signature.user_inputs) == 5
