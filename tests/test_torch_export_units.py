"""The port's serving export of a sampled post-NMS mode: each (image, run)
unit draws its banks from its own seed, and the (B, M) seeds are an input
of the program.

Beside ``tests/test_torch_export.py``, whose geometry and helpers it uses,
so that each file runs in under a minute on one core:
``mc_dropout_ensembles`` with the post-NMS merge, 2 MC-dropout runs and
CLS_SAMPLING and BOX_SAMPLING ``mc_iid``, saved, loaded and served bit for
bit as the live predictor; a unit's seed moves that unit's image only.
"""

import shutil

import numpy as np
import pytest
import torch

from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds
from test_torch_export import (
    BATCH,
    IMAGE_SIZE,
    INPUT_SIZES,
    OUTPUT_SIZES,
    assert_equal_detections,
    example_batch,
    generator,
    reference_state,
    round_trip,
)
from test_torch_export_sampled import NORMAL_OP, sampled_cfg
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    cfg = sampled_cfg("mc_dropout_ensembles", "mc_iid", mc=True)
    cfg.PROBABILISTIC_INFERENCE.ENSEMBLES_DROPOUT.BOX_MERGE_MODE = "post_nms"
    predictor = build_predictor(cfg, IMAGE_SIZE, reference_state(cfg), device="cpu")
    root, served = round_trip(tmp_path_factory, "units", predictor)
    yield predictor, served
    shutil.rmtree(root, ignore_errors=True)


def test_sampled_post_nms_round_trip_exact(units):
    live, served = units
    assert live.post_nms and live.num_runs == 2 and live.sampled
    assert served.manifest["sampling_seeds_shape"] == [BATCH, 2]
    ops = [str(n.target) for n in served.program.graph.nodes]
    # per (image, run) unit: the class bank and one box chunk (20 samples)
    assert ops.count(NORMAL_OP) == BATCH * 2 * 2
    images = example_batch()
    want = live(images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    assert_equal_detections(want, served(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))
    assert bool((want.cluster_size[want.valid] >= 2).any())


def test_each_unit_draws_from_its_own_seed(units):
    """The program called with the call's seeds, then with image 1's unit
    seeds replaced: image 0's detections stay bit for bit, image 1's move;
    the live pipeline agrees on both."""
    live, served = units
    images = torch.from_numpy(example_batch())
    sizes = lambda s: torch.as_tensor(s, dtype=torch.float32)
    dropout_seeds, seeds = draw_call_seeds(generator(7), 2, live.num_convs, BATCH, 2)
    other = seeds.clone()
    other[1] += 1
    outs = []
    for s in (seeds, other):
        with torch.no_grad():
            got = served._call(images, sizes(INPUT_SIZES), sizes(OUTPUT_SIZES), dropout_seeds, s)
        want = live.pipeline(images, sizes(INPUT_SIZES), sizes(OUTPUT_SIZES), dropout_seeds, s)
        assert_equal_detections(want, type(want)(**dict(zip(served.fields, got))))
        outs.append(want)
    np.testing.assert_array_equal(outs[0].covs[0].numpy(), outs[1].covs[0].numpy())
    assert not torch.equal(outs[0].covs[1], outs[1].covs[1])
