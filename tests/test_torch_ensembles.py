"""The ensemble and post-NMS inference modes, port against JAX.

* The predictor on ``ensembles_pre_nms.yaml``, ``ensembles_post_nms.yaml``
  and ``mc_dropout_ensembles_post_nms.yaml`` in ``tests/test_torch_modes.py``'s
  setting (64x64, 3 classes, full R50 depth, float32, M = 3 injected MC
  masks; two ensemble members whose head biases differ a little, so that
  post-NMS clusters form). Classes and `valid` exactly, the other fields
  within 1e-4 relative and 1e-3 absolute.
* Five members once in the port alone, for shapes.
* ``run_inference`` on ``ensembles_post_nms`` end to end on the CPU: two
  members from their ``random_seed_<seed>`` sibling checkpoints on the
  port's side, the same weights as ``params_list`` on JAX's, over the
  synthetic dataset of ``tests/test_torch_apply_net.py``; the json and
  every metric with that file's tolerances. Checkpoints are written in a
  temporary directory emptied at the end.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pod_compare_tpu.cli.apply_net import run_inference as jax_run_inference
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from pod_compare_tpu.train.torch_convert import convert_torch_state_dict, merge_into_params
from pod_compare_tpu_torch.cli.apply_net import load_predictor_params, run_inference
from pod_compare_tpu_torch.data.synthetic import register_synthetic
from pod_compare_tpu_torch.train.checkpoint import Checkpointer, load_ensemble_params
from test_torch_apply_net import _assert_metrics_close
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)
from test_torch_modes import (
    check_case,
    configs,
    make_setup,
    member,
    port_predictor,
)
from test_torch_pipeline import _tensors

NAME = "synth_ensembles"


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("case,affinity", [
    ("ensembles_pre_nms", None), ("ensembles_post_nms", None),
    ("mc_dropout_ensembles_post_nms", None), ("mc_dropout_ensembles_post_nms", 0.7)])
def test_predictor_matches_jax(setup, case, affinity):
    """The configs as they stand, and the MC post-NMS merge once at affinity
    0.7: at the config's 0.9 the random weights' dropout runs disagree too
    much for any two of their detections to cluster."""
    extra = [] if affinity is None else ["PROBABILISTIC_INFERENCE.AFFINITY_THRESHOLD", affinity]
    ours = check_case(setup, case, extra)
    if case == "ensembles_post_nms" or affinity is not None:
        # the black-box merge clustered runs in every image
        assert ((ours.cluster_size >= 2) & ours.valid).any(dim=1).all()


def test_ensembles_stack_the_members_outputs(setup):
    """run_outputs stacks the members' deterministic forwards (M, B, R, k);
    head_outputs gives their mean and the members' deltas."""
    predictor = port_predictor(setup, "ensembles_pre_nms")
    images = torch.from_numpy(setup["images"])
    stacked = predictor.run_outputs(images)
    assert stacked["box_cls"].shape[:2] == (2, 2)
    alone = [m(images) for m in predictor.models]
    for k in ("box_cls", "box_delta", "box_cls_var", "box_reg_var"):
        for i in range(2):
            assert torch.equal(stacked[k][i], alone[i][k])
    mean, run_deltas = predictor.head_outputs(images)
    assert torch.equal(run_deltas, stacked["box_delta"])
    assert torch.equal(mean["box_cls"], stacked["box_cls"].mean(dim=0))


@pytest.mark.parametrize("case", ["ensembles_pre_nms", "ensembles_post_nms"])
def test_five_members(setup, case):
    """The configs' own five seeds: five members, the user entry point,
    (2, 12, ...) detections, finite and PD where valid."""
    sd = setup["members"][0]
    members = [sd] + [member(sd, seed) for seed in (2, 3, 4, 5)]
    predictor = port_predictor(setup, case, ["PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS",
                                             [0, 1000, 2000, 3000, 4000]], members=members)
    assert len(predictor.models) == 5
    assert predictor.run_outputs(torch.from_numpy(setup["images"]))["box_cls"].shape[0] == 5
    dets = predictor(setup["images"], setup["input_sizes"], setup["output_sizes"])
    assert dets.boxes.shape == (2, 12, 4) and dets.covs.shape == (2, 12, 4, 4)
    assert dets.prob_vectors.shape == (2, 12, 3)
    v = dets.valid
    assert v.any(dim=1).all()
    assert torch.isfinite(dets.boxes[v]).all()
    assert (torch.linalg.eigvalsh(dets.covs[v].double()) > 0).all()


def test_ensembles_need_the_members(setup):
    cfg, _ = configs("ensembles_post_nms")
    from pod_compare_tpu_torch.inference import build_predictor

    with pytest.raises(ValueError, match="state dict per member"):
        build_predictor(cfg, (64, 64), _tensors(setup["members"][0]), device="cpu")


# ------------------------------------------------------------ apply_net
APPLY_OPTS = [
    "DATASETS.TRAIN", (NAME,),
    "DATASETS.TEST", (NAME,),
    "INPUT.MIN_SIZE_TEST", 72,
    "DATALOADER.NUM_WORKERS", 2,
    "SEED", 0,
]


@pytest.fixture(scope="module")
def apply_setup(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp("ensembles_apply")
    kw = dict(num_images=8, image_size=(64, 80), num_classes=3)
    jax_register_synthetic(str(root / "jax"), NAME, **kw)
    register_synthetic(str(root / "port"), NAME, **kw)
    yield root
    shutil.rmtree(root, ignore_errors=True)  # two full R50 checkpoints among them


def test_run_inference_from_sibling_checkpoints_matches_jax(setup, apply_setup):
    """apply_net's ensembles_post_nms: the port loads each member from
    <config dir>/random_seed_<seed>/checkpoints (load_predictor_params), JAX
    takes the same weights as params_list; json and metrics agree."""
    root = apply_setup
    out_dir = root / "model" / "random_seed_0"
    cfg, jcfg = configs("ensembles_post_nms", APPLY_OPTS + ["OUTPUT_DIR", str(out_dir)])
    jcfg.OUTPUT_DIR = str(root / "jax")
    seeds = list(cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS)
    assert seeds == [0, 1000]
    members = [_tensors(sd) for sd in setup["members"]]
    for seed, sd in zip(seeds, members):
        Checkpointer(str(root / "model" / f"random_seed_{seed}")).save(7, {"model": sd})
    params, params_list = load_predictor_params(cfg)
    assert params is None and len(params_list) == 2
    for loaded, sd in zip(load_ensemble_params(cfg.OUTPUT_DIR, seeds), members):
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)

    template = jax.tree_util.tree_map(np.asarray, setup["template"])
    jparams = [merge_into_params(template, convert_torch_state_dict(sd))
               for sd in setup["members"]]
    kw = dict(batch_size=3, verbose=False, min_allowed_score=0.0)
    theirs = jax_run_inference(jcfg, NAME, "ensembles_post_nms", params_list=jparams, **kw)
    ours = run_inference(cfg, NAME, "ensembles_post_nms", device="cpu", **kw)

    def results(summary):
        with open(os.path.join(summary["inference_output_dir"],
                               "coco_instances_results.json")) as f:
            return json.load(f)

    a, b = results(ours), results(theirs)
    assert ours["num_images"] == theirs["num_images"] == 8
    assert len(a) == len(b) > 0
    assert [(r["image_id"], r["category_id"]) for r in a] == \
        [(r["image_id"], r["category_id"]) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["bbox"], y["bbox"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(x["bbox_covar"], y["bbox_covar"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(x["cls_prob"], y["cls_prob"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(x["score"], y["score"], rtol=1e-4, atol=1e-6)
    _assert_metrics_close(ours, theirs)
