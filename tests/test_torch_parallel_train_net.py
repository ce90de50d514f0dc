"""``cli.train_net.main`` on two processes against one, on the CPU.

``main`` with ``--num-devices 2 --device cpu`` spawns two gloo processes
(``parallel.launch``), which register BDD's layout from --dataset-dir
themselves, each on two torch threads (OMP_NUM_THREADS=2); the launch is
joined with its own timeout so that a hung rendezvous fails this file
alone. The flagship training config runs at full R50-FPN depth in float32
with the stochastic focal loss's kernel route (its plain version on the
CPU), on a synthetic set in BDD's layout (8 train and 5 validation images at
64x80, BDD's 7 classes): 3 steps of a global batch of 2 (one image per
process), a checkpoint every 2 steps and at the end, an evaluation of the
validation set after every step (rank 0's shard of 3 images, rank 1's of
2, gathered). Then the two-process run is resumed from its step-2
checkpoint.

What is held, against ``main`` on one process over the same argv, and
against that run with two processes' arithmetic (``TrainStep.losses``
replaced by ``_losses_of_two_processes``: the two halves' backward passes
summed, as DistributedDataParallel sums them):

* the checkpoints (steps 2 and 3) and metrics.jsonl's rows (the same
  iterations with the same keys: rank 0 alone writes);
* the losses, positive count and learning rate logged at step 3 within
  1e-5 relative of the one-process run's and 1e-6 of the two-halves run's;
* each weight of the step-3 checkpoint within 1e-6 of its tensor's largest
  magnitude of the two-halves run's: with two threads PyTorch's CPU
  reduction of a bias gradient rounds in a run-dependent order, and two
  identical two-process runs differ by a few 1e-8 of scale in P6's and
  P7's biases. The one-process run sums each weight gradient over the
  batch in one call, the processes over their halves, a gap that grows
  with the loss's conditioning and with the steps
  (``tools/torch_ddp_precision.py`` reads it against float64); so the
  weights are held against the arithmetic the processes do, and
  tests/test_torch_parallel.py holds one step's gradients against the
  one-process step's;
* the evaluation json after each step under tests/test_multihost.py's
  tolerances (image and class exact; score to 4 decimals and box to 2,
  within 0.05), eval/mAP and eval/AP50 within 1e-4, eval/num_detections
  equal;
* the resumed two-process run's step-3 checkpoint against the uninterrupted
  two-process run's: the step, generator, normaliser and learning rates
  equal, weights and momenta within 1e-6 of scale (the same run-dependent
  rounding), and its logged losses within 1e-6.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pod_compare_tpu_torch.cli import train_net
from pod_compare_tpu_torch.config import setup_arg_parser
from pod_compare_tpu_torch.data.synthetic import generate_synthetic_dataset
from pod_compare_tpu_torch.ops.matcher import label_anchors_batch
from pod_compare_tpu_torch.parallel import BatchShard, launch
from pod_compare_tpu_torch.train import loss as train_loss
from pod_compare_tpu_torch.train.checkpoint import Checkpointer
from pod_compare_tpu_torch.train.trainer import TrainStep
from test_torch_modes import few_threads  # noqa: F401  (module fixture)
from test_torch_parallel import LAUNCH_TIMEOUT_S, _assert_keys_close, _key, child_threads  # noqa: F401

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
STEPS = 3
OPTS = [
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 100,
    "TEST.DETECTIONS_PER_IMAGE", 12,
    "INPUT.MIN_SIZE_TRAIN", (64,),
    "INPUT.MIN_SIZE_TEST", 64,
    "SOLVER.IMS_PER_BATCH", 2,
    "SOLVER.BASE_LR", 1e-4,
    "SOLVER.WARMUP_ITERS", 2,
    "SOLVER.MAX_ITER", STEPS,
    "SOLVER.CHECKPOINT_PERIOD", 2,
    "TEST.EVAL_PERIOD", 1,
    "DATALOADER.NUM_WORKERS", 1,
    "MODEL.RETINANET.SCORE_THRESH_TEST", 0.0,
]


def _write_bdd_layout(root):
    """BDD's layout (labels/{split}_coco_format.json, images/100k/{split}/)
    from the synthetic writer."""
    os.makedirs(root / "labels")
    os.makedirs(root / "images" / "100k")
    for split, count, seed in (("train", 8, 5), ("val", 5, 6)):
        json_file, image_dir = generate_synthetic_dataset(
            str(root), split, num_images=count, image_size=(64, 80), num_classes=7, seed=seed)
        os.replace(json_file, root / "labels" / f"{split}_coco_format.json")
        os.replace(image_dir, root / "images" / "100k" / split)


def _output_dir(data_dir):
    return os.path.join(data_dir, "BDD-Detection", "retinanet",
                        os.path.splitext(os.path.basename(TRAIN_CFG))[0], "random_seed_0")


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _eval_json(out, step):
    path = os.path.join(out, "inference", "bdd_val", f"eval_iter_{step}",
                        "coco_instances_results.json")
    with open(path) as f:
        return json.load(f)


def _losses_of_two_processes(self, state, batch, seeds, loss_seed, tower_dropout=None):
    """``TrainStep.losses`` on one process with two processes' arithmetic:
    the batch's halves through ``forward_train`` with their shards, each
    half's loss over the whole batch's positive count (the all-reduce's),
    the first half's backward taken here and the second's left to the
    caller, so that each gradient is the first half's plus the second's, as
    DistributedDataParallel sums them."""
    lc = self.lc
    classes = label_anchors_batch(self.anchors, batch["gt_boxes"], batch["gt_classes"],
                                  batch["gt_valid"], lc.num_classes, lc.iou_thresholds).gt_classes
    num_pos = ((classes >= 0) & (classes != lc.num_classes)).sum().to(torch.float32)
    parts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_loss, "all_reduce_sum", lambda t: num_pos)
        for r in range(2):
            shard = BatchShard.of(batch["images"].shape[0], r, 2)
            part = {k: v[shard.first:shard.first + shard.size] for k, v in batch.items()}
            outputs = state.model.forward_train(part["images"], seeds, self.shared_masks, shard)
            losses, norm = train_loss.compute_losses(
                outputs, self.anchors, part["gt_boxes"], part["gt_classes"], part["gt_valid"],
                state.loss_normalizer, state.step, lc, loss_seed, shard)
            if r == 0:
                (losses["loss_cls"] + losses["loss_box_reg"]).backward()
                losses = {k: v.detach() for k, v in losses.items()}
            parts.append(losses)
    first, second = parts
    losses = {k: first[k] + second[k] for k in ("loss_cls", "loss_box_reg")}
    losses["num_pos_anchors"] = second["num_pos_anchors"]
    return losses["loss_cls"] + losses["loss_box_reg"], losses, norm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, two processes, and two processes resumed from step 2;
    the step-3 checkpoint of the uninterrupted two-process run is kept in
    memory before the resumed run writes its own."""
    root = tmp_path_factory.mktemp("parallel_train_net")
    dataset = root / "bdd"
    _write_bdd_layout(dataset)

    def argv(n, *flags):
        return setup_arg_parser().parse_args(
            ["--config-file", TRAIN_CFG, "--dataset-dir", str(dataset), "--random-seed", "0",
             "--num-devices", str(n), *flags, *map(str, OPTS)])

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net, "launch", functools.partial(launch, timeout_s=LAUNCH_TIMEOUT_S))
        for name, n in (("one", 1), ("one_split", 1), ("two", 2)):
            mp.setenv("POD_COMPARE_DATA_DIR", str(root / name))
            with pytest.MonkeyPatch.context() as split:
                if name == "one_split":
                    split.setattr(TrainStep, "losses", _losses_of_two_processes)
                result = train_net.main(argv(n), device="cpu")
            out[name] = _output_dir(str(root / name))
            out[f"{name}_result"] = result
            out[f"{name}_events"] = _events(out[name])
        two = Checkpointer(out["two"])
        out["steps"] = {name: Checkpointer(out[name]).steps() for name in ("one", "two")}
        out["one_split_final"] = Checkpointer(out["one_split"]).restore(STEPS)
        out["two_final"] = two.restore(STEPS)
        os.remove(two.path(STEPS))
        mp.setenv("POD_COMPARE_DATA_DIR", str(root / "two"))
        out["resumed_result"] = train_net.main(argv(2, "--resume"), device="cpu")
        out["resumed_final"] = two.restore(STEPS)
        out["resumed_events"] = _events(out["two"])[len(out["two_events"]):]
        out["one_final"] = Checkpointer(out["one"]).restore(STEPS)
        yield out
    shutil.rmtree(root, ignore_errors=True)


LOSS_KEYS = ("loss_cls", "loss_box_reg", "total_loss", "num_pos_anchors", "lr")


def _loss_row(events):
    """The row written at the logged step (the last): the first that holds
    the losses (the storage writes its latest value of every scalar)."""
    return next(e for e in events if "total_loss" in e)


def test_two_processes_write_what_one_process_writes(runs):
    assert runs["steps"] == {"one": [2, STEPS], "two": [2, STEPS]}
    rows = lambda events: [(e["iteration"], sorted(k for k in e if k != "time"))
                           for e in events]
    # An evaluation after each step, the losses logged at the last.
    assert [i for i, _ in rows(runs["one_events"])] == [0, 1, 2, 2]
    assert rows(runs["two_events"]) == rows(runs["one_events"])
    assert isinstance(runs["one_result"], train_net.Trainer)
    assert runs["two_result"]["step"] == STEPS  # rank 0's summary of a launched run
    assert runs["two_result"]["latest"]["eval/num_detections"] > 0


def _scaled_errors(got: dict, want: dict) -> dict:
    """Each floating tensor's largest difference over its largest magnitude."""
    return {k: float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in want.items() if v.is_floating_point()}


def test_two_process_losses_and_weights_equal_one_process(runs):
    one, two = _loss_row(runs["one_events"]), _loss_row(runs["two_events"])
    split = _loss_row(runs["one_split_events"])
    assert one["iteration"] == STEPS - 1
    for key in LOSS_KEYS:
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(two[key], split[key], rtol=1e-6, err_msg=key)
    assert np.isfinite(one["total_loss"]) and one["num_pos_anchors"] > 0
    want, got = runs["one_split_final"]["model"], runs["two_final"]["model"]
    assert want.keys() == got.keys()
    worst = max(_scaled_errors(got, want).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-6, worst
    assert runs["two_final"]["step"] == runs["one_final"]["step"] == STEPS


def test_two_process_evaluations_equal_one_process(runs):
    for a, b in zip(runs["two_events"], runs["one_events"]):
        np.testing.assert_allclose(a["eval/mAP"], b["eval/mAP"], atol=1e-4)
        np.testing.assert_allclose(a["eval/AP50"], b["eval/AP50"], atol=1e-4)
        assert a["eval/num_detections"] == b["eval/num_detections"] > 0
    for step in range(1, STEPS + 1):
        got = _key(_eval_json(runs["two"], step))
        assert {r[0] for r in got} == set(range(5)), "not every image was evaluated"
        _assert_keys_close(got, _key(_eval_json(runs["one"], step)))


def test_two_process_resume_equals_the_uninterrupted_run(runs):
    assert runs["resumed_result"]["step"] == STEPS
    a, b = runs["resumed_final"], runs["two_final"]
    worst = max(_scaled_errors(a["model"], b["model"]).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-6, worst
    momenta = [(s["momentum_buffer"], b["optimizer"]["state"][i]["momentum_buffer"])
               for i, s in a["optimizer"]["state"].items()]
    assert len(momenta) == len(b["optimizer"]["state"]) > 0
    assert max(_scaled_errors({0: x}, {0: y})[0] for x, y in momenta) <= 1e-6
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["loss_normalizer"], b["loss_normalizer"])
    assert [e["iteration"] for e in runs["resumed_events"]] == [STEPS - 1, STEPS - 1]
    resumed, logged = _loss_row(runs["resumed_events"]), _loss_row(runs["two_events"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(resumed[key], logged[key], rtol=1e-6, err_msg=key)
