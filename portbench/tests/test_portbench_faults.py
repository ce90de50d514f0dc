"""A run of each kind with its timed path broken underneath: the harness's
look for a card skipped, the rest of a run driven at a small size on the
CPU, and `correct` must come out false, once for each fault the cell can
have. One card: no exchange between cards to leave out."""

import json

import pytest
import torch

from conftest import small
from portbench import run


def run_cell(capsys, workload, seconds):
    rc = run.main(["--workload", workload, "--seed", "2147484011", "--seconds", seconds,
                   "--trace", "0"], device="cpu", tweak=small)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _altered_answer(dets):
    """One detection's box moved where the predictor produces it."""
    boxes = dets.boxes.clone()
    boxes[0, 0] += 3.0
    return dets._replace(boxes=boxes)


def _half_batch(dets):
    """Detections of the batch's first half only, repeated for the rest."""
    half = dets.boxes.shape[0] // 2
    return type(dets)(*[None if f is None else torch.cat([f[:half], f[:half]])[:f.shape[0]]
                        for f in dets])


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch], ids=lambda f: f.__name__)
def test_inference_faults(capsys, monkeypatch, fault):
    from pod_compare_tpu_torch.inference.predictor import PipelineModule

    detect = PipelineModule.detect

    def broken(self, *args, **kwargs):
        return fault(detect(self, *args, **kwargs))

    monkeypatch.setattr(PipelineModule, "detect", broken)
    result = run_cell(capsys, "dropout_bayes_od_mc_b8", "8")
    assert not result["correct"]
    assert result["checks"]["det_gap"]["value"] > result["checks"]["det_gap"]["limit"]


def test_training_step_returns_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result = run_cell(capsys, "dropout_train_b4", "1")
    assert not result["correct"]


def test_training_step_leaves_out_half_the_batch(capsys, monkeypatch):
    from pod_compare_tpu_torch.train.trainer import TrainStep

    losses = TrainStep.losses

    def half(self, state, batch, *args, **kwargs):
        cut = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return losses(self, state, cut, *args, **kwargs)

    monkeypatch.setattr(TrainStep, "losses", half)
    result = run_cell(capsys, "dropout_train_b4", "1")
    assert not result["correct"]
