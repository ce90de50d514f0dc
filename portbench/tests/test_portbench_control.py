"""The output check's controls.

The control of each cell is the plain reference put in the program's place
and computed in the precision below the configuration's: its convolutions
in float8 (the configurations compute in bfloat16) and, for inference, the
candidate core from bfloat16 class probabilities (the core computes in
float32). An inference control must fail at least one of the cell's
numbers against the cell's limits. A training cell's float8 control reads
above the sound runs but not above its limits on every seed (PERF.md, the
output check); its faults must fail: half the batch left out here, a state
left unchanged in test_portbench_faults.py. The CPU tests run at a small
size; the card tests at the cell's own size.
"""

import pytest
import torch

from conftest import small
from portbench import calibrate
from portbench.harness import bench
from portbench.harness.trace import Spans
from portbench.reference import model as ref

INFER = ["dropout_bayes_od_mc_b8", "clsvar_standard_nms_b8"]
TRAIN = ["dropout_train_b4"]


def _fails(numbers, limits):
    return any(k in limits and v > limits[k] for k, v in numbers.items())


def _infer_controls(workload, device, tweak, seed):
    cell = bench.load_cell(workload)
    if tweak:
        tweak(cell)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    state = calibrate.infer_program(driver, cell, seed, torch.device(device))
    with torch.no_grad():
        fp8 = calibrate.reference_gap(driver, state, ref.fp8)
        core = driver.detection_numbers(state, probs_dtype=torch.bfloat16)
        sound = driver.numbers(state)
    return cell.limits, sound, fp8, core


def _train_controls(workload, device, tweak, seed):
    cell = bench.load_cell(workload)
    if tweak:
        tweak(cell)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    state = driver.set_up(cell, seed, torch.device(device), Spans())
    sound = driver.check(state)
    full = state.program["readings"]
    as_program = lambda r: {"losses": r.losses, "grad_norms": r.grad_norms,
                            "update_norms": r.update_norms}
    fp8 = driver.compare(as_program(driver.reference(state, quant=ref.fp8)), full)
    half = driver.compare(as_program(driver.reference(state, half_batch=True)), full)
    return cell.limits, sound, fp8, half


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", INFER)
def test_inference_controls_fail(workload):
    limits, sound, fp8, core = _infer_controls(workload, "cpu", small, 2147484401)
    assert not _fails(sound, limits), sound
    assert _fails(fp8, limits), fp8
    assert _fails(core, limits), core


@pytest.mark.parametrize("workload", TRAIN)
def test_training_controls(workload):
    limits, sound, fp8, half = _train_controls(workload, "cpu", small, 2147484402)
    assert not _fails(sound, limits), sound
    assert fp8["grad_gap"] > sound["grad_gap"] and fp8["update_gap"] > sound["update_gap"]
    assert _fails(half, limits), half


@pytest.mark.parametrize("workload", INFER)
def test_inference_controls_fail_on_the_card(workload):
    _cuda()
    limits, sound, fp8, core = _infer_controls(workload, "cuda", None, 2147484403)
    assert not _fails(sound, limits), sound
    assert _fails(fp8, limits) and _fails(core, limits), (fp8, core)


@pytest.mark.parametrize("workload", TRAIN)
def test_training_controls_on_the_card(workload):
    _cuda()
    limits, sound, fp8, half = _train_controls(workload, "cuda", None, 2147484404)
    assert not _fails(sound, limits), sound
    assert fp8["grad_gap"] > sound["grad_gap"] and fp8["update_gap"] > sound["update_gap"]
    assert _fails(half, limits), half
