"""Readings of a cell's output check over many seeds in one process, for
setting its limits (``limits/<workload>.json``); not part of a run.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

For each of --seeds, the program as a run drives it (the driver's own
``set_up``, then the window's first batches for inference) and the numbers
its ``check`` compares. For each of --control-seeds, the same numbers of the
controls:
  - inference: the program with its int8 head (PROBABILISTIC_INFERENCE.
    HEAD_QUANT int8, the program's own lower-precision path) against the
    float32 reference; the reference's forward in float8 e4m3 put in the
    program's place; the reference's core computed from bfloat16 class
    probabilities put in the program's place;
  - training: the reference in float8 (e4m3 forward, e5m2 gradients) in
    the program's place, and the fault of half the batch left out (the mean
    taken over the rest), planted in the reference put in the program's
    place; the leaves with the largest gaps beside them.
Inference reads a window of the cell's check batches at the cell's load.
One JSON line a reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

import torch  # noqa: E402

from portbench.harness import bench  # noqa: E402
from portbench.harness.trace import Spans  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def emit(kind, seed, nums):
    print(json.dumps({"kind": kind, "seed": seed, **nums}), flush=True)
    return nums


def infer_program(driver, cell, seed, device, extra_opts=()):
    """A run's set-up and its window's first batches, through the check
    batches, as the run drives them; the program freed after."""
    spans = Spans()
    state = driver.set_up(cell, seed, device, spans, extra_opts)
    driver.loop(state, math.inf, spans, torch.Generator().manual_seed(seed), 0, capture=True,
                max_batches=max(state.check_batches) + 1)
    return state


def reference_gap(driver, state, quant) -> dict:
    """The reference in a lower precision put in the program's place: its
    head outputs against the float32 reference's, as `head_numbers`."""
    conf = state.cell.config["model"]
    rate = float(state.cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE)
    gaps = {"logit_gap": 0.0, "delta_gap": 0.0}
    for i in state.check_batches:
        images = driver._batch_images(state, i).to(state.device)
        outs, deltas = [], []
        for q in (None, quant):
            if state.num_runs > 1:
                seeds = driver.bits.call_dropout_seeds(state.call_seeds[i], state.num_runs,
                                                       conf["num_convs"]).tolist()
                o, d = ref.mc_outputs(state.sd, images, seeds, rate, conf["num_convs"],
                                      conf["num_classes"], q)
            else:
                o, d = ref.single_outputs(state.sd, images, conf["num_convs"],
                                          conf["num_classes"], q), None
            outs.append(o)
            deltas.append(d)
        for b in range(state.batch):
            for k in driver.HEAD_KEYS:
                if outs[0].get(k) is None:
                    continue
                name = "logit_gap" if k in ("box_cls", "box_cls_var") else "delta_gap"
                gaps[name] = max(gaps[name], driver._gap(outs[1][k][b], outs[0][k][b]))
            if deltas[0] is not None:
                gaps["delta_gap"] = max(gaps["delta_gap"],
                                        driver._gap(deltas[1][:, b], deltas[0][:, b]))
    return gaps


def calibrate_infer(driver, cell, seeds, control_seeds, device):
    for seed in seeds:
        state = infer_program(driver, cell, seed, device)
        emit("program", seed, driver.check(state))
    for seed in control_seeds:
        state = infer_program(driver, cell, seed, device,
                              ["PROBABILISTIC_INFERENCE.HEAD_QUANT", "int8"])
        emit("control_int8_program", seed, driver.check(state))
        state = infer_program(driver, cell, seed, device)
        driver.free_program(state)
        with torch.no_grad():
            emit("control_fp8_reference", seed, reference_gap(driver, state, ref.fp8))
            emit("control_bf16_core", seed,
                 driver.detection_numbers(state, probs_dtype=torch.bfloat16))


def worst_leaves(driver, program, readings, n=3):
    """The leaves with the largest gaps of the first gradient's norms."""
    g = driver.leaf_gaps(program["grad_norms"], readings.grad_norms, list(readings.grad_norms))
    return {k: [g[k], readings.grad_norms[k]] for k in sorted(g, key=lambda k: -g[k])[:n]}


def calibrate_train(driver, cell, seeds, control_seeds, device):
    for seed in seeds:
        state = driver.set_up(cell, seed, device, Spans())
        nums = driver.check(state)
        nums["worst_leaves"] = worst_leaves(driver, state.program, state.program["readings"])
        emit("program", seed, nums)
    for seed in control_seeds:
        state = driver.build(cell, seed, device)
        driver.free_program(state)
        full = driver.reference(state)
        as_program = lambda r: {"losses": r.losses, "grad_norms": r.grad_norms,
                                "update_norms": r.update_norms}
        fp8 = as_program(driver.reference(state, quant=ref.fp8))
        nums = driver.compare(fp8, full)
        nums["worst_leaves"] = worst_leaves(driver, fp8, full)
        emit("control_fp8_reference", seed, nums)
        emit("fault_half_batch", seed,
             driver.compare(as_program(driver.reference(state, half_batch=True)), full))


def main(argv=None, device=None, tweak=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    if tweak is not None:
        tweak(cell)
    device = torch.device(device or "cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    driver = bench.load_module("drivers", cell.traffic["driver"])
    if cell.traffic["driver"] == "predictor_loop":
        calibrate_infer(driver, cell, seeds, control, device)
    else:
        calibrate_train(driver, cell, seeds, control, device)
    print(json.dumps({"seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
