"""Training traffic: ``Trainer.train_step`` on batches staged on the device.

Set-up makes the weights (the backbone He-scaled, the head as the program
initialises one), a ring of distinct batches with their ground truth on
the device, and one ``Trainer`` with the configuration's solver. It loads
the weights and drives that trainer from the seed through its first
steps, through the window's own call and feed (``train_step`` on the
ring's first batches): the output check reads those steps. A few more
steps warm up, then the window dispatches step after step with no sync
between them, records a CUDA event after each, and ends in a
``torch.cuda.synchronize()`` once `seconds` have passed.

The check: the plain reference follows the first `check_steps` steps from
the same weights, batches and seeds, in float32, and compares each step's
loss, the first gradient as the optimizer got it (its momentum after one
step) and the change of the parameters after the steps, leaf by leaf.
"""

import gc
import math
import shutil
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench.harness import gen
from portbench.harness.trace import Spans, profiled
from portbench.reference import train as rtrain


class _Feed:
    """What the Trainer asks of a batch source: a canvas (its batches come
    from the ring, through ``train_step``)."""

    def __init__(self, canvas):
        self.canvas = tuple(canvas)

    def iter_from(self, start: int = 0):
        raise RuntimeError("the benchmark feeds train_step itself")


@dataclass
class State:
    cell: object
    seed: int
    cfg_seed: int
    device: torch.device
    cfg: object
    trainer: object
    sd: Dict[str, torch.Tensor]
    ring: List[dict]
    out_dir: str
    program: Dict[str, object] = field(default_factory=dict)


def solver(cfg) -> rtrain.Solver:
    s, pm = cfg.SOLVER, cfg.MODEL.PROBABILISTIC_MODELING
    return rtrain.Solver(
        num_classes=cfg.MODEL.RETINANET.NUM_CLASSES, base_lr=s.BASE_LR, momentum=s.MOMENTUM,
        weight_decay=s.WEIGHT_DECAY, warmup_factor=s.WARMUP_FACTOR,
        warmup_iters=s.WARMUP_ITERS, steps=tuple(s.STEPS), gamma=s.GAMMA,
        num_convs=cfg.MODEL.RETINANET.NUM_CONVS, dropout_rate=pm.DROPOUT_RATE,
        cls_samples=pm.CLS_VAR_LOSS.NUM_SAMPLES, annealing_step=pm.ANNEALING_STEP or s.STEPS[1],
        focal_alpha=cfg.MODEL.RETINANET.FOCAL_LOSS_ALPHA,
        focal_gamma=cfg.MODEL.RETINANET.FOCAL_LOSS_GAMMA,
        iou_thresholds=tuple(cfg.MODEL.RETINANET.IOU_THRESHOLDS),
        normalizer_momentum=cfg.MODEL.RETINANET.LOSS_NORMALIZER_MOMENTUM)


def build(cell, seed: int, device, extra_opts=()) -> State:
    from pod_compare_tpu_torch.config.setup import merge_configs
    from pod_compare_tpu_torch.train.trainer import Trainer

    conf, traffic = cell.config, cell.traffic
    cfg_seed = seed % (2 ** 31 - 1)
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    opts = list(conf.get("opts", [])) + list(conf.get("train_opts", [])) + \
        list(traffic.get("opts", [])) + ["SEED", cfg_seed, "OUTPUT_DIR", out_dir] + \
        list(extra_opts)
    cfg = merge_configs(conf["train_config"], "", opts)
    if cfg.SOLVER.IMS_PER_BATCH != traffic["batch"]:
        raise ValueError(f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} against the traffic's "
                         f"batch {traffic['batch']}")
    canvas, image = conf["canvas"], conf["image"]
    sd = gen.weights(seed, gen.reference_shapes(conf), "init", device,
                     cfg.MODEL.RETINANET.PRIOR_PROB)
    ring = gen.train_batches(seed + 7, traffic["ring_batches"], traffic["batch"], canvas, image,
                             device, traffic["gt_mean"], cfg.INPUT.MAX_GT_BOXES,
                             traffic["class_weights"], tuple(traffic["box_side_px"]))
    trainer = Trainer(cfg, _Feed(canvas), device=device)
    trainer.state.model.load_state_dict(sd)
    # The state's host generator, which seeds each step's masks and draws,
    # from the run's seed too, so that the reference draws the same.
    trainer.state.generator.manual_seed(cfg_seed)
    return State(cell, seed, cfg_seed, device, cfg, trainer, sd, ring, out_dir)


def _named_trainable(trainer):
    return [(n, p) for n, p in trainer.state.model.named_parameters() if p.requires_grad]


def first_steps(state: State, steps: int) -> None:
    """The program's first `steps` steps from the loaded weights, on the
    ring's first batches; keeps each step's losses, the momentum's norms
    after step 1 and the parameters' change after the last."""
    trainer = state.trainer
    before = {n: p.detach().clone() for n, p in _named_trainable(trainer)}
    losses = []
    for i in range(steps):
        metrics = trainer.train_step(trainer.state, state.ring[i % len(state.ring)])
        losses.append({k: float(metrics[k]) for k in ("loss_cls", "loss_box_reg",
                                                      "total_loss")})
        if i == 0:
            opt = trainer.state.optimizer
            state.program["grad_norms"] = {
                n: float(torch.linalg.vector_norm(opt.state[p]["momentum_buffer"]))
                for n, p in _named_trainable(trainer) if "momentum_buffer" in opt.state[p]}
    state.program["losses"] = losses
    state.program["update_norms"] = {n: float(torch.linalg.vector_norm(p.detach() - before[n]))
                                     for n, p in _named_trainable(trainer)}


def window(state: State, seconds: float, spans: Spans, start: int, max_steps=None):
    """Steps dispatched ahead for `seconds` of the host's clock (or
    `max_steps` steps), then a sync; returns (steps, wall seconds, per-step
    ms between step ends)."""
    trainer, device = state.trainer, state.device
    cuda = device.type == "cuda"
    events, step = [], start
    t0 = time.perf_counter()
    while True:
        n = step - start
        if max_steps is not None and n >= max_steps:
            break
        if time.perf_counter() - t0 >= seconds:
            break
        with spans("train_step"):
            trainer.train_step(trainer.state, state.ring[step % len(state.ring)])
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        step += 1
    with spans("window_sync"):
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return step - start, wall, step_ms


def leaf_gaps(prog: Dict[str, float], ref_norms: Dict[str, float], leaves) -> Dict[str, float]:
    """Per leaf: |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf (inf for a leaf
    the program lacks)."""
    vals = sorted(ref_norms[n] for n in leaves)
    median = vals[len(vals) // 2] if vals else 0.0
    return {n: abs(prog[n] - ref_norms[n]) / max(ref_norms[n], median, 1e-30) if n in prog
            else math.inf for n in leaves}


def _median(values) -> float:
    vals = sorted(values)
    return vals[len(vals) // 2] if vals else 0.0


def compare(program: Dict[str, object], readings: rtrain.Readings) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's total loss;
    box_loss_gap: the same of its box regression loss, a sum over the
    positive anchors alone; grad_gap: the worst leaf of the first
    gradient's norms; update_gap: the worst leaf of the parameters' change
    over the steps, among the leaves whose reference gradient is above a
    thousandth of the median leaf's."""
    def gap(key):
        return max(abs(p[key] - r[key]) / max(abs(r[key]), 1e-30)
                   for p, r in zip(program["losses"], readings.losses))

    grads = readings.grad_norms
    moving = [n for n in grads if grads[n] >= 1e-3 * _median(grads.values())]
    return {
        "loss_gap": gap("total_loss"),
        "box_loss_gap": gap("loss_box_reg"),
        "grad_gap": max(leaf_gaps(program["grad_norms"], grads, list(grads)).values()),
        "update_gap": max(leaf_gaps(program["update_norms"], readings.update_norms,
                                    moving).values()),
    }


def free_program(state: State) -> None:
    if state.trainer is not None:
        state.trainer.close()
    state.trainer = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    shutil.rmtree(state.out_dir, ignore_errors=True)


def reference(state: State, quant=None, half_batch=False) -> rtrain.Readings:
    steps = int(state.cell.traffic["check_steps"])
    batches = [state.ring[i % len(state.ring)] for i in range(steps)]
    return rtrain.run_steps(state.sd, batches, state.cfg_seed, steps, solver(state.cfg),
                            state.cell.config["canvas"], quant=quant, half_batch=half_batch)


def set_up(cell, seed: int, device, spans: Spans, extra_opts=()) -> State:
    """A run's set-up: the state, the first steps the check reads, the
    warm-up steps."""
    state = build(cell, seed, device, extra_opts)
    check_steps = int(cell.traffic["check_steps"])
    first_steps(state, check_steps)
    window(state, math.inf, spans, check_steps, max_steps=int(cell.traffic["warmup_steps"]))
    return state


def check(state: State) -> Dict[str, float]:
    """After the window: frees the program, runs the reference over the
    first steps and compares (the reference's readings kept in
    ``state.program["readings"]``)."""
    free_program(state)
    readings = reference(state)
    state.program["readings"] = readings
    return compare(state.program, readings)


def run(ctx):
    from pod_compare_tpu_torch.ops.kernels import dropout as kdropout, focal as kfocal

    cell, device, traffic = ctx.cell, ctx.device, ctx.cell.traffic
    spans = Spans()
    state = set_up(cell, ctx.seed, device, spans)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t0
    spans.records.clear()
    k1, k2 = kdropout.LAUNCHES, kfocal.LAUNCHES
    start = int(traffic["check_steps"]) + int(traffic["warmup_steps"])
    steps, wall, step_ms = window(state, ctx.seconds, spans, start)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    k1, k2 = kdropout.LAUNCHES - k1, kfocal.LAUNCHES - k2
    record = {
        "kind": "train", "cell": cell, "setup_s": setup_s, "window_s": wall, "steps": steps,
        "batch": int(traffic["batch"]), "images": steps * int(traffic["batch"]),
        "step_ms": step_ms, "peak_bytes": peak, "trace": None, "host_trace": None,
        "k1_launches": k1, "k2_launches": k2,
    }
    if ctx.trace:
        traces, at = [], start + steps
        for host in (False, True):
            with profiled(spans, traces, host):
                window(state, math.inf, spans, at, max_steps=int(traffic["profile_steps"]))
            at += int(traffic["profile_steps"])
        record["trace"], record["host_trace"] = traces
    losses = state.program["losses"]
    diagnostics = [
        f"window: {steps} steps of {traffic['batch']} images, {wall:.6f} s",
        f"launches: K1 {k1} ({k1 / max(steps, 1):.1f} a step), K2 {k2} "
        f"({k2 / max(steps, 1):.1f} a step)",
        "first steps' losses: " + ", ".join(f"{l['total_loss']:.6g}" for l in losses),
        "device ms between step ends, quartiles: " + (", ".join(
            f"{q:.3f}" for q in statistics.quantiles(step_ms, n=4)) if len(step_ms) > 1
            else "too few"),
    ]
    nums = check(state)
    return record, nums, diagnostics, steps, 0
