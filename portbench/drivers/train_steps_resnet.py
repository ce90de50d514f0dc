"""Training traffic on a configuration of any ResNet or ResNeXt backbone:
``train_steps``' run, set-up, window and check, on the backbone that the
configuration file's `model` names (depth, num_groups, width_per_group,
stride_in_1x1, pixel_std).

Set-up makes the weights' shapes and the plain reference from those keys
(``reference/resnets.py``): every convolution He-scaled as ``harness/gen``
scales it, the stem then multiplied per input channel by PIXEL_STD, so
that its output on raw pixels is what a PIXEL_STD-1 stem gives, and each
residual branch's last FrozenBN scale set to the configuration file's
`residual_scale` (``gen``'s 0.5 without it). The check runs the
reference's training steps `reference_chunk` images at a time (the
traffic's key; the whole batch without it), with the batch's labels,
normaliser, focal normals and masks. Each step's grouped 3x3 calls
(``models/resnet.py``'s ``GROUPED_CONV_CALLS``) are counted in the window
beside K1's and K2's launches.

A traced run profiles `profile_steps` more steps with the operators'
input shapes recorded and attributes to the grouped convolutions every
kernel, fill and copy launched inside a forward (``aten::convolution``) or
backward (``aten::convolution_backward``) whose input has more channels
than its weight takes (``grouped_kernels``): the kernels cuDNN picks for a
grouped 3x3 share names with those of ungrouped convolutions, so a name
alone does not tell them apart.
"""

import math
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.harness import bench, gen
from portbench.harness.trace import Spans, profiled
from portbench.reference import resnets

ts = bench.load_module("drivers", "train_steps")
compare, free_program, leaf_gaps, window = ts.compare, ts.free_program, ts.leaf_gaps, ts.window


def backbone(cell) -> resnets.Backbone:
    return resnets.Backbone.of(cell.config["model"])


def build(cell, seed: int, device, extra_opts=()) -> "ts.State":
    """``train_steps.build`` with this backbone's weights."""
    from pod_compare_tpu_torch.config.setup import merge_configs
    from pod_compare_tpu_torch.train.trainer import Trainer

    conf, traffic, arch = cell.config, cell.traffic, backbone(cell)
    cfg_seed = seed % (2 ** 31 - 1)
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    opts = list(conf.get("opts", [])) + list(conf.get("train_opts", [])) + \
        list(traffic.get("opts", [])) + ["SEED", cfg_seed, "OUTPUT_DIR", out_dir] + \
        list(extra_opts)
    cfg = merge_configs(conf["train_config"], "", opts)
    if cfg.SOLVER.IMS_PER_BATCH != traffic["batch"]:
        raise ValueError(f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} against the traffic's "
                         f"batch {traffic['batch']}")
    m = conf["model"]
    shapes = resnets.parameter_shapes(arch, m["num_classes"], m["num_anchors"], m["num_convs"],
                                      m["cls_var"], m["bbox_cov_dims"])
    sd = gen.weights(seed, shapes, "init", device, cfg.MODEL.RETINANET.PRIOR_PROB)
    stem = "backbone.bottom_up.stem.conv1.weight"
    sd[stem] = sd[stem] * torch.tensor(arch.pixel_std, device=device).view(1, 3, 1, 1)
    for k in sd:
        if k.endswith(".conv3.norm.weight"):
            sd[k].fill_(conf.get("residual_scale", 0.5))
    ring = gen.train_batches(seed + 7, traffic["ring_batches"], traffic["batch"], conf["canvas"],
                             conf["image"], device, traffic["gt_mean"], cfg.INPUT.MAX_GT_BOXES,
                             traffic["class_weights"], tuple(traffic["box_side_px"]))
    trainer = Trainer(cfg, ts._Feed(conf["canvas"]), device=device)
    trainer.state.model.load_state_dict(sd)
    trainer.state.generator.manual_seed(cfg_seed)
    return ts.State(cell, seed, cfg_seed, device, cfg, trainer, sd, ring, out_dir)


def reference(state, quant=None, half_batch=False):
    traffic = state.cell.traffic
    steps = int(traffic["check_steps"])
    batches = [state.ring[i % len(state.ring)] for i in range(steps)]
    return resnets.run_steps(state.sd, batches, state.cfg_seed, steps, ts.solver(state.cfg),
                             state.cell.config["canvas"], backbone(state.cell), quant=quant,
                             half_batch=half_batch, chunk=traffic.get("reference_chunk"))


def set_up(cell, seed: int, device, spans: Spans, extra_opts=()):
    """A run's set-up: the state, the first steps the check reads, the
    warm-up steps."""
    state = build(cell, seed, device, extra_opts)
    check_steps = int(cell.traffic["check_steps"])
    ts.first_steps(state, check_steps)
    window(state, math.inf, spans, check_steps, max_steps=int(cell.traffic["warmup_steps"]))
    return state


def check(state):
    """After the window: frees the program, runs the reference over the
    first steps and compares (the readings kept in the state)."""
    free_program(state)
    readings = reference(state)
    state.program["readings"] = readings
    return compare(state.program, readings)


CONV_OPS = {"aten::convolution": (0, 1), "aten::convolution_backward": (1, 2)}


def is_grouped(op: str, shapes: Sequence) -> bool:
    """A convolution's forward or backward operator whose input has more
    channels than its weight takes (input_shapes from the profiler)."""
    at = CONV_OPS.get(op)
    if at is None or len(shapes) <= at[1]:
        return False
    x, w = shapes[at[0]], shapes[at[1]]
    return len(x) == 4 and len(w) == 4 and x[1] != w[1]


def conv_ops(events) -> List[Tuple[str, list, List[Tuple[str, float]]]]:
    """(operator, input shapes, [(kernel, device us)]) of each convolution
    operator among a profile's events, with the kernels of its subtree."""
    out = []
    for e in events:
        if e.name not in CONV_OPS:
            continue
        kernels, stack = [], [e]
        while stack:
            node = stack.pop()
            kernels += [(k.name, float(k.duration)) for k in node.kernels]
            stack += node.cpu_children
        out.append((e.name, e.input_shapes, kernels))
    return out


def grouped_kernels(ops) -> Dict[str, float]:
    """Device seconds by kernel name of the grouped convolutions' operators."""
    out: Dict[str, float] = defaultdict(float)
    for op, shapes, kernels in ops:
        if is_grouped(op, shapes):
            for name, us in kernels:
                out[name] += us * 1e-6
    return dict(out)


def grouped_conv_census(state, spans: Spans, start: int, steps: int) -> Dict[str, float]:
    """``grouped_kernels`` over `steps` steps profiled with shapes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if state.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        window(state, math.inf, spans, start, max_steps=steps)
    return grouped_kernels(conv_ops(prof.events()))


def run(ctx):
    from pod_compare_tpu_torch.models import resnet
    from pod_compare_tpu_torch.ops.kernels import dropout as kdropout, focal as kfocal

    cell, device, traffic = ctx.cell, ctx.device, ctx.cell.traffic
    spans = Spans()
    state = set_up(cell, ctx.seed, device, spans)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t0
    spans.records.clear()
    k1, k2, gconv = kdropout.LAUNCHES, kfocal.LAUNCHES, resnet.GROUPED_CONV_CALLS
    start = int(traffic["check_steps"]) + int(traffic["warmup_steps"])
    steps, wall, step_ms = window(state, ctx.seconds, spans, start)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    k1, k2 = kdropout.LAUNCHES - k1, kfocal.LAUNCHES - k2
    gconv = resnet.GROUPED_CONV_CALLS - gconv
    record = {
        "kind": "train", "cell": cell, "setup_s": setup_s, "window_s": wall, "steps": steps,
        "batch": int(traffic["batch"]), "images": steps * int(traffic["batch"]),
        "step_ms": step_ms, "peak_bytes": peak, "trace": None, "host_trace": None,
        "k1_launches": k1, "k2_launches": k2, "gconv_calls": gconv,
    }
    if ctx.trace:
        traces, at = [], start + steps
        for host in (False, True):
            with profiled(spans, traces, host):
                window(state, math.inf, spans, at, max_steps=int(traffic["profile_steps"]))
            at += int(traffic["profile_steps"])
        record["trace"], record["host_trace"] = traces
        record["gconv_kernels"] = grouped_conv_census(state, spans, at,
                                                      int(traffic["profile_steps"]))
    losses = state.program["losses"]
    per = max(steps, 1)
    diagnostics = [
        f"window: {steps} steps of {traffic['batch']} images, {wall:.6f} s",
        f"launches: K1 {k1} ({k1 / per:.1f} a step), K2 {k2} ({k2 / per:.1f} a step); "
        f"grouped 3x3 calls {gconv} ({gconv / per:.1f} a step)",
        "first steps' losses: " + ", ".join(f"{l['total_loss']:.6g}" for l in losses),
        "device ms between step ends, quartiles: " + (", ".join(
            f"{q:.3f}" for q in statistics.quantiles(step_ms, n=4)) if len(step_ms) > 1
            else "too few"),
    ]
    for name, seconds in sorted(record.get("gconv_kernels", {}).items(), key=lambda kv: -kv[1]):
        diagnostics.append(f"grouped 3x3 kernel: {seconds * 1e3 / int(traffic['profile_steps']):.3f}"
                           f" ms a step: {name}")
    nums = check(state)
    return record, nums, diagnostics, steps, 0
