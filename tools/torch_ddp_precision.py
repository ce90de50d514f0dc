#!/usr/bin/env python3
"""Where the port's data-parallel gradients part from the one-process step's.

    python tools/torch_ddp_precision.py [--device cuda|cpu] [--canvas H W]
        [--batch 4] [--state init|random] [--steps 1] [--seed 0]

From one training state of the flagship training config (the focal
kernel's route, CLS_VAR_LOSS.IMPL 'pallas'), the gradients of one step over
one global batch of ``--batch`` random images and boxes
(``train.RandomBatches``), five ways:

  one32    one process, float32: the kernels on CUDA, their plain versions
           on the CPU;
  two32    two processes (gloo, both on the device) through
           DistributedDataParallel, float32, the way the trainer steps;
  split32  one process, the batch in the two processes' halves, each half's
           loss over the whole batch's positive count, the backward passes
           summed: two32's arithmetic without the processes
           (``chip_smoke.split_step_gradients``);
  one64, two64   one and two processes in float64, through the kernels'
           plain versions (the kernels take float32 and bfloat16 only).

The state: ``init`` is the trainer's (``create_train_state``);
``backbone`` warm-starts its backbone from ``chip_smoke.random_jax_params``,
as chip_smoke's phase 13 does; ``random`` loads every weight from it, whose
head is not a training init and makes the first steps' losses large.
``--steps`` one-process float32 steps are taken from it before the
measured one.

For every gradient tensor it takes the largest difference over the scale of
one64's, and prints one JSON line per comparison (the worst tensor, and the
log-variance head's ``head.cls_var.weight``), then the card's name and power
limit where there is a card. If two64 agrees with one64 to float64's
rounding while two32 and split32 sit as far from one32 as one32 sits from
one64, the float32 gap is the summation order of a sum whose terms cancel,
not a fault of the normaliser, the rows' random streams or the loss scaling.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the repository's root)
from pod_compare_tpu_torch.models import build_anchor_generator, convert  # noqa: E402
from pod_compare_tpu_torch.ops.kernels import dropout as kd  # noqa: E402
from pod_compare_tpu_torch.ops.kernels import focal as kf  # noqa: E402
from pod_compare_tpu_torch.parallel import (  # noqa: E402
    BatchShard,
    launch,
    local_device,
    process_count,
    process_index,
)
from pod_compare_tpu_torch.train import RandomBatches, create_train_state, make_train_step  # noqa: E402
from pod_compare_tpu_torch.train.trainer import batch_to_device  # noqa: E402

DTYPES = (torch.float32, torch.float64)


@contextlib.contextmanager
def plain_kernels():
    """Both kernels' plain versions on every device, in float64 too (their
    dtype checks are the kernels')."""
    saved = (kd.dropout_levels, kd.dropout_levels_backward, kd._DTYPE_CODES, kf.focal,
             kf._check)
    kd.dropout_levels = kd.dropout_levels_plain
    kd.dropout_levels_backward = kd.dropout_levels_backward_plain
    kd._DTYPE_CODES = {**kd._DTYPE_CODES, torch.float64: None}
    kf._check = lambda *args, **kwargs: None
    kf.focal = (lambda x, s, t, seed, n, alpha=0.25, gamma=2.0, index_base=0:
                kf.focal_plain(x, s, t, kf._int32(seed), n, alpha, gamma, index_base))
    try:
        yield
    finally:
        (kd.dropout_levels, kd.dropout_levels_backward, kd._DTYPE_CODES, kf.focal,
         kf._check) = saved


def setup(args, device):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = chip_smoke.train_cfg(args.seed, tempfile.gettempdir(),
                               ["PARALLEL.COMPUTE_DTYPE", "float32"])
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(tuple(args.canvas)),
                              device=device)
    batches = RandomBatches(tuple(args.canvas), args.batch, cfg.MODEL.RETINANET.NUM_CLASSES,
                            cfg.INPUT.MAX_GT_BOXES, seed=args.seed)
    return cfg, anchors, batches


def load_state(cfg, device, saved: bytes, dtype):
    state = create_train_state(cfg, device, seed=0)
    state.load_state_dict(torch.load(io.BytesIO(saved), weights_only=True))
    if dtype == torch.float64:
        state.model.double()
        state.model.compute_dtype = state.model.head.compute_dtype = torch.float64
    return state


def gradients(model) -> dict:
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def kernels_for(dtype):
    return plain_kernels() if dtype == torch.float64 else contextlib.nullcontext()


def one_process(cfg, anchors, saved, whole, device, dtype, split: bool):
    state = load_state(cfg, device, saved, dtype)
    step = make_train_step(cfg, anchors)
    seeds, loss_seed = step.draw_seeds(state.generator)
    with kernels_for(dtype):
        if split:
            chip_smoke.split_step_gradients(step, state, whole, seeds, loss_seed, 2)
        else:
            total, _, _ = step.losses(state, whole, seeds, loss_seed)
            total.backward()
    return gradients(state.model)


def two_process_rank(args, saved: bytes, device):
    """One rank: the data-parallel gradients in each dtype, as the
    trainer's step takes them (its share of the loss times the process
    count, the all-reduce averaging); rank 0 returns them."""
    device = local_device(device)
    cfg, anchors, batches = setup(args, device)
    whole = batch_to_device(batches.batch(args.steps), device)
    shard = BatchShard.of(args.batch)
    local = {k: v[shard.first:shard.first + shard.size] for k, v in whole.items()}
    out = {}
    for dtype in DTYPES:
        state = load_state(cfg, device, saved, dtype)
        step = make_train_step(cfg, anchors)
        step.data_parallel(state.model)
        seeds, loss_seed = step.draw_seeds(state.generator)
        with kernels_for(dtype):
            total, _, _ = step.losses(state, local, seeds, loss_seed)
            (total * process_count()).backward()
        if process_index() == 0:
            out[dtype] = gradients(state.model)
        del state, step
    return out


def report(name: str, got: dict, want: dict) -> dict:
    errors = chip_smoke.scaled_errors(got, want)
    worst = max(errors.items(), key=lambda kv: kv[1])
    return {"comparison": name, "worst": worst[0], "worst_error": worst[1],
            "cls_var_weight_error": errors["head.cls_var.weight"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--canvas", type=int, nargs=2, default=list(chip_smoke.CANVAS))
    parser.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    parser.add_argument("--state", choices=("init", "backbone", "random"), default="random")
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    cfg, anchors, batches = setup(args, device)

    state = create_train_state(cfg, device, seed=0)
    if args.state != "init":
        weights = convert.from_jax_params(chip_smoke.random_jax_params(args.seed,
                                                                       chip_smoke.NUM_CLASSES))
        if args.state == "backbone":
            weights = {k: v for k, v in weights.items() if k.startswith("backbone.")}
        state.model.load_state_dict(weights, strict=False)
    step = make_train_step(cfg, anchors)
    losses = []
    for k in range(args.steps):
        metrics = step(state, batch_to_device(batches.batch(k), device))
        losses.append({key: float(v) for key, v in metrics.items()})
    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    saved = buf.getvalue()
    del state, step

    whole = batch_to_device(batches.batch(args.steps), device)
    grads = {}
    for dtype in DTYPES:
        grads[f"one{dtype.itemsize * 8}"] = one_process(cfg, anchors, saved, whole, device,
                                                        dtype, split=False)
    grads["split32"] = one_process(cfg, anchors, saved, whole, device, torch.float32, split=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    two = launch(two_process_rank, 2, (args, saved, str(device)), device=str(device),
                 backend="gloo", timeout_s=1800)
    grads["two32"], grads["two64"] = two[torch.float32], two[torch.float64]

    print(json.dumps({"state": args.state, "steps_before": args.steps, "losses": losses,
                      "canvas": args.canvas, "batch": args.batch, "device": str(device)}))
    ref = grads["one64"]
    for name in ("one32", "two32", "split32", "two64"):
        print(json.dumps(report(f"{name} against one64", grads[name], ref)))
    print(json.dumps(report("two32 against one32", grads["two32"], grads["one32"])))
    print(json.dumps(report("split32 against two32", grads["split32"], grads["two32"])))
    print(json.dumps(report("split32 against one32", grads["split32"], grads["one32"])))
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
