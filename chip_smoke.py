#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python chip_smoke.py [--seed N]

Phases, each printing its seconds on its own line as it ends:
  1. device: the card's name and power limit (nvidia-smi); build both CUDA
     kernels of csrc/ with nvcc into build/, one nvcc each, started
     together, and print what ptxas reports of them.
  2. kernel: the dropout kernel against its plain PyTorch version at the
     main path's P3 shape, float32 and bfloat16, per-sample and
     batch-shared: bit-identical outputs, keep share inside a binomial band,
     one mask across the batch when shared; kernel, plain and bound times
     (device time of launches replayed from a CUDA graph, on inputs that
     do not fit in L2 and on one that does).
  3. slice: the flagship BayesOD + MC-dropout(10) predictor at full R50-FPN
     width on the 736x1280 BDD canvas, batch 2, random weights from the
     seed: the launch count of one call, finite outputs, PSD covariances,
     a detection and a fused cluster in every image; ms per batch (median
     of 10 calls), img/s and peak device memory.
  4. reference: the same predictor at a small size in float32 on the GPU
     against its plain PyTorch path on the CPU, same weights, same masks.
  5. focal kernel: the stochastic focal kernel against its plain version at
     the training path's shape (4, 176580, 7), S = 10 and S = 3: every plane
     finite and within 1e-5 of its scale; kernel time (CUDA-graph replay,
     L2-cold), its bound (the largest of bytes, instruction issue and MUFU
     work), the plain version's time, and the 'threefry' sample bank's for
     context.
  6. dropout backward: the dropout kernel's forward and its seed-replay
     backward against their plain versions at the P3 shape of a training
     step, bf16 and f32, per-sample and batch-shared masks, channels_last
     and NCHW cotangents: bit-identical; the backward's time and byte bound.
  7. train: the Trainer on the flagship training config with the fused focal
     kernel (CLS_VAR_LOSS.IMPL 'pallas'), batch 4 on the 736x1280 canvas,
     random weights from the seed (the backbone warm-started from a .pth),
     random ground truth: 6 steps through Trainer.train with 80 dropout and
     1 focal launch per step, finite losses, frozen stem/res2, moved head, a
     checkpoint read back to the same state; then 1 untimed and 5 timed
     steps: ms/step (median), img/s, peak device memory.
  8. train reference: one train step at a small size in float32 on the GPU
     against the same step on the CPU through the plain versions, same
     weights, seeds and batch, the CPU's tower dropout keeping the GPU's
     ReLU gates (an input within rounding of 0 can take either sign on two
     devices): losses and every gradient within 1e-3 of each tensor's
     scale, and at most 1e-5 of the CPU's own gates differing from the
     GPU's. The same step with the CPU's own gates is printed beside it.
Then one JSON line of the kernels, the nvidia-smi line, and the result line.

It needs a CUDA device and the repository around it; it exits non-zero
without either, and on any failed check.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor, detections_to_json
from pod_compare_tpu_torch.models import (
    KernelDropout,
    TowerDropout,
    build_anchor_generator,
    build_model,
    convert,
    level_offsets,
)
from pod_compare_tpu_torch.ops import losses as plosses
from pod_compare_tpu_torch.ops.kernels import _build
from pod_compare_tpu_torch.ops.kernels import dropout as kdropout
from pod_compare_tpu_torch.ops.kernels import focal as kfocal
from pod_compare_tpu_torch.train import RandomBatches, Trainer
from pod_compare_tpu_torch.train.trainer import batch_to_device

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
INFER_CFG = "Inference/bayes_od_mc_dropout.yaml"
CANVAS = (736, 1280)  # BDD 720x1280 padded to a multiple of 32
BATCH = 2
P3_SHAPE = (BATCH, 256, CANVAS[0] // 8, CANVAS[1] // 8)
IMAGE_SIZES = np.array([[720, 1280]] * BATCH, np.float32)  # (h, w) before padding
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# H100 SXM at its 1.98 GHz boost clock (NVIDIA data sheet): 132 SMs issue 128
# thread-instructions a clock (the data sheet's 67 TFLOP/s in float32 counts
# an FMA as two), and their special-function units (MUFU: exp2, log2, sin,
# cos, rsqrt, rcp) do 16 a clock per SM.
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
TRAIN_BATCH = 4
TRAIN_P3_SHAPE = (TRAIN_BATCH, 256, CANVAS[0] // 8, CANVAS[1] // 8)
NUM_CLASSES = 7
# Operations of the focal kernel (csrc/focal.cu), counted from its source,
# each add, multiply, FMA, compare, select, shift, logical op, conversion or
# transcendental as one instruction and each transcendental also as one MUFU
# operation (the least a fast-math version could take; the precise ones take
# more). Per element: the block key (4), clamp, std and its exp (4), gate (3),
# alpha_t and 2t-1 (4), the three outputs (5): 20, of which 1 MUFU. Per pair
# of draws: two hashes (18) and uniforms (8), the take test (1), Box-Muller
# (log, sqrt, cos, sin and 4 more): 35, of which 4 MUFU. Per draw: the
# sampled logit (1), sigmoid (exp, add, reciprocal), cross-entropy (max, FMA,
# exp, log1p, add), the focal loss (4) and its derivative (8), the three
# accumulations (3): 24, of which 4 MUFU.
FOCAL_OPS = {"element": (20, 1), "pair": (35, 4), "draw": (24, 4)}
MAX_GATE_FLIPS = 1e-5  # share of tower gates the GPU and CPU may disagree on
RESNET_BLOCKS = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fns, iters: int) -> float:
    """Mean device milliseconds of `iters` calls, cycling through `fns`,
    captured in one CUDA graph: the host's cost of launching them is not in
    the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ weights
def random_jax_params(seed: int, num_classes: int, num_anchors: int = 9, cov_dims: int = 4):
    """Full-width R50-FPN RetinaNet weights in the JAX package's parameter
    tree (HWIO kernels, FrozenBN scale/bias/mean/var) from a seed.

    He-scaled convs; the last FrozenBN of each residual branch scales by 0.5
    so activations grow slowly through the 16 blocks."""
    rng = np.random.default_rng(seed)

    def kernel(k, cin, cout, gain=2.0):
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        return w * np.float32(math.sqrt(gain / (k * k * cin)))

    def norm(c, scale=1.0):
        return {
            "scale": np.full(c, scale, np.float32),
            "bias": (0.1 * rng.standard_normal(c, dtype=np.float32)),
            "mean": np.zeros(c, np.float32),
            "var": np.ones(c, np.float32),
        }

    def biased(k, cin, cout, gain=2.0):
        return {"kernel": kernel(k, cin, cout, gain), "bias": np.zeros(cout, np.float32)}

    resnet = {"stem_conv1": {"kernel": kernel(7, 3, 64, gain=2.0 / 128.0 ** 2)},
              "stem_norm1": norm(64)}
    cin, cmid, cout = 64, 64, 256
    for stage, blocks in RESNET_BLOCKS.items():
        for b in range(blocks):
            block = {
                "conv1": {"kernel": kernel(1, cin, cmid)}, "norm1": norm(cmid),
                "conv2": {"kernel": kernel(3, cmid, cmid)}, "norm2": norm(cmid),
                "conv3": {"kernel": kernel(1, cmid, cout)}, "norm3": norm(cout, 0.5),
            }
            if b == 0:
                block["shortcut"] = {"kernel": kernel(1, cin, cout, gain=1.0)}
                block["shortcut_norm"] = norm(cout)
            resnet[f"{stage}_block{b}"] = block
            cin = cout
        cmid, cout = cmid * 2, cout * 2
    fpn = {}
    for lvl, c in (("3", 512), ("4", 1024), ("5", 2048)):
        fpn[f"lateral_res{lvl}"] = biased(1, c, 256, gain=1.0)
        fpn[f"output_res{lvl}"] = biased(3, 256, 256, gain=1.0)
    fpn["p6"] = biased(3, 2048, 256, gain=1.0)
    fpn["p7"] = biased(3, 256, 256)
    head = {}
    for i in range(4):
        head[f"cls_subnet_conv{i}"] = biased(3, 256, 256)
        head[f"bbox_subnet_conv{i}"] = biased(3, 256, 256)
    head["cls_score"] = biased(3, 256, num_anchors * num_classes, gain=1.0)
    head["bbox_pred"] = biased(3, 256, num_anchors * 4, gain=1.0)
    head["cls_var"] = biased(3, 256, num_anchors * num_classes, gain=1.0)
    head["bbox_cov"] = biased(3, 256, num_anchors * cov_dims, gain=1.0)
    return {"resnet": resnet, "fpn": fpn, "head": head}


def temper_head(state_dict, cfg, images: torch.Tensor, device):
    """Scale the output convs so one deterministic forward gives logits
    within +-2, deltas within +-0.05 and log-variances within +-1, then
    bias them like a trained detector on crowded scenes: class 0 preferred
    (+1.5), boxes 6x their anchors (neighbouring anchors then overlap at
    IoU > 0.9 and BayesOD fuses them), small variances."""
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    model.cast_convs().to(device).eval()
    with torch.no_grad():
        probe = model(images.to(device))
    num_classes = cfg.MODEL.RETINANET.NUM_CLASSES
    targets = {"cls_score": ("box_cls", 2.0), "bbox_pred": ("box_delta", 0.05),
               "cls_var": ("box_cls_var", 1.0), "bbox_cov": ("box_reg_var", 1.0)}
    sd = dict(state_dict)
    for conv, (key, target) in targets.items():
        peak = float(probe[key].abs().max())
        if not math.isfinite(peak) or peak == 0.0:
            raise RuntimeError(f"probe forward gave {key} peak {peak}")
        sd[f"head.{conv}.weight"] = sd[f"head.{conv}.weight"] * (target / peak)
        sd[f"head.{conv}.bias"] = sd[f"head.{conv}.bias"] * (target / peak)
    sd["head.cls_score.bias"] = sd["head.cls_score.bias"].reshape(-1, num_classes).clone()
    sd["head.cls_score.bias"][:, 0] += 1.5
    sd["head.cls_score.bias"] = sd["head.cls_score.bias"].reshape(-1)
    box = sd["head.bbox_pred.bias"].reshape(-1, 4).clone()
    box[:, 2:] += math.log(6.0)
    sd["head.bbox_pred.bias"] = box.reshape(-1)
    sd["head.cls_var.bias"] = sd["head.cls_var.bias"] - 6.0
    sd["head.bbox_cov.bias"] = sd["head.bbox_cov.bias"] - 4.0
    return sd


def canvases(seed: int, size, batch: int) -> np.ndarray:
    """uint8 BGR canvases: smooth random blobs over noise, from the seed."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = rng.integers(0, 40, (batch, h, w, 3)).astype(np.float32)
    for b in range(batch):
        for _ in range(12):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.05, 0.25) * min(h, w)
            color = rng.uniform(60, 255, 3).astype(np.float32)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            out[b] += blob[..., None] * color
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ phases
def check_kernel(seed: int, card: str):
    """Phase 2. Returns the numbers of the bf16 batch-shared case, the one
    the main path launches."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rate = 0.2
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(P3_SHAPE, generator=gen, device="cuda").to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        positive = x.abs() + 1.0
        x_bytes = x.numel() * x.element_size()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        for shared in (False, True):
            args = dict(seed=seed * 7919 + 17, rate=rate, batch_shared=shared, offset=256)
            k = kdropout.dropout_cuda(x, relu=True, **args)
            p = kdropout.dropout_plain(x, relu=True, **args)
            torch.cuda.synchronize()
            if not torch.equal(k.view(bits), p.view(bits)):
                raise AssertionError(f"kernel != plain ({dtype}, shared={shared})")
            err = float((k.float() - p.float()).abs().max())
            kp = kdropout.dropout_cuda(positive, **args)
            dropped = kp == 0
            n = dropped[0].numel() if shared else dropped.numel()
            share = float(dropped[0].float().mean() if shared else dropped.float().mean())
            band = 6.0 * math.sqrt(rate * (1 - rate) / n)
            if abs(share - rate) > band:
                raise AssertionError(f"drop share {share} outside {rate} +- {band}")
            if shared and not torch.equal(dropped[0], dropped[1]):
                raise AssertionError("batch-shared mask differs across the batch")
            if not shared and torch.equal(dropped[0], dropped[1]):
                raise AssertionError("per-sample masks repeat across the batch")
            # L2-cold: launches cycle through copies of x that together
            # exceed the 50 MB L2 twice over; L2-warm: one x again and again.
            copies = [x.clone() for _ in range(max(2, -(-120_000_000 // x_bytes)))]
            kernel = [lambda c=c: kdropout.dropout_cuda(c, relu=True, **args) for c in copies]
            ms = graph_ms(kernel, 100)
            warm_ms = graph_ms(kernel[:1], 100)
            plain_ms = graph_ms(
                [lambda c=c: kdropout.dropout_plain(c, relu=True, **args) for c in copies], 10)
            torch_ms = graph_ms(
                [lambda c=c: torch.nn.functional.dropout(c, rate) for c in copies], 100)
            bound_ms = 2 * x_bytes / HBM_BYTES_PER_S * 1e3
            log(f"kernel {str(dtype)[6:]} shared={shared}: bit-identical, drop share "
                f"{share:.5f} (band {band:.5f}), kernel {ms:.4f} ms L2-cold / {warm_ms:.4f} ms "
                f"L2-warm, plain {plain_ms:.4f} ms, "
                f"F.dropout {torch_ms:.4f} ms, bound {bound_ms:.4f} ms ({card})")
            if dtype == torch.bfloat16 and shared:
                main = dict(max_abs_err=err, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, torch_dropout_ms=torch_ms)
    levels = [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in (8, 16, 32, 64, 128)]
    elems = sum(h * w for h, w in levels) * 256 * BATCH
    log(f"kernel bound for one (run, tower, layer) over P3-P7 in bf16: {elems} elements, "
        f"{2 * elems * 2 / HBM_BYTES_PER_S * 1e3:.4f} ms ({card})")
    return main


def check_detections(dets, output_sizes, min_cluster: int):
    """Finite values, symmetric PSD covariances, boxes inside the image, and
    in every image a valid detection and one fused from >= min_cluster."""
    v = dets.valid
    if not bool(v.any(dim=1).all()):
        raise AssertionError(f"an image has no valid detection: {v.sum(dim=1).tolist()}")
    for name in ("boxes", "covs", "scores", "prob_vectors"):
        if not bool(torch.isfinite(getattr(dets, name)[v]).all()):
            raise AssertionError(f"non-finite {name}")
    covs = dets.covs[v].double()
    if not bool(torch.allclose(covs, covs.transpose(-1, -2), rtol=1e-5, atol=1e-6)):
        raise AssertionError("asymmetric covariance")
    eig = torch.linalg.eigvalsh(covs)
    if not bool((eig > 0).all()):
        raise AssertionError(f"covariance not PD: min eigenvalue {float(eig.min())}")
    sizes = torch.as_tensor(output_sizes, dtype=dets.boxes.dtype, device=dets.boxes.device)
    lim = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]], -1)[:, None]
    if not bool(((dets.boxes >= 0) & (dets.boxes <= lim))[v].all()):
        raise AssertionError("box outside its image")
    fused = (dets.cluster_size >= min_cluster) & v
    if not bool(fused.any(dim=1).all()):
        raise AssertionError(f"no cluster of >= {min_cluster} members in some image")
    return int(v.sum()), int(dets.cluster_size[v].max())


def build_slice(seed: int):
    """The flagship predictor at full width on the card, its weights and
    canvases from the seed."""
    cfg = merge_configs(TRAIN_CFG, INFER_CFG)
    images = torch.from_numpy(canvases(seed, CANVAS, BATCH))
    sd = convert.from_jax_params(random_jax_params(seed, cfg.MODEL.RETINANET.NUM_CLASSES))
    predictor = build_predictor(cfg, CANVAS, temper_head(sd, cfg, images[:1], "cuda"))
    return cfg, predictor, images.cuda()


def run_slice(seed: int, card: str):
    """Phase 3: the flagship at full width."""
    cfg, predictor, images = build_slice(seed)
    input_sizes = output_sizes = IMAGE_SIZES

    def call(s):
        return predictor(images, input_sizes, output_sizes,
                         generator=torch.Generator().manual_seed(s))

    runs = int(cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS)
    levels = len(cfg.MODEL.RETINANET.IN_FEATURES)
    expected = runs * 2 * cfg.MODEL.RETINANET.NUM_CONVS * levels
    kdropout.LAUNCHES = 0
    dets = call(seed)
    torch.cuda.synchronize()
    launches = kdropout.LAUNCHES
    if launches != expected:
        raise AssertionError(f"{launches} dropout launches, expected {expected}")
    n_valid, biggest = check_detections(dets, output_sizes, min_cluster=2)
    records = detections_to_json(type(dets)(*[None if f is None else f[0] for f in dets]), 0)
    if not records or set(records[0]) != {"image_id", "category_id", "bbox", "score",
                                          "cls_prob", "bbox_covar"}:
        raise AssertionError("COCO json records missing or malformed")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(seed + 1 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # Stage split of one more call: head bank vs per-image core + BayesOD.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, run_deltas = predictor.head_outputs(images, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sizes = lambda s: torch.as_tensor(s, device="cuda")
    predictor.detect(outs, run_deltas, sizes(input_sizes), sizes(output_sizes))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ms = float(np.median(times))
    log(f"slice: {launches} dropout launches (expected {expected}), {n_valid} valid "
        f"detections, largest BayesOD cluster {biggest}, {len(records)} json records")
    log(f"slice: {ms:.2f} ms/batch median of {[round(t, 2) for t in times]}, "
        f"{BATCH / ms * 1e3:.2f} img/s, head bank {(t1 - t0) * 1e3:.2f} ms, core+BayesOD "
        f"{(t2 - t1) * 1e3:.2f} ms, peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    return launches


def profile_slice(seed: int, card: str) -> None:
    """With --profile: one traced call of the full-width slice; device busy
    share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    _, predictor, images = build_slice(seed)
    call = lambda: predictor(images, IMAGE_SIZES, IMAGE_SIZES,
                             generator=torch.Generator().manual_seed(seed))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"profile: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {launches} device kernels ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def check_against_cpu(seed: int, card: str):
    """Phase 4: GPU path against the plain CPU path at 128x128, float32."""
    opts = ["PARALLEL.COMPUTE_DTYPE", "float32",
            "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 3]
    cfg = merge_configs(TRAIN_CFG, INFER_CFG, opts)
    size = (128, 128)
    images = torch.from_numpy(canvases(seed + 1, size, BATCH))
    sd = convert.from_jax_params(random_jax_params(seed + 1, cfg.MODEL.RETINANET.NUM_CLASSES))
    sd = temper_head(sd, cfg, images[:1], "cpu")
    sizes = np.array([[128, 128]] * BATCH, np.float32)
    dets = {}
    for device in ("cuda", "cpu"):
        predictor = build_predictor(cfg, size, sd, device=device)
        out = predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(seed))
        dets[device] = type(out)(*[None if f is None else f.cpu() for f in out])
    g, c = dets["cuda"], dets["cpu"]
    if not torch.equal(g.valid, c.valid):
        raise AssertionError("valid flags differ between GPU and CPU")
    v = c.valid
    if not torch.equal(g.classes[v], c.classes[v]):
        raise AssertionError("classes differ between GPU and CPU")
    # Errors relative to each box's / matrix's largest entry: float32 sums
    # taken in another order move the epistemic covariance (a spread of
    # nearly equal run boxes) by far more than 1e-6 of its own entries.
    errs = {}
    for name in ("boxes", "covs", "scores"):
        a, b = getattr(g, name)[v].double(), getattr(c, name)[v].double()
        dims = tuple(range(1, b.dim()))
        scale = b.abs().amax(dim=dims, keepdim=True) if dims else b.abs()
        errs[name] = float(((a - b).abs() / scale.clamp_min(1e-6)).max())
        if errs[name] > 1e-3:
            raise AssertionError(f"{name} differ between GPU and CPU: {errs[name]}")
    log(f"reference: {int(v.sum())} detections agree, GPU vs CPU max relative error "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + f" ({card})")


# ------------------------------------------------------------ training phases
def event_ms(fn, iters: int) -> float:
    """Mean milliseconds of `iters` calls between CUDA events after one
    warm-up call (for work a CUDA graph cannot capture)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def focal_inputs(seed: int, shape, copies: int = 1):
    """Logits, log-variances and one-hot-like targets on the card, like the
    training path's (B, R, K) planes; `copies` independent sets."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(copies):
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0 - 4.0
        s = torch.randn(shape, generator=gen, device="cuda") * 2.0 - 3.0
        t = (torch.rand(shape, generator=gen, device="cuda") < 0.01).float()
        out.append((x, s, t))
    return out


def check_focal_kernel(seed: int, card: str, num_anchors: int):
    """Phase 5. Returns the numbers of S = 10, the main path's."""
    shape = (TRAIN_BATCH, num_anchors, NUM_CLASSES)
    n = math.prod(shape)
    main = None
    for num_samples in (10, 3):
        (x, s, t), = focal_inputs(seed, shape)
        k = kfocal.focal_cuda(x, s, t, seed + 11, num_samples)
        p = kfocal.focal_plain(x, s, t, seed + 11, num_samples)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("loss", "gx", "gs"), k, p):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"focal kernel gave non-finite {name} (S={num_samples})")
            scale = float(b.abs().max())
            errs[name] = float((a - b).abs().max())
            if not errs[name] <= 1e-5 * scale:
                raise AssertionError(f"focal {name}: max abs {errs[name]} > 1e-5 x {scale}")
        # Three inputs and three outputs of 19.8 MB each: every launch
        # already streams more than the 50 MB L2; two input sets alternate.
        sets = focal_inputs(seed + 1, shape, copies=2)
        ms = graph_ms([lambda a=a: kfocal.focal_cuda(*a, seed, num_samples) for a in sets], 20)
        plain_ms = graph_ms([lambda a=a: kfocal.focal_plain(*a, seed, num_samples)
                             for a in sets], 2)
        valid = torch.ones(shape[:2], dtype=torch.bool, device="cuda")

        def threefry(a=sets[0]):
            xs = a[0].clone().requires_grad_(True)
            ss = a[1].clone().requires_grad_(True)
            loss = plosses.stochastic_focal_loss(xs, ss, a[2], valid, num_samples, seed)
            loss.backward()

        threefry_ms = event_ms(threefry, 3)
        counts = {"element": 1, "pair": -(-num_samples // 2), "draw": num_samples}
        instructions = n * sum(FOCAL_OPS[k][0] * c for k, c in counts.items())
        mufu = n * sum(FOCAL_OPS[k][1] * c for k, c in counts.items())
        bytes_bound = 6 * 4 * n / HBM_BYTES_PER_S * 1e3
        issue_bound = instructions / INSTRUCTIONS_PER_S * 1e3
        mufu_bound = mufu / MUFU_PER_S * 1e3
        bound_ms = max(bytes_bound, issue_bound, mufu_bound)
        log(f"focal S={num_samples} {shape}: max abs err vs plain " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f"; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, threefry bank fwd+bwd {threefry_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes {bytes_bound:.4f}, instruction issue {issue_bound:.4f} "
            f"for {instructions} instructions, MUFU {mufu_bound:.4f} for {mufu}) ({card})")
        if num_samples == 10:
            main = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bytes_bound_ms=bytes_bound,
                        issue_bound_ms=issue_bound, mufu_bound_ms=mufu_bound,
                        threefry_ms=threefry_ms, shape=list(shape))
    return main


def check_dropout_backward(seed: int, card: str):
    """Phase 6. Returns the bf16 numbers with a channels_last cotangent (the
    layout the convolutions' backward hands the kernel on the main path)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rate = 0.2
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(TRAIN_P3_SHAPE, generator=gen, device="cuda").to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        # Per-sample masks, the flagship's, and batch-shared ones
        # (DROPOUT_SHARED_BATCH_TRAIN): forward and backward bit for bit.
        for shared in (True, False):
            args = dict(seed=seed * 131 + 7, rate=rate, batch_shared=shared, offset=512,
                        relu=True)
            out = kdropout.dropout_cuda(x, **args)
            if not torch.equal(out.view(bits), kdropout.dropout_plain(x, **args).view(bits)):
                raise AssertionError(f"dropout kernel != plain at {TRAIN_P3_SHAPE} "
                                     f"({dtype}, shared={shared})")
            for layout in ("channels_last", "nchw"):
                g = torch.randn(TRAIN_P3_SHAPE, generator=gen, device="cuda").to(dtype)
                if layout == "channels_last":
                    g = g.contiguous(memory_format=torch.channels_last)
                k = kdropout.dropout_backward_cuda(g, out, **args)
                p = kdropout.dropout_backward_plain(g, out, **args)
                torch.cuda.synchronize()
                if not torch.equal(k.contiguous().view(bits), p.contiguous().view(bits)):
                    raise AssertionError(f"dropout backward kernel != plain ({dtype}, "
                                         f"shared={shared}, {layout})")
        nbytes = x.numel() * x.element_size()
        gs = [torch.randn(TRAIN_P3_SHAPE, generator=gen, device="cuda").to(dtype)
              .contiguous(memory_format=torch.channels_last) for _ in range(2)]
        outs = [out, out.clone()]
        pairs = list(zip(gs, outs))
        ms = graph_ms([lambda gp=gp: kdropout.dropout_backward_cuda(gp[0], gp[1], **args)
                       for gp in pairs], 50)
        plain_ms = graph_ms([lambda gp=gp: kdropout.dropout_backward_plain(gp[0], gp[1], **args)
                             for gp in pairs], 4)
        bound_ms = 3 * nbytes / HBM_BYTES_PER_S * 1e3
        log(f"dropout {str(dtype)[6:]} {TRAIN_P3_SHAPE}: forward and backward bit-identical, "
            f"per-sample and batch-shared, channels_last and NCHW cotangents; backward kernel {ms:.4f} ms L2-cold, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({card})")
        if dtype == torch.bfloat16:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
    return main


def train_cfg(seed: int, out_dir: str, opts=()):
    return merge_configs(TRAIN_CFG, "", [
        "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
        "OUTPUT_DIR", out_dir, "SEED", seed, *opts,
    ])


def backbone_pth(seed: int, path: str) -> str:
    """The seed's full-width R50-FPN backbone weights (random_jax_params) as
    a reference-namespace .pth, the trainer's warm start."""
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    torch.save({"model": {k: v for k, v in sd.items() if k.startswith("backbone.")}}, path)
    return path


def run_train(seed: int, card: str, work: str):
    """Phase 7: the training slice at full width. Returns the launch counts
    of its Trainer.train run and of its last timed step."""
    cfg = train_cfg(seed, os.path.join(work, "train"),
                    ["MODEL.WEIGHTS", backbone_pth(seed, os.path.join(work, "r50.pth"))])
    if cfg.SOLVER.IMS_PER_BATCH != TRAIN_BATCH:
        raise AssertionError(f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH}")
    loader = RandomBatches(CANVAS, TRAIN_BATCH, cfg.MODEL.RETINANET.NUM_CLASSES,
                           cfg.INPUT.MAX_GT_BOXES, seed=seed)
    trainer = Trainer(cfg, loader)
    trainer.resume_or_load(resume=False)
    model = trainer.state.model
    watched = ("backbone.bottom_up.stem.conv1.weight", "backbone.bottom_up.res2.2.conv3.weight",
               "head.cls_subnet.0.weight", "head.cls_score.weight", "head.cls_var.weight")
    before = {k: model.state_dict()[k].clone() for k in watched}
    per_step = 2 * cfg.MODEL.RETINANET.NUM_CONVS * len(cfg.MODEL.RETINANET.IN_FEATURES)
    steps = 6
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    trainer.train(max_iter=steps, log_period=steps)
    torch.cuda.synchronize()
    launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES}
    if launches != {"dropout": 2 * per_step * steps, "focal": steps}:
        raise AssertionError(f"launches {launches} in {steps} steps, expected "
                             f"{2 * per_step} dropout and 1 focal per step")
    latest = trainer.storage.latest()
    if not all(math.isfinite(latest[k]) for k in ("loss_cls", "loss_box_reg", "total_loss")):
        raise AssertionError(f"non-finite losses {latest}")
    after = model.state_dict()
    for k in watched:
        frozen = ".stem." in k or ".res2." in k
        if torch.equal(before[k], after[k]) != frozen:
            raise AssertionError(f"{k}: {'changed' if frozen else 'did not change'}")
    saved = trainer.checkpointer.restore()
    state = trainer.state.state_dict()
    if saved["step"] != steps or not all(
            torch.equal(v.cpu(), saved["model"][k].cpu()) for k, v in state["model"].items()):
        raise AssertionError("checkpoint does not read back to the trained state")
    for pid, st in state["optimizer"]["state"].items():
        if not torch.equal(st["momentum_buffer"].cpu(),
                           saved["optimizer"]["state"][pid]["momentum_buffer"].cpu()):
            raise AssertionError("checkpointed momentum differs")
    if not (torch.equal(saved["generator"], state["generator"])
            and torch.equal(saved["loss_normalizer"], state["loss_normalizer"])):
        raise AssertionError("checkpointed generator or normalizer differs")
    log(f"train: {steps} steps through Trainer.train, {launches['dropout']} dropout and "
        f"{launches['focal']} focal launches ({2 * per_step} and 1 per step), losses "
        + ", ".join(f"{k} {latest[k]:.4g}" for k in ("loss_cls", "loss_box_reg",
                                                     "num_pos_anchors", "total_loss"))
        + f"; frozen stages unchanged, head moved, checkpoint of step {steps} read back")

    data = loader.iter_from(trainer.state.step)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(6):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kdropout.LAUNCHES = kfocal.LAUNCHES = 0
        metrics = trainer.train_step(trainer.state, batch_to_device(batch, trainer.device))
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        step_launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES}
        if step_launches != {"dropout": 2 * per_step, "focal": 1}:
            raise AssertionError(f"step launched {step_launches}, expected "
                                 f"{2 * per_step} dropout and 1 focal")
    if not math.isfinite(float(metrics["total_loss"])):
        raise AssertionError("non-finite loss in the timed steps")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    log(f"train: {ms:.2f} ms/step median of {[round(t, 2) for t in times]} at batch "
        f"{TRAIN_BATCH} on {CANVAS[0]}x{CANVAS[1]}, {TRAIN_BATCH / ms * 1e3:.2f} img/s, peak "
        f"memory {peak / 2 ** 30:.3f} GiB ({card})")
    trainer.close()
    return launches, step_launches


def profile_train(seed: int, card: str, work: str) -> None:
    """With --profile: one traced train step at full width."""
    from torch.profiler import ProfilerActivity, profile

    cfg = train_cfg(seed, os.path.join(work, "profile"))
    loader = RandomBatches(CANVAS, TRAIN_BATCH, NUM_CLASSES, cfg.INPUT.MAX_GT_BOXES, seed=seed)
    trainer = Trainer(cfg, loader)
    data = loader.iter_from(0)
    trainer.train_step(trainer.state, batch_to_device(next(data), trainer.device))
    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch_to_device(batch, trainer.device))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile train: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device kernels "
        f"({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"profile train: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    trainer.close()


class RecordedGates(TowerDropout):
    """The kernel's dropout (with its fused ReLU), recording which outputs
    are positive: the gates through which the backward passes gradient."""

    def __init__(self, kernel: KernelDropout):
        self.kernel, self.gates = kernel, {}

    def __call__(self, x, tower, layer, level):
        out = self.kernel(x, tower, layer, level)
        self.gates[tower, layer, level] = (out > 0).cpu()
        return out


class PinnedGates(TowerDropout):
    """The same dropout on another device with the gates of a recorded run:
    x·scale where that run's output was positive, else 0. Where x is within
    rounding of 0 the two devices can disagree on the sign of the ReLU's
    input; pinning the gates keeps one such element from standing in for a
    difference of the whole step. `flips` counts where the plain kernel's
    own gate differs from the pinned one, out of `total`."""

    def __init__(self, kernel: KernelDropout, gates):
        self.kernel, self.gates, self.flips, self.total = kernel, gates, 0, 0

    def __call__(self, x, tower, layer, level):
        gate = self.gates[tower, layer, level].to(x.device)
        with torch.no_grad():
            self.flips += int(((self.kernel(x, tower, layer, level) > 0) != gate).sum())
        self.total += gate.numel()
        scale = kdropout.keep_scale(self.kernel.rate, x.dtype)
        return torch.where(gate, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def check_train_against_cpu(seed: int, card: str, work: str) -> None:
    """Phase 8: one train step at 128x128, float32: the GPU through the
    kernels against the CPU through their plain versions, same weights,
    seeds and batch. The checked CPU step keeps the GPU's ReLU gates in the
    towers (PinnedGates); a second CPU step with its own gates is reported
    beside it. The kernels' own bit-for-bit checks are phases 2 and 6."""
    size, batch_size = (128, 128), 2
    pth = backbone_pth(seed + 1, os.path.join(work, "r50_small.pth"))
    grads, losses, gates, flips, n_gates = {}, {}, None, 0, 0
    for run in ("cuda", "cpu pinned", "cpu own"):
        device = run.split()[0]
        cfg = train_cfg(seed + 1, os.path.join(work, f"reference_{device}"), [
            "PARALLEL.COMPUTE_DTYPE", "float32", "SOLVER.IMS_PER_BATCH", batch_size,
            "MODEL.WEIGHTS", pth])
        loader = RandomBatches(size, batch_size, NUM_CLASSES, cfg.INPUT.MAX_GT_BOXES,
                               seed=seed + 1)
        trainer = Trainer(cfg, loader, device=device)
        trainer.resume_or_load(resume=False)
        state, step = trainer.state, trainer.train_step
        seeds, loss_seed = step.draw_seeds(state.generator)
        shapes = [torch.empty(batch_size, 256, -(-size[0] // s), -(-size[1] // s),
                              device="meta") for s in (8, 16, 32, 64, 128)]
        kernel = KernelDropout(seeds, cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE,
                               level_offsets(shapes, False), False)
        tower_dropout = {"cuda": lambda: RecordedGates(kernel),
                         "cpu pinned": lambda: PinnedGates(kernel, gates),
                         "cpu own": lambda: kernel}[run]()
        total, out, new_norm = step.losses(state, batch_to_device(loader.batch(0), trainer.device),
                                           seeds, loss_seed, tower_dropout)
        total.backward()
        if run == "cuda":
            gates = tower_dropout.gates
        elif run == "cpu pinned":
            flips, n_gates = tower_dropout.flips, tower_dropout.total
        losses[run] = {k: float(v.detach()) for k, v in out.items()}
        losses[run]["normalizer"] = float(new_norm)
        grads[run] = {n: p.grad.detach().cpu().double()
                      for n, p in state.model.named_parameters() if p.grad is not None}
        trainer.close()

    def errors(run):
        g, c = grads["cuda"], grads[run]
        if set(g) != set(c) or not g:
            raise AssertionError("GPU and CPU steps differ in which tensors have gradients")
        worst = max(float((g[n] - c[n]).abs().max() / c[n].abs().max().clamp_min(1e-30))
                    for n in c)
        loss_err = max(abs(losses["cuda"][k] - v) / max(abs(v), 1e-30)
                       for k, v in losses[run].items())
        return worst, loss_err

    # A wrong mask on either side flips about a fifth of the gates; rounding
    # flips a few (1 of 1,396,736 on an H100 at this size and seed).
    if not flips <= MAX_GATE_FLIPS * n_gates:
        raise AssertionError(f"{flips} of {n_gates} tower gates differ between the GPU's "
                             f"kernel and the CPU's plain dropout")
    worst, loss_err = errors("cpu pinned")
    if not (worst <= 1e-3 and loss_err <= 1e-3):
        raise AssertionError(f"GPU vs CPU train step: gradients {worst:.3e}, losses {loss_err:.3e}")
    own_worst, own_loss = errors("cpu own")
    log(f"train reference: {len(grads['cuda'])} gradients, GPU vs CPU max error {worst:.3e} of "
        f"each tensor's scale, losses {loss_err:.3e} relative; with the CPU's own ReLU gates "
        f"({flips} of {n_gates} differ from the GPU's) {own_worst:.3e} and {own_loss:.3e} ({card})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also trace one full-width call and one train step with "
                             "torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()

    def phase(name, t0):
        log(f"[phase {name}] {time.perf_counter() - t0:.2f} s ({card})")

    t0 = time.perf_counter()
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for source, report in _build.build_all(_build.SOURCES).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {source}: {line.strip()}")
    for source in _build.SOURCES:
        _build.load(source)
    phase("device (nvcc of csrc/dropout.cu and csrc/focal.cu, in parallel)", t0)

    t0 = time.perf_counter()
    k1 = check_kernel(args.seed, card)
    phase("kernel", t0)

    t0 = time.perf_counter()
    launches = run_slice(args.seed, card)
    phase("slice", t0)

    if args.profile:
        t0 = time.perf_counter()
        profile_slice(args.seed, card)
        phase("profile", t0)

    t0 = time.perf_counter()
    check_against_cpu(args.seed, card)
    phase("reference", t0)

    cfg = merge_configs(TRAIN_CFG, "")
    num_anchors = build_anchor_generator(cfg).concatenated(CANVAS).shape[0]
    t0 = time.perf_counter()
    k2 = check_focal_kernel(args.seed, card, num_anchors)
    phase("focal kernel", t0)

    t0 = time.perf_counter()
    k1_bwd = check_dropout_backward(args.seed, card)
    phase("dropout backward", t0)

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        train_launches, step_launches = run_train(args.seed, card, work)
        phase("train", t0)

        if args.profile:
            t0 = time.perf_counter()
            profile_train(args.seed, card, work)
            phase("profile train", t0)

        t0 = time.perf_counter()
        check_train_against_cpu(args.seed, card, work)
        phase("train reference", t0)
    log(f"[total] {time.perf_counter() - t_all:.2f} s ({card})")

    kernels = [{
        "name": "hardware_dropout",
        "route": "cuda",
        "source": "pod_compare_tpu_torch/csrc/dropout.cu",
        "replaces": "pod_compare_tpu/ops/pallas/dropout.py:28",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "l2_warm_ms": k1["warm_ms"],
        "torch_dropout_ms": k1["torch_dropout_ms"],
        "shape": list(P3_SHAPE),
        "dtype": "bfloat16",
        "backward_ms": k1_bwd["ms"],
        "backward_plain_ms": k1_bwd["plain_ms"],
        "backward_bound_ms": k1_bwd["bound_ms"],
        "backward_shape": list(TRAIN_P3_SHAPE),
        "train_launches": train_launches["dropout"],
        "train_launches_per_step": step_launches["dropout"],
    }, {
        "name": "stochastic_focal_elem",
        "route": "cuda",
        "source": "pod_compare_tpu_torch/csrc/focal.cu",
        "replaces": "pod_compare_tpu/ops/pallas/focal.py:92",
        "launches": train_launches["focal"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "bytes" if k2["bytes_bound_ms"] >= k2["bound_ms"] else "operations",
        "library_ms": None,
        "bytes_bound_ms": k2["bytes_bound_ms"],
        "issue_bound_ms": k2["issue_bound_ms"],
        "mufu_bound_ms": k2["mufu_bound_ms"],
        "threefry_bank_ms": k2["threefry_ms"],
        "shape": k2["shape"],
        "num_samples": 10,
        "dtype": "float32",
        "train_launches_per_step": step_launches["focal"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
