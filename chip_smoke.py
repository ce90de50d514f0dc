#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python chip_smoke.py [--seed N] [--profile]

Phases, each printing its seconds on its own line as it ends:
  1. device: the card's name and power limit (nvidia-smi); build the five
     CUDA kernels of csrc/ with nvcc into build/, one nvcc each, started
     together, and print what ptxas reports of them.
  2. kernels: every row of KERNEL_CASES, one kernel of csrc/ at one shape
     of the main paths (K1's grouped forward, bf16 and float32, and its
     grouped backward; K2 at S = 10; the normal kernel's class bank and box
     chunk; the NMS kernel at 4,540 and 1,000 candidates; K3 forward and
     backward at three of X101-32x8d's shapes), timed alike: the kernel and
     its plain version (and PyTorch's own call, where there is one) in CUDA
     graphs over copies of their inputs past the L2, beside the kernel's
     bound. Before its timing each row's kernel is held against its plain
     version on one input set: bit for bit, K2 within 1e-5 of each output's
     scale. tests/test_torch_*_cuda.py hold the kernels at more shapes.
  3. slice: the flagship BayesOD + MC-dropout(10) predictor at full R50-FPN
     width on the 736x1280 BDD canvas, batch 2, random weights from the
     seed: the launch counts of one call (the dropout kernel's, and 49 of
     K3's, one a backbone convolution), finite outputs, PSD covariances,
     a detection and a fused cluster in every image; ms per batch (median
     of 10 calls), img/s and peak device memory.
  4. reference: the same predictor at a small size in float32 on the GPU
     against its plain PyTorch path on the CPU, same weights, same masks.
  5. train: the Trainer on the flagship training config with the fused focal
     kernel (CLS_VAR_LOSS.IMPL 'pallas'), batch 4 on the 736x1280 canvas,
     random weights from the seed (the backbone warm-started from a .pth),
     random ground truth: 6 steps through Trainer.train with 16 dropout, 1
     focal and 88 K3 launches per step (49 forward, 39 backward: none for
     the frozen stem and res2), finite losses, frozen stem/res2, moved head, a
     checkpoint read back to the same state; then 1 untimed and 5 timed
     steps: ms/step (median), img/s, peak device memory.
  6. train reference: one train step at a small size in float32 on the GPU
     against the same step on the CPU through the plain versions, same
     weights, seeds and batch, the CPU's tower dropout keeping the GPU's
     ReLU gates (an input within rounding of 0 can take either sign on two
     devices): losses and every gradient within 1e-3 of each tensor's
     scale, and at most 1e-5 of the CPU's own gates differing from the
     GPU's. The same step with the CPU's own gates is printed beside it.
  7. eval: apply_net's main, as `python -m pod_compare_tpu_torch.cli.apply_net`
     runs it, on 32 synthetic PNGs at BDD's 720x1280 (1-30 boxes, 7 classes)
     laid out as bdd_val under --dataset-dir, with the seeded, tempered
     weights saved as the checkpoint it loads: the loader (cv2 decode, resize
     to 750x1333 on a 768x1344 canvas), the flagship predictor at batch 2 in
     bf16, the json and the metric suite. An entry for every image,
     cls_prob and a PD bbox_covar on every detection, 80 dropout launches a
     batch, the native and numpy COCO engines equal, mAP and the metrics
     finite (NaN, the reference's None, only where nothing matched); then the
     ground truth with seeded jitter and covariances, scored the same way,
     every metric finite and AP50 above 0.5. Loader-fed img/s, evaluation
     seconds, host decode and resize ms per image, peak device memory; then
     the loader alone (img/s) and the predictor alone on its first batch
     (ms/batch), to split the loader-fed time.
  8. train_net: train_net's main, as `python -m pod_compare_tpu_torch.cli.train_net`
     runs it, on the flagship training config with the fused focal kernel:
     48 train and 16 val JPEGs at BDD's 720x1280 (cv2, quality 90; 1-30
     boxes, 7 classes) in BDD's layout under --dataset-dir, the backbone
     warm-started from a seeded R-50 written as a detectron2-style .pkl
     (which must load the same tensors as a .pth of them), batch 4 on
     736x1280, 20 steps with a checkpoint and Trainer.test every 10; then
     train_net --resume from the step-10 checkpoint. 16 dropout and 1 focal
     launches in every step, finite losses, frozen stages equal to the
     .pkl's, Trainer.test at steps 10 and 20 on 768x1344 from one test
     loader and one predictor, the resumed run's batches equal to the
     uninterrupted run's by digest and its first losses within 1e-5 of
     theirs. Loader-fed ms/step, Trainer.test seconds, peak device memory;
     TrainLoader alone with threads and with spawned processes (the same
     batches), and cv2 decode and resize ms per JPEG.
  9. modes: every file of configs/Inference/, bayes_od.yaml with
     covariance intersection and the flagship with CLS_SAMPLING and
     BOX_SAMPLING mc_iid (S = 10 and 1000), each through the predictor at
     full width on the 736x1280 canvas, batch 2, bf16; the ensembles with
     five members, the seeded weights with each head tensor moved by 2% in
     noise from the member's seed, each tempered. Per mode: the dropout
     launches of one call (80 with the MC bank, else 0), finite values,
     PD covariances, boxes inside the image, a cluster of >= 2 members in
     every image where the mode clusters; ms/batch (median of 5), peak
     memory, head vs core/mode/merge ms, the card's busy share of a traced
     call, and the greedy merge's clusters and ms; the normal kernel's
     launches of one call (22 on the mc_iid flagship: per image the class
     bank and 10 box chunks; else 0) and the NMS kernel's (at least one an
     image). The mc_iid banks held by law on image
     0 (standardised errors of the class bank against the exact sigmoid
     moments, of the sampled box decode against the closed-form moments).
     Every mode, the mc_iid flagship too (its normals drawn from the call's
     seeds on both sides), against the CPU at 128x128 in float32, M = 3:
     detections matched by class and IoU, at most 1% flips, matched values
     within 1e-3. Then apply_net's main
     on ensembles_post_nms over 8 of phase 7's PNGs, the five members
     from their random_seed_<seed> sibling checkpoints.
 10. rest: apply_net's main on 16 of phase 7's PNGs and its checkpoint with
     --batch-size auto (the peak-memory guard's probes at batch 1 and 2, its
     linear fit, the budget, the chosen batch, whose measured peak must fit)
     and --run-pdq (PDQ finite in [0, 1], its seconds), then
     visualize_predictions on 4 images of that json (a PNG each, differing
     from its image); the flagship with HEAD_QUANT int8 at 736x1280, batch
     2: 80 float32 dropout launches, ms/batch, head ms, peak, its
     detections against the bf16 head's on the same canvases and masks,
     quantized_conv3x3 at the P3 tower shape on the card against the CPU
     (int32 sums equal, outputs within 1e-6 of scale) and timed against the
     bf16 conv, and the int8 predictor against the CPU at 128x128 (at most
     1% flips); the energy config's Trainer, 5 steps at batch 4 on 736x1280
     with one focal launch a step, ms/step and peak, and its energy term of
     1000 samples (8 seeds) within 4 standard errors of a 20,000-sample
     estimate; one flagship train step without and with PARALLEL.REMAT from
     the same state and seeds: losses equal, gradients within 1e-5 of
     scale, REMAT's peak lower.
 11. parallel: more than one process (parallel/), on 8 of phase 7's PNGs
     and its checkpoint: apply_net's main on the flagship in one process
     spawned by parallel.launch (NCCL) against the same run without a
     process group; two processes on the one card (gloo: NCCL refuses two
     ranks on a device) on standard_nms, the merged json against one
     process's, and on the flagship, each rank's part against a one-process
     run over its shard alone (detections matched by class and IoU, at most
     1% flips, values within 1e-3); --num-devices above the card count
     refused, naming both numbers; train_net's main (the flagship training
     config with the focal kernel, float32, batch 4, three steps and an
     evaluation, on phase 8's JPEGs warm-started from its .pkl) on two
     processes sharing the card (gloo over CUDA tensors), launched as
     --num-devices launches them, against train_net's main on one process
     and twice on one process taking each step's backward over the two
     processes' rows in turn: 48 dropout and 3 focal launches per rank (the
     kernels line's), the same checkpoints and metrics rows, the logged
     losses within 1e-5 relative, the evaluation's json matched as above,
     the weights' gaps printed; then three data-parallel steps of that
     config on generated batches at 736x1280, each against the one-process
     step from the same state and against the same step with its backward
     over the two processes' rows in turn: weights bit-identical across the
     ranks, losses within 1e-5 relative, every weight within 1e-5 of its
     scale, every gradient within 1e-5 of the rows' sum and 6e-5 of the
     one-process step's (which sums over the four images in one call),
     ReLU and log-variance clamp gates that differ at most 1e-5 of them, 16
     dropout and 1 focal launches per rank, ms/step per rank beside the
     one process's; phase 9's five ensemble members placed by
     create_ensemble_placement, bit-identical to the unplaced predictor;
     resize_and_pad of two 720x1280 frames on the card against the CPU.
 12. export: the serving export (inference/export.py) through
     cli.export_model, as a user runs it, from a checkpoint of the seeded,
     tempered flagship weights: the flagship (10 runs, batch 2, 736x1280,
     bf16), mc_dropout_ensembles_post_nms cut to 2 runs and batch 1, and
     the flagship with CLS_SAMPLING and BOX_SAMPLING mc_iid (S = 10 and
     1000) cut to 2 runs and batch 1 (its sampling seeds a fifth input of
     the program), each exported on the card, saved, then loaded and
     served by a fresh process in which the port's models, config and
     predictor (and JAX) cannot be imported, from the generator seed of a
     live call: every output field bit-identical to the live call's, the
     dropout and normal kernels launched as often (80 and 0 for the
     flagship, 16 and 11 for the mc_iid one); torch.export and
     torch.export.save seconds, graph nodes, load seconds, the first served
     call and the median of 5 in ms/batch beside the live predictor's.
Then the kernels line, {"kernels": [...]}, one record a row of phase 2 with
its launch counts on the main paths (phases 3-12) filled in, the
nvidia-smi line, and the result line.

It needs a CUDA device and the repository around it; it exits non-zero
without either, and on any failed check.
"""

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import cv2
import numpy as np
import torch

from pod_compare_tpu_torch import native
from pod_compare_tpu_torch.cli import export_model, train_net
from pod_compare_tpu_torch.cli.apply_net import main as apply_net_main
from pod_compare_tpu_torch.cli.apply_net import run_inference
from pod_compare_tpu_torch.cli.visualize_predictions import visualize_dataset
from pod_compare_tpu_torch.config import merge_configs, setup_arg_parser, setup_config
from pod_compare_tpu_torch.data import TestLoader, TrainLoader, get_dataset, load_image_bgr
from pod_compare_tpu_torch.data.converters.common import (
    BDD_CATEGORIES,
    annotation,
    write_coco_json,
)
from pod_compare_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_detections
from pod_compare_tpu_torch.evaluation.average_precision import (
    DEFAULT_CAT_IDS,
    evaluate_average_precision,
)
from pod_compare_tpu_torch.evaluation.calibration_errors import evaluate_calibration_errors
from pod_compare_tpu_torch.evaluation.coco_eval import COCOEvaluator
from pod_compare_tpu_torch.evaluation.probabilistic_metrics import (
    evaluate_probabilistic_metrics,
)
from pod_compare_tpu_torch.inference import (
    Detections,
    build_predictor,
    classification_probs,
    detections_to_json,
    pick_chunk,
    probabilistic_inference_core,
    sampled_box_moments,
)
from pod_compare_tpu_torch.inference import modes as pmodes
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds
from pod_compare_tpu_torch.models import retinanet as pretinanet
from pod_compare_tpu_torch.models.layers import FrozenBatchNorm2d
from pod_compare_tpu_torch.models import (
    KernelDropout,
    TowerDropout,
    build_anchor_generator,
    build_model,
    convert,
    level_offsets,
)
from pod_compare_tpu_torch.ops import losses as plosses
from pod_compare_tpu_torch.ops.boxes import decoded_box_moments, pairwise_iou
from pod_compare_tpu_torch.ops.gaussian import covariance_output_to_cholesky
from pod_compare_tpu_torch.ops.kernels import _build
from pod_compare_tpu_torch.ops.kernels import dropout as kdropout
from pod_compare_tpu_torch.ops.kernels import focal as kfocal
from pod_compare_tpu_torch.ops.kernels import frozen_bn as kfb
from pod_compare_tpu_torch.ops.kernels import nms as knms
from pod_compare_tpu_torch.ops.kernels import normal as knormal
from pod_compare_tpu_torch.ops.matcher import label_anchors_batch
from pod_compare_tpu_torch.ops import quant as pquant
from pod_compare_tpu_torch.ops.preprocess import resize_and_pad
from pod_compare_tpu_torch.parallel import (
    BatchShard,
    barrier,
    create_ensemble_placement,
    gather_process_results,
    launch,
    local_device,
    process_count,
    process_index,
)
from pod_compare_tpu_torch.train import RandomBatches, Trainer, create_train_state, make_train_step
from pod_compare_tpu_torch.train import trainer as trainer_module
from pod_compare_tpu_torch.train.checkpoint import Checkpointer, load_params
from pod_compare_tpu_torch.train import loss as ptrain_loss
from pod_compare_tpu_torch.train.loss import LossConfig, box_seed, encode_deltas
from pod_compare_tpu_torch.train.trainer import batch_to_device
from pod_compare_tpu_torch.utils.memory_guard import BATCH_CANDIDATES, BUDGET_FRACTION

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
INFER_CFG = "Inference/bayes_od_mc_dropout.yaml"
CANVAS = (736, 1280)  # BDD 720x1280 padded to a multiple of 32
BATCH = 2
P3_SHAPE = (BATCH, 256, CANVAS[0] // 8, CANVAS[1] // 8)
EVAL_CANVAS = (768, 1344)  # 720x1280 resized to 750x1333 (MIN 800, MAX 1333), padded to /32
IMAGE_SIZES = np.array([[720, 1280]] * BATCH, np.float32)  # (h, w) before padding
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# H100 SXM at its 1.98 GHz boost clock (NVIDIA data sheet): 132 SMs issue 128
# thread-instructions a clock (the data sheet's 67 TFLOP/s in float32 counts
# an FMA as two), and their special-function units (MUFU: exp2, log2, sin,
# cos, rsqrt, rcp) do 16 a clock per SM.
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
TRAIN_BATCH = 4
# K3's launches in R50: the stem and 3 a block x 16 forward; 3 a block of
# res3-res5's 13 backward (FREEZE_AT 2 freezes the stem and res2).
FROZEN_BN_FORWARD, FROZEN_BN_BACKWARD = 49, 39
NUM_CLASSES = 7
ANCHORS = 176580  # 9 a cell of P3-P7 on the 736x1280 canvas
# The kernels phase's copies of a call's inputs and outputs exceed the H100's
# 50 MB L2 twice over; each kernel is replayed KERNEL_ITERS times (or once a
# copy, if more) and its plain version PLAIN_ITERS times.
L2_COLD_BYTES = 120_000_000
KERNEL_ITERS, PLAIN_ITERS = 50, 3
# The least work of the stochastic focal function (csrc/focal.cu), fixed to
# the function and not to any implementation of it: each add, multiply, FMA,
# compare, select, shift, logical op, conversion or transcendental as one
# instruction, each transcendental also as one MUFU operation. Per element:
# the block key (4), clamp, halve and exp for std (4), gate (3), alpha_t and
# -(2t-1)alpha_t (5), the three outputs (8): 24, of which 1 MUFU. Per pair of
# draws: two hashes with their keys (18), two uniforms (shift, convert, FMA:
# 6), log, -2x and sqrt (3), theta, sin and cos (3), the two normals (2): 32,
# of which 4 MUFU. Per draw: the sampled logit (2), exp(-|y|) (2), 1 + e and
# its reciprocal (2), e/(1+e) (1), the sigmoid's select (2), the
# cross-entropy (max, FMA, log, FMA: 4), t - p and its square (2), gamma
# p(1-p) (2), the derivative's FMA and multiply (2), the three accumulations
# (3): 22, of which 3 MUFU. At S = 10: 404 instructions and 51 MUFU per
# element.
FOCAL_OPS = {"element": (24, 1), "pair": (32, 4), "draw": (22, 3)}
# The least work of the normal function (csrc/normal.cu), counted as
# FOCAL_OPS is: per Philox block of four normals, the counter's two words
# and ten rounds of two high and two low multiplies and four xors, with
# nine key steps of two adds (100); per Box-Muller pair, two uniforms
# (shift, convert, FMA: 6), log, -2x and sqrt (3), theta (1), sin and cos
# (2), the two products (2): 14, of which 4 MUFU. 32 instructions and 2
# MUFU a normal.
NORMAL_OPS = {"block": (100, 0), "pair": (14, 4)}
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


def k1_per_pass(cfg) -> int:
    """K1 launches of one stochastic head pass: one per (tower, layer), each
    over every FPN level (KernelDropout), each way."""
    return 2 * cfg.MODEL.RETINANET.NUM_CONVS


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


# ------------------------------------------------------------ kernels
def level_shapes(canvas, batch: int):
    """The five FPN levels' tower shapes on a canvas, P3-P7."""
    return [(batch, 256, -(-canvas[0] // s), -(-canvas[1] // s)) for s in (8, 16, 32, 64, 128)]


def random_levels(gen, shapes, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            .contiguous(memory_format=torch.channels_last) for shape in shapes]


def dropout_group(seed: int, canvas, batch: int, dtype, shared: bool):
    """The arguments of one grouped K1 forward, relu on: the five FPN
    levels of a (run, tower, layer) on the card, their offsets in one draw."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = random_levels(gen, level_shapes(canvas, batch), dtype)
    return xs, seed * 7919 + 17, 0.2, shared, level_offsets(xs, shared), True


def dropout_backward_group(seed: int, canvas, batch: int, dtype, shared: bool):
    """The arguments of one grouped K1 backward: random channels-last
    cotangents and the forward's outputs."""
    xs, *args = dropout_group(seed, canvas, batch, dtype, shared)
    outs = kdropout.dropout_levels_cuda(xs, *args)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return (random_levels(gen, [x.shape for x in xs], dtype), outs, *args)


def group_bytes(canvas, batch: int, dtype) -> int:
    return sum(math.prod(sh) for sh in level_shapes(canvas, batch)) * torch.finfo(dtype).bits // 8


def focal_inputs(seed: int, shape):
    """Logits, log-variances and one-hot-like targets on the card, like the
    training path's (B, R, K) planes, and the draw's seed and S = 10."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda") * 3.0 - 4.0
    s = torch.randn(shape, generator=gen, device="cuda") * 2.0 - 3.0
    t = (torch.rand(shape, generator=gen, device="cuda") < 0.01).float()
    return x, s, t, seed, 10


def focal_ops(n: int):
    """(instructions, MUFU operations) of the focal function on n elements
    at S = 10 (FOCAL_OPS)."""
    counts = {"element": 1, "pair": 5, "draw": 10}
    return tuple(n * sum(FOCAL_OPS[k][i] * c for k, c in counts.items()) for i in (0, 1))


def normal_inputs(seed: int, shape, keyed: bool):
    """The arguments of one normal draw on the card, float32: with `keyed`,
    a box chunk's rows keyed by as many random anchors of ANCHORS."""
    gen = torch.Generator().manual_seed(seed)
    index = torch.randperm(ANCHORS, generator=gen)[:shape[1]].cuda() if keyed else None
    return shape, seed * 7919 + 23, 4 * 12345, torch.zeros(1, device="cuda"), index, \
        ANCHORS if keyed else 0


def normal_ops(n: int):
    """(instructions, MUFU operations) of the normal function on n normals
    (NORMAL_OPS)."""
    blocks = -(-n // 4)
    return (blocks * (NORMAL_OPS["block"][0] + 2 * NORMAL_OPS["pair"][0]),
            blocks * 2 * NORMAL_OPS["pair"][1])


def dropout_library(xs, seed, rate, *_):
    """F.dropout a level at K1's rate: PyTorch's own dropout, another
    mask law."""
    return [torch.nn.functional.dropout(x, rate) for x in xs]


def normal_library(shape, *_):
    """torch.randn of normal_cuda's shape: PyTorch's own normals, another
    stream."""
    return torch.randn(shape, device="cuda")


def normal_plain_like(shape, seed, offset, like, index, rows):
    """knormal.normal_plain given normal_cuda's arguments: the dtype and
    device of `like`."""
    return knormal.normal_plain(shape, seed, offset, like.dtype, like.device, index, rows)


def nms_inputs(seed: int, n: int, device="cuda"):
    """(boxes, scores, classes, valid, threshold 0.5, max_out 100) of n
    pre-NMS candidates on the 736x1280 canvas: boxes jittered around n / 15
    objects (sides 16-400 px), uniform scores, valid above 0.05, NUM_CLASSES
    classes."""
    rs = np.random.RandomState(seed)
    objects = max(n // 15, 1)
    side = np.exp(rs.uniform(np.log(16.0), np.log(400.0), (objects, 2)))
    centre = rs.rand(objects, 2) * (CANVAS[1], CANVAS[0])
    which = rs.randint(0, objects, n)
    s = side[which] * np.exp(rs.normal(0.0, 0.15, (n, 2)))
    c = centre[which] + rs.normal(0.0, 0.1, (n, 2)) * side[which]
    boxes = np.concatenate([c - s / 2, c + s / 2], axis=1).astype(np.float32)
    scores = rs.rand(n).astype(np.float32)
    classes = rs.randint(0, NUM_CLASSES, n).astype(np.int64)
    return (*[torch.from_numpy(a).to(device) for a in (boxes, scores, classes, scores > 0.05)],
            0.5, 100)


def nms_floor_ms(n: int) -> float:
    """The NMS kernel's latency floor: pod_nms_chain, the same 100 steps'
    block argmax and barrier with no candidates."""
    return graph_ms([lambda: knms.chain_cuda(100, n)], KERNEL_ITERS)


# K3's shapes: X101-32x8d's training step at batch 16 on 736x1280, bf16
# channels-last, each (name, shape, side input).
FROZEN_BN_CASES = (
    ("x101_res2_conv1", (16, 256, 184, 320), "none"),
    ("x101_res4_conv3", (16, 1024, 46, 80), "residual"),
    ("x101_res3_0_conv3", (16, 512, 92, 160), "projection"),
)


def frozen_bn_stats(c: int, seed: int):
    """A FrozenBN's buffers on the card, float32 as in training, with some
    scales negative, as the operators take them."""
    gen = torch.Generator().manual_seed(seed)
    norm = FrozenBatchNorm2d(c)
    norm.weight.copy_(torch.randn(c, generator=gen))
    norm.bias.copy_(torch.randn(c, generator=gen) * 0.5)
    norm.running_mean.copy_(torch.randn(c, generator=gen) * 0.5)
    norm.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return kfb.stats(norm.cuda())


def frozen_bn_inputs(seed: int, shape, side: str):
    """The arguments of one K3 forward: (z, n, residual, shortcut, ns)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def tensor():
        t = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        return t.contiguous(memory_format=torch.channels_last)

    z, n = tensor(), frozen_bn_stats(shape[1], seed)
    if side == "residual":
        return z, n, tensor(), None, None
    if side == "projection":
        return z, n, None, tensor(), frozen_bn_stats(shape[1], seed + 1)
    return z, n, None, None, None


def frozen_bn_backward_inputs(seed: int, shape, side: str):
    """The arguments of one K3 backward: (g, y, n, ns, z_grad, side_grad),
    y the forward's output."""
    z, n, residual, shortcut, ns = frozen_bn_inputs(seed, shape, side)
    y = kfb.frozen_bn_act_cuda(z, n, residual, shortcut, ns)
    g = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(seed + 2),
                    device="cuda").to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return g, y, n, ns, True, side != "none"


def frozen_bn_library(z, n, residual=None, shortcut=None, ns=None):
    """The backbone's chain before K3, as separate PyTorch operations in z's
    dtype: FrozenBN's multiply and add with the pair rebuilt each call, the
    shortcut's FrozenBN the same way, the residual add, F.relu."""
    def frozen_bn(x, stats):
        weight, bias, mean, var, eps = stats
        mul = weight * torch.rsqrt(var + eps)
        add = bias - mean * mul
        return x * mul.to(x.dtype).view(1, -1, 1, 1) + add.to(x.dtype).view(1, -1, 1, 1)

    y = frozen_bn(z, n)
    if residual is not None:
        y = y + residual
    elif shortcut is not None:
        y = y + frozen_bn(shortcut, ns)
    return torch.nn.functional.relu(y)


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One row of the kernels phase: a kernel of csrc/ at one shape of the
    main paths. `inputs(seed)` builds the arguments of one call on the card;
    `kernel`, `plain` and `library` (PyTorch's own call, where there is
    one) each take them. `tol` is how far each output of the kernel may be
    from the plain version's, over the largest magnitude of the latter: 0
    is bit for bit. `bytes` is what one call reads and writes once; `ops`
    the (instructions, MUFU operations) its function needs at least;
    `floor`, where given, measures a latency floor in ms."""

    name: str
    case: str
    shape: tuple
    dtype: str
    inputs: Callable
    kernel: Callable
    plain: Callable
    bytes: int
    ops: tuple = (0, 0)
    floor: Optional[Callable] = None
    library: Optional[Callable] = None
    tol: float = 0.0


# Each kernel's source and what it replaces in the JAX package.
KERNEL_SOURCES = {
    "hardware_dropout": ("pod_compare_tpu_torch/csrc/dropout.cu",
                         "pod_compare_tpu/ops/pallas/dropout.py:28"),
    "stochastic_focal_elem": ("pod_compare_tpu_torch/csrc/focal.cu",
                              "pod_compare_tpu/ops/pallas/focal.py:92"),
    "normal": ("pod_compare_tpu_torch/csrc/normal.cu",
               "none: jax.random.normal (XLA threefry) in pod_compare_tpu/inference/core.py, "
               "outside any Pallas kernel"),
    "batched_nms": ("pod_compare_tpu_torch/csrc/nms.cu",
                    "none: the lax.scan of pod_compare_tpu/ops/nms.py, outside any Pallas kernel"),
    "frozen_bn_act": ("pod_compare_tpu_torch/csrc/frozen_bn.cu",
                      "none: FrozenBatchNorm's multiply-add in pod_compare_tpu/models/layers.py, "
                      "which XLA fuses, outside any Pallas kernel"),
}
_K1_INFER, _K1_TRAIN = level_shapes(CANVAS, BATCH), level_shapes(CANVAS, TRAIN_BATCH)
_FOCAL = (TRAIN_BATCH, ANCHORS, NUM_CLASSES)
_CLASS_BANK, _BOX_CHUNK = (10, ANCHORS, NUM_CLASSES), (100, 4540, 4)
# The rows PERF.md's kernel table reports, at the main paths' shapes.
KERNEL_CASES = (
    KernelCase("hardware_dropout", "forward, grouped over P3-P7, bf16 batch-shared, 736x1280 "
               "(the MC bank)", _K1_INFER, "bfloat16",
               lambda s: dropout_group(s, CANVAS, BATCH, torch.bfloat16, True),
               kdropout.dropout_levels_cuda, kdropout.dropout_levels_plain,
               2 * group_bytes(CANVAS, BATCH, torch.bfloat16), library=dropout_library),
    KernelCase("hardware_dropout", "forward, grouped over P3-P7, float32 batch-shared, fused "
               "ReLU, 736x1280 (the int8 head's MC bank)", _K1_INFER, "float32",
               lambda s: dropout_group(s, CANVAS, BATCH, torch.float32, True),
               kdropout.dropout_levels_cuda, kdropout.dropout_levels_plain,
               2 * group_bytes(CANVAS, BATCH, torch.float32), library=dropout_library),
    KernelCase("hardware_dropout", "backward, grouped over a train step's P3-P7, bf16 "
               "per-sample, batch 4", _K1_TRAIN, "bfloat16",
               lambda s: dropout_backward_group(s, CANVAS, TRAIN_BATCH, torch.bfloat16, False),
               kdropout.dropout_levels_backward_cuda, kdropout.dropout_levels_backward_plain,
               3 * group_bytes(CANVAS, TRAIN_BATCH, torch.bfloat16)),
    KernelCase("stochastic_focal_elem", "forward and gradients, S = 10 (training's)", _FOCAL,
               "float32", lambda s: focal_inputs(s, _FOCAL), kfocal.focal_cuda,
               kfocal.focal_plain, 6 * 4 * math.prod(_FOCAL), focal_ops(math.prod(_FOCAL)),
               tol=1e-5),
    KernelCase("normal", "class bank (the mc_iid flagship's, an image)", _CLASS_BANK, "float32",
               lambda s: normal_inputs(s, _CLASS_BANK, False), knormal.normal_cuda,
               normal_plain_like, 4 * math.prod(_CLASS_BANK), normal_ops(math.prod(_CLASS_BANK)),
               library=normal_library),
    KernelCase("normal", "box chunk, rows keyed by 4540 anchors", _BOX_CHUNK, "float32",
               lambda s: normal_inputs(s, _BOX_CHUNK, True), knormal.normal_cuda,
               normal_plain_like, 4 * math.prod(_BOX_CHUNK) + 8 * _BOX_CHUNK[1],
               normal_ops(math.prod(_BOX_CHUNK)), library=normal_library),
    *(KernelCase("batched_nms", f"{n} candidates, {NUM_CLASSES} classes, max_out 100, "
                 f"threshold 0.5 ({what})", (n, 4), "float32",
                 lambda s, n=n: nms_inputs(s, n), knms.batched_nms_cuda, knms.batched_nms_plain,
                 29 * n, floor=lambda n=n: nms_floor_ms(n))
      for n, what in ((4540, "the pre-NMS paths'"), (1000, "the post-NMS merge's"))),
    *(row for name, shape, side in FROZEN_BN_CASES for row in (
        KernelCase("frozen_bn_act", f"forward at {name}, side input {side}, channels-last",
                   shape, "bfloat16", lambda s, shape=shape, side=side: frozen_bn_inputs(
                       s, shape, side), kfb.frozen_bn_act_cuda, kfb.frozen_bn_act_plain,
                   2 * math.prod(shape) * (2 + (side != "none")), library=frozen_bn_library),
        # Autograd's backward of frozen_bn_library is threshold_backward and a
        # multiply by each FrozenBN's scale: the plain version's operations.
        KernelCase("frozen_bn_act", f"backward at {name}, side input {side}, channels-last",
                   shape, "bfloat16", lambda s, shape=shape, side=side:
                   frozen_bn_backward_inputs(s, shape, side), kfb.frozen_bn_act_backward_cuda,
                   kfb.frozen_bn_act_backward_plain,
                   2 * math.prod(shape) * (3 + (side != "none"))))),
)


def outputs_agree(case: KernelCase, args) -> bool:
    """The kernel's outputs on `args` against the plain version's, within
    the row's `tol`: bit for bit where it is 0."""
    def leaves(out):
        return list(out) if isinstance(out, (list, tuple)) else [out]

    got, want = leaves(case.kernel(*args)), leaves(case.plain(*args))
    if len(got) != len(want):
        return False
    for k, p in zip(got, want):
        if k is None or p is None:
            if k is not p:
                return False
        elif k.shape != p.shape or k.dtype != p.dtype:
            return False
        elif case.tol:
            err = float((k.double() - p.double()).abs().max())
            if not (bool(torch.isfinite(k).all()) and err <= case.tol * float(p.abs().max())):
                return False
        elif not torch.equal(*(t.contiguous().reshape(-1).view(torch.uint8) for t in (k, p))):
            return False
    return True


def run_kernels(seed: int, card: str) -> list:
    """Phase 2: every row of KERNEL_CASES checked on one input set against
    its plain version (outputs_agree), then timed alike. Each call is captured
    in a CUDA graph (graph_ms) over copies of its inputs that, with the
    outputs the last copies' calls wrote, exceed the 50 MB L2 twice over, so
    every call reads and writes memory that is not in L2; the plain version
    the same way with fewer calls. The bound is the largest of the bytes
    over HBM_BYTES_PER_S, the instructions over INSTRUCTIONS_PER_S, the MUFU
    operations over MUFU_PER_S and the measured floor. Returns one record a
    row with the keys of the kernels line; main() fills in `launches`."""
    records = []
    for case in KERNEL_CASES:
        copies = max(2, -(-L2_COLD_BYTES // case.bytes))
        sets = [case.inputs(seed + c) for c in range(copies)]
        written = collections.deque(maxlen=copies)
        if not outputs_agree(case, sets[0]):
            raise AssertionError(f"kernel {case.name}, {case.case}: its outputs differ from the "
                                 f"plain version's" + (f" by more than {case.tol:g} of scale"
                                                       if case.tol else " (bit for bit)"))

        def timed(fn, iters):
            ms = graph_ms([lambda a=a: written.append(fn(*a)) for a in sets], iters)
            written.clear()
            return ms

        ms = timed(case.kernel, max(KERNEL_ITERS, copies))
        plain_ms = timed(case.plain, PLAIN_ITERS)
        library_ms = timed(case.library, KERNEL_ITERS) if case.library else None
        bounds = {"bytes": case.bytes / HBM_BYTES_PER_S * 1e3,
                  "instruction issue": case.ops[0] / INSTRUCTIONS_PER_S * 1e3,
                  "MUFU": case.ops[1] / MUFU_PER_S * 1e3}
        if case.floor is not None:
            bounds["latency floor (measured)"] = case.floor()
        bound_by = max(bounds, key=bounds.get)
        source, replaces = KERNEL_SOURCES[case.name]
        records.append(dict(
            name=case.name, case=case.case, route="cuda", source=source, replaces=replaces,
            shape=case.shape, dtype=case.dtype, launches=None, ms=ms, plain_ms=plain_ms,
            bound_ms=bounds[bound_by], bound_by=bound_by, library_ms=library_ms))
        agree = f"within {case.tol:g} of scale" if case.tol else "bit for bit"
        log(f"kernel {case.name}, {case.case}: {agree} with the plain version; {ms:.4f} ms "
            f"L2-cold, bound {bounds[bound_by]:.4f}"
            f" ms by {bound_by} ({100 * bounds[bound_by] / ms:.1f}%), plain {plain_ms:.4f} ms"
            + ("" if library_ms is None else f", PyTorch's own {library_ms:.4f} ms")
            + f"; {copies} input sets ({card})")
        del sets
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ phases
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
    expected = runs * k1_per_pass(cfg)
    kdropout.LAUNCHES = kfb.LAUNCHES = 0
    t0 = time.perf_counter()
    dets = call(seed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, frozen_bn_launches = kdropout.LAUNCHES, kfb.LAUNCHES
    if launches != expected:
        raise AssertionError(f"{launches} dropout launches, expected {expected}")
    if frozen_bn_launches != FROZEN_BN_FORWARD:
        raise AssertionError(f"{frozen_bn_launches} FrozenBN epilogue launches, expected "
                             f"{FROZEN_BN_FORWARD}")
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
    log(f"slice: {launches} dropout launches (expected {expected}), {frozen_bn_launches} "
        f"FrozenBN epilogue launches, {n_valid} valid "
        f"detections, largest BayesOD cluster {biggest}, {len(records)} json records; the "
        f"process's first call {first_s:.2f} s")
    log(f"slice: {ms:.2f} ms/batch median of {[round(t, 2) for t in times]}, "
        f"{BATCH / ms * 1e3:.2f} img/s, head bank {(t1 - t0) * 1e3:.2f} ms, core+BayesOD "
        f"{(t2 - t1) * 1e3:.2f} ms, peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    return launches, frozen_bn_launches


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
    """Phase 5: the training slice at full width. Returns the launch counts
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
    per_step = k1_per_pass(cfg)
    steps = 6
    per_step_k3 = FROZEN_BN_FORWARD + FROZEN_BN_BACKWARD
    kdropout.LAUNCHES = kfocal.LAUNCHES = kfb.LAUNCHES = 0
    trainer.train(max_iter=steps, log_period=steps)
    torch.cuda.synchronize()
    launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES,
                "frozen_bn": kfb.LAUNCHES}
    if launches != {"dropout": 2 * per_step * steps, "focal": steps,
                    "frozen_bn": per_step_k3 * steps}:
        raise AssertionError(f"launches {launches} in {steps} steps, expected "
                             f"{2 * per_step} dropout, 1 focal and {per_step_k3} FrozenBN "
                             f"epilogue per step")
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
    log(f"train: {steps} steps through Trainer.train, {launches['dropout']} dropout, "
        f"{launches['focal']} focal and {launches['frozen_bn']} FrozenBN epilogue launches "
        f"({2 * per_step}, 1 and {per_step_k3} per step), losses "
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
        kdropout.LAUNCHES = kfocal.LAUNCHES = kfb.LAUNCHES = 0
        metrics = trainer.train_step(trainer.state, batch_to_device(batch, trainer.device))
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        step_launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES,
                         "frozen_bn": kfb.LAUNCHES}
        if step_launches != {"dropout": 2 * per_step, "focal": 1, "frozen_bn": per_step_k3}:
            raise AssertionError(f"step launched {step_launches}, expected "
                                 f"{2 * per_step} dropout, 1 focal and {per_step_k3} FrozenBN "
                                 f"epilogue")
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

    def __call__(self, xs, tower, layer):
        outs = self.kernel(xs, tower, layer)
        for level, out in enumerate(outs):
            self.gates[tower, layer, level] = (out > 0).cpu()
        return outs


class PinnedGates(TowerDropout):
    """The same dropout on another device with the gates of a recorded run:
    x·scale where that run's output was positive, else 0. Where x is within
    rounding of 0 the two devices can disagree on the sign of the ReLU's
    input; pinning the gates keeps one such element from standing in for a
    difference of the whole step. `flips` counts where the plain kernel's
    own gate differs from the pinned one, out of `total`."""

    def __init__(self, kernel: KernelDropout, gates):
        self.kernel, self.gates, self.flips, self.total = kernel, gates, 0, 0

    def __call__(self, xs, tower, layer):
        with torch.no_grad():
            own = self.kernel(xs, tower, layer)
        outs = []
        for level, (x, y) in enumerate(zip(xs, own)):
            gate = self.gates[tower, layer, level].to(x.device)
            self.flips += int(((y > 0) != gate).sum())
            self.total += gate.numel()
            scale = kdropout.keep_scale(self.kernel.rate, x.dtype)
            outs.append(torch.where(gate, x * scale,
                                    torch.zeros((), dtype=x.dtype, device=x.device)))
        return outs


def check_train_against_cpu(seed: int, card: str, work: str) -> None:
    """Phase 6: one train step at 128x128, float32: the GPU through the
    kernels against the CPU through their plain versions, same weights,
    seeds and batch. The checked CPU step keeps the GPU's ReLU gates in the
    towers (PinnedGates); a second CPU step with its own gates is reported
    beside it. The kernels' own bit-for-bit checks are tests/test_torch_*_cuda.py."""
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


# ------------------------------------------------------------ evaluation phase
EVAL_IMAGES = 32
EVAL_SIZE = (720, 1280)  # BDD100k's frames


def write_bdd_layout(root: str, seed: int):
    """The synthetic dataset at BDD's geometry (1-30 boxes per image, 7
    classes), laid out as --dataset-dir expects bdd_val: labels/ and
    images/100k/val. Returns the ground truth's path."""
    json_file, image_dir = generate_synthetic_dataset(
        root, "val", num_images=EVAL_IMAGES, image_size=EVAL_SIZE, num_classes=NUM_CLASSES,
        max_objects=30, seed=seed)
    os.makedirs(os.path.join(root, "labels"))
    os.makedirs(os.path.join(root, "images", "100k"))
    gt_file = os.path.join(root, "labels", "val_coco_format.json")
    os.replace(json_file, gt_file)
    os.replace(image_dir, os.path.join(root, "images", "100k", "val"))
    return gt_file


def decode_and_resize_ms(paths):
    """Per-image host ms of the loader's decode (``load_image_bgr``) and of
    its resize to apply_net's 750x1333 (``cv2.resize``, INTER_LINEAR), with
    OpenCV on one thread."""
    cv2_threads = cv2.getNumThreads()
    cv2.setNumThreads(0)
    decode_ms, resize_ms = [], []
    try:
        for path in paths:
            t = time.perf_counter()
            img = load_image_bgr(path)
            decode_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            cv2.resize(img, (1333, 750), interpolation=cv2.INTER_LINEAR)
            resize_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        cv2.setNumThreads(cv2_threads)
    return decode_ms, resize_ms


def check_metrics(name: str, summary: dict, finite_only: bool) -> None:
    """mAP and every metric of the suite finite; with `finite_only` False a
    metric may be NaN (the reference's None) where its partition is empty."""
    values = {"mAP": summary["mAP"], "AP50": summary["AP50"],
              **{f"nll.{k}": v for k, v in summary["probabilistic_metrics"].items()},
              **{f"calibration.{k}": v for k, v in summary["calibration_errors"].items()}}
    for key, value in values.items():
        if math.isinf(value) or (finite_only and not math.isfinite(value)):
            raise AssertionError(f"{name}: {key} = {value}")
    for key in ("mAP", "AP50", "calibration.cls_marginal_calibration_error"):
        if not math.isfinite(values[key]):
            raise AssertionError(f"{name}: {key} = {values[key]}")


def engines_agree(gt: dict, records: list, name: str) -> np.ndarray:
    """The native and the numpy COCO engines give the same stats."""
    native_stats = COCOEvaluator(gt, records, cat_ids=DEFAULT_CAT_IDS).run(verbose=False)
    numpy_stats = COCOEvaluator(gt, records, cat_ids=DEFAULT_CAT_IDS).run(
        verbose=False, use_native=False)
    if not np.allclose(native_stats, numpy_stats, rtol=0, atol=1e-12):
        raise AssertionError(f"{name}: native {native_stats} != numpy {numpy_stats}")
    return native_stats


def run_eval(seed: int, card: str, work: str):
    """Phase 7: apply_net's main on the card, from PNGs on disk through the
    loader and the flagship predictor to the json and the metric suite, and
    the metric suite on the ground truth with seeded jitter."""
    t0 = time.perf_counter()
    root = os.path.join(work, "bdd")
    gt_file = write_bdd_layout(root, seed)
    with open(gt_file) as f:
        gt = json.load(f)
    write_s = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(root, "images", "100k", "val")))[:8]
    decode_ms, resize_ms = decode_and_resize_ms(
        [os.path.join(root, "images", "100k", "val", name) for name in names])

    # The smoke's seeded, tempered weights as the checkpoint apply_net loads.
    data = os.path.join(work, "data")
    os.environ["POD_COMPARE_DATA_DIR"] = data
    argv = ["--config-file", TRAIN_CFG, "--inference-config", INFER_CFG, "--dataset-dir", root,
            "--test-dataset", "bdd_val", "--random-seed", str(seed)]
    args = setup_arg_parser().parse_args(argv)
    cfg = merge_configs(TRAIN_CFG, INFER_CFG)
    out_dir = os.path.join(data, "BDD-Detection", "retinanet",
                           os.path.splitext(os.path.basename(TRAIN_CFG))[0], f"random_seed_{seed}")
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    probe = torch.from_numpy(canvases(seed, EVAL_CANVAS, 1))
    Checkpointer(out_dir).save(0, {"model": temper_head(sd, cfg, probe, "cuda")})

    batches = -(-EVAL_IMAGES // BATCH)
    per_batch = int(cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS) * k1_per_pass(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kdropout.LAUNCHES = 0
    t = time.perf_counter()
    summary = apply_net_main(args, batch_size=BATCH)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = kdropout.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != per_batch * batches:
        raise AssertionError(f"{launches} dropout launches in apply_net, expected "
                             f"{per_batch} x {batches} batches")

    # Where the loader-fed time goes: the loader alone, then the predictor
    # alone on its first batch, already on the card.
    loader = TestLoader(get_dataset("bdd_val"), batch_size=BATCH, min_size=cfg.INPUT.MIN_SIZE_TEST,
                        max_size=cfg.INPUT.MAX_SIZE_TEST, num_workers=cfg.DATALOADER.NUM_WORKERS)
    t = time.perf_counter()
    host_batches = list(loader)
    loader_ips = EVAL_IMAGES / (time.perf_counter() - t)
    loader.close()
    predictor = build_predictor(cfg, loader.canvas, load_params(out_dir))
    first = host_batches[0]
    feed = [torch.from_numpy(first[k]).cuda() for k in ("images", "input_sizes", "output_sizes")]
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predictor(*feed, generator=torch.Generator().manual_seed(seed + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    predictor_ms = float(np.median(times[1:]))
    del predictor

    with open(os.path.join(summary["inference_output_dir"], "coco_instances_results.json")) as f:
        records = json.load(f)
    if {r["image_id"] for r in records} != {im["id"] for im in gt["images"]}:
        raise AssertionError("an image has no entry in coco_instances_results.json")
    probs = np.array([r["cls_prob"] for r in records])
    covs = np.array([r["bbox_covar"] for r in records])
    if probs.shape != (len(records), NUM_CLASSES) or covs.shape != (len(records), 4, 4):
        raise AssertionError(f"cls_prob {probs.shape} / bbox_covar {covs.shape} malformed")
    if not (np.isfinite(probs).all() and np.linalg.eigvalsh(covs).min() > 0):
        raise AssertionError("non-finite class probabilities or a covariance not PD")
    engines_agree(gt, records, "model json")
    check_metrics("model json", summary, finite_only=False)

    # The ground truth with seeded jitter and covariances, scored the same
    # way: every metric a finite number, and not a trivial one.
    jitter_dir = os.path.join(work, "jittered")
    os.makedirs(jitter_dir)
    jittered = synthetic_detections(gt, NUM_CLASSES, seed=seed, false_positives=4)
    with open(os.path.join(jitter_dir, "coco_instances_results.json"), "w") as f:
        json.dump(jittered, f)
    t = time.perf_counter()
    stats = engines_agree(gt, jittered, "jittered ground truth")
    ap, threshold = evaluate_average_precision(jitter_dir, "bdd_val", verbose=False)
    jitter_summary = {
        "mAP": float(ap[0]), "AP50": float(ap[1]),
        "probabilistic_metrics": evaluate_probabilistic_metrics(
            jitter_dir, "bdd_val", "bdd_train", verbose=False),
        "calibration_errors": evaluate_calibration_errors(
            jitter_dir, "bdd_val", "bdd_train", verbose=False),
    }
    jitter_s = time.perf_counter() - t
    check_metrics("jittered ground truth", jitter_summary, finite_only=True)
    if not (stats[1] > 0.5 and jitter_summary["probabilistic_metrics"]["num_true_positives"] > 0):
        raise AssertionError(f"jittered ground truth scored trivially: AP50 {stats[1]}")

    log(f"eval: wrote {EVAL_IMAGES} PNGs at {EVAL_SIZE[0]}x{EVAL_SIZE[1]} in {write_s:.2f} s; "
        f"host decode (cv2) {np.median(decode_ms):.2f} ms/image, resize to 750x1333 "
        f"{np.median(resize_ms):.2f} ms/image (median of {len(names)}, one thread) ({card})")
    log(f"eval: apply_net main {main_s:.2f} s: {summary['num_images']} images, "
        f"{summary['num_detections']} detections, loader-fed "
        f"{summary['images_per_second']:.2f} img/s at batch {BATCH} on {EVAL_CANVAS[0]}x"
        f"{EVAL_CANVAS[1]}, evaluation {summary['evaluation_seconds']:.2f} s, {launches} dropout "
        f"launches ({per_batch} x {batches} batches), peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    log(f"eval: the loader alone {loader_ips:.2f} img/s ({cfg.DATALOADER.NUM_WORKERS} threads); "
        f"the predictor alone {predictor_ms:.2f} ms/batch, {BATCH / predictor_ms * 1e3:.2f} img/s "
        f"(median of 5 after one, {[round(x, 2) for x in times]}) ({card})")
    log("eval: model json mAP {:.4f} AP50 {:.4f}; ".format(summary["mAP"], summary["AP50"])
        + ", ".join(f"{k} {v:.4f}" for k, v in {**summary["probabilistic_metrics"],
                                                  **summary["calibration_errors"]}.items()))
    log(f"eval: jittered ground truth scored in {jitter_s:.2f} s (both COCO engines): mAP "
        f"{jitter_summary['mAP']:.4f} AP50 {jitter_summary['AP50']:.4f}, threshold {threshold:.4f}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in {**jitter_summary["probabilistic_metrics"],
                                                  **jitter_summary["calibration_errors"]}.items()))
    return launches


# ------------------------------------------------------------ train_net phase
TRAIN_NET_IMAGES = {"train": 48, "val": 16}  # cut from BDD100k's 70,000 and 10,000
TRAIN_NET_STEPS = 20
TRAIN_NET_PERIOD = 10  # SOLVER.CHECKPOINT_PERIOD and TEST.EVAL_PERIOD
TRAIN_NET_CANVAS = (736, 1280)  # MIN_SIZE_TRAIN (720,): 720x1280 unscaled, padded to /32


def write_bdd_jpeg_layout(root: str, seed: int) -> None:
    """BDD's layout with JPEGs at BDD's 720x1280, written by cv2 at quality
    90: labels/{train,val}_coco_format.json (the converters' schema and
    categories) and images/100k/{train,val}/; 1-30 boxes of 7 classes per
    image, solid rectangles over noise, from the seed."""
    rng = np.random.default_rng([seed, 10])
    h, w = EVAL_SIZE
    colors = rng.integers(90, 256, (NUM_CLASSES, 3), dtype=np.uint8)
    for split, count in TRAIN_NET_IMAGES.items():
        image_dir = os.path.join(root, "images", "100k", split)
        os.makedirs(image_dir)
        images, annotations = [], []
        for image_id in range(count):
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            for _ in range(int(rng.integers(1, 31))):
                side = np.exp(rng.uniform(np.log(16), np.log(min(400, h // 2)), 2))
                bw, bh = (int(v) for v in side)
                x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                cls = int(rng.integers(0, NUM_CLASSES))
                img[y:y + bh, x:x + bw] = colors[cls]
                annotations.append(annotation(len(annotations), image_id, cls + 1,
                                              [x, y, x + bw, y + bh]))
            name = f"{split}_{image_id:05d}.jpg"
            if not cv2.imwrite(os.path.join(image_dir, name), img, [cv2.IMWRITE_JPEG_QUALITY, 90]):
                raise RuntimeError(f"cv2.imwrite failed for {name}")
            images.append({"id": image_id, "width": w, "height": h, "file_name": name,
                           "license": 1})
        write_coco_json(os.path.join(root, "labels", f"{split}_coco_format.json"), images,
                        annotations, BDD_CATEGORIES)


def backbone_pkl_and_pth(seed: int, work: str):
    """The seed's full-width R-50 in detectron2's bare backbone names
    (stem.*, res{2-5}.*) as a model-zoo style .pkl (numpy arrays under
    "model") and the same tensors as a .pth."""
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    prefix = "backbone.bottom_up."
    backbone = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    pkl, pth = os.path.join(work, "R-50.pkl"), os.path.join(work, "R-50.pth")
    with open(pkl, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in backbone.items()},
                     "__author__": "chip_smoke"}, f, protocol=2)
    torch.save({"model": backbone}, pth)
    return pkl, pth


def batch_digest(batch) -> str:
    h = hashlib.sha256()
    for k in trainer_module.TRAIN_BATCH_KEYS:
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def watch_train_net(record: dict):
    """Record what train_net.main's trainer does, without changing it: each
    step's wall time (the step synchronised at its end, so each interval
    holds that step's data, transfer, step and whatever followed it: a
    checkpoint, an evaluation), losses and kernel launches, a digest of each
    batch, and each Trainer.test call (seconds, canvas, summary) with the
    test loaders and predictors built."""
    step_call, test_call = trainer_module.TrainStep.__call__, trainer_module.Trainer.test
    to_device = trainer_module.batch_to_device
    test_loader, predictor = trainer_module.TestLoader, trainer_module.build_predictor
    record.update(steps=[], digests=[], tests=[], built={"TestLoader": 0, "predictor": 0})
    last = [time.perf_counter()]

    def step(self, state, batch):
        k1, k2 = kdropout.LAUNCHES, kfocal.LAUNCHES
        metrics = step_call(self, state, batch)
        torch.cuda.synchronize()
        now = time.perf_counter()
        record["steps"].append({
            "ms": (now - last[0]) * 1e3, "k1": kdropout.LAUNCHES - k1, "k2": kfocal.LAUNCHES - k2,
            **{k: float(metrics[k]) for k in ("loss_cls", "loss_box_reg", "total_loss")}})
        last[0] = now
        return metrics

    def digest(batch, device):
        record["digests"].append(batch_digest(batch))
        return to_device(batch, device)

    def test(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        summary = test_call(self, *args, **kwargs)
        torch.cuda.synchronize()
        loader, _ = next(iter(self._eval_cache.values()))
        record["tests"].append({"step": self.state.step, "s": time.perf_counter() - t,
                                "canvas": tuple(loader.canvas), "summary": summary})
        return summary

    def counted(name, fn):
        def build(*args, **kwargs):
            record["built"][name] += 1
            return fn(*args, **kwargs)
        return build

    trainer_module.TrainStep.__call__, trainer_module.Trainer.test = step, test
    trainer_module.batch_to_device = digest
    trainer_module.TestLoader = counted("TestLoader", test_loader)
    trainer_module.build_predictor = counted("predictor", predictor)
    try:
        yield record
    finally:
        trainer_module.TrainStep.__call__, trainer_module.Trainer.test = step_call, test_call
        trainer_module.batch_to_device = to_device
        trainer_module.TestLoader, trainer_module.build_predictor = test_loader, predictor


def train_loader_ips(cfg, backend: str, batches: int):
    """TrainLoader alone on bdd_train as train_net's trainer builds it
    (batch 4, 720x1280 JPEGs, 8 workers), with `backend`: seconds to its
    first batch (with 'process', the workers' start), img/s over the next
    `batches` and their digests."""
    t = time.perf_counter()
    loader = TrainLoader(
        get_dataset("bdd_train"), batch_size=cfg.SOLVER.IMS_PER_BATCH,
        min_size=tuple(cfg.INPUT.MIN_SIZE_TRAIN), max_size=cfg.INPUT.MAX_SIZE_TRAIN,
        divisibility=cfg.INPUT.SIZE_DIVISIBILITY, max_gt_boxes=cfg.INPUT.MAX_GT_BOXES,
        seed=max(cfg.SEED, 0), num_workers=cfg.DATALOADER.NUM_WORKERS,
        flip=cfg.INPUT.RANDOM_FLIP == "horizontal", worker_backend=backend)
    try:
        stream = loader.iter_from(0)
        next(stream)
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        digests = [batch_digest(next(stream)) for _ in range(batches)]
        ips = batches * TRAIN_BATCH / (time.perf_counter() - t)
    finally:
        loader.close()
    return first_s, ips, digests


def run_train_net(seed: int, card: str, work: str):
    """Phase 8: train_net's main on the card at full width, as
    `python -m pod_compare_tpu_torch.cli.train_net` runs it, from JPEGs on
    disk in BDD's layout, warm-started from a .pkl; then a run resumed from
    its step-10 checkpoint. Returns the launches of the uninterrupted run."""
    t0 = time.perf_counter()
    root = os.path.join(work, "bdd_jpeg")
    write_bdd_jpeg_layout(root, seed)
    write_s = time.perf_counter() - t0
    pkl, pth = backbone_pkl_and_pth(seed, work)
    from_pkl = convert.from_reference_state_dict(convert.load_reference_checkpoint(pkl))
    from_pth = convert.from_reference_state_dict(convert.load_reference_checkpoint(pth))
    if from_pkl.keys() != from_pth.keys() or not all(
            torch.equal(v, from_pth[k]) for k, v in from_pkl.items()):
        raise AssertionError("the .pkl and the .pth of the same tensors load differently")

    os.environ["POD_COMPARE_DATA_DIR"] = os.path.join(work, "train_net")
    opts = ["MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas", "MODEL.WEIGHTS", pkl,
            "SOLVER.MAX_ITER", TRAIN_NET_STEPS, "SOLVER.CHECKPOINT_PERIOD", TRAIN_NET_PERIOD,
            "TEST.EVAL_PERIOD", TRAIN_NET_PERIOD, "SOLVER.IMS_PER_BATCH", TRAIN_BATCH,
            "INPUT.MIN_SIZE_TRAIN", f"({EVAL_SIZE[0]},)"]

    def args(*flags):
        return setup_arg_parser().parse_args(
            ["--config-file", TRAIN_CFG, "--dataset-dir", root, "--random-seed", str(seed),
             *flags, *map(str, opts)])

    cfg = merge_configs(TRAIN_CFG, "", list(map(str, opts)) + ["SEED", str(seed)])
    if (cfg.DATALOADER.NUM_WORKERS, cfg.DATALOADER.WORKER_BACKEND) != (8, "thread"):
        raise AssertionError("the flagship config's loader is no longer 8 threads")
    per_step = k1_per_pass(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    with watch_train_net({}) as whole:
        t = time.perf_counter()
        trainer = train_net.main(args())
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t
    launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    steps = whole["steps"]
    if launches != {"dropout": per_step * 2 * TRAIN_NET_STEPS, "focal": TRAIN_NET_STEPS} or any(
            (st["k1"], st["k2"]) != (2 * per_step, 1) for st in steps) or len(steps) != TRAIN_NET_STEPS:
        raise AssertionError(f"train_net launched {launches}, per step "
                             f"{[(st['k1'], st['k2']) for st in steps]}; expected "
                             f"{2 * per_step} dropout and 1 focal in each of {TRAIN_NET_STEPS}")
    if not all(math.isfinite(st[k]) for st in steps for k in ("loss_cls", "loss_box_reg")):
        raise AssertionError(f"non-finite losses: {steps}")
    if trainer.canvas != TRAIN_NET_CANVAS:
        raise AssertionError(f"train canvas {trainer.canvas}")
    final = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
    del trainer
    frozen = [k for k in from_pkl if ".stem." in k or ".res2." in k]
    if not frozen or not all(torch.equal(final[k], from_pkl[k]) for k in frozen):
        raise AssertionError("a frozen stage moved, or was not loaded from the .pkl")
    checkpointer = Checkpointer(os.path.join(
        os.environ["POD_COMPARE_DATA_DIR"], "BDD-Detection", "retinanet",
        os.path.splitext(os.path.basename(TRAIN_CFG))[0], f"random_seed_{seed}"))
    if checkpointer.steps() != [TRAIN_NET_PERIOD, TRAIN_NET_STEPS]:
        raise AssertionError(f"checkpoints at {checkpointer.steps()}")
    if torch.equal(checkpointer.restore(TRAIN_NET_PERIOD)["model"]["head.cls_score.weight"],
                   final["head.cls_score.weight"]):
        raise AssertionError("the head did not move between steps 10 and 20")
    tests = whole["tests"]
    eval_canvas = tuple(EVAL_CANVAS)
    if ([t["step"] for t in tests] != [TRAIN_NET_PERIOD, TRAIN_NET_STEPS]
            or any(t["canvas"] != eval_canvas for t in tests)
            or whole["built"] != {"TestLoader": 1, "predictor": 1}
            or not all(math.isfinite(t["summary"][k]) for t in tests for k in ("mAP", "AP50"))):
        raise AssertionError(f"Trainer.test: {[(t['step'], t['canvas']) for t in tests]}, "
                             f"built {whole['built']}, "
                             f"{[(t['summary']['mAP'], t['summary']['AP50']) for t in tests]}")

    # Resume from step 10 with 2 checkpoints on disk at most: the step-20
    # one goes, the resumed run writes its own.
    os.remove(checkpointer.path(TRAIN_NET_STEPS))
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    with watch_train_net({}) as resumed:
        trainer = train_net.main(args("--resume"))
        torch.cuda.synchronize()
    del trainer
    if resumed["digests"] != whole["digests"][TRAIN_NET_PERIOD:]:
        raise AssertionError("the resumed run's batches differ from the uninterrupted run's")
    if (kdropout.LAUNCHES, kfocal.LAUNCHES) != (2 * per_step * TRAIN_NET_PERIOD, TRAIN_NET_PERIOD):
        raise AssertionError(f"resumed run launched {kdropout.LAUNCHES}, {kfocal.LAUNCHES}")
    diffs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                 for k in ("loss_cls", "loss_box_reg", "total_loss"))
             for a, b in zip(resumed["steps"], steps[TRAIN_NET_PERIOD:])]
    if len(diffs) != TRAIN_NET_PERIOD or not diffs[0] <= 1e-5:
        raise AssertionError(f"the first resumed step's losses differ by {diffs[:1]} of their "
                             "magnitude")
    shutil.rmtree(os.environ["POD_COMPARE_DATA_DIR"])
    torch.cuda.empty_cache()

    # The loader alone, both backends; the same batches from both.
    thread_first, thread_ips, thread_digests = train_loader_ips(cfg, "thread", TRAIN_NET_STEPS - 1)
    process_first, process_ips, process_digests = train_loader_ips(cfg, "process",
                                                                   TRAIN_NET_STEPS - 1)
    if thread_digests != process_digests or thread_digests != whole["digests"][1:]:
        raise AssertionError("the process backend's batches differ from the thread backend's")
    jpegs = sorted(os.listdir(os.path.join(root, "images", "100k", "train")))[:8]
    decode_ms, resize_ms = decode_and_resize_ms(
        [os.path.join(root, "images", "100k", "train", name) for name in jpegs])  # root stays: phase 11

    # Step i's interval runs from step i-1's end: the first holds the
    # trainer's start, the eleventh the checkpoint and evaluation of step 10
    # (step 20's come after the last interval).
    step_ms = [st["ms"] for i, st in enumerate(steps) if i not in (0, TRAIN_NET_PERIOD)]
    log(f"train_net: wrote {sum(TRAIN_NET_IMAGES.values())} JPEGs (quality 90) at "
        f"{EVAL_SIZE[0]}x{EVAL_SIZE[1]} in {write_s:.2f} s; the .pkl warm start loads the "
        f".pth's tensors exactly ({card})")
    log(f"train_net: main {whole_s:.2f} s for {TRAIN_NET_STEPS} steps at batch {TRAIN_BATCH} on "
        f"{TRAIN_NET_CANVAS[0]}x{TRAIN_NET_CANVAS[1]}: loader-fed {np.median(step_ms):.2f} ms/step "
        f"median of the {len(step_ms)} steps without the start or an eval "
        f"({[round(x, 2) for x in step_ms]}), {launches['dropout']} dropout and "
        f"{launches['focal']} focal launches, peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    log("train_net: losses at steps " + "; ".join(
        f"{i + 1}: " + ", ".join(f"{k} {steps[i][k]:.4g}" for k in ("loss_cls", "loss_box_reg"))
        for i in (0, TRAIN_NET_PERIOD - 1, TRAIN_NET_STEPS - 1)) + f" ({card})")
    log(f"train_net: Trainer.test at steps {[t['step'] for t in tests]} on "
        f"{eval_canvas[0]}x{eval_canvas[1]}: {[round(t['s'], 2) for t in tests]} s, mAP "
        f"{[round(t['summary']['mAP'], 4) for t in tests]}, AP50 "
        f"{[round(t['summary']['AP50'], 4) for t in tests]}; one test loader and one predictor "
        f"built over both calls ({card})")
    first = TRAIN_NET_PERIOD + 1
    log(f"train_net: resumed at step {TRAIN_NET_PERIOD}: batches {first}-{TRAIN_NET_STEPS} equal "
        f"by digest, step {first} losses within {diffs[0]:.3e} of their magnitude, the largest "
        f"over steps {first}-{TRAIN_NET_STEPS} {max(diffs):.3e} ({card})")
    log(f"train_net: TrainLoader alone, 8 workers: thread {thread_ips:.2f} img/s (first batch "
        f"after {thread_first:.2f} s), process {process_ips:.2f} img/s (first batch after "
        f"{process_first:.2f} s, the spawned workers' start), the same batches; cv2 decode "
        f"{np.median(decode_ms):.2f} ms per {EVAL_SIZE[0]}x{EVAL_SIZE[1]} JPEG, resize to 750x1333 "
        f"{np.median(resize_ms):.2f} ms (median of {len(jpegs)}, one thread) ({card})")
    return launches


# ------------------------------------------------------------ modes phase
# Every file of configs/Inference/, bayes_od.yaml with covariance
# intersection, and the flagship with the Monte-Carlo banks: (name,
# inference config, overrides).
MODE_CASES = [
    ("standard_nms", "Inference/standard_nms.yaml", ()),
    ("anchor_statistics", "Inference/anchor_statistics.yaml", ()),
    ("bayes_od", "Inference/bayes_od.yaml", ()),
    ("bayes_od_covariance_intersection", "Inference/bayes_od.yaml",
     ("PROBABILISTIC_INFERENCE.BAYES_OD.BOX_MERGE_MODE", "covariance_intersection")),
    ("bayes_od_mc_dropout", INFER_CFG, ()),
    ("mc_dropout_ensembles_pre_nms", "Inference/mc_dropout_ensembles_pre_nms.yaml", ()),
    ("mc_dropout_ensembles_post_nms", "Inference/mc_dropout_ensembles_post_nms.yaml", ()),
    ("ensembles_pre_nms", "Inference/ensembles_pre_nms.yaml", ()),
    ("ensembles_post_nms", "Inference/ensembles_post_nms.yaml", ()),
    ("bayes_od_mc_dropout_mc_iid", INFER_CFG,
     ("PROBABILISTIC_INFERENCE.CLS_SAMPLING", "mc_iid",
      "PROBABILISTIC_INFERENCE.BOX_SAMPLING", "mc_iid")),
]
# Modes whose detections are clusters: each image must hold one of >= 2.
CLUSTERED = {"anchor_statistics", "bayes_od", "bayes_od_covariance_intersection",
             "bayes_od_mc_dropout", "mc_dropout_ensembles_post_nms", "ensembles_post_nms",
             "bayes_od_mc_dropout_mc_iid"}
MODE_TIMED_CALLS = 5
MAX_MODE_FLIPS = 0.01  # share of detections the GPU and CPU may disagree on
MODES_APPLY_IMAGES = 8  # of phase 7's 32 PNGs


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mode_config(infer: str, opts=()):
    return merge_configs(TRAIN_CFG, infer, list(opts))


def ensemble_members(cfg, state_dict, probe: torch.Tensor, device):
    """One member per ENSEMBLES.RANDOM_SEED_NUMS seed: the given weights with
    every head tensor moved by 2% of its spread in noise drawn from the
    member's seed, then tempered like the flagship's. The members agree on
    most objects, as members trained from different seeds do, so post-NMS
    clusters form."""
    members = []
    for seed in cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS:
        gen = torch.Generator().manual_seed(int(seed))
        sd = {k: v + 0.02 * float(v.std()) * torch.randn(v.shape, generator=gen)
              if k.startswith("head.") and v.numel() > 1 else v
              for k, v in state_dict.items()}
        members.append({k: v.cpu() for k, v in temper_head(sd, cfg, probe, device).items()})
    return members


def mode_predictor(cfg, size, tempered, members, device):
    if cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE == "ensembles":
        return build_predictor(cfg, size, device=device, state_dicts=members)
    return build_predictor(cfg, size, tempered, device=device)


@contextlib.contextmanager
def watch_greedy(record: dict, device):
    """Count the clusters the post-NMS merge's greedy loop opens (one host
    read-back each) and its time, for the length of the block."""
    original = pmodes.greedy_sequential_clusters

    def watched(*args, **kwargs):
        sync(device)
        t = time.perf_counter()
        centers, members = original(*args, **kwargs)
        sync(device)
        record["ms"] += (time.perf_counter() - t) * 1e3
        record["clusters"] += int(centers.sum())
        record["calls"] += 1
        return centers, members

    pmodes.greedy_sequential_clusters = watched
    try:
        yield
    finally:
        pmodes.greedy_sequential_clusters = original


def check_mode_detections(dets, output_sizes, min_cluster):
    """Finite values, symmetric PD covariances, boxes inside the image, a
    valid detection in every image and, with `min_cluster`, one fused from
    at least that many members in every image."""
    if min_cluster is not None:
        return check_detections(dets, output_sizes, min_cluster)
    return check_detections(dets._replace(cluster_size=torch.ones_like(dets.classes)),
                            output_sizes, 1)


def busy_share(call, device) -> float:
    """Device busy time over wall time of one call traced with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    # The card's activity only: a trace of every host op as well adds its own
    # cost to each op inside the traced wall, and events to process after.
    # (A rehearsal on the CPU traces the host.)
    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        call()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy_ms / wall_ms, wall_ms


def normal_launches_per_call(predictor, batch: int) -> int:
    """The normal kernel's launches in one call: per image, or per (image,
    run) unit post-NMS, one for a Monte-Carlo class bank and one for each
    chunk of a Monte-Carlo box bank (`pick_chunk` of the candidates)."""
    kw = predictor.core_kwargs
    units = batch * (predictor.num_runs if predictor.post_nms else 1)
    candidates = sum(min(kw["topk"], n) for n in predictor.level_sizes)
    per_unit = int(kw["cls_sampling"] != "analytic")
    if kw["box_sampling"] != "analytic":
        per_unit += kw["box_num_samples"] // pick_chunk(kw["box_num_samples"], candidates)
    return units * per_unit


def call_sampling_seeds(predictor, seed: int, batch: int) -> torch.Tensor:
    """The sampling seeds a call with generator `seed` draws
    (seeds.draw_call_seeds), for the stage API's detect and detect_post_nms."""
    return draw_call_seeds(torch.Generator().manual_seed(seed), predictor.num_runs,
                           predictor.num_convs, batch,
                           predictor.num_runs if predictor.post_nms else 0)[1]


def run_modes(seed: int, card: str, device="cuda", canvas=CANVAS):
    """Phase 9, part 1: every mode at full width on the card. Returns each
    mode's record (dropout and normal launches of one call, ms/batch, peak
    memory, stage split, traced busy share, greedy clusters)."""
    images = torch.from_numpy(canvases(seed, canvas, BATCH)).to(device)
    sizes = IMAGE_SIZES if canvas == CANVAS else np.array([canvas] * BATCH, np.float32)
    flagship = mode_config(INFER_CFG)
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    probe = images[:1].cpu()
    tempered = temper_head(sd, flagship, probe, device)
    members = ensemble_members(flagship, sd, probe, device)
    per_batch = int(flagship.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS) * k1_per_pass(flagship)
    records = {}
    for name, infer, opts in MODE_CASES:
        t_mode = time.perf_counter()
        cfg = mode_config(infer, opts)
        predictor = mode_predictor(cfg, canvas, tempered, members, device)
        call = lambda s: predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(s))
        expected = per_batch if cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.ENABLE else 0
        expected_normal = normal_launches_per_call(predictor, BATCH)
        greedy = {"ms": 0.0, "clusters": 0, "calls": 0}
        sync(device)
        kdropout.LAUNCHES = knormal.LAUNCHES = knms.LAUNCHES = 0
        with watch_greedy(greedy, device):
            dets = call(seed)
            sync(device)
        launches, normal_launches, nms_launches = (kdropout.LAUNCHES, knormal.LAUNCHES,
                                                   knms.LAUNCHES)
        if device == "cuda" and nms_launches < BATCH:
            raise AssertionError(f"{name}: {nms_launches} NMS launches for {BATCH} images")
        if launches != expected:
            raise AssertionError(f"{name}: {launches} dropout launches, expected {expected}")
        if normal_launches != expected_normal:
            raise AssertionError(f"{name}: {normal_launches} normal launches, expected "
                                 f"{expected_normal}")
        n_valid, biggest = check_mode_detections(
            dets, sizes, 2 if name in CLUSTERED else None)
        if predictor.post_nms and greedy["calls"] != BATCH:
            raise AssertionError(f"{name}: {greedy['calls']} merges for {BATCH} images")

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(MODE_TIMED_CALLS):
            sync(device)
            t = time.perf_counter()
            call(seed + 1 + i)
            sync(device)
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        # Stage split of one more call: the head outputs of every run, then
        # the per-image (or per-unit) core, mode, merge and rescale.
        dropout_gen = torch.Generator().manual_seed(seed)
        sampling_seeds = call_sampling_seeds(predictor, seed, BATCH)
        sync(device)
        t0 = time.perf_counter()
        if predictor.post_nms:
            outs = predictor.run_outputs(images, dropout_gen)
        else:
            outs, run_deltas = predictor.head_outputs(images, dropout_gen)
        sync(device)
        t1 = time.perf_counter()
        if predictor.post_nms:
            predictor.detect_post_nms(outs, torch.as_tensor(sizes, device=device),
                                      torch.as_tensor(sizes, device=device), sampling_seeds)
        else:
            predictor.detect(outs, run_deltas, torch.as_tensor(sizes, device=device),
                             torch.as_tensor(sizes, device=device), sampling_seeds)
        sync(device)
        t2 = time.perf_counter()
        share, traced_ms = busy_share(lambda: call(seed), device)
        ms = float(np.median(times))
        records[name] = dict(
            launches=launches, normal_launches=normal_launches, nms_launches=nms_launches,
            ms=ms, times=times,
            peak_gib=peak / 2 ** 30,
            head_ms=(t1 - t0) * 1e3, rest_ms=(t2 - t1) * 1e3, busy_share=share,
            traced_ms=traced_ms, valid=n_valid, largest_cluster=biggest,
            greedy_clusters=greedy["clusters"], greedy_ms=greedy["ms"])
        log(f"modes {name}: {launches} dropout launches (expected {expected}), {normal_launches} "
            f"normal launches (expected {expected_normal}), {nms_launches} NMS launches, "
            f"{n_valid} valid "
            f"detections, largest cluster {biggest}; {ms:.2f} ms/batch median of "
            f"{[round(t, 2) for t in times]}, head {records[name]['head_ms']:.2f} ms, core/mode/"
            f"merge {records[name]['rest_ms']:.2f} ms, traced call {traced_ms:.2f} ms with the "
            f"card busy {100 * share:.1f}% (host {100 * (1 - share):.1f}%), peak memory "
            f"{peak / 2 ** 30:.3f} GiB"
            + (f", greedy merge {greedy['clusters']} clusters (one read-back each) in "
               f"{greedy['ms']:.2f} ms" if greedy["calls"] else "")
            + f"; the mode's checks {time.perf_counter() - t_mode:.2f} s ({card})")
        if name == "bayes_od_mc_dropout_mc_iid":
            check_sampled_law(predictor, images, seed, card)
        del predictor, dets
        if device == "cuda":
            torch.cuda.empty_cache()
    return records, members


def sigmoid_moments(logit: torch.Tensor, log_var: torch.Tensor):
    """E[sigmoid(z)] and Var[sigmoid(z)], z ~ N(logit, exp(log_var)), by
    64-node Gauss-Hermite quadrature in float64."""
    nodes, weights = np.polynomial.hermite.hermgauss(64)
    nodes = torch.as_tensor(np.sqrt(2.0) * nodes, dtype=torch.float64, device=logit.device)
    weights = torch.as_tensor(weights / np.sqrt(np.pi), dtype=torch.float64, device=logit.device)
    std = torch.exp(0.5 * log_var.double())
    mean, second = 0, 0
    for node, w in zip(nodes, weights):
        s = torch.sigmoid(logit.double() + node * std)
        mean = mean + w * s
        second = second + w * s * s
    return mean, (second - mean * mean).clamp_min(0.0)


def z_stats(z: torch.Tensor):
    return float(z.mean()), float(z.std()), float((z.abs() > 6).float().mean())


def check_sampled_law(predictor, images, seed: int, card: str) -> None:
    """Phase 9, the Monte-Carlo banks at full width, held by law: on image
    0's head outputs, the mc_iid class bank (S = 10 per anchor and class)
    against the exact mean and variance of the sigmoid, and the sampled box
    decode (S = 1000, chunked) at the analytic core's candidates against
    the closed-form decode moments; each as standardised errors z, whose
    mean must be ~0 and spread ~1. The banks draw from image 0's sampling
    seed of a call with generator `seed`, as the predictor's call does."""
    kw = predictor.core_kwargs
    outs, _ = predictor.head_outputs(images, torch.Generator().manual_seed(seed))
    cls, var = outs["box_cls"][0], outs["box_cls_var"][0]
    image_seed = call_sampling_seeds(predictor, seed, images.shape[0])[0]
    s_cls = kw["cls_num_samples"]
    mc = classification_probs(cls, var, "mc_iid", s_cls, image_seed).double()
    exact, variance = sigmoid_moments(cls, var)
    se = torch.sqrt(variance / s_cls)
    keep = se > 1e-5  # saturated sigmoids: float32 rounding, not sampling
    zc = ((mc - exact) / se)[keep]

    cands = probabilistic_inference_core(
        predictor.anchors, cls, outs["box_delta"][0], var, outs["box_reg_var"][0], None,
        **{**kw, "cls_sampling": "analytic", "box_sampling": "analytic"})
    idx = cands.anchor_idx
    deltas = outs["box_delta"][0][idx]
    chol = covariance_output_to_cholesky(outs["box_reg_var"][0][idx])
    anchors = predictor.anchors[idx]
    s_box = kw["box_num_samples"]
    chunk = pick_chunk(s_box, idx.shape[0])
    span = knormal.stream_span(math.prod(cls.shape) * s_cls)
    mean_mc, cov_mc = sampled_box_moments(image_seed, deltas, chol, anchors, s_box,
                                          kw["box_reg_weights"], offset=span, index=idx,
                                          rows=predictor.anchors.shape[0])
    mean_a, cov_a = decoded_box_moments(deltas, chol @ chol.transpose(-1, -2), anchors,
                                        kw["box_reg_weights"])
    var_a = torch.diagonal(cov_a, dim1=-2, dim2=-1).double()
    zm = ((mean_mc - mean_a).double() / torch.sqrt(var_a / s_box)).flatten()
    zv = ((torch.diagonal(cov_mc, dim1=-2, dim2=-1).double() - var_a)
          / (var_a * math.sqrt(2.0 / (s_box - 1)))).flatten()
    stats = {"class bank": z_stats(zc), "box means": z_stats(zm), "box variances": z_stats(zv)}
    log(f"modes mc_iid law: {int(keep.sum())} class probabilities (S = {s_cls}), "
        f"{idx.shape[0]} candidates (S = {s_box} in {s_box // chunk} chunks of {chunk}); "
        + "; ".join(f"{k} z mean {m:+.4f} std {sd:.4f}, |z| > 6 {100 * f:.4f}%"
                    for k, (m, sd, f) in stats.items()) + f" ({card})")
    bands = {"class bank": (0.02, 0.95, 1.05), "box means": (0.1, 0.85, 1.15),
             "box variances": (0.2, 0.75, 1.5)}
    for key, (m, sd, f) in stats.items():
        max_mean, lo, hi = bands[key]
        if not (abs(m) < max_mean and lo < sd < hi and f < 1e-3):
            raise AssertionError(f"mc_iid {key}: z mean {m}, std {sd}, |z| > 6 share {f} "
                                 f"outside |mean| < {max_mean}, {lo} < std < {hi}, < 1e-3")


def match_detections(gpu, cpu):
    """Per image, each CPU detection matched to an unmatched GPU detection of
    its class at IoU > 0.99 in the output frame. Returns the matched index
    pairs (batch, cpu, gpu) and the number of detections either side has
    unmatched (flips)."""
    pairs, flips = [], 0
    for b in range(cpu.valid.shape[0]):
        c_idx = torch.nonzero(cpu.valid[b]).flatten().tolist()
        g_idx = torch.nonzero(gpu.valid[b]).flatten().tolist()
        iou = pairwise_iou(cpu.boxes[b], gpu.boxes[b])
        free = set(g_idx)
        for i in c_idx:
            best = max((j for j in free if int(gpu.classes[b, j]) == int(cpu.classes[b, i])),
                       key=lambda j: float(iou[i, j]), default=None)
            if best is not None and float(iou[i, best]) > 0.99:
                pairs.append((b, i, best))
                free.discard(best)
            else:
                flips += 1
        flips += len(free)
    return pairs, flips


def check_modes_against_cpu(seed: int, card: str) -> None:
    """Phase 9, part 2: every mode on the GPU against its plain path on the
    CPU at 128x128 in float32, M = 3, same weights, masks, members and
    normals (the mc_iid flagship's banks draw from the call's seeds on both
    sides, through the normal kernel on the GPU and its plain version on
    the CPU, within a few ulps of each other). Detections are matched by
    class and IoU; the unmatched count as flips, at most 1% of the
    detections; matched values within 1e-3 of each box's or matrix's
    largest entry."""
    opts = ("PARALLEL.COMPUTE_DTYPE", "float32", "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 3)
    size = (128, 128)
    images = torch.from_numpy(canvases(seed + 1, size, BATCH))
    flagship = mode_config(INFER_CFG, opts)
    sd = convert.from_jax_params(random_jax_params(seed + 1, NUM_CLASSES))
    tempered = temper_head(sd, flagship, images[:1], "cpu")
    members = ensemble_members(flagship, sd, images[:1], "cpu")
    summary = []
    for name, infer, extra in MODE_CASES:
        cfg = mode_config(infer, tuple(opts) + tuple(extra))
        summary.append(gpu_against_cpu(name, cfg, size, images, tempered, members, seed))
    log("modes reference (GPU vs CPU, 128x128 float32, max relative error): "
        + "; ".join(summary) + f" ({card})")


def gpu_against_cpu(name, cfg, size, images, tempered, members, seed) -> str:
    """One configuration's predictor on the GPU and on the CPU, same weights
    and generator, held by `held_against_cpu`. Returns the summary line."""
    sizes = np.array([size] * images.shape[0], np.float32)
    dets = {}
    for device in (DEVICE, "cpu"):
        predictor = mode_predictor(cfg, size, tempered, members, device)
        out = predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(seed))
        dets[device] = type(out)(*[None if f is None else f.cpu() for f in out])
    return held_against_cpu(name, dets[DEVICE], dets["cpu"])


def held_against_cpu(name, g, c) -> str:
    """GPU detections `g` against CPU detections `c`: matched by class and
    IoU, at most 1% flips, matched values within 1e-3 of each box's or
    matrix's largest entry. Returns the summary line."""
    pairs, flips = match_detections(g, c)
    n = int(c.valid.sum())
    if n == 0 or flips > MAX_MODE_FLIPS * n:
        raise AssertionError(f"{name}: {flips} of {n} detections differ between GPU and CPU")
    errs = {}
    for field in ("boxes", "covs", "scores"):
        a = torch.stack([getattr(g, field)[b, j] for b, _, j in pairs]).double()
        r = torch.stack([getattr(c, field)[b, i] for b, i, _ in pairs]).double()
        dims = tuple(range(1, r.dim()))
        scale = r.abs().amax(dim=dims, keepdim=True) if dims else r.abs()
        errs[field] = float(((a - r).abs() / scale.clamp_min(1e-6)).max())
        if errs[field] > 1e-3:
            raise AssertionError(f"{name}: {field} differ between GPU and CPU: {errs[field]}")
    return (f"{name} {len(pairs)}/{n} matched, {flips} flips, "
            + ", ".join(f"{k} {e:.1e}" for k, e in errs.items()))


def bdd_subset(work: str, name: str, count: int) -> str:
    """The first `count` of phase 7's PNGs and their ground truth in BDD's
    layout under work/name, for --dataset-dir. Returns the root."""
    src = os.path.join(work, "bdd")
    root = os.path.join(work, name)
    with open(os.path.join(src, "labels", "val_coco_format.json")) as f:
        gt = json.load(f)
    gt["images"] = gt["images"][:count]
    ids = {im["id"] for im in gt["images"]}
    gt["annotations"] = [a for a in gt["annotations"] if a["image_id"] in ids]
    os.makedirs(os.path.join(root, "labels"))
    os.makedirs(os.path.join(root, "images", "100k", "val"))
    with open(os.path.join(root, "labels", "val_coco_format.json"), "w") as f:
        json.dump(gt, f)
    for im in gt["images"]:
        shutil.copy(os.path.join(src, "images", "100k", "val", im["file_name"]),
                    os.path.join(root, "images", "100k", "val", im["file_name"]))
    return root


def run_modes_apply_net(seed: int, card: str, work: str, members) -> dict:
    """Phase 9, part 3: apply_net's main on ensembles_post_nms with five
    members from their random_seed_<seed> sibling checkpoints, over 8 of
    phase 7's PNGs."""
    root = bdd_subset(work, "bdd_modes", MODES_APPLY_IMAGES)
    with open(os.path.join(root, "labels", "val_coco_format.json")) as f:
        ids = {im["id"] for im in json.load(f)["images"]}

    infer = "Inference/ensembles_post_nms.yaml"
    cfg = mode_config(infer)
    data = os.path.join(work, "data_modes")
    os.environ["POD_COMPARE_DATA_DIR"] = data
    config_dir = os.path.join(data, "BDD-Detection", "retinanet",
                              os.path.splitext(os.path.basename(TRAIN_CFG))[0])
    seeds = cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS
    for member_seed, member in zip(seeds, members):
        Checkpointer(os.path.join(config_dir, f"random_seed_{member_seed}")).save(
            0, {"model": member})
    args = setup_arg_parser().parse_args(
        ["--config-file", TRAIN_CFG, "--inference-config", infer, "--dataset-dir", root,
         "--test-dataset", "bdd_val", "--random-seed", str(seeds[0])])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kdropout.LAUNCHES = 0
    t = time.perf_counter()
    summary = apply_net_main(args, batch_size=BATCH)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    if kdropout.LAUNCHES != 0:
        raise AssertionError(f"{kdropout.LAUNCHES} dropout launches in the ensembles' apply_net")
    with open(os.path.join(summary["inference_output_dir"], "coco_instances_results.json")) as f:
        records = json.load(f)
    if {r["image_id"] for r in records} != ids or summary["num_images"] != len(ids):
        raise AssertionError("an image has no entry in the ensembles' json")
    probs = np.array([r["cls_prob"] for r in records])
    covs = np.array([r["bbox_covar"] for r in records])
    if probs.shape != (len(records), NUM_CLASSES) or covs.shape != (len(records), 4, 4):
        raise AssertionError(f"cls_prob {probs.shape} / bbox_covar {covs.shape} malformed")
    if not (np.isfinite(probs).all() and np.linalg.eigvalsh(covs).min() > 0):
        raise AssertionError("non-finite class probabilities or a covariance not PD")
    check_metrics("ensembles json", summary, finite_only=False)
    log(f"modes apply_net ensembles_post_nms: {len(seeds)} members from random_seed_"
        f"{{{','.join(map(str, seeds))}}}, main {main_s:.2f} s: {summary['num_images']} images, "
        f"{summary['num_detections']} detections, loader-fed {summary['images_per_second']:.2f} "
        f"img/s at batch {BATCH} on {EVAL_CANVAS[0]}x{EVAL_CANVAS[1]}, evaluation "
        f"{summary['evaluation_seconds']:.2f} s, mAP {summary['mAP']:.4f}, peak memory "
        f"{peak / 2 ** 30:.3f} GiB ({card})")
    shutil.rmtree(data, ignore_errors=True)
    return dict(seconds=main_s, images_per_second=summary["images_per_second"],
                peak_gib=peak / 2 ** 30)

# ------------------------------------------------------------ rest phase
ENERGY_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_covar_energy.yaml"
INT8 = ["PROBABILISTIC_INFERENCE.HEAD_QUANT", "int8"]
ENERGY_STEPS = 5
ENERGY_SEEDS = 8  # 1000-sample energy terms whose spread gives the standard error
ENERGY_REFERENCE_SAMPLES = 20000
REST_VIZ_IMAGES = 4
# Share of the int8 head's first-conv codes the GPU's and the CPU's FPN
# features may quantize differently (tests/test_torch_quant.py holds the
# port against JAX to the same bound).
MAX_CODE_FLIPS = 1e-3
# Where phase 10 runs; a rehearsal on the CPU sets "cpu" (with small shapes
# and the torch.cuda calls stubbed).
DEVICE = "cuda"


def flagship_launches(cfg) -> int:
    return int(cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS) * k1_per_pass(cfg)


AUTO_IMAGES = 16  # of phase 7's 32 PNGs: PDQ, on the host, takes ~1.6 s an image


def run_auto_apply_net(seed: int, card: str, work: str):
    """Phase 10, part 1: apply_net's main with --batch-size auto and
    --run-pdq on AUTO_IMAGES of phase 7's PNGs and its checkpoint. Returns
    its dropout launches and its json's path."""
    data = os.path.join(work, "data")
    os.environ["POD_COMPARE_DATA_DIR"] = data
    root = bdd_subset(work, "bdd_auto", AUTO_IMAGES)
    args = setup_arg_parser().parse_args(
        ["--config-file", TRAIN_CFG, "--inference-config", INFER_CFG, "--dataset-dir",
         root, "--test-dataset", "bdd_val", "--random-seed", str(seed)])
    args.run_pdq = True
    per_call = flagship_launches(merge_configs(TRAIN_CFG, INFER_CFG))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kdropout.LAUNCHES = 0
    t = time.perf_counter()
    summary = apply_net_main(args, batch_size="auto")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = kdropout.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    auto = summary["auto_batch"]
    chosen, budget = auto["batch"], auto["budget"]
    # The guard's predictor calls (batches 1 and 2, then each candidate run
    # to check its prediction) and the batches of the run itself.
    guard_calls = 2 + sum(1 for b in auto["measured"] if b not in (1, 2))
    batches = -(-AUTO_IMAGES // chosen)
    if launches != per_call * (guard_calls + batches):
        raise AssertionError(f"{launches} dropout launches, expected {per_call} x "
                             f"({guard_calls} guard calls + {batches} batches)")
    if not auto["measured"][chosen] <= budget:
        raise AssertionError(f"chosen batch {chosen} measured {auto['measured'][chosen]} bytes "
                             f"over the {budget} budget")
    for b in BATCH_CANDIDATES:
        if b == chosen:
            break
        if not max(auto["predicted"][b], auto["measured"].get(b, 0)) > budget:
            raise AssertionError(f"batch {b} fits the budget but {chosen} was chosen")
    pdq = summary["pdq"]
    if not (0.0 <= pdq["pdq"] <= 1.0 and all(math.isfinite(v) for v in pdq.values())):
        raise AssertionError(f"PDQ {pdq}")
    json_path = os.path.join(summary["inference_output_dir"], "coco_instances_results.json")
    with open(json_path) as f:
        records = json.load(f)
    with open(os.path.join(root, "labels", "val_coco_format.json")) as f:
        ids = {im["id"] for im in json.load(f)["images"]}
    if {r["image_id"] for r in records} != ids or summary["num_images"] != AUTO_IMAGES:
        raise AssertionError("an image has no entry in the auto run's json")
    check_metrics("auto json", summary, finite_only=False)
    gib = lambda v: f"{v / 2 ** 30:.3f} GiB"
    log(f"rest auto batch: probes {', '.join(f'batch {b} {gib(v)}' for b, v in auto['probes'].items())}"
        f", {gib(auto['slope'])} per image; budget {gib(budget)} "
        f"({BUDGET_FRACTION} of the card's {gib(torch.cuda.mem_get_info()[1])}); predicted "
        + ", ".join(f"{b}: {gib(v)}" for b, v in auto["predicted"].items())
        + "; measured " + ", ".join(f"{b}: {gib(v)}" for b, v in auto["measured"].items())
        + f"; chosen batch {chosen}, its measured peak {gib(auto['measured'][chosen])} ({card})")
    log(f"rest auto apply_net: main {main_s:.2f} s, {summary['num_images']} images at batch "
        f"{chosen}, {summary['num_detections']} detections, loader-fed "
        f"{summary['images_per_second']:.2f} img/s, evaluation {summary['evaluation_seconds']:.2f} "
        f"s, {launches} dropout launches ({per_call} x ({guard_calls} + {batches})), peak memory "
        f"{gib(peak)} ({card})")
    log(f"rest PDQ: {pdq['pdq']:.6f} (avg pPDQ {pdq['avg_ppdq']:.4f}, spatial "
        f"{pdq['avg_spatial_quality']:.4f}, label {pdq['avg_label_quality']:.4f}, TP/FP/FN "
        f"{pdq['tp']}/{pdq['fp']}/{pdq['fn']}) in {summary['pdq_seconds']:.2f} s ({card})")
    return launches, json_path


def check_quantized_conv(seed: int, card: str, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Phase 10: ``quantized_conv3x3`` at the P3 tower shape on the card
    against the CPU on the same inputs (signed, as conv 0 sees the FPN
    features, and unsigned, as the later convs see ReLU outputs): int32 sums
    equal, outputs within 1e-6 of scale; then its time and the int8
    product's against the bf16 conv's at that shape."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(P3_SHAPE, generator=gen) * 2.0).contiguous(memory_format=torch.channels_last)
    card_tensor = lambda t: t.to(DEVICE)
    w, b = weight.float().cpu(), bias.float().cpu()
    for signed in (True, False):
        xin = x if signed else torch.relu(x)
        x8, _ = pquant.quantize_act_per_image(xin, signed)
        w8, _ = pquant.quantize_weight_per_channel(w)
        sums_cpu = pquant.int8_conv3x3(x8, w8)
        sums_gpu = pquant.int8_conv3x3(card_tensor(x8), card_tensor(w8)).cpu()
        if not torch.equal(sums_cpu, sums_gpu):
            raise AssertionError(f"int32 sums differ between GPU and CPU (signed={signed})")
        ref = pquant.quantized_conv3x3(xin, w, b, act_signed=signed)
        out = pquant.quantized_conv3x3(card_tensor(xin), card_tensor(w), card_tensor(b),
                                       act_signed=signed).cpu()
        err = float((out - ref).abs().max() / ref.abs().max())
        if err > 1e-6:
            raise AssertionError(f"quantized conv GPU vs CPU {err} of scale (signed={signed})")
    xg, wg, bg = card_tensor(x), card_tensor(w), card_tensor(b)
    x8, _ = pquant.quantize_act_per_image(xg, True)
    w8, _ = pquant.quantize_weight_per_channel(wg)
    c = P3_SHAPE[1]
    rows = P3_SHAPE[0] * P3_SHAPE[2] * P3_SHAPE[3]
    cols = torch.randint(-127, 128, (rows, 9 * c), dtype=torch.int8, device=DEVICE)
    w_mat = w8.permute(0, 2, 3, 1).reshape(c, 9 * c)
    xb, wb, bb = xg.bfloat16(), wg.bfloat16(), bg.bfloat16()
    times = dict(
        int8_conv_ms=event_ms(lambda: pquant.quantized_conv3x3(xg, wg, bg), 20),
        int8_product_ms=event_ms(lambda: torch._int_mm(cols, w_mat.t()), 20),
        bf16_conv_ms=event_ms(lambda: torch.nn.functional.conv2d(xb, wb, bb, padding=1), 20),
    )
    ops = 2.0 * rows * 9 * c * c
    log(f"rest quantized conv at {P3_SHAPE}: int32 sums GPU == CPU, outputs within 1e-6 of "
        f"scale (signed and unsigned); whole int8 conv (quantize, im2col, product, dequantize) "
        f"{times['int8_conv_ms']:.4f} ms, the int8 product alone ({rows}x{9 * c}x{c}) "
        f"{times['int8_product_ms']:.4f} ms (its operations over 1979 TOP/s: "
        f"{ops / 1979e12 * 1e3:.4f} ms), the bf16 conv {times['bf16_conv_ms']:.4f} ms "
        f"({ops / 989e12 * 1e3:.4f} ms over 989 TFLOP/s) ({card})")


def run_int8(seed: int, card: str) -> int:
    """Phase 10, part 2: the flagship with HEAD_QUANT int8 at full width."""
    cfg = merge_configs(TRAIN_CFG, INFER_CFG)
    cfg8 = merge_configs(TRAIN_CFG, INFER_CFG, INT8)
    images = torch.from_numpy(canvases(seed, CANVAS, BATCH))
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    tempered = temper_head(sd, cfg, images[:1], DEVICE)
    images = images.to(DEVICE)
    per_call = flagship_launches(cfg8)
    levels = len(cfg8.MODEL.RETINANET.IN_FEATURES)
    dtypes = []
    real_dropout = pretinanet.dropout_levels

    def watched(xs, *args, **kwargs):
        dtypes.extend(x.dtype for x in xs)
        return real_dropout(xs, *args, **kwargs)

    predictor = build_predictor(cfg8, CANVAS, tempered, device=DEVICE)
    call = lambda p, s: p(images, IMAGE_SIZES, IMAGE_SIZES,
                          generator=torch.Generator().manual_seed(s))
    pretinanet.dropout_levels = watched
    try:
        torch.cuda.synchronize()
        kdropout.LAUNCHES = 0
        dets8 = call(predictor, seed)
        torch.cuda.synchronize()
        launches = kdropout.LAUNCHES
    finally:
        pretinanet.dropout_levels = real_dropout
    if launches != per_call or dtypes != [torch.float32] * (per_call * levels):
        raise AssertionError(f"int8 head: {launches} dropout launches on "
                             f"{sorted(set(map(str, dtypes)))}, expected {per_call} float32")
    n_valid, biggest = check_detections(dets8, IMAGE_SIZES, min_cluster=2)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call(predictor, seed + 1 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    head_ms = {}
    bf16 = build_predictor(cfg, CANVAS, tempered, device=DEVICE)
    for name, p in (("int8", predictor), ("bf16", bf16)):
        gen = torch.Generator().manual_seed(seed)
        p.head_outputs(images, gen)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            p.head_outputs(images, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        head_ms[name] = (time.perf_counter() - t) * 1e3 / 3
    # The same canvases and generator, so the same dropout masks: int8
    # detections against the bf16 head's, matched by class and IoU > 0.99.
    dets_bf16 = call(bf16, seed)
    pairs, flips = match_detections(dets8, dets_bf16)
    share = len(pairs) / max(int(dets_bf16.valid.sum()), 1)
    check_quantized_conv(seed, card, tempered["head.cls_subnet.0.weight"],
                         tempered["head.cls_subnet.0.bias"])
    del predictor, bf16
    torch.cuda.empty_cache()

    reference = int8_against_cpu(seed)
    ms = float(np.median(times[1:]))
    log(f"rest int8: {launches} dropout launches, all float32 (expected {per_call}), {n_valid} "
        f"valid detections, largest cluster {biggest}; {ms:.2f} ms/batch median of 5 after one "
        f"{[round(t, 2) for t in times]}, head {head_ms['int8']:.2f} ms (bf16 head "
        f"{head_ms['bf16']:.2f} ms), peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    log(f"rest int8 against the bf16 head on the same canvases and masks: {len(pairs)} of "
        f"{int(dets_bf16.valid.sum())} bf16 detections matched ({100 * share:.1f}%), {flips} "
        f"unmatched on either side ({card})")
    log(f"rest int8 reference (GPU vs CPU, 128x128 float32, max relative error): {reference} "
        f"({card})")
    return launches


def int8_against_cpu(seed: int) -> str:
    """The int8 predictor on the card against the CPU at 128x128 in float32,
    M = 3, same weights and generator. The two backbones round differently
    (cuDNN's and oneDNN's convolutions), and an FPN value within rounding of
    a quantization step takes another int8 code on each side (a flip), which
    moves the tower's outputs and through BayesOD's clusters whole
    detections: those flips are counted and bounded (at most 1e-3 of the
    first tower conv's codes), and the CPU's head then runs on the card's
    FPN features, as the training check pins the card's ReLU gates. From
    there the towers are equal bit for bit (int32 sums, dequantization, the
    dropout kernel), and the detections are held as phase 9 holds them."""
    opts = ("PARALLEL.COMPUTE_DTYPE", "float32", "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 3)
    size = (128, 128)
    images = torch.from_numpy(canvases(seed + 1, size, BATCH))
    sizes = np.array([size] * BATCH, np.float32)
    flagship = mode_config(INFER_CFG, opts)
    sd = temper_head(convert.from_jax_params(random_jax_params(seed + 1, NUM_CLASSES)),
                     flagship, images[:1], "cpu")
    cfg = mode_config(INFER_CFG, opts + tuple(INT8))
    card, host = (build_predictor(cfg, size, sd, device=d) for d in (DEVICE, "cpu"))
    with torch.no_grad():
        card_feats = [f.cpu() for f in card.model.backbone_features(images.to(DEVICE))]
        host_feats = host.model.backbone_features(images)
    flips = total = 0
    for a, b in zip(card_feats, host_feats):
        codes_a = pquant.quantize_act_per_image(a, True)[0]
        codes_b = pquant.quantize_act_per_image(b, True)[0]
        flips += int((codes_a != codes_b).sum())
        total += codes_a.numel()
    if flips > MAX_CODE_FLIPS * total:
        raise AssertionError(f"int8: {flips} of {total} first-conv codes differ between GPU and CPU")
    host.model.backbone_features = lambda _: card_feats
    dets = {}
    for name, p in (("card", card), ("host", host)):
        out = p(images, sizes, sizes, generator=torch.Generator().manual_seed(seed))
        dets[name] = type(out)(*[None if f is None else f.cpu() for f in out])
    return (f"{flips} of {total} first-conv codes flipped between the two backbones; on the "
            f"card's FPN features " + held_against_cpu("int8", dets["card"], dets["host"]))


def energy_terms(model, cfg, batch, anchors, seeds, num_samples) -> list:
    """The energy score (before normalisation) of one batch's outputs, one
    value per seed of its device generator."""
    lc = LossConfig.from_config(cfg)
    with torch.no_grad():
        outputs = model(batch["images"])
        labels = label_anchors_batch(anchors, batch["gt_boxes"], batch["gt_classes"],
                                     batch["gt_valid"], lc.num_classes, lc.iou_thresholds)
        pos = (labels.gt_classes >= 0) & (labels.gt_classes != lc.num_classes)
        gt = encode_deltas(anchors[None], labels.matched_boxes, lc.box_reg_weights)
        gt = torch.where(pos[..., None], gt, torch.zeros((), device=gt.device))
        return [float(plosses.energy_score_box_loss(
            outputs["box_delta"], gt, outputs["box_reg_var"], pos, num_samples,
            lc.smooth_l1_beta,
            generator=torch.Generator(device=DEVICE).manual_seed(box_seed(s))))
            for s in seeds]


def run_energy_train(seed: int, card: str, work: str) -> int:
    """Phase 10, part 3: the energy config's Trainer at batch 4 on 736x1280.
    Returns its focal launches."""
    cfg = merge_configs(ENERGY_CFG, "", [
        "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
        "OUTPUT_DIR", os.path.join(work, "energy"), "SEED", seed,
        "MODEL.WEIGHTS", backbone_pth(seed, os.path.join(work, "r50_energy.pth"))])
    if cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME != "energy_loss":
        raise AssertionError("the energy config does not train the energy score")
    loader = RandomBatches(CANVAS, TRAIN_BATCH, NUM_CLASSES, cfg.INPUT.MAX_GT_BOXES, seed=seed)
    trainer = Trainer(cfg, loader, device=DEVICE)
    trainer.resume_or_load(resume=False)
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    trainer.train(max_iter=ENERGY_STEPS, log_period=ENERGY_STEPS)
    torch.cuda.synchronize()
    launches = {"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES}
    if launches != {"dropout": 0, "focal": ENERGY_STEPS}:
        raise AssertionError(f"energy config: launches {launches} in {ENERGY_STEPS} steps")
    latest = trainer.storage.latest()
    if not all(math.isfinite(latest[k]) for k in ("loss_cls", "loss_box_reg", "total_loss")):
        raise AssertionError(f"energy config: non-finite losses {latest}")
    data = loader.iter_from(trainer.state.step)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ENERGY_STEPS + 1):
        batch = batch_to_device(next(data), trainer.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
        if not math.isfinite(float(metrics["total_loss"])):
            raise AssertionError("energy config: non-finite loss in the timed steps")
    peak = torch.cuda.max_memory_allocated()

    # The energy term by law: 1000-sample values over 8 seeds against one
    # 20,000-sample estimate on the same batch.
    model = trainer.state.model
    values = energy_terms(model, cfg, batch, trainer.train_step.anchors,
                          range(ENERGY_SEEDS), cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NUM_SAMPLES)
    reference = energy_terms(model, cfg, batch, trainer.train_step.anchors, [ENERGY_SEEDS],
                             ENERGY_REFERENCE_SAMPLES)[0]
    se = float(np.std(values, ddof=1))
    worst = max(abs(v - reference) for v in values)
    if not (se > 0 and worst <= 4 * se):
        raise AssertionError(f"energy term: 1000-sample values {values} vs 20,000-sample "
                             f"{reference}, standard error {se}")
    ms = float(np.median(times))
    log(f"rest energy config: {ENERGY_STEPS} steps through Trainer.train, {launches['focal']} focal "
        f"and {launches['dropout']} dropout launches, losses "
        + ", ".join(f"{k} {latest[k]:.4g}" for k in ("loss_cls", "loss_box_reg", "total_loss"))
        + f"; {ms:.2f} ms/step median of {[round(t, 2) for t in times]} at batch {TRAIN_BATCH} on "
        f"{CANVAS[0]}x{CANVAS[1]}, peak memory {peak / 2 ** 30:.3f} GiB ({card})")
    log(f"rest energy term: 1000 samples over {ENERGY_SEEDS} seeds {np.mean(values):.6f} (standard "
        f"error of one {se:.6f}, farthest {worst / se:.2f} of it) against {ENERGY_REFERENCE_SAMPLES} "
        f"samples {reference:.6f} ({card})")
    trainer.close()
    return launches["focal"]


def run_remat(seed: int, card: str, work: str):
    """Phase 10, part 4: one flagship train step from the same state, seeds
    and batch without and with PARALLEL.REMAT: losses equal, every gradient
    within 1e-5 of its tensor's scale, REMAT's peak lower. Returns the
    kernels' launches of each step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for remat in (False, True):
            cfg = train_cfg(seed, os.path.join(work, f"remat_{remat}"),
                            ["PARALLEL.REMAT", remat])
            state = create_train_state(cfg, DEVICE, seed=seed)
            state.step = 1000
            anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(CANVAS),
                                      device=DEVICE)
            step = make_train_step(cfg, anchors)
            batch = batch_to_device(
                RandomBatches(CANVAS, TRAIN_BATCH, NUM_CLASSES, 100, seed=seed).batch(0), DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kdropout.LAUNCHES = kfocal.LAUNCHES = 0
            metrics = step(state, batch)
            torch.cuda.synchronize()
            runs[remat] = dict(
                peak=torch.cuda.max_memory_allocated(),
                launches={"dropout": kdropout.LAUNCHES, "focal": kfocal.LAUNCHES},
                metrics={k: v.clone() for k, v in metrics.items()},
                grads={n: p.grad.clone() for n, p in state.model.named_parameters()
                       if p.grad is not None})
            del state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, remat = runs[False], runs[True]
    per_pass = k1_per_pass(cfg)
    if plain["launches"] != {"dropout": 2 * per_pass, "focal": 1} or \
            remat["launches"] != {"dropout": 3 * per_pass, "focal": 1}:
        raise AssertionError(f"launches: without REMAT {plain['launches']}, with "
                             f"{remat['launches']}")
    for k in ("loss_cls", "loss_box_reg", "total_loss"):
        if not torch.equal(plain["metrics"][k], remat["metrics"][k]):
            raise AssertionError(f"REMAT changed {k}: {plain['metrics'][k]} vs "
                                 f"{remat['metrics'][k]}")
    worst = 0.0
    if plain["grads"].keys() != remat["grads"].keys():
        raise AssertionError("REMAT changed the set of gradients")
    for n, g in plain["grads"].items():
        err = float((g - remat["grads"][n]).abs().max() / g.abs().max().clamp_min(1e-30))
        worst = max(worst, err)
        if err > 1e-5:
            raise AssertionError(f"REMAT gradient {n} off by {err} of its scale")
    if not remat["peak"] < plain["peak"]:
        raise AssertionError(f"REMAT peak {remat['peak']} not below {plain['peak']}")
    log(f"rest REMAT: one flagship step at batch {TRAIN_BATCH} on {CANVAS[0]}x{CANVAS[1]}, losses "
        f"equal, {len(plain['grads'])} gradients within {worst:.2e} of their scale; dropout "
        f"launches {plain['launches']['dropout']} without, {remat['launches']['dropout']} with "
        f"(the recomputed forward); peak memory {plain['peak'] / 2 ** 30:.3f} GiB without, "
        f"{remat['peak'] / 2 ** 30:.3f} GiB with ({card})")
    return plain["launches"], remat["launches"]


def run_visualize(card: str, work: str, json_path: str) -> None:
    """Phase 10, part 5: visualize_predictions on 4 images of the auto run's
    json: a PNG each, differing from its source image."""
    out = os.path.join(work, "viz")
    t = time.perf_counter()
    visualize_dataset("bdd_val", out, json_path, max_images=REST_VIZ_IMAGES)
    seconds = time.perf_counter() - t
    records = {r["image_id"]: r for r in get_dataset("bdd_val").load()}
    names = sorted(os.listdir(out))
    if len(names) != REST_VIZ_IMAGES:
        raise AssertionError(f"visualize_predictions wrote {names}")
    for name in names:
        drawn = cv2.imread(os.path.join(out, name))
        source = load_image_bgr(records[int(os.path.splitext(name)[0])]["file_name"])
        if drawn is None or drawn.shape != source.shape or not (drawn != source).any():
            raise AssertionError(f"{name} is not a drawing over its image")
    log(f"rest visualize_predictions: {len(names)} PNGs in {seconds:.2f} s, each differing from "
        f"its image ({card})")


def run_rest(seed: int, card: str, work: str) -> dict:
    """Phase 10. Returns the kernels' launches on each of its paths."""
    auto_launches, json_path = run_auto_apply_net(seed, card, work)
    run_visualize(card, work, json_path)
    int8_launches = run_int8(seed, card)
    energy_launches = run_energy_train(seed, card, work)
    plain, remat = run_remat(seed, card, work)
    return {"dropout": {"auto_apply_net": auto_launches, "int8_batch": int8_launches,
                        "train_step": plain["dropout"], "remat_train_step": remat["dropout"]},
            "focal": {"energy": energy_launches, "remat_train_step": remat["focal"]}}


# ------------------------------------------------------------ parallel phase
PARALLEL_IMAGES = 8  # of phase 7's PNGs
PARALLEL_STEPS = 3
PARALLEL_TIMEOUT_S = 300  # each launch's own limit
MAX_DDP_GRAD_ERROR = 6e-5  # of each gradient's scale: summation order (run_parallel)
MAX_SPLIT_GRAD_ERROR = 1e-5  # the processes against their arithmetic in one process


def results_json(summary) -> list:
    with open(os.path.join(summary["inference_output_dir"], "coco_instances_results.json")) as f:
        return json.load(f)


def match_json(name: str, got: list, want: list) -> str:
    """Phase 9's rule on two results jsons: per image, each of `want`'s
    detections matched to an unmatched one of `got`'s of its class at IoU >
    0.99; at most 1% flips; matched boxes, covariances, scores and class
    probabilities within 1e-3 of their scale. Returns the summary line."""
    def by_image(records):
        out = {}
        for r in records:
            out.setdefault(r["image_id"], []).append(r)
        return out

    def xyxy(records):
        b = torch.tensor([r["bbox"] for r in records], dtype=torch.float64).reshape(-1, 4)
        return torch.cat([b[:, :2], b[:, :2] + b[:, 2:]], dim=1)

    g_all, w_all = by_image(got), by_image(want)
    pairs, flips = [], 0
    for image in set(g_all) | set(w_all):
        g, w = g_all.get(image, []), w_all.get(image, [])
        iou = pairwise_iou(xyxy(w), xyxy(g)) if g and w else None
        free = set(range(len(g)))
        for i, r in enumerate(w):
            best = max((j for j in free if g[j]["category_id"] == r["category_id"]),
                       key=lambda j: float(iou[i, j]), default=None)
            if best is not None and float(iou[i, best]) > 0.99:
                pairs.append((r, g[best]))
                free.discard(best)
            else:
                flips += 1
        flips += len(free)
    n = len(want)
    if n == 0 or flips > MAX_MODE_FLIPS * n:
        raise AssertionError(f"{name}: {flips} of {n} detections differ")
    errs = {}
    for field in ("bbox", "bbox_covar", "score", "cls_prob"):
        a = np.array([p[1][field] for p in pairs], np.float64).reshape(len(pairs), -1)
        r = np.array([p[0][field] for p in pairs], np.float64).reshape(len(pairs), -1)
        scale = np.maximum(np.abs(r).max(axis=1, keepdims=True), 1e-6)
        errs[field] = float((np.abs(a - r) / scale).max())
        if errs[field] > 1e-3:
            raise AssertionError(f"{name}: {field} differ: {errs[field]}")
    return (f"{name} {len(pairs)}/{n} matched, {flips} flips, "
            + ", ".join(f"{k} {e:.1e}" for k, e in errs.items()))


def parallel_apply_net(argv, data_dir: str, device):
    """One process of a phase-13 apply_net run: ``main`` as the CLI calls it,
    inside the process group ``launch`` set up. Returns rank 0's summary
    with every rank's dropout launches."""
    os.environ["POD_COMPARE_DATA_DIR"] = data_dir
    kdropout.LAUNCHES = 0
    summary = apply_net_main(setup_arg_parser().parse_args(argv), batch_size=BATCH,
                             device=device)
    return dict(summary, launches=gather_process_results([kdropout.LAUNCHES]),
                processes=process_count())


def parallel_train_net(argv, data_dir: str, device):
    """One process of phase 11's train_net run: ``train_net.main`` as the CLI
    calls it, inside the process group ``launch`` set up. Returns rank 0's
    step and latest scalars with every rank's dropout and focal launches."""
    os.environ["POD_COMPARE_DATA_DIR"] = data_dir
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    trainer = train_net.main(setup_arg_parser().parse_args(argv), device=device)
    return {"step": trainer.state.step, "latest": trainer.storage.latest(),
            "canvas": trainer.canvas, "processes": process_count(),
            "launches": gather_process_results([(kdropout.LAUNCHES, kfocal.LAUNCHES)])}


def train_net_output(data_dir: str, seed: int) -> str:
    return os.path.join(data_dir, "BDD-Detection", "retinanet",
                        os.path.splitext(os.path.basename(TRAIN_CFG))[0], f"random_seed_{seed}")


def metrics_rows(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def pack_bits(mask: torch.Tensor):
    """A bool tensor's bits in row-major order, packed on the host, and its
    element count."""
    return np.packbits(mask.cpu().numpy(), axis=None), mask.numel()


class RecordingDropout(KernelDropout):
    """The kernel's dropout recording its output's gates (positive or not)
    in `GATES`, keyed by (tower, layer, level), bit-packed on the host: the
    ReLU gates through which the backward passes gradient."""

    GATES = {}

    def __call__(self, xs, tower, layer):
        outs = super().__call__(xs, tower, layer)
        for level, out in enumerate(outs):
            RecordingDropout.GATES[tower, layer, level] = pack_bits(out > 0)
        return outs


@contextlib.contextmanager
def recorded_gates():
    """Every KernelDropout that ``forward_train`` builds records its gates,
    and the stochastic focal loss the gate of its log-variance clamp
    (-10 < s < 10, the other threshold a rounding can cross), under the key
    "clamp"."""
    saved = pretinanet.KernelDropout, plosses.stochastic_focal_loss
    gates = RecordingDropout.GATES

    def focal_loss(logits, log_vars, *args, **kwargs):
        inside = (log_vars > -kfocal.LOG_VAR_CLAMP) & (log_vars < kfocal.LOG_VAR_CLAMP)
        gates["clamp"] = pack_bits(inside)
        return saved[1](logits, log_vars, *args, **kwargs)

    pretinanet.KernelDropout, plosses.stochastic_focal_loss = RecordingDropout, focal_loss
    try:
        yield gates
    finally:
        pretinanet.KernelDropout, plosses.stochastic_focal_loss = saved


def state_bytes(state) -> bytes:
    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    return buf.getvalue()


def weights_digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def losses_in_parts(step, state, whole, seeds, loss_seed: int, count: int):
    """``TrainStep.losses`` over the batch `whole` with the arithmetic of
    `count` processes, in one process: the rows of each process through
    ``forward_train`` with its shard, each part's loss over the whole
    batch's positive count (as the all-reduce gives it), the backward of
    every part but the last taken here and the last's left to the caller.
    So each gradient is the sum of the parts' gradients, taken in turn, as
    a data-parallel step (``TrainStep.data_parallel``) sums them."""
    lc = step.lc
    classes = label_anchors_batch(step.anchors, whole["gt_boxes"], whole["gt_classes"],
                                  whole["gt_valid"], lc.num_classes,
                                  lc.iou_thresholds).gt_classes
    num_pos = ((classes >= 0) & (classes != lc.num_classes)).sum().to(torch.float32)
    saved = ptrain_loss.all_reduce_sum
    ptrain_loss.all_reduce_sum = lambda t: num_pos.to(t.device)
    parts = []
    try:
        for r in range(count):
            shard = BatchShard.of(whole["images"].shape[0], r, count)
            part = {k: v[shard.first:shard.first + shard.size] for k, v in whole.items()}
            outputs = state.model.forward_train(part["images"], seeds, step.shared_masks, shard)
            losses, norm = ptrain_loss.compute_losses(
                outputs, step.anchors, part["gt_boxes"], part["gt_classes"], part["gt_valid"],
                state.loss_normalizer, state.step, lc, loss_seed, shard)
            if r < count - 1:
                (losses["loss_cls"] + losses["loss_box_reg"]).backward()
                losses = {k: v.detach() for k, v in losses.items()}
            parts.append(losses)
    finally:
        ptrain_loss.all_reduce_sum = saved
    losses = {k: sum(p[k] for p in parts) for k in ("loss_cls", "loss_box_reg")}
    losses["num_pos_anchors"] = parts[-1]["num_pos_anchors"]
    return losses["loss_cls"] + losses["loss_box_reg"], losses, norm


def split_step_gradients(step, state, whole, seeds, loss_seed: int, count: int) -> None:
    """Leave in `state`'s model the gradients of one step's loss over
    `whole` with `count` processes' arithmetic (``losses_in_parts``)."""
    losses_in_parts(step, state, whole, seeds, loss_seed, count)[0].backward()


@contextlib.contextmanager
def steps_in_parts(count: int):
    """Every ``TrainStep`` of the trainer takes its losses in `count` parts
    (``losses_in_parts``): a one-process run with `count` processes'
    arithmetic."""
    saved = trainer_module.TrainStep.losses
    trainer_module.TrainStep.losses = (
        lambda self, state, batch, seeds, loss_seed, tower_dropout=None:
        losses_in_parts(self, state, batch, seeds, loss_seed, count))
    try:
        yield
    finally:
        trainer_module.TrainStep.losses = saved


def scaled_errors(got: dict, want: dict) -> dict:
    """Each tensor's largest difference over its scale (the largest
    magnitude of `want`'s)."""
    return {n: float((got[n].to(g) - g).abs().max()) / (float(g.abs().max()) or 1.0)
            for n, g in want.items()}


def parallel_train(seed: int, steps: int, canvas, out_dir: str, device):
    """One process of phase 11's data-parallel training: the flagship
    training config with the focal kernel in float32 at full width, a
    global batch of 4, this process's rows through DistributedDataParallel
    (``TrainStep.data_parallel``). Before each step rank 0 keeps the state;
    after it, it takes the one-process step over the whole batch from that
    state and compares losses, gradients, weights and ReLU gates. Returns,
    per step, what rank 0 measured and every rank's digest and launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = local_device(device)
    cfg = train_cfg(seed, out_dir, ["PARALLEL.COMPUTE_DTYPE", "float32"])
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(canvas), device=device)
    batches = RandomBatches(canvas, TRAIN_BATCH, cfg.MODEL.RETINANET.NUM_CLASSES,
                            cfg.INPUT.MAX_GT_BOXES, seed=seed)
    # The backbone warm-started as phase 5's, the head at its training init.
    weights = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    state = create_train_state(cfg, device, seed=seed)
    state.model.load_state_dict({k: v for k, v in weights.items() if k.startswith("backbone.")},
                                strict=False)
    step = make_train_step(cfg, anchors)
    step.data_parallel(state.model)
    shard = BatchShard.of(TRAIN_BATCH)
    rows = slice(shard.first, shard.first + shard.size)
    main_rank = process_index() == 0
    records = []
    with recorded_gates() as gates:
        for k in range(steps):
            whole = batch_to_device(batches.batch(k), device)
            local = {key: v[rows] for key, v in whole.items()}
            before = state_bytes(state) if main_rank else None
            gates.clear()
            kdropout.LAUNCHES = kfocal.LAUNCHES = 0
            sync(device)
            barrier()  # both ranks start the timed step together
            t0 = time.perf_counter()
            metrics = step.global_metrics(step(state, local))
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            launches = (kdropout.LAUNCHES, kfocal.LAUNCHES)
            grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
            mine = dict(gates)
            record = {
                "ms": gather_process_results([ms]),
                "launches": gather_process_results([launches]),
                "digests": gather_process_results([weights_digest(state.model)]),
                "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                "losses": {key: float(v) for key, v in metrics.items()},
            }
            rank_gates = gather_process_results([mine])
            if main_rank:
                ref = create_train_state(cfg, device, seed=seed)
                ref.load_state_dict(torch.load(io.BytesIO(before), weights_only=True))
                gates.clear()
                sync(device)
                t0 = time.perf_counter()
                ref_metrics = make_train_step(cfg, anchors)(ref, whole)
                sync(device)
                record["one_process_ms"] = (time.perf_counter() - t0) * 1e3
                record["one_process_losses"] = {key: float(v) for key, v in ref_metrics.items()}
                ref_gates = dict(gates)
                # The same state once more, the batch's halves backward in
                # turn: the processes' summation order in one process.
                halves = create_train_state(cfg, device, seed=seed)
                halves.load_state_dict(torch.load(io.BytesIO(before), weights_only=True))
                half_step = make_train_step(cfg, anchors)
                split_step_gradients(half_step, halves, whole,
                                     *half_step.draw_seeds(halves.generator), count=2)
                split = {n: p.grad for n, p in halves.model.named_parameters()
                         if p.grad is not None}
                record["split_error"] = max(scaled_errors(grads, split).items(),
                                            key=lambda kv: kv[1])
                record["split_against_one_process"] = max(
                    scaled_errors(split, {n: p.grad for n, p in ref.model.named_parameters()
                                            if p.grad is not None}).items(),
                    key=lambda kv: kv[1])
                del halves, split
                # A gate tensor in row-major order: rank r's rows are the
                # r-th run of the one-process step's bits.
                flips = {"relu": [0, 0], "clamp": [0, 0]}
                for key, (packed, n) in ref_gates.items():
                    ref_bits = np.unpackbits(packed, count=n)
                    count = flips["clamp" if key == "clamp" else "relu"]
                    for r, theirs in enumerate(rank_gates):
                        part = np.unpackbits(theirs[key][0], count=theirs[key][1])
                        want = ref_bits[r * len(part):(r + 1) * len(part)]
                        count[0] += int((part != want).sum())
                        count[1] += len(part)
                record["gate_flips"] = flips
                errors = {}
                for n, p in ref.model.named_parameters():
                    scale = float(p.detach().abs().max()) or 1.0
                    errors[n] = float((p.detach() - state.model.get_parameter(n).detach())
                                      .abs().max()) / scale
                record["weight_error"] = max(errors.items(), key=lambda kv: kv[1])
                record["grad_error"] = max(scaled_errors(grads, {
                    n: p.grad for n, p in ref.model.named_parameters() if p.grad is not None
                }).items(), key=lambda kv: kv[1])
                del ref
            records.append(record)
    return records


def run_parallel(seed: int, card: str, work: str, members, device=None, canvas=CANVAS,
                 opts=()) -> dict:
    """Phase 11. Returns the dropout and focal launches of its paths. A
    rehearsal on the CPU passes device 'cpu', a small canvas for the train
    steps and config overrides for apply_net."""
    data = os.path.join(work, "data")  # phase 7's checkpoint
    os.environ["POD_COMPARE_DATA_DIR"] = data
    root = bdd_subset(work, "bdd_parallel", PARALLEL_IMAGES)
    base = ["--config-file", TRAIN_CFG, "--dataset-dir", root, "--test-dataset", "bdd_val",
            "--random-seed", str(seed)]
    tail = list(opts)
    flagship = base + ["--inference-config", INFER_CFG]
    nms = base + ["--inference-config", "Inference/standard_nms.yaml"]
    ranks = lambda argv, n: argv + ["--num-devices", str(n)] + tail
    on_card = device is None or str(device).startswith("cuda")
    shared = device if device is not None else "cuda:0"
    launches = {}

    # 1. The flagship through launch on one process: NCCL on the card.
    t0 = time.perf_counter()
    one_rank = launch(parallel_apply_net, 1, (ranks(flagship, 1), data, device),
                      device=device, timeout_s=PARALLEL_TIMEOUT_S)
    one_rank_s = time.perf_counter() - t0
    one_rank_json = results_json(one_rank)
    plain = apply_net_main(setup_arg_parser().parse_args(ranks(flagship, 1)),
                           batch_size=BATCH, device=device)
    line = match_json("flagship, 1 rank against no process group", one_rank_json,
                      results_json(plain))
    launches["apply_net_1_rank"] = one_rank["launches"]
    log(f"parallel apply_net: {line}; launch of 1 rank ({'NCCL' if on_card else 'gloo'}) "
        f"{one_rank_s:.2f} s, {one_rank['num_images']} images, dropout launches "
        f"{one_rank['launches']} ({card})")

    # 2. Two ranks on one card: gloo, since NCCL refuses two ranks on a device.
    t0 = time.perf_counter()
    two = {name: launch(parallel_apply_net, 2, (ranks(argv, 2), data, None),
                        device=shared, backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
           for name, argv in (("standard_nms", nms), ("flagship", flagship))}
    two_s = time.perf_counter() - t0
    nms_one = apply_net_main(setup_arg_parser().parse_args(ranks(nms, 1)),
                             batch_size=BATCH, device=device)
    lines = [match_json("standard_nms, 2 ranks against 1", results_json(two["standard_nms"]),
                        results_json(nms_one))]
    cfg = setup_config(setup_arg_parser().parse_args(flagship + tail), random_seed=seed,
                       is_testing=True)
    params = load_params(cfg.OUTPUT_DIR)
    merged, parts = results_json(two["flagship"]), []
    for r in range(2):
        loader = TestLoader(get_dataset("bdd_val"), batch_size=BATCH,
                            min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
                            divisibility=cfg.INPUT.SIZE_DIVISIBILITY, process_index=r,
                            process_count=2)
        ids = {rec["image_id"] for rec in loader.records}
        summary = run_inference(cfg, "bdd_val", f"shard_{r}", batch_size=BATCH, params=params,
                                run_metrics=False, run_map=False, verbose=False,
                                loader=loader, device=device)
        loader.close()
        part = [x for x in merged if x["image_id"] in ids]
        lines.append(match_json(f"flagship rank {r}'s part against its shard alone", part,
                                results_json(summary)))
        parts.append(part)
    if merged != parts[0] + parts[1]:
        raise AssertionError("the merged json is not rank 0's part, then rank 1's")
    launches["apply_net_2_ranks"] = two["flagship"]["launches"]
    log(f"parallel apply_net on 2 ranks (gloo, {shared}): " + "; ".join(lines)
        + f"; {two_s:.2f} s for both launches, gather {two['flagship']['gather_seconds']:.4f} s "
        f"(flagship, {two['flagship']['processes']} processes), "
        f"{two['flagship']['num_images']} images in all, dropout launches per rank "
        f"{two['flagship']['launches']} ({card})")

    # 3. --num-devices: more cards than the machine has is refused.
    if on_card:
        try:
            apply_net_main(setup_arg_parser().parse_args(
                flagship + ["--num-devices", str(torch.cuda.device_count() + 1)]))
        except ValueError as e:
            if "torch.cuda.device_count()" not in str(e):
                raise
            log(f"parallel --num-devices {torch.cuda.device_count() + 1}: refused: {e}")
        else:
            raise AssertionError("--num-devices above the card count ran")

    # 4. Data-parallel training, two ranks sharing the card (gloo over CUDA
    # tensors). train_net's main, as the CLI runs it, on phase 8's JPEGs
    # warm-started from its .pkl, against train_net's main on one process;
    # the launches of the two ranks are the main path's.
    per_step = 2 * k1_per_pass(cfg)
    expected = (per_step, 1) if on_card else (0, 0)  # the CPU's plain versions: none
    train_opts = ["MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
                  "MODEL.WEIGHTS", os.path.join(work, "R-50.pkl"),
                  "PARALLEL.COMPUTE_DTYPE", "float32", "SOLVER.IMS_PER_BATCH", TRAIN_BATCH,
                  "SOLVER.MAX_ITER", PARALLEL_STEPS, "SOLVER.CHECKPOINT_PERIOD", PARALLEL_STEPS,
                  "TEST.EVAL_PERIOD", PARALLEL_STEPS, "MODEL.RETINANET.SCORE_THRESH_TEST", 0.0,
                  "INPUT.MIN_SIZE_TRAIN", f"({EVAL_SIZE[0]},)", *tail]
    train_argv = lambda n: ["--config-file", TRAIN_CFG, "--dataset-dir",
                            os.path.join(work, "bdd_jpeg"), "--random-seed", str(seed),
                            "--num-devices", str(n), *map(str, train_opts)]
    dirs = {n: os.path.join(work, f"parallel_train_net_{n}")
            for n in (1, 2, "halves", "again")}
    t0 = time.perf_counter()
    two_net = launch(parallel_train_net, 2, (train_argv(2), dirs[2], device), device=shared,
                     backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
    two_net_s = time.perf_counter() - t0
    os.environ["POD_COMPARE_DATA_DIR"] = dirs[1]
    kdropout.LAUNCHES = kfocal.LAUNCHES = 0
    t0 = time.perf_counter()
    one_net = train_net.main(setup_arg_parser().parse_args(train_argv(1)), device=device)
    sync(device or "cuda")
    one_net_s = time.perf_counter() - t0
    one_launches = (kdropout.LAUNCHES, kfocal.LAUNCHES)
    # Twice more on one process, each step's backward over the ranks' rows
    # in turn: the two ranks' arithmetic, and that arithmetic run again.
    for name in ("halves", "again"):
        os.environ["POD_COMPARE_DATA_DIR"] = dirs[name]
        with steps_in_parts(2):
            del one_net
            one_net = train_net.main(setup_arg_parser().parse_args(train_argv(1)),
                                     device=device)
    os.environ["POD_COMPARE_DATA_DIR"] = data
    whole_run = tuple(n * PARALLEL_STEPS for n in expected)
    if any(tuple(n) != whole_run for n in two_net["launches"]) or one_launches != whole_run:
        raise AssertionError(f"train_net launched {two_net['launches']} per rank, "
                             f"{one_launches} on one process; expected {whole_run}")
    if two_net["step"] != PARALLEL_STEPS or tuple(two_net["canvas"]) != tuple(one_net.canvas):
        raise AssertionError(f"train_net on 2 ranks: step {two_net['step']}, canvas "
                             f"{two_net['canvas']} against {one_net.canvas}")
    outs = {n: train_net_output(d, seed) for n, d in dirs.items()}
    rows = {n: metrics_rows(o) for n, o in outs.items()}
    keys = lambda rs: [(r["iteration"], sorted(k for k in r if k != "time")) for r in rs]
    steps = {n: Checkpointer(o).steps() for n, o in outs.items()}
    if any(keys(rs) != keys(rows[1]) for rs in rows.values()) or any(
            st != [PARALLEL_STEPS] for st in steps.values()):
        raise AssertionError(f"train_net wrote rows {keys(rows[2])} and checkpoints {steps[2]} "
                             f"on 2 ranks, {keys(rows[1])} and {steps[1]} on one process")
    loss_keys = ("loss_cls", "loss_box_reg", "total_loss", "num_pos_anchors", "lr")
    logged = {n: next(r for r in rs if "total_loss" in r) for n, rs in rows.items()}
    for key in loss_keys:
        a = logged[2][key]
        for ref in (1, "halves"):
            b = logged[ref][key]
            if not math.isfinite(a) or abs(a - b) > 1e-5 * max(abs(b), 1e-6):
                raise AssertionError(f"train_net step {PARALLEL_STEPS}: {key} {a} on 2 ranks, "
                                     f"{b} on one process ({ref})")
    # The weights after three steps are printed, not held: a zero-initialised
    # bias's gradient is a sum whose terms cancel (in float32 it rounds
    # farther from float64's than the sum itself, tools/torch_ddp_precision
    # .py), so two summation orders, or one order run again, part by up to
    # 1e-3 of that bias's small scale. Each step's weights and gradients are
    # held below, from one state.
    final = {n: Checkpointer(o).restore(PARALLEL_STEPS)["model"] for n, o in outs.items()}
    net_weight = {(a, b): max(scaled_errors(final[a], {
        k: v for k, v in final[b].items() if v.is_floating_point()}).items(),
        key=lambda kv: kv[1]) for a, b in ((2, "halves"), (2, 1), ("again", "halves"))}
    last = {n: rs[-1] for n, rs in rows.items()}  # the evaluation after the last step
    detections = [last[n]["eval/num_detections"] for n in (2, "halves")]
    evals = [results_json({"inference_output_dir": os.path.join(
        outs[n], "inference", "bdd_val", f"eval_iter_{PARALLEL_STEPS}")}) for n in (2, "halves")]
    if detections[0] != len(evals[0]) or detections[1] != len(evals[1]):
        raise AssertionError(f"eval/num_detections {detections}, jsons of {len(evals[0])} and "
                             f"{len(evals[1])}")
    eval_line = (match_json("Trainer.test on 2 ranks against the halves", *evals)
                 if evals[1] else f"Trainer.test: {len(evals[0])} and 0 detections")
    if not evals[1] and evals[0]:
        raise AssertionError(eval_line)
    launches["train_net_2_ranks"] = two_net["launches"]
    log(f"parallel train_net: main on 2 ranks (gloo, {shared}) {two_net_s:.2f} s with the "
        f"processes' start, on one process {one_net_s:.2f} s, {PARALLEL_STEPS} steps at batch "
        f"{TRAIN_BATCH} (float32) on {one_net.canvas[0]}x{one_net.canvas[1]} from JPEGs; launches "
        f"per rank {two_net['launches']}, one process {one_launches}; step {PARALLEL_STEPS} "
        + ", ".join(f"{k} {logged[2][k]:.6g}/{logged[1][k]:.6g}" for k in loss_keys[:4])
        + "; worst weight of scale: " + ", ".join(
            f"{a} against {b} {name} {e:.2e}" for (a, b), (name, e) in net_weight.items())
        + f"; {eval_line}; "
        f"mAP {last[2]['eval/mAP']:.4f}/{last['halves']['eval/mAP']:.4f}/"
        f"{last[1]['eval/mAP']:.4f} (2 ranks/halves/one process) ({card})")
    del one_net
    for d in dirs.values():
        shutil.rmtree(d)

    # Each step from one state: the ranks' step against the one-process step
    # over the whole batch and against its halves backward in turn.
    t0 = time.perf_counter()
    records = launch(parallel_train, 2,
                     (seed, PARALLEL_STEPS, canvas, os.path.join(work, "parallel_train"), None),
                     device=shared, backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    for k, rec in enumerate(records):
        if len(set(rec["digests"])) != 1:
            raise AssertionError(f"step {k}: the ranks' weights differ")
        if any(tuple(n) != expected for n in rec["launches"]):
            raise AssertionError(f"step {k}: launches per rank {rec['launches']}, expected "
                                 f"{expected}")
        if not rec["finite"]:
            raise AssertionError(f"step {k}: a non-finite gradient")
        flips = "; ".join(f"{kind} gate flips {n} of {total}"
                          for kind, (n, total) in rec["gate_flips"].items())
        log(f"parallel train step {k}: ms per rank {[round(m, 2) for m in rec['ms']]}, one "
            f"process {rec['one_process_ms']:.2f} ms (batch {TRAIN_BATCH}, float32, "
            f"{canvas[0]}x{canvas[1]}); losses " + ", ".join(
                f"{key} {rec['losses'][key]:.6g}/{rec['one_process_losses'][key]:.6g}"
                for key in ("loss_cls", "loss_box_reg", "num_pos_anchors"))
            + f"; worst gradient {rec['grad_error'][0]} {rec['grad_error'][1]:.2e}, worst "
            f"weight {rec['weight_error'][0]} {rec['weight_error'][1]:.2e} of scale; against "
            f"the halves in one process: the ranks' worst gradient {rec['split_error'][0]} "
            f"{rec['split_error'][1]:.2e}, the one-process step's "
            f"{rec['split_against_one_process'][0]} {rec['split_against_one_process'][1]:.2e};"
            f" {flips}; launches per rank {rec['launches']} ({card})")
        if any(n > MAX_GATE_FLIPS * total for n, total in rec["gate_flips"].values()):
            raise AssertionError(f"step {k}: {flips}")
        for key in ("loss_cls", "loss_box_reg", "total_loss", "num_pos_anchors"):
            a, b = rec["losses"][key], rec["one_process_losses"][key]
            if abs(a - b) > 1e-5 * max(abs(b), 1e-6):
                raise AssertionError(f"step {k}: {key} {a} against one process's {b}")
        # The weights are held to 1e-5 of their scale. A gradient is held to
        # MAX_SPLIT_GRAD_ERROR against the same sum taken as the processes
        # take it (each half's gradient, then their sum), and to
        # MAX_DDP_GRAD_ERROR, about 3x the largest reading, against the
        # one-process step, which sums over the four images in one call: the
        # log-variance head's gradient (the focal kernel's, whose terms
        # cancel) came 1.85e-5 and 2.06e-5 of its scale apart with no gate
        # differing, the same sum as the halves', and float64 puts one and
        # two processes 3e-15 apart (tools/torch_ddp_precision.py).
        if (rec["weight_error"][1] > 1e-5 or rec["grad_error"][1] > MAX_DDP_GRAD_ERROR
                or rec["split_error"][1] > MAX_SPLIT_GRAD_ERROR):
            raise AssertionError(f"step {k}: weight {rec['weight_error']}, gradient "
                                 f"{rec['grad_error']}, against the halves "
                                 f"{rec['split_error']}")
    log(f"parallel train: {PARALLEL_STEPS} steps on 2 ranks in {train_s:.2f} s ({card})")

    # 5. Five ensemble members placed on the card, against the unplaced predictor.
    ens_cfg = mode_config("Inference/ensembles_pre_nms.yaml")
    images = torch.from_numpy(canvases(seed + 5, canvas, BATCH))
    sizes = np.array([canvas] * BATCH, np.float32)
    placement = create_ensemble_placement(len(members), None if on_card else [device])
    outs = []
    for where in (placement, None):
        predictor = build_predictor(ens_cfg, canvas, device=device or "cuda",
                                    state_dicts=members, placement=where)
        outs.append(predictor(images, sizes, sizes,
                              generator=torch.Generator().manual_seed(seed)))
        del predictor
    if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the placed ensemble differs from the unplaced one")
    log(f"parallel ensembles: {len(members)} members placed on {sorted(set(map(str, placement)))}"
        f", detections bit-identical to the unplaced predictor's ({int(outs[0].valid.sum())} "
        f"detections) ({card})")

    # 6. resize_and_pad on the card against the CPU, BDD at the test size.
    raw = torch.from_numpy(canvases(seed + 6, EVAL_SIZE, BATCH).astype(np.float32))
    args = (EVAL_SIZE, 800, 1333, EVAL_CANVAS)
    got, size = resize_and_pad(raw.to(device or "cuda"), *args)
    want, _ = resize_and_pad(raw, *args)
    err = float((got.cpu() - want).abs().max())
    if size != (750, 1333) or err > 1e-3:
        raise AssertionError(f"resize_and_pad on the card: {size}, max abs {err} against the CPU")
    resize_ms = event_ms(lambda: resize_and_pad(raw.to(device or "cuda"), *args), 10) \
        if on_card else float("nan")
    log(f"parallel resize_and_pad: {tuple(raw.shape)} -> {tuple(got.shape)}, max abs {err:.2e} "
        f"against the CPU (0-255 scale), {resize_ms:.4f} ms with the copy to the card ({card})")
    return launches


EXPORT_TIMED_CALLS = 5
# The post-NMS artifact, cut to 2 MC runs (from the config's 10) and batch 1:
# at batch 2 its 17,507-node program took 57 s to export and 23 s to load.
EXPORT_POST_NMS = ("Inference/mc_dropout_ensembles_post_nms.yaml",
                   ["PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", "2"], 1)
# The flagship with both Monte-Carlo banks mc_iid (S = 10 and 1000), cut to
# 2 MC runs (from 10) and batch 1 so that its program (about half the
# flagship's nodes) fits the smoke's time: 11 normal launches (the class
# bank and 10 box chunks of 100) and 80 dropout launches a served call.
EXPORT_MC_IID = (INFER_CFG, ["PROBABILISTIC_INFERENCE.CLS_SAMPLING", "mc_iid",
                             "PROBABILISTIC_INFERENCE.BOX_SAMPLING", "mc_iid",
                             "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", "2"], 1)
# A fresh process that serves one artifact with the model code unimportable:
# argv is the device, the images (.npy), their (h, w) sizes (json), the
# generator seed, the timed calls, the file for the first call's outputs and
# the artifact. It prints one json line: load seconds, first call ms, its
# dropout and normal launches, the timed calls' ms.
SERVE_SCRIPT = r"""
import importlib.abc, json, statistics, sys, time

BLOCKED = ("pod_compare_tpu_torch.models", "pod_compare_tpu_torch.config",
           "pod_compare_tpu_torch.inference.predictor", "jax", "pod_compare_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import torch
from pod_compare_tpu_torch.inference.export import load_artifact
from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import normal as kn

device, images_path, sizes, seed, calls, out_path, artifact = sys.argv[1:]
images = torch.from_numpy(np.load(images_path)).to(device)
sizes, seed, calls = json.loads(sizes), int(seed), int(calls)
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
t0 = time.perf_counter()
served = load_artifact(artifact)
load_s = time.perf_counter() - t0
call = lambda s: served(images, sizes, sizes, torch.Generator().manual_seed(s))
sync()
kd.LAUNCHES = kn.LAUNCHES = 0
t0 = time.perf_counter()
dets = call(seed)
sync()
first_ms = (time.perf_counter() - t0) * 1e3
launches, normal_launches = kd.LAUNCHES, kn.LAUNCHES
torch.save(tuple(None if f is None else f.cpu() for f in dets), out_path)
times = []
for i in range(calls):
    sync()
    t0 = time.perf_counter()
    call(seed + 1 + i)
    sync()
    times.append((time.perf_counter() - t0) * 1e3)
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print(json.dumps(dict(load_s=load_s, first_ms=first_ms, launches=launches,
                      normal_launches=normal_launches, ms=statistics.median(times),
                      times=times)))
"""


def same_bits(a, b) -> bool:
    """Both None, or tensors of one shape and dtype with the same bytes."""
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def dispatch_us(device) -> dict:
    """Host microseconds per launch of K1 through its operators and through
    its ctypes wrappers: one (1, 256, 8, 8) bf16 tensor, and a group of five
    levels (1, 256, 8, 8) to (1, 256, 1, 1) in one launch, whose kernels take
    a few microseconds: 2000 launches each, in turns (operator, wrapper,
    levels operator, levels wrapper, then back), the median of each."""
    sizes = (8, 4, 2, 1, 1)
    xs = [torch.randn(1, 256, h, h, device=device).to(torch.bfloat16)
          .contiguous(memory_format=torch.channels_last) for h in sizes]
    x = xs[0]
    offsets = level_offsets(xs, True)
    seed = torch.tensor(12345)
    calls = {"operator": lambda: kdropout.dropout_op(x, seed, 0.2, True, 0, True),
             "wrapper": lambda: kdropout.dropout_levels_cuda([x], 12345, 0.2, True, [0], True),
             "levels_operator": lambda: kdropout.dropout_levels_op(xs, seed, 0.2, True, offsets,
                                                                   True),
             "levels_wrapper": lambda: kdropout.dropout_levels_cuda(xs, 12345, 0.2, True, offsets,
                                                                    True)}
    times = {k: [] for k in calls}
    order = list(calls)
    for name in order + order[::-1]:
        calls[name]()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(2000):
            calls[name]()
        sync(device)
        times[name].append((time.perf_counter() - t0) / 2000 * 1e6)
    return {k: float(np.median(v)) for k, v in times.items()}


def run_export(seed: int, card: str, work: str, device="cuda", canvas=CANVAS) -> dict:
    """Phase 12: the serving export. Returns each artifact's record (live
    and served launches, times, graph nodes) and, under "dispatch_us", K1's
    host cost a launch through its operator and through its wrapper. Each
    artifact is written by cli.export_model's main, as a user runs it, and
    served by a fresh process started as soon as it is written (the
    flagship's serves while the post-NMS artifact is exported). A rehearsal
    on the CPU passes device 'cpu' and a small canvas."""
    data = os.path.join(work, "export_data")
    os.environ["POD_COMPARE_DATA_DIR"] = data
    flagship = merge_configs(TRAIN_CFG, INFER_CFG)
    canvas_images = canvases(seed + 14, canvas, BATCH)
    all_sizes = IMAGE_SIZES if canvas == CANVAS else np.array([canvas] * BATCH, np.float32)
    sd = convert.from_jax_params(random_jax_params(seed, NUM_CLASSES))
    tempered = temper_head(sd, flagship, torch.from_numpy(canvas_images[:1]), device)
    out_dir = os.path.join(data, "BDD-Detection", "retinanet",
                           os.path.splitext(os.path.basename(TRAIN_CFG))[0], f"random_seed_{seed}")
    Checkpointer(out_dir).save(0, {"model": {k: v.cpu() for k, v in tempered.items()}})
    repo = os.path.dirname(os.path.abspath(__file__))
    cases = {"flagship": (INFER_CFG, [], BATCH), "post_nms": EXPORT_POST_NMS,
             "mc_iid": EXPORT_MC_IID}
    records, live, serving = {}, {}, {}
    try:
        for name, (infer, opts, batch) in cases.items():
            cfg = merge_configs(TRAIN_CFG, infer, opts)
            runs = int(cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS)
            expected = runs * k1_per_pass(cfg)
            images_path = os.path.join(work, f"export_{name}.npy")
            np.save(images_path, canvas_images[:batch])
            images, sizes = torch.from_numpy(canvas_images[:batch]).to(device), all_sizes[:batch]
            predictor = build_predictor(cfg, canvas, tempered, device=device)
            call = lambda s: predictor(images, sizes, sizes,
                                       generator=torch.Generator().manual_seed(s))
            expected_normal = normal_launches_per_call(predictor, batch)
            sync(device)
            kdropout.LAUNCHES = knormal.LAUNCHES = 0
            dets = call(seed)
            sync(device)
            launches, normal_launches = kdropout.LAUNCHES, knormal.LAUNCHES
            if (launches, normal_launches) != (expected, expected_normal):
                raise AssertionError(f"export {name}: {launches} live dropout and "
                                     f"{normal_launches} normal launches, expected "
                                     f"{expected} and {expected_normal}")
            live[name] = tuple(None if f is None else f.cpu() for f in dets)
            times = []
            for i in range(EXPORT_TIMED_CALLS):
                sync(device)
                t0 = time.perf_counter()
                call(seed + 1 + i)
                sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            del predictor, dets
            # The CLI's main, as a user runs it, from the checkpoint written above.
            args = setup_arg_parser().parse_args(
                ["--config-file", TRAIN_CFG, "--inference-config", infer,
                 "--random-seed", str(seed)] + opts)
            args.device, args.batch_size, args.random_init = device, batch, False
            args.canvas_height, args.canvas_width = canvas
            args.output_dir = os.path.join(work, f"artifact_{name}")
            t0 = time.perf_counter()
            export_model.main(args)
            cli_s = time.perf_counter() - t0
            with open(os.path.join(args.output_dir, "manifest.json")) as f:
                manifest = json.load(f)
            served_path = os.path.join(work, f"served_{name}.pt")
            with open(served_path + ".log", "w") as log_file:
                serving[name] = subprocess.Popen(
                    [sys.executable, "-c", SERVE_SCRIPT, device, images_path,
                     json.dumps(sizes.tolist()), str(seed), str(EXPORT_TIMED_CALLS), served_path,
                     args.output_dir],
                    cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
                    stderr=log_file, text=True)
            records[name] = dict(
                runs=runs, batch=batch, live_launches=launches, expected=expected,
                live_normal_launches=normal_launches, expected_normal=expected_normal,
                live_ms=float(np.median(times)), live_times=times, cli_s=cli_s,
                export_s=manifest["export_seconds"], save_s=manifest["save_seconds"],
                graph_nodes=manifest["graph_nodes"], served_path=served_path,
                bytes=os.path.getsize(os.path.join(args.output_dir, "pipeline.pt2")))
            log(f"export {name}: {runs} runs, batch {batch}, {launches} live dropout and "
                f"{normal_launches} live normal launches, "
                f"live {records[name]['live_ms']:.2f} ms/batch median of "
                f"{[round(t, 2) for t in times]}; cli.export_model {cli_s:.2f} s (torch.export "
                f"{manifest['export_seconds']:.2f} s, {manifest['graph_nodes']} graph nodes; "
                f"torch.export.save {manifest['save_seconds']:.2f} s, "
                f"{records[name]['bytes'] / 2 ** 20:.1f} MiB) ({card})")
        dispatch = dispatch_us(device) if device == "cuda" else None
        for name, proc in serving.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                with open(records[name]["served_path"] + ".log") as f:
                    raise AssertionError(f"serving {name} failed:\n{f.read()[-4000:]}")
            records[name].update({f"served_{k}": v
                                  for k, v in json.loads(out.strip().splitlines()[-1]).items()})
    finally:
        for proc in serving.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, rec in records.items():
        got = torch.load(rec["served_path"])
        fields = [f for f, a in zip(Detections._fields, live[name]) if a is not None]
        differ = [f for f, a, b in zip(Detections._fields, live[name], got)
                  if not same_bits(a, b)]
        if differ:
            raise AssertionError(f"export {name}: served {differ} differ from the live call's")
        if (rec["served_launches"], rec["served_normal_launches"]) != (
                rec["live_launches"], rec["live_normal_launches"]):
            raise AssertionError(f"export {name}: {rec['served_launches']} served dropout and "
                                 f"{rec['served_normal_launches']} normal launches, live "
                                 f"{rec['live_launches']} and {rec['live_normal_launches']}")
        log(f"export {name}: served by a process without the model code: {fields} "
            f"bit-identical to the live call, {rec['served_launches']} dropout launches "
            f"(expected {rec['expected']}), {rec['served_normal_launches']} normal launches "
            f"(expected {rec['expected_normal']}); load {rec['served_load_s']:.2f} s, first call "
            f"{rec['served_first_ms']:.2f} ms, {rec['served_ms']:.2f} ms/batch median of "
            f"{[round(t, 2) for t in rec['served_times']]} beside live {rec['live_ms']:.2f} "
            f"ms/batch ({card})")
    if dispatch is not None:
        log(f"export: K1's host cost a launch, through its operator {dispatch['operator']:.2f} "
            f"us, through its ctypes wrapper {dispatch['wrapper']:.2f} us (2000 launches on "
            f"(1, 256, 8, 8) bf16, in turns); a group of five levels in one launch through "
            f"its operator {dispatch['levels_operator']:.2f} us, through its wrapper "
            f"{dispatch['levels_wrapper']:.2f} us ({card})")
    records["dispatch_us"] = dispatch
    return records


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
    native_build = threading.Thread(target=native.build)  # g++, beside the nvcc builds
    native_build.start()
    for source, report in _build.build_all(_build.SOURCES).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {source}: {line.strip()}")
    for source in _build.SOURCES:
        _build.load(source)
    native_build.join()
    native.load()
    phase("device (nvcc of csrc/dropout.cu, csrc/focal.cu, csrc/normal.cu, csrc/nms.cu and "
          "csrc/frozen_bn.cu, g++ of native/, in parallel)", t0)

    t0 = time.perf_counter()
    kernels = run_kernels(args.seed, card)
    phase("kernels", t0)

    t0 = time.perf_counter()
    k1_slice, k3_slice = run_slice(args.seed, card)
    phase("slice", t0)

    if args.profile:
        t0 = time.perf_counter()
        profile_slice(args.seed, card)
        phase("profile", t0)

    t0 = time.perf_counter()
    check_against_cpu(args.seed, card)
    phase("reference", t0)

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

        t0 = time.perf_counter()
        eval_launches = run_eval(args.seed, card, work)
        phase("eval", t0)

        t0 = time.perf_counter()
        train_net_launches = run_train_net(args.seed, card, work)
        phase("train_net", t0)

        t0 = time.perf_counter()
        modes, members = run_modes(args.seed, card)
        t1 = time.perf_counter()
        check_modes_against_cpu(args.seed, card)
        t2 = time.perf_counter()
        run_modes_apply_net(args.seed, card, work, members)
        log(f"modes: the modes on the card {t1 - t0:.2f} s, against the CPU {t2 - t1:.2f} s, "
            f"apply_net {time.perf_counter() - t2:.2f} s ({card})")
        phase("modes", t0)

        t0 = time.perf_counter()
        rest = run_rest(args.seed, card, work)
        phase("rest", t0)

        t0 = time.perf_counter()
        parallel = run_parallel(args.seed, card, work, members)
        phase("parallel", t0)

        t0 = time.perf_counter()
        export = run_export(args.seed, card, work)
        phase("export", t0)
    log(f"[total] {time.perf_counter() - t_all:.2f} s ({card})")

    launches = {
        "hardware_dropout": dict(
            slice=k1_slice, train=dict(run=train_launches["dropout"],
                                       step=step_launches["dropout"]),
            eval=eval_launches, train_net=train_net_launches["dropout"],
            modes={name: rec["launches"] for name, rec in modes.items()}, rest=rest["dropout"],
            parallel=dict(apply_net_1_rank=parallel["apply_net_1_rank"],
                          apply_net_2_ranks=parallel["apply_net_2_ranks"],
                          train_net_2_ranks=[n[0] for n in parallel["train_net_2_ranks"]]),
            export={name: export[name]["served_launches"] for name in ("flagship", "post_nms",
                                                                       "mc_iid")}),
        "stochastic_focal_elem": dict(
            train=dict(run=train_launches["focal"], step=step_launches["focal"]),
            train_net=train_net_launches["focal"], rest=rest["focal"],
            parallel=dict(train_net_2_ranks=[n[1] for n in parallel["train_net_2_ranks"]])),
        "normal": dict(
            modes={name: rec["normal_launches"] for name, rec in modes.items()},
            export=dict(mc_iid=export["mc_iid"]["served_normal_launches"],
                        mc_iid_live=export["mc_iid"]["live_normal_launches"])),
        "batched_nms": dict(modes={name: rec["nms_launches"] for name, rec in modes.items()}),
        "frozen_bn_act": dict(slice=k3_slice, train=dict(run=train_launches["frozen_bn"],
                                                         step=step_launches["frozen_bn"])),
    }
    for record in kernels:
        record["launches"] = launches[record["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
