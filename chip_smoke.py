#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python chip_smoke.py [--seed N]

Phases, each printing its seconds on its own line as it ends:
  1. device: the card's name and power limit (nvidia-smi); build the CUDA
     dropout kernel from csrc/ with nvcc into build/.
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
Then one JSON line of the kernels, the nvidia-smi line, and the result line.

It needs a CUDA device and the repository around it; it exits non-zero
without either, and on any failed check.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor, detections_to_json
from pod_compare_tpu_torch.models import build_model, convert
from pod_compare_tpu_torch.ops.kernels import _build
from pod_compare_tpu_torch.ops.kernels import dropout as kdropout

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
INFER_CFG = "Inference/bayes_od_mc_dropout.yaml"
CANVAS = (736, 1280)  # BDD 720x1280 padded to a multiple of 32
BATCH = 2
P3_SHAPE = (BATCH, 256, CANVAS[0] // 8, CANVAS[1] // 8)
IMAGE_SIZES = np.array([[720, 1280]] * BATCH, np.float32)  # (h, w) before padding
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also trace one full-width call with torch.profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load("dropout.cu")
    log(f"[phase device] build of csrc/dropout.cu and device setup: "
        f"{time.perf_counter() - t0:.2f} s ({card})")

    t0 = time.perf_counter()
    k1 = check_kernel(args.seed, card)
    log(f"[phase kernel] {time.perf_counter() - t0:.2f} s ({card})")

    t0 = time.perf_counter()
    launches = run_slice(args.seed, card)
    log(f"[phase slice] {time.perf_counter() - t0:.2f} s ({card})")

    if args.profile:
        t0 = time.perf_counter()
        profile_slice(args.seed, card)
        log(f"[phase profile] {time.perf_counter() - t0:.2f} s ({card})")

    t0 = time.perf_counter()
    check_against_cpu(args.seed, card)
    log(f"[phase reference] {time.perf_counter() - t0:.2f} s ({card})")
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
