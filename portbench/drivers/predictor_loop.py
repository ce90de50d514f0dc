"""Inference traffic: the predictor in a closed loop, as apply_net drives it.

Set-up makes the weights (tempered through the plain reference), a ring
of distinct canvases in pinned host memory and the predictor, and warms up
the cell's one shape. The window then calls
``ProbabilisticPredictor.__call__`` on batch after batch of the ring, each
with a CPU generator seeded from the run's seed stream as apply_net seeds
its calls, with one batch in flight: batch i + 1 is enqueued before batch
i's detections are fetched and turned into COCO json records on the host
(``inference/postprocess.py::detections_to_json``). It stops enqueuing
when `seconds` have passed and ends when the last batch's records are
made.

The output check judges what the window produced, in two parts, for a
sample of its batches drawn from the seed:
  - the start: the head outputs the timed path handed to its candidate
    core (copied to pinned host memory as they pass) against the plain
    reference's forward, float32, on the same images with the same
    dropout masks (K1's bits from the same call seeds);
  - the rest, followed from the program's own state: the batch's
    detections against the reference's core, mode and rescale run on
    those head outputs.
"""

import gc
import math
import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench.harness import gen
from portbench.harness.trace import Spans, profiled
from portbench.reference import bits, detect, model as ref

HEAD_KEYS = ("box_cls", "box_delta", "box_cls_var", "box_reg_var")


@dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    cfg: object
    predictor: object
    sd: Dict[str, torch.Tensor]
    ring: torch.Tensor  # (N, H, W, 3) uint8, pinned host memory
    sizes: torch.Tensor  # (B, 2) float32 input (= output) sizes
    batch: int
    num_runs: int
    mode: str
    check_batches: List[int]
    slot: Optional[dict] = None  # the pinned buffers of the batch being captured
    buffers: List[dict] = field(default_factory=list)
    dets: Dict[int, object] = field(default_factory=dict)
    call_seeds: Dict[int, int] = field(default_factory=dict)


def _opts(cell, extra):
    return list(cell.config.get("opts", [])) + list(cell.traffic.get("opts", [])) + list(extra)


def build(cell, seed: int, device, extra_opts=()) -> State:
    """Everything before the window except the warm-up."""
    from pod_compare_tpu_torch.config.setup import merge_configs
    from pod_compare_tpu_torch.inference.predictor import build_predictor

    conf, traffic = cell.config, cell.traffic
    cfg = merge_configs(conf["train_config"], traffic["inference_config"],
                        _opts(cell, extra_opts))
    canvas, image = tuple(conf["canvas"]), tuple(conf["image"])
    m = conf["model"]
    ref.strict_float32()
    sd = gen.weights(seed, gen.reference_shapes(conf), "tempered", device)
    ring = gen.canvases(seed + 7, traffic["ring_images"], canvas, image, device)
    probe = ref.single_outputs(sd, ring[:1], m["num_convs"], m["num_classes"])
    sd = gen.temper(sd, probe, m["num_classes"])
    del probe
    ring = ring.cpu().pin_memory() if device.type == "cuda" else ring.cpu()
    predictor = build_predictor(cfg, canvas, sd, device=device)
    batch = int(traffic["batch"])
    sizes = torch.tensor([list(image)] * batch, dtype=torch.float32)
    picks = random.Random(seed).sample(range(int(traffic["check_within"])),
                                       int(traffic["check_batches"]))
    return State(cell, seed, device, cfg, predictor, sd, ring, sizes, batch,
                 int(predictor.num_runs), traffic["mode"], sorted(picks))


def _hook(state: State, spans: Spans, stage_sync: bool):
    """Wrap the pipeline's stages: copy the head outputs of a captured
    batch to pinned host buffers as they reach the candidate core, and,
    with `stage_sync`, time each stage between syncs."""
    pipe = state.predictor.pipeline
    head, det = type(pipe)._head_outputs.__get__(pipe), type(pipe).detect.__get__(pipe)
    sync = (lambda: torch.cuda.synchronize()) if state.device.type == "cuda" else (lambda: None)

    def head_outputs(*args, **kwargs):
        if not stage_sync:
            with spans("head_outputs"):
                return head(*args, **kwargs)
        sync()
        with spans("head_outputs_synced"):
            out = head(*args, **kwargs)
            sync()
        return out

    def detect_(outs, run_deltas, *args, **kwargs):
        slot = state.slot
        if slot is not None:
            for k, v in list(outs.items()) + [("run_deltas", run_deltas)]:
                if v is not None:
                    slot[k].copy_(v, non_blocking=True)
        if not stage_sync:
            with spans("detect"):
                return det(outs, run_deltas, *args, **kwargs)
        sync()
        with spans("detect_synced"):
            out = det(outs, run_deltas, *args, **kwargs)
            sync()
        return out

    pipe._head_outputs = head_outputs
    pipe.detect = detect_


def _buffers(state: State) -> List[dict]:
    """Pinned host buffers for the captured batches' head outputs, shaped
    by one call of the pipeline's stages."""
    pipe = state.predictor.pipeline
    images = state.ring[: state.batch].to(state.device)
    seeds = bits.draw_seeds(torch.Generator().manual_seed(0), (state.num_runs, 2, pipe.num_convs))
    with torch.no_grad():
        outs, run_deltas = type(pipe)._head_outputs(pipe, images, seeds)
    shapes = {k: v.shape for k, v in outs.items() if v is not None}
    if run_deltas is not None:
        shapes["run_deltas"] = run_deltas.shape
    pin = state.device.type == "cuda"
    return [{k: torch.empty(s, dtype=torch.float32, pin_memory=pin) for k, s in shapes.items()}
            for _ in state.check_batches]


def _batch_images(state: State, i: int) -> torch.Tensor:
    n = state.ring.shape[0] // state.batch
    j = i % n
    return state.ring[j * state.batch:(j + 1) * state.batch]


def _drain(pending, records: list, latencies: list, state: State, dets_stats: dict):
    from pod_compare_tpu_torch.inference.core import Detections
    from pod_compare_tpu_torch.inference.postprocess import detections_to_json

    dets, i, t_enq = pending
    dets = Detections(*[None if f is None else f.cpu() for f in dets])
    for b in range(dets.boxes.shape[0]):
        per = Detections(*[None if f is None else f[b] for f in dets])
        records.extend(detections_to_json(per, i * state.batch + b))
    latencies.append((time.perf_counter() - t_enq) * 1e3)
    v = dets.valid
    dets_stats["valid"] += int(v.sum())
    dets_stats["images"] += int(v.shape[0])
    if dets.cluster_size is not None and bool(v.any()):
        dets_stats["largest_cluster"] = max(dets_stats["largest_cluster"],
                                            int(dets.cluster_size[v].max()))
    if i in state.call_seeds:
        state.dets[i] = dets


def loop(state: State, seconds: float, spans: Spans, seed_stream: torch.Generator,
         first_index: int, capture: bool, max_batches: Optional[int] = None):
    """Closed loop with one batch in flight for `seconds` of enqueuing (or
    `max_batches` batches); returns (images done, wall seconds, per-batch
    ms, records, stats, next index)."""
    records, latencies = [], []
    stats = {"valid": 0, "images": 0, "largest_cluster": 0}
    pending, i = None, first_index
    t0 = time.perf_counter()
    while True:
        if max_batches is not None and i - first_index >= max_batches:
            break
        if time.perf_counter() - t0 >= seconds:
            break
        call_seed = int(torch.randint(0, bits.SEED_HIGH, (1,), generator=seed_stream))
        slot = None
        if capture and i in state.check_batches:
            slot = state.buffers[state.check_batches.index(i)]
            state.call_seeds[i] = call_seed
        state.slot = slot
        t_enq = time.perf_counter()
        with spans("enqueue"):
            dets = state.predictor(_batch_images(state, i), state.sizes, state.sizes,
                                   generator=torch.Generator().manual_seed(call_seed))
        state.slot = None
        if pending is not None:
            with spans("drain_json"):
                _drain(pending, records, latencies, state, stats)
        pending = (dets, i, t_enq)
        i += 1
    if pending is not None:
        with spans("drain_json"):
            _drain(pending, records, latencies, state, stats)
    wall = time.perf_counter() - t0
    return stats["images"], wall, latencies, records, stats, i


# ------------------------------------------------------------ the check
def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """Largest |p - r| over the largest |r|."""
    return float((p.double() - r.double()).abs().max() / r.double().abs().max().clamp_min(1e-30))


def head_numbers(state: State, quant=None) -> Dict[str, float]:
    """Per captured batch, the reference's head outputs against the
    program's: the largest gap of the mean logits and log-variances
    (`logit_gap`) and of the mean and per-run box deltas and their
    covariance parameters (`delta_gap`), over the largest reference value,
    per image; the largest over images."""
    conf = state.cell.config["model"]
    rate = float(state.cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE)
    gaps = {"logit_gap": 0.0, "delta_gap": 0.0}
    for i, buf in zip(state.check_batches, state.buffers):
        images = _batch_images(state, i).to(state.device)
        if state.num_runs > 1:
            seeds = bits.call_dropout_seeds(state.call_seeds[i], state.num_runs,
                                            conf["num_convs"]).tolist()
            outs, run_deltas = ref.mc_outputs(state.sd, images, seeds, rate, conf["num_convs"],
                                              conf["num_classes"], quant)
        else:
            outs = ref.single_outputs(state.sd, images, conf["num_convs"], conf["num_classes"],
                                      quant)
            run_deltas = None
        for b in range(state.batch):
            for k in HEAD_KEYS:
                if outs.get(k) is None:
                    continue
                name = "logit_gap" if k in ("box_cls", "box_cls_var") else "delta_gap"
                gaps[name] = max(gaps[name], _gap(buf[k][b].to(state.device), outs[k][b]))
            if run_deltas is not None:
                gaps["delta_gap"] = max(gaps["delta_gap"], _gap(
                    buf["run_deltas"][:, b].to(state.device), run_deltas[:, b]))
        del outs, run_deltas, images
    return gaps


def detection_gap(p, r) -> float:
    """Slot by slot, one image: 1 for a slot whose validity or class
    differs; else the largest of the box gap over the box's larger side,
    the score and class-probability gaps, and the covariance gap over the
    covariance's largest entry."""
    if bool((p.valid != r.valid).any()):
        return 1.0
    v = r.valid
    if not bool(v.any()):
        return 0.0
    if bool((p.classes[v] != r.classes[v]).any()):
        return 1.0
    rb = r.boxes[v].double()
    side = torch.maximum(rb[:, 2] - rb[:, 0], rb[:, 3] - rb[:, 1]).clamp_min(1.0)
    box = ((p.boxes[v].double() - rb).abs().amax(dim=1) / side).max()
    score = (p.scores[v].double() - r.scores[v].double()).abs().max()
    prob = (p.prob_vectors[v].double() - r.prob_vectors[v].double()).abs().max()
    rc = r.covs[v].double()
    cov = ((p.covs[v].double() - rc).abs().amax(dim=(1, 2))
           / rc.abs().amax(dim=(1, 2)).clamp_min(1e-30)).max()
    return float(max(box, score, prob, cov))


def detection_numbers(state: State, probs_dtype=torch.float32) -> Dict[str, float]:
    """The captured batches' detections against the reference's core, mode
    and rescale on the same head outputs: `det_gap`, the largest
    `detection_gap` over the images."""
    pi = state.cfg.PROBABILISTIC_INFERENCE
    rc = state.cfg.MODEL.RETINANET
    anc_np, level_sizes = detect.anchors(state.cell.config["canvas"])
    anc = torch.as_tensor(anc_np, device=state.device)
    image = tuple(state.cell.config["image"])
    worst = 0.0
    for i, buf in zip(state.check_batches, state.buffers):
        prog = state.dets[i]
        for b in range(state.batch):
            outs = {k: buf[k][b].to(state.device) if k in buf else None for k in HEAD_KEYS}
            run_deltas = buf["run_deltas"][:, b].to(state.device) if "run_deltas" in buf \
                else None
            r = detect.detect(anc, level_sizes, outs, run_deltas, state.mode, image, image,
                              float(rc.NMS_THRESH_TEST),
                              int(state.cfg.TEST.DETECTIONS_PER_IMAGE),
                              float(pi.AFFINITY_THRESHOLD), pi.BAYES_OD.CLS_MERGE_MODE,
                              int(rc.TOPK_CANDIDATES_TEST), float(rc.SCORE_THRESH_TEST),
                              probs_dtype)
            p = detect.Dets(*[getattr(prog, f)[b].to(state.device) for f in detect.Dets._fields])
            worst = max(worst, detection_gap(p, r))
    return {"det_gap": worst}


def free_program(state: State) -> None:
    state.predictor = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def numbers(state: State, quant=None, probs_dtype=torch.float32) -> Dict[str, float]:
    missing = [i for i in state.check_batches if i not in state.dets]
    if missing:
        return {"missing_batches": float(len(missing))}
    with torch.no_grad():
        out = head_numbers(state, quant)
        out.update(detection_numbers(state, probs_dtype))
    out["missing_batches"] = 0.0
    return out


# ------------------------------------------------------------ a run
TRACE_FROM = 10 ** 6  # batch indices of the traced passes, past any checked batch


def traced(state: State, spans: Spans, seed_stream) -> dict:
    """After the window: a pass of the cell's profile_batches traced on the
    device alone (busy time, kernels), one traced with the host's spans
    (what the host did in each idle gap), and stage_batches batches with
    each stage timed between syncs."""
    n = int(state.cell.traffic["profile_batches"])
    traces = []
    for host in (False, True):
        with profiled(spans, traces, host):
            loop(state, math.inf, spans, seed_stream, TRACE_FROM, capture=False, max_batches=n)
    spans.records.clear()
    _hook(state, spans, stage_sync=True)
    loop(state, math.inf, spans, seed_stream, TRACE_FROM, capture=False,
         max_batches=int(state.cell.traffic["stage_batches"]))
    return {"trace": traces[0], "host_trace": traces[1],
            "stage_ms": {"head_outputs": spans.durations_ms("head_outputs_synced"),
                         "detect": spans.durations_ms("detect_synced")}}


def warm_up(state: State, spans: Spans, calls: int = 3) -> None:
    """The cell's one shape through the whole loop (calls, fetch, json)."""
    loop(state, math.inf, spans, torch.Generator().manual_seed(state.seed + 13), -calls,
         capture=False, max_batches=calls)
    if state.device.type == "cuda":
        torch.cuda.synchronize()


def set_up(cell, seed: int, device, spans: Spans, extra_opts=()) -> State:
    """A run's set-up: the state, the stages' hooks, the capture buffers,
    the warm-up."""
    state = build(cell, seed, device, extra_opts)
    _hook(state, spans, stage_sync=False)
    state.buffers = _buffers(state)
    warm_up(state, spans)
    return state


def check(state: State) -> Dict[str, float]:
    """After the window: frees the program and compares what it captured."""
    free_program(state)
    return numbers(state)


def run(ctx):
    """One run of the cell: set-up, the window, the check. Returns the
    record the metric readers read, the numbers compared and diagnostics."""
    from pod_compare_tpu_torch.ops.kernels import dropout as kdropout

    cell, device = ctx.cell, ctx.device
    spans = Spans()
    state = set_up(cell, ctx.seed, device, spans)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t0
    spans.records.clear()
    launches0 = kdropout.LAUNCHES
    seed_stream = torch.Generator().manual_seed(ctx.seed)
    done, wall, latencies, records, stats, batches = loop(
        state, ctx.seconds, spans, seed_stream, 0, capture=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    launches = kdropout.LAUNCHES - launches0
    record = {
        "kind": "infer", "cell": cell, "setup_s": setup_s, "window_s": wall,
        "images": done, "batches": batches, "batch": state.batch, "num_runs": state.num_runs,
        "batch_ms": latencies, "peak_bytes": peak, "trace": None, "host_trace": None,
        "stage_ms": {}, "k1_launches": launches,
    }
    if ctx.trace:
        record.update(traced(state, spans, seed_stream))
    diagnostics = [
        f"window: {done} images in {batches} batches of {state.batch}, {wall:.6f} s, "
        f"{len(records)} json records",
        f"launches: K1 {launches} in {batches} batches "
        f"({launches / max(batches, 1):.1f} a batch), K2 0",
        f"detections: {stats['valid'] / max(stats['images'], 1):.3f} an image, largest BayesOD "
        f"cluster {stats['largest_cluster']}",
        "batch ms from enqueue to json, quartiles: " + (", ".join(
            f"{q:.3f}" for q in statistics.quantiles(latencies, n=4)) if len(latencies) > 1
            else "too few"),
    ]
    nums = check(state)
    attempted = batches * state.batch
    return record, nums, diagnostics, attempted, attempted - done
