"""What each process of ``tests/test_torch_parallel.py``'s process groups
runs. ``parallel.launch`` spawns the processes, which import this module
and not the test module: it imports neither JAX nor the JAX package, since
a spawned process does not load the suite's conftest, which pins JAX to
the CPU."""

import hashlib
import io
import os

import torch

from pod_compare_tpu_torch.cli.apply_net import run_inference
from pod_compare_tpu_torch.config import get_cfg, merge_configs
from pod_compare_tpu_torch.data.datasets import register_coco_instances
from pod_compare_tpu_torch.models import build_anchor_generator
from pod_compare_tpu_torch.parallel import (
    BatchShard,
    gather_process_results,
    process_count,
    process_index,
)
from pod_compare_tpu_torch.train import create_train_state, make_train_step
from pod_compare_tpu_torch.train.trainer import batch_to_device

THREADS = 2
NUM_CLASSES = 3
# tests/test_multihost.py's evaluation config, on the port's defaults.
MULTIHOST_OPTS = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RETINANET.SCORE_THRESH_TEST", 0.0,
    "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 32,
    "TEST.DETECTIONS_PER_IMAGE", 8,
    "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NAME", "loss_attenuation",
    "MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME", "negative_log_likelihood",
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "PROBABILISTIC_INFERENCE.INFERENCE_MODE", "standard_nms",
    "INPUT.MIN_SIZE_TEST", 64,
    "DATALOADER.NUM_WORKERS", 1,
    "SEED", 0,
]
FLAGSHIP = ("BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml",
            "Inference/bayes_od_mc_dropout.yaml")
FLAGSHIP_OPTS = MULTIHOST_OPTS[:8] + [
    "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 3,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TEST", 64,
    "DATALOADER.NUM_WORKERS", 1,
    "SEED", 0,
]
TRAIN_CFG = FLAGSHIP[0]
TRAIN_OPTS = [
    "MODEL.RETINANET.NUM_CLASSES", NUM_CLASSES,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
    "MODEL.PROBABILISTIC_MODELING.ANNEALING_STEP", 10,
    "SOLVER.IMS_PER_BATCH", 4,
]
TRAIN_START_STEP = 5  # the annealed NLL half way in, so that both box terms count


def eval_cfg(mode: str, name: str, out_dir: str):
    """The port's config of one evaluation case: tests/test_multihost.py's
    standard_nms on the defaults, or the flagship with three MC runs."""
    data = ["DATASETS.TRAIN", (name,), "DATASETS.TEST", (name,), "OUTPUT_DIR", out_dir]
    if mode == "standard_nms":
        cfg = get_cfg()
        cfg.merge_from_list(MULTIHOST_OPTS + data)
        return cfg
    return merge_configs(*FLAGSHIP, FLAGSHIP_OPTS + data)


def register(name: str, json_file: str, image_dir: str) -> None:
    register_coco_instances(name, json_file, image_dir,
                            [f"class_{i}" for i in range(NUM_CLASSES)],
                            {i + 1: i for i in range(NUM_CLASSES)})


def evaluate(dataset, weights_path: str, out_dir: str):
    """Rank r: gather payloads of r + 2 items, then run_inference on its
    shard for standard_nms and the flagship. Returns, on every rank, the
    gathered payloads and each mode's summary and json (rank 0's), and
    every rank's summary."""
    torch.set_num_threads(THREADS)
    register(*dataset)
    rank = process_index()
    payload = [{"rank": rank, "item": i} for i in range(rank + 2)]
    out = {"gathered": gather_process_results(payload), "count": process_count()}
    state_dict = torch.load(weights_path, weights_only=True)
    for mode in ("standard_nms", "flagship"):
        cfg = eval_cfg(mode, dataset[0], os.path.join(out_dir, mode))
        summary = run_inference(cfg, dataset[0], mode, batch_size=2, params=state_dict,
                                run_metrics=False, run_map=True, verbose=False, device="cpu")
        out[mode] = {"summaries": gather_process_results([summary])}
    return out


def digest(model) -> str:
    h = hashlib.sha256()
    for p in model.state_dict().values():
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _snapshot(state) -> bytes:
    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    return buf.getvalue()


def train_steps(batches, steps: int):
    """For each global batch of 4 (numpy arrays): `steps` data-parallel
    steps of the flagship training config from one fresh state, rank r on
    its rows. Before each step rank 0 keeps the state; after it, rank 0
    takes the one-process step (no process group in the step) from that
    state over the whole batch and returns each gradient's and each
    weight's largest error against it over its scale, the losses of both,
    whether every gradient is finite, and every rank's digest of its
    weights. Each step starts both sides from the same state: a weight one
    rounding apart can flip a ReLU gate of the next step (ROADMAP §3, fault
    4), which a comparison over several steps would count."""
    torch.set_num_threads(THREADS)
    cfg = merge_configs(TRAIN_CFG, "", TRAIN_OPTS)
    image = batches[0]["images"].shape[1:3]
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(image))
    shard = BatchShard.of(4)
    rows = slice(shard.first, shard.first + shard.size)
    out = []
    for batch in batches:
        state = create_train_state(cfg, "cpu", seed=0)
        state.step = TRAIN_START_STEP
        step = make_train_step(cfg, anchors)
        step.data_parallel(state.model)
        local = batch_to_device({k: v[rows] for k, v in batch.items()}, "cpu")
        records = []
        for _ in range(steps):
            before = _snapshot(state) if process_index() == 0 else None
            metrics = step.global_metrics(step(state, local))
            grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
            record = {
                "losses": {key: float(v) for key, v in metrics.items()},
                "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                "digests": gather_process_results([digest(state.model)]),
            }
            if before is not None:
                ref = create_train_state(cfg, "cpu", seed=0)
                ref.load_state_dict(torch.load(io.BytesIO(before), weights_only=True))
                ref_metrics = make_train_step(cfg, anchors)(ref, batch_to_device(batch, "cpu"))
                ref_grads = {n: p.grad for n, p in ref.model.named_parameters()
                             if p.grad is not None}
                ref_weights = dict(ref.model.named_parameters())
                record["reference_losses"] = {key: float(v) for key, v in ref_metrics.items()}
                record["grad_names"] = sorted(grads) == sorted(ref_grads)
                record["grad_errors"] = {
                    n: float((grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                    for n, g in ref_grads.items()}
                record["weight_errors"] = {
                    n: float((p.detach() - ref_weights[n].detach()).abs().max()
                             / ref_weights[n].detach().abs().max().clamp_min(1e-30))
                    for n, p in state.model.named_parameters()}
            records.append(record)
        out.append(records)
    return out


def fail_on_rank_one():
    """Rank 1 raises at once; rank 0 waits until the launch stops it (not in
    a collective, whose own failure could reach the launcher first)."""
    if process_index() == 1:
        raise ValueError("rank 1 fails on purpose")
    sleep_forever()


def sleep_forever():
    import time

    time.sleep(3600)
