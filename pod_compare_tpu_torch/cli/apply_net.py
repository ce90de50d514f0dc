"""Probabilistic inference and evaluation CLI.

    python -m pod_compare_tpu_torch.cli.apply_net \\
        --config-file BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml \\
        --inference-config Inference/bayes_od_mc_dropout.yaml \\
        --test-dataset bdd_val --dataset-dir /path/to/bdd --random-seed 0

Counterpart of ``pod_compare_tpu/cli/apply_net.py``: a COCO-format dataset
on disk goes through ``TestLoader`` and the predictor on the card, with one
batch in flight, into ``coco_instances_results.json`` (the JAX CLI's
schema, with ``cls_prob`` and ``bbox_covar``); then ``mAP_res.txt``, the
probabilistic metrics and the calibration errors. The weights are the
latest checkpoint under ``OUTPUT_DIR`` (``train/checkpoint.py``); for the
``ensembles`` mode, the latest checkpoint of each member, the sibling runs
``random_seed_<seed>`` of ENSEMBLES.RANDOM_SEED_NUMS. It runs on CUDA
unless the caller names a device, and raises without CUDA otherwise.

``profile=True`` traces the inference loop with ``torch.profiler`` into
the inference directory's ``profile/``. ``batch_size='auto'`` runs at the
largest batch of (32, 24, 16, 8, 4, 2, 1) whose measured peak memory fits
the card (``utils/memory_guard.py``); ``run_pdq`` adds PDQ
(``evaluation/pdq.py``) to the summary.

Every inference mode of ``configs/Inference/`` runs. Several processes,
one per card, each infer a strided shard of the test set
(``TestLoader(process_index, process_count)``) and gather their json in
rank order; rank 0 alone writes it and runs the metric suite and PDQ, as
the JAX CLI's main process does. ``main`` joins the process group a
launcher (``torchrun``) set up, or spawns ``--num-devices`` processes
itself (``parallel.launch``; -1, the default, is every local card).
"""

import json
import os
import time
from shutil import copyfile

import torch

from pod_compare_tpu_torch.config import (
    configs_dir,
    inference_output_dir,
    setup_arg_parser,
    setup_config,
)
from pod_compare_tpu_torch.data.datasets import get_dataset
from pod_compare_tpu_torch.data.loader import DevicePrefetcher, TestLoader
from pod_compare_tpu_torch.evaluation.average_precision import (
    evaluate_average_precision,
    read_optimal_score_threshold,
)
from pod_compare_tpu_torch.evaluation.calibration_errors import evaluate_calibration_errors
from pod_compare_tpu_torch.evaluation.category_mapping import (
    dataset_id_to_model_contiguous_map,
    model_to_dataset_id_map,
)
from pod_compare_tpu_torch.evaluation.pdq import evaluate_pdq
from pod_compare_tpu_torch.evaluation.probabilistic_metrics import (
    evaluate_probabilistic_metrics,
)
from pod_compare_tpu_torch.inference.core import Detections
from pod_compare_tpu_torch.inference.postprocess import detections_to_json
from pod_compare_tpu_torch.inference.predictor import build_predictor
from pod_compare_tpu_torch.parallel import (
    check_process_count,
    gather_process_results,
    is_main_process,
    launch,
    local_device,
    maybe_initialize_distributed,
    process_count,
    process_index,
    resolve_num_devices,
)
from pod_compare_tpu_torch.train.checkpoint import load_ensemble_params, load_params
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.logging import setup_logger
from pod_compare_tpu_torch.utils.memory_guard import auto_batch_size
from pod_compare_tpu_torch.utils.profiling import trace

_SEED_HIGH = 2 ** 63 - 1


def load_predictor_params(cfg):
    """(state_dict, None) for single-model modes, (None, member state dicts)
    for `ensembles`, from the latest checkpoints under cfg.OUTPUT_DIR or its
    seed siblings."""
    if cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE == "ensembles":
        seeds = cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS
        return None, load_ensemble_params(cfg.OUTPUT_DIR, seeds)
    return load_params(cfg.OUTPUT_DIR), None


def _refuse_unported(resume) -> None:
    if not resume:
        raise ValueError("apply_net: resume=False asks for a fresh run, but the weights are "
                         "always `params`/`params_list` or the latest checkpoints under "
                         "cfg.OUTPUT_DIR")


def run_inference(
    cfg,
    test_dataset: str,
    inference_name: str,
    batch_size: int = 8,
    resume: bool = True,
    run_metrics: bool = True,
    run_map: bool = True,
    params=None,
    params_list=None,
    verbose: bool = True,
    profile: bool = False,
    min_allowed_score=None,
    loader=None,
    predictor=None,
    run_pdq: bool = False,
    device=None,
):
    """Run the full inference + evaluation pipeline; returns a summary dict,
    the JAX CLI's keys and ``evaluation_seconds``.

    `params` is a state dict in this package's names and `params_list` one
    per ensemble member (default: `load_predictor_params`).
    `loader`/`predictor` may be passed in to reuse built ones; a predictor
    is called as
    ``predictor(images, input_sizes, output_sizes, generator=...)``.
    `device` is where the predictor and the scoring rules run: CUDA unless
    given. `resume` is there for the JAX CLI's signature and must stay True:
    there is no fresh run, the weights are `params`/`params_list` or the
    checkpoints. `batch_size` 'auto' (or 0 or None) measures the largest
    batch that fits the card (``utils.memory_guard.auto_batch_size``; a
    ValueError on the CPU) and sets the loader's batch to it; the summary
    then holds it as ``auto_batch``.

    In a process group each process infers its shard of the test set on
    its own device (``parallel.local_device``) and probes its own `auto`
    batch; the gathers are collective, and a process other than rank 0
    returns ``{num_images, images_per_second, inference_output_dir,
    is_main_process: False}`` after them. ``num_images`` counts every
    process's images, ``images_per_second`` this process's over its own
    time; rank 0's summary adds ``processes`` and ``gather_seconds``."""
    _refuse_unported(resume)
    check_process_count(cfg.PARALLEL.NUM_DEVICES)
    auto_batch = batch_size in ("auto", 0, None)
    device = resolve_device(local_device(device))
    if auto_batch and device.type != "cuda":
        raise ValueError(f"batch_size='auto' measures peak memory on CUDA, not on {device}")
    logger = setup_logger(name="pod_compare_tpu_torch")
    output_dir = inference_output_dir(cfg, test_dataset, inference_name)
    os.makedirs(output_dir, exist_ok=True)

    own_loader = loader is None
    if own_loader:
        loader = TestLoader(
            get_dataset(test_dataset),
            batch_size=1 if auto_batch else batch_size,
            min_size=cfg.INPUT.MIN_SIZE_TEST,
            max_size=cfg.INPUT.MAX_SIZE_TEST,
            divisibility=cfg.INPUT.SIZE_DIVISIBILITY,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            worker_backend=cfg.DATALOADER.WORKER_BACKEND,
            process_index=process_index(),
            process_count=process_count(),
        )
    if predictor is None:
        if params is None and params_list is None:
            params, params_list = load_predictor_params(cfg)
        predictor = build_predictor(cfg, loader.canvas, params, device=device,
                                    state_dicts=params_list)
    auto_info = None
    if auto_batch:
        loader.batch_size, auto_info = auto_batch_size(
            predictor, loader.canvas, log=logger.info)

    train_dataset = cfg.DATASETS.TRAIN[0]
    cat_mapping = model_to_dataset_id_map(train_dataset, test_dataset)

    # One generator draw per batch, as the JAX CLI splits its key per batch:
    # every process draws from cfg.SEED, so its k-th batch takes the k-th seed.
    seeds = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
    results = []
    num_images = 0

    def drain(pending):
        """Host-side fetch + COCO-json conversion for one finished batch."""
        nonlocal num_images
        dets, batch = pending
        dets = Detections(*[None if f is None else f.cpu() for f in dets])
        for b in range(len(batch["batch_valid"])):
            if not batch["batch_valid"][b]:
                continue
            per_image = Detections(*[None if f is None else f[b] for f in dets])
            results.extend(detections_to_json(per_image, int(batch["image_ids"][b]), cat_mapping))
            num_images += 1

    # DevicePrefetcher copies batch i+1 to the card on a side stream while
    # batch i runs; and with one batch in flight, batch i+1's kernels are
    # queued before batch i is fetched and turned into json on the host.
    prefetcher = DevicePrefetcher(loader, device) if cfg.DATALOADER.H2D_OVERLAP else None
    feed = prefetcher if prefetcher is not None else iter(loader)
    start = time.time()
    try:
        with trace(output_dir, enabled=profile):
            pending = None
            for batch in feed:
                seed = int(torch.randint(0, _SEED_HIGH, (1,), generator=seeds))
                dets = predictor(
                    batch["images"], batch["input_sizes"], batch["output_sizes"],
                    generator=torch.Generator().manual_seed(seed),
                )
                if pending is not None:
                    drain(pending)
                pending = (dets, batch)
            if pending is not None:
                drain(pending)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if own_loader:
            loader.close()
    elapsed = time.time() - start
    # This process's rate: its images over its own time (a gathered count
    # over local time would overstate it by about the process count).
    images_per_second = num_images / max(elapsed, 1e-9)
    logger.info(f"Inference on {num_images} images in {elapsed:.1f}s "
                f"({images_per_second:.2f} img/s, {device})")

    gather_seconds = None
    if process_count() > 1:
        start = time.time()
        results = gather_process_results(results)
        num_images = sum(gather_process_results([num_images]))
        gather_seconds = time.time() - start
        if not is_main_process():
            return {
                "num_images": num_images,
                "images_per_second": images_per_second,
                "inference_output_dir": output_dir,
                "is_main_process": False,
            }

    with open(os.path.join(output_dir, "coco_instances_results.json"), "w") as f:
        json.dump(results, f)

    summary = {
        "num_images": num_images,
        "num_detections": len(results),
        "images_per_second": images_per_second,
        "inference_output_dir": output_dir,
    }
    if auto_info is not None:
        summary["auto_batch"] = dict(auto_info, batch=loader.batch_size)
    if gather_seconds is not None:
        summary["processes"] = process_count()
        summary["gather_seconds"] = gather_seconds
    start = time.time()
    if run_map:
        stats, threshold = evaluate_average_precision(
            output_dir, test_dataset, verbose=verbose)
        summary["mAP"] = float(stats[0])
        summary["AP50"] = float(stats[1])
        summary["optimal_score_threshold"] = threshold
    if run_metrics:
        # --min-allowed-score overrides the optimal-F1 threshold read from
        # mAP_res.txt, as in the reference.
        summary["probabilistic_metrics"] = evaluate_probabilistic_metrics(
            output_dir, test_dataset, train_dataset,
            min_allowed_score=min_allowed_score, verbose=verbose, device=device,
        )
        summary["calibration_errors"] = evaluate_calibration_errors(
            output_dir, test_dataset, train_dataset,
            min_allowed_score=min_allowed_score, verbose=verbose,
        )
    if run_pdq:
        # The optimal-F1 threshold of mAP_res.txt unless one is given, so
        # that PDQ scores the same detections as the other metrics.
        pdq_score = min_allowed_score
        if pdq_score is None:
            try:
                pdq_score = read_optimal_score_threshold(output_dir)
            except FileNotFoundError:
                pdq_score = 0.0
        pdq_start = time.time()
        summary["pdq"] = evaluate_pdq(
            output_dir, get_dataset(test_dataset).json_file,
            dataset_id_to_model_contiguous_map(train_dataset, test_dataset),
            min_allowed_score=pdq_score, verbose=verbose,
        )
        summary["pdq_seconds"] = time.time() - pdq_start
    summary["evaluation_seconds"] = time.time() - start
    logger.info(f"Evaluation in {summary['evaluation_seconds']:.1f}s")
    return summary


def main(args, batch_size: int = 8, profile: bool = False, device=None):
    """Run ``run_inference`` from the command line's arguments and return
    rank 0's summary. Under a launcher that set the process group's
    variables (``torchrun``) this process joins it; otherwise
    ``--num-devices`` N > 1 (-1: every local card) spawns N processes, one
    per card, or N on the CPU with ``device='cpu'``."""
    if maybe_initialize_distributed(device) or process_count() > 1:
        return _main(args, batch_size, profile, device)
    device = resolve_device(device)
    count = resolve_num_devices(args.num_devices, device)
    if count > 1:
        # Rank r on cuda:r, unless the caller named the CPU or one card.
        per_rank = None if device.type == "cuda" and device.index is None else device
        return launch(_main, count, (args, batch_size, profile, per_rank), device=per_rank)
    return _main(args, batch_size, profile, device)


def _main(args, batch_size, profile, device):
    device = local_device(device)
    cfg = setup_config(args, random_seed=args.random_seed, is_testing=True)
    inference_name = os.path.splitext(os.path.basename(args.inference_config))[0]
    test_dataset = args.test_dataset or cfg.DATASETS.TEST[0]
    summary = run_inference(
        cfg, test_dataset, inference_name, batch_size=batch_size, profile=profile,
        min_allowed_score=args.min_allowed_score or None,
        run_pdq=getattr(args, "run_pdq", False), device=device,
    )
    # The inference config beside its artifacts, for provenance.
    src_cfg = args.inference_config
    if not os.path.isfile(src_cfg):
        src_cfg = os.path.join(configs_dir(), args.inference_config)
    if is_main_process() and os.path.isfile(src_cfg):
        copyfile(src_cfg, os.path.join(summary["inference_output_dir"], os.path.basename(src_cfg)))
    return summary


if __name__ == "__main__":
    parser = setup_arg_parser()
    parser.add_argument("--batch-size", default="8",
                        help="images per batch, or 'auto': the largest that fits the card")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--run-pdq", action="store_true", dest="run_pdq",
                        help="also score with PDQ (evaluation/pdq.py)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; raises without it)")
    args = parser.parse_args()
    print("Command Line Args:", args)
    batch = args.batch_size if args.batch_size == "auto" else int(args.batch_size)
    main(args, batch_size=batch, profile=args.profile, device=args.device)
