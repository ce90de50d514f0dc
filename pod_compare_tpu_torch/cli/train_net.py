"""Training CLI.

    python -m pod_compare_tpu_torch.cli.train_net \\
        --config-file BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml \\
        --dataset-dir /path/to/bdd --random-seed 0 [--resume] [--eval-only] \\
        [--num-devices N] [--device cpu] [KEY VALUE ...]

Counterpart of ``pod_compare_tpu/cli/train_net.py`` (the reference's
``train_net.py``): trains DATASETS.TRAIN[0] from disk with ``Trainer``,
warm-started from MODEL.WEIGHTS or resumed from the latest checkpoint under
OUTPUT_DIR, scoring DATASETS.TEST[0] every TEST.EVAL_PERIOD steps;
``--eval-only`` scores the latest checkpoint with standard NMS and COCO mAP
and checks TEST.EXPECTED_RESULTS. It runs on CUDA unless ``--device`` names
another device, and raises without CUDA otherwise.

Data-parallel training runs one process per card, as the reference's
``launch`` does: under ``torchrun`` each process joins the process group
it set up; otherwise ``--num-devices`` N > 1 (-1, the default: every local
card) spawns N processes (``parallel.launch``), each taking its rows of
every global batch of SOLVER.IMS_PER_BATCH, which N must divide.
"""

import json

from pod_compare_tpu_torch.cli.apply_net import run_inference
from pod_compare_tpu_torch.config import setup_arg_parser, setup_config
from pod_compare_tpu_torch.parallel import (
    launch,
    local_device,
    maybe_initialize_distributed,
    process_count,
    process_index,
    resolve_num_devices,
)
from pod_compare_tpu_torch.train.trainer import Trainer
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.logging import setup_logger


def verify_results(cfg, results, logger) -> bool:
    """Compare `results` with the TEST.EXPECTED_RESULTS entries
    ([metric_key, expected, tolerance]), as detectron2's verify_results
    does; True when every entry holds (also when there is none)."""
    ok = True
    for key, expected, tolerance in cfg.TEST.EXPECTED_RESULTS:
        actual = results.get(key)
        if actual is None or abs(actual - expected) > tolerance:
            logger.error(f"Result verification FAILED: {key}={actual} "
                         f"(expected {expected} ± {tolerance})")
            ok = False
        else:
            logger.info(f"Result verification passed: {key}={actual}")
    return ok


def main(args, device=None):
    """Train (returns the closed ``Trainer``, its state that of the last
    step) or, with ``args.eval_only``, evaluate (returns the summary). When
    it spawns the processes itself it returns rank 0's summary instead of
    its trainer: ``{"step": ..., "latest": <the last logged scalars>}``."""
    if maybe_initialize_distributed(device) or process_count() > 1:
        return _main(args, local_device(device))
    device = resolve_device(device)
    count = resolve_num_devices(args.num_devices, device)
    if count > 1:
        # Rank r on cuda:r, unless the caller named the CPU or one card.
        per_rank = None if device.type == "cuda" and device.index is None else device
        return launch(_launched_main, count, (args, per_rank), device=per_rank)
    return _main(args, device)


def _launched_main(args, device):
    result = _main(args, local_device(device))
    if isinstance(result, Trainer):
        return {"step": result.state.step, "latest": result.storage.latest()}
    return result


def _main(args, device):
    device = resolve_device(device)
    cfg = setup_config(args, random_seed=args.random_seed)
    logger = setup_logger(name="pod_compare_tpu_torch.train_net", rank=process_index())

    if args.eval_only:
        test_dataset = args.test_dataset or cfg.DATASETS.TEST[0]
        results = run_inference(cfg, test_dataset, "standard_nms_eval", run_metrics=False,
                                run_map=True, device=device)
        if results.get("is_main_process", True):
            logger.info(f"Eval-only results: {json.dumps(results)}")
            verify_results(cfg, results, logger)
        return results

    trainer = Trainer(cfg, device=device)
    try:
        trainer.resume_or_load(resume=args.resume)
        trainer.train()
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    parser = setup_arg_parser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; raises without it)")
    args = parser.parse_args()
    print("Command Line Args:", args)
    main(args, device=args.device)
