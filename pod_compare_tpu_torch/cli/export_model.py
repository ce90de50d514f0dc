"""Export a trained model + inference config to a serving artifact.

Usage:
    python -m pod_compare_tpu_torch.cli.export_model \\
        --config-file BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml \\
        --inference-config Inference/bayes_od_mc_dropout.yaml \\
        --random-seed 0 --batch-size 2 --device cuda \\
        --output-dir /path/to/artifact

Counterpart of ``pod_compare_tpu/cli/export_model.py``, with ``--device``
in place of ``--platforms``: an ExportedProgram runs on the device it was
exported on (default: CUDA, which must be present). The weights are the
latest checkpoints under the config's OUTPUT_DIR (its seed siblings for the
``ensembles`` mode), loaded as ``cli/apply_net`` loads them, or, with
``--random-init``, fresh weights drawn from the seed. The artifact directory
(program, weights, manifest) is served with
``pod_compare_tpu_torch.inference.export.load_artifact``; the serving host
needs no config and no model code.
"""

import os

import torch

from pod_compare_tpu_torch.config import setup_arg_parser, setup_config
from pod_compare_tpu_torch.inference.export import save_artifact
from pod_compare_tpu_torch.inference.predictor import build_predictor
from pod_compare_tpu_torch.models import build_model
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.logging import setup_logger


def default_canvas(cfg):
    """The shortest-edge test size on a BDD-ratio (720x1280) frame, padded
    to SIZE_DIVISIBILITY: the static canvas TestLoader derives for
    BDD-geometry datasets."""
    short = int(cfg.INPUT.MIN_SIZE_TEST)
    div = int(cfg.INPUT.SIZE_DIVISIBILITY)
    return -(-short // div) * div, -(-(short * 16 // 9) // div) * div


def random_state_dicts(cfg):
    """(state_dict, state_dicts): fresh weights from cfg.SEED, or for the
    `ensembles` mode one model per ENSEMBLES.RANDOM_SEED_NUMS seed."""
    draw = lambda seed: build_model(cfg).init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    if cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE == "ensembles":
        return None, [draw(int(s)) for s in cfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS]
    return draw(max(cfg.SEED, 0)), None


def main(args) -> str:
    """Write the artifact; returns its directory."""
    logger = setup_logger(name="pod_compare_tpu_torch.export_model")
    device = resolve_device(args.device)
    # --random-init exports fresh weights, so no checkpoint directory needs
    # to exist in that case.
    cfg = setup_config(args, random_seed=args.random_seed, is_testing=not args.random_init)
    canvas = (args.canvas_height, args.canvas_width)
    if not all(canvas):
        canvas = default_canvas(cfg)
    if args.random_init:
        state_dict, state_dicts = random_state_dicts(cfg)
    else:
        from pod_compare_tpu_torch.cli.apply_net import load_predictor_params

        state_dict, state_dicts = load_predictor_params(cfg)
    predictor = build_predictor(cfg, canvas, state_dict, device=device, state_dicts=state_dicts)

    out_dir = args.output_dir or os.path.join(
        cfg.OUTPUT_DIR, "serving", os.path.splitext(os.path.basename(args.inference_config))[0])
    save_artifact(predictor, out_dir, batch_size=args.batch_size, device=device,
                  extra_manifest={"train_config": args.config_file,
                                  "inference_config": args.inference_config})
    logger.info(f"serving artifact written to {out_dir}")
    return out_dir


if __name__ == "__main__":
    parser = setup_arg_parser()
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device the artifact runs on (default: CUDA; raises "
                             "without it)")
    parser.add_argument("--output-dir", type=str, default="")
    parser.add_argument("--canvas-height", type=int, default=0)
    parser.add_argument("--canvas-width", type=int, default=0)
    parser.add_argument("--random-init", action="store_true",
                        help="export weights drawn from the seed (smoke tests)")
    main(parser.parse_args())
