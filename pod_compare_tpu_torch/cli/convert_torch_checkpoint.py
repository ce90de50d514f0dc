"""Convert a reference (detectron2) checkpoint into a checkpoint of this package.

    python -m pod_compare_tpu_torch.cli.convert_torch_checkpoint \\
        --checkpoint /path/to/model_final.pth \\
        --config-file BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml \\
        --random-seed 0

Counterpart of ``pod_compare_tpu/cli/convert_torch_checkpoint.py``: reads a
``.pth`` or detectron2 ``.pkl`` (a whole model or a bare backbone; what it
lacks keeps the trainer's initialisation from the seed) and writes it as the
step-0 checkpoint under the config's OUTPUT_DIR, where ``apply_net`` and
``train_net --resume`` pick it up. The model is built on the CPU; no device
is needed.
"""


import torch

from pod_compare_tpu_torch.config import setup_arg_parser, setup_config
from pod_compare_tpu_torch.models import build_model
from pod_compare_tpu_torch.models.convert import (
    from_reference_state_dict,
    load_reference_checkpoint,
)
from pod_compare_tpu_torch.train.checkpoint import Checkpointer


def main(args) -> str:
    """Write the checkpoint; returns its path."""
    cfg = setup_config(args, random_seed=args.random_seed)
    model = build_model(cfg).init_weights(torch.Generator().manual_seed(max(cfg.SEED, 0)))
    state = from_reference_state_dict(load_reference_checkpoint(args.checkpoint))
    _, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"{args.checkpoint}: tensors the model lacks: {unexpected}")
    path = Checkpointer(cfg.OUTPUT_DIR).save(0, {"model": model.state_dict()})
    print(f"Converted {args.checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    parser = setup_arg_parser()
    parser.add_argument("--checkpoint", required=True, type=str)
    main(parser.parse_args())
