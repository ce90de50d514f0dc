"""Probabilistic predictor: the inference pipeline on one device.

Counterpart of ``pod_compare_tpu/inference/predictor.py`` for the
single-model and MC-dropout-bank paths of the pre-NMS modes
(``standard_nms``, ``bayes_od``). One call runs

  uint8 canvas -> normalize -> R50 + FPN (once)
  -> head: once, or M times with dropout (the first tower conv once)
  -> mean head outputs and per-run deltas
  -> per image: candidate core -> mode -> rescale

PyTorch runs eagerly; nothing in the pipeline reads a value back to the
host. The predictor runs on CUDA unless given another device, and raises
when CUDA is absent and no device was given.
"""

from typing import Optional, Sequence

import torch

from pod_compare_tpu_torch.inference import modes as M
from pod_compare_tpu_torch.inference.core import (
    Detections,
    deferred_covariance,
    probabilistic_inference_core,
)
from pod_compare_tpu_torch.inference.postprocess import detector_postprocess
from pod_compare_tpu_torch.models import (
    KernelDropout,
    TowerDropout,
    build_anchor_generator,
    build_model,
    level_offsets,
)
from pod_compare_tpu_torch.utils.device import resolve_device

_SEED_HIGH = 2 ** 63 - 1


def _draw_seeds(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, _SEED_HIGH, shape, generator=generator, dtype=torch.int64)


class ProbabilisticPredictor:
    """Inference pipeline for one INFERENCE_MODE.

    Args:
        cfg: train config + inference config merged.
        image_size: network input (H, W) after resize and padding.
        state_dict: model weights in this package's (detectron2) names.
        device: torch device; None means CUDA.

    On CUDA the constructor sets ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False, process-wide, so that
    float32 convolutions and products run in full float32 as on the CPU.
    """

    def __init__(self, cfg, image_size: Sequence[int], state_dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.image_size = tuple(int(s) for s in image_size)
        self.model = build_model(cfg)
        self.model.load_state_dict(state_dict)
        self.model.cast_convs().to(self.device).eval()

        gen = build_anchor_generator(cfg)
        self.anchors = torch.as_tensor(gen.concatenated(self.image_size), device=self.device)
        self.level_sizes = tuple(a.shape[0] for a in gen.per_level(self.image_size))

        pi = cfg.PROBABILISTIC_INFERENCE
        self.mode = pi.INFERENCE_MODE
        if self.mode not in ("standard_nms", "bayes_od"):
            raise NotImplementedError(f"INFERENCE_MODE={self.mode!r} is not ported yet")
        self.mc_enabled = bool(pi.MC_DROPOUT.ENABLE)
        self.num_runs = int(pi.MC_DROPOUT.NUM_RUNS) if self.mc_enabled else 1
        self.batch_shared_masks = bool(pi.MC_DROPOUT.BATCH_SHARED_MASKS)
        if self.mc_enabled and self.model.dropout_rate == 0.0:
            raise ValueError(
                "MC_DROPOUT.ENABLE requires a model trained with dropout "
                "(MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE > 0)."
            )
        rc = cfg.MODEL.RETINANET
        self.nms_thresh = float(rc.NMS_THRESH_TEST)
        self.max_dets = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.affinity = float(pi.AFFINITY_THRESHOLD)
        self.core_kwargs = dict(
            topk=int(rc.TOPK_CANDIDATES_TEST),
            level_sizes=self.level_sizes,
            score_thresh=float(rc.SCORE_THRESH_TEST),
            box_reg_weights=tuple(rc.BBOX_REG_WEIGHTS),
            cls_sampling=pi.CLS_SAMPLING,
            box_sampling=pi.BOX_SAMPLING,
        )

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def head_outputs(
        self,
        images: torch.Tensor,
        dropout_gen: Optional[torch.Generator] = None,
        tower_dropouts: Optional[Sequence[TowerDropout]] = None,
    ):
        """Backbone once, head once or M times. Returns (outputs, run_deltas):
        outputs of (B, R, k) float32 tensors, averaged over runs when there
        are several, and the (M, B, R, 4) per-run deltas (None for one run).

        The M dropout passes draw their masks with the dropout kernel from
        seeds of `dropout_gen`, unless `tower_dropouts` gives one
        `TowerDropout` per run (the tests inject the JAX package's masks)."""
        model = self.model
        feats = model.backbone_features(images)
        prefix = model.head.prefix(feats)
        if not (self.mc_enabled and self.num_runs > 1):
            return model.head.rest(prefix), None
        if tower_dropouts is None:
            offsets = level_offsets(feats, self.batch_shared_masks)
            seeds = _draw_seeds(dropout_gen, (self.num_runs, 2, model.head.num_convs)).tolist()
            tower_dropouts = [
                KernelDropout(s, model.dropout_rate, offsets, self.batch_shared_masks)
                for s in seeds
            ]
        runs = [model.head.rest(prefix, td) for td in tower_dropouts]
        mean = {
            k: None if runs[0][k] is None else torch.stack([r[k] for r in runs]).mean(dim=0)
            for k in runs[0]
        }
        return mean, torch.stack([r["box_delta"] for r in runs])

    def _mode(self, cands):
        if self.mode == "standard_nms":
            return M.standard_nms(cands, self.nms_thresh, self.max_dets)
        bod = self.cfg.PROBABILISTIC_INFERENCE.BAYES_OD
        return M.bayes_od(
            cands, self.nms_thresh, self.max_dets, self.affinity,
            bod.BOX_MERGE_MODE, bod.CLS_MERGE_MODE,
        )

    @torch.no_grad()
    def detect(self, outs, run_deltas, input_sizes, output_sizes) -> Detections:
        """Per-image candidate core, mode and rescale; batched Detections."""
        defer = (
            run_deltas is None
            and self.mode == "standard_nms"
            and self.core_kwargs["box_sampling"] == "analytic"
        )
        per_image = []
        for b in range(outs["box_cls"].shape[0]):
            pick = lambda t: None if t is None else t[b]
            cands = probabilistic_inference_core(
                self.anchors, outs["box_cls"][b], outs["box_delta"][b],
                pick(outs["box_cls_var"]), pick(outs["box_reg_var"]),
                None if run_deltas is None else run_deltas[:, b],
                defer_covariance=defer, **self.core_kwargs,
            )
            dets = self._mode(cands)
            if defer and outs["box_reg_var"] is not None:
                dets = deferred_covariance(
                    dets, outs["box_delta"][b], outs["box_reg_var"][b], self.anchors,
                    self.core_kwargs["box_reg_weights"],
                )
            per_image.append(
                detector_postprocess(
                    dets, input_sizes[b, 0], input_sizes[b, 1],
                    output_sizes[b, 0], output_sizes[b, 1],
                )
            )
        return Detections(*[
            None if field[0] is None else torch.stack(field) for field in zip(*per_image)
        ])

    # ------------------------------------------------------------ API
    def __call__(
        self,
        images,
        input_sizes,
        output_sizes,
        generator: Optional[torch.Generator] = None,
    ) -> Detections:
        """Run inference on a padded batch.

        Args:
            images: (B, H, W, 3) raw BGR pixels (uint8 canvases), resized and
                padded to `image_size`; numpy or tensor.
            input_sizes: (B, 2) resized (pre-padding) sizes as (h, w).
            output_sizes: (B, 2) original image sizes as (h, w).
            generator: CPU torch.Generator for the stochastic paths
                (default: seeded with 0). The dropout stream and the
                sampling stream are drawn from it as two separate seeds, so
                they never share numbers whatever the run and batch counts.
        Returns:
            Batched Detections (leading batch axis) in original-image
            coordinates.
        """
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dropout_seed, _sampling_seed = _draw_seeds(generator, (2,)).tolist()
        dropout_gen = torch.Generator().manual_seed(dropout_seed)
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        sizes = lambda s: torch.as_tensor(s, dtype=torch.float32, device=self.device)
        outs, run_deltas = self.head_outputs(images, dropout_gen)
        return self.detect(outs, run_deltas, sizes(input_sizes), sizes(output_sizes))


def build_predictor(cfg, image_size, state_dict, device=None) -> ProbabilisticPredictor:
    """Dispatch on the meta-architecture, as the JAX `build_predictor` does."""
    if cfg.MODEL.META_ARCHITECTURE in ("ProbabilisticRetinaNet", "RetinaNet"):
        return ProbabilisticPredictor(cfg, image_size, state_dict, device)
    raise ValueError(f"Invalid meta-architecture {cfg.MODEL.META_ARCHITECTURE}.")
