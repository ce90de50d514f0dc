"""Probabilistic predictor: the inference pipeline on one device.

Counterpart of ``pod_compare_tpu/inference/predictor.py`` for every
INFERENCE_MODE of ``configs/Inference/``. One call runs

  uint8 canvas -> normalize -> R50 + FPN
  -> head outputs of every run:
       one model, the head once;
       MC dropout, backbone and first tower conv once, the rest M times;
       ensembles, each member's whole forward without dropout
  -> pre-NMS modes: mean outputs and per-run deltas, then per image the
     candidate core and the mode (standard_nms, anchor_statistics,
     bayes_od; the pre-NMS MC-dropout and ensemble modes are standard_nms)
  -> post-NMS modes: per (image, run) the core and standard_nms, then per
     image the runs' detections, run-major, through black_box_merge
  -> rescale.

PyTorch runs eagerly. The predictor runs on CUDA unless given another
device, and raises when CUDA is absent and no device was given. Its
forward after the host's seed draw is one module (``PipelineModule``),
which ``inference/export.py`` exports whole. While a profiler records,
each stage opens a ``pod.*`` span (``utils/profiling.span``): ``pod.seeds``,
``pod.head_bank`` (``pod.backbone``, ``pod.head_runs``) and ``pod.detect``
(per image ``pod.core``, ``pod.mode``, ``pod.rescale``; ``pod.stack``);
an exported program holds none of them.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from pod_compare_tpu_torch.inference import modes as M
from pod_compare_tpu_torch.inference.core import (
    Detections,
    deferred_covariance,
    probabilistic_inference_core,
)
from pod_compare_tpu_torch.inference.postprocess import detector_postprocess
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds, draw_seeds
from pod_compare_tpu_torch.models import (
    KernelDropout,
    TowerDropout,
    build_anchor_generator,
    build_model,
    level_offsets,
)
from pod_compare_tpu_torch.utils.device import resolve_device
from pod_compare_tpu_torch.utils.profiling import span

MODES = ("standard_nms", "anchor_statistics", "bayes_od", "mc_dropout_ensembles", "ensembles")


def _stack(runs):
    """Stack a list of output dicts on a new leading axis (None stays None)."""
    return {k: None if runs[0][k] is None else torch.stack([r[k] for r in runs]) for k in runs[0]}


def _stack_images(per_image: List[Detections]) -> Detections:
    return Detections(*[
        None if field[0] is None else torch.stack(field) for field in zip(*per_image)
    ])


class PipelineModule(nn.Module):
    """The predictor's forward as one module: (images, input_sizes,
    output_sizes, dropout_seeds) -> Detections, with no host-side draw and
    no data-dependent Python, so that ``torch.export`` captures it whole
    (``inference/export.py``). It owns the member models (`models`, one
    unless the mode is `ensembles`), the anchors (a buffer) and the
    settings of the INFERENCE_MODE; the stages below are its methods.

    `member_devices` gives each member's device (the images are copied to
    it and its outputs back to `device`); `dropout_seeds` is the (M, 2,
    num_convs) int64 CPU tensor of `seeds.draw_call_seeds`, read only by an
    MC bank; `sampling_seeds`, its (B,) or, on the post-NMS paths, (B, M)
    int64 CPU tensor, seeds the Monte-Carlo sampling impls, one stream per
    image or (image, run) unit (`sampling_seeds_shape`), and is read only
    when they are on (`sampled`).
    """

    def __init__(self, cfg, image_size: Sequence[int], models, device: torch.device,
                 member_devices: Sequence[torch.device]):
        super().__init__()
        pi = cfg.PROBABILISTIC_INFERENCE
        self.mode = pi.INFERENCE_MODE
        self.device = device
        self.image_size = tuple(int(s) for s in image_size)
        self.models = nn.ModuleList(models)
        self.member_devices = list(member_devices)
        model = self.models[0]
        self.num_convs = model.head.num_convs

        gen = build_anchor_generator(cfg)
        self.register_buffer(
            "anchors", torch.as_tensor(gen.concatenated(self.image_size), device=device),
            persistent=False)
        self.level_sizes = tuple(a.shape[0] for a in gen.per_level(self.image_size))

        self.mc_enabled = bool(pi.MC_DROPOUT.ENABLE)
        self.num_runs = int(pi.MC_DROPOUT.NUM_RUNS) if self.mc_enabled else 1
        self.batch_shared_masks = bool(pi.MC_DROPOUT.BATCH_SHARED_MASKS)
        if self.mc_enabled and model.dropout_rate == 0.0:
            raise ValueError(
                "MC_DROPOUT.ENABLE requires a model trained with dropout "
                "(MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE > 0)."
            )
        self.is_multi = self.mode == "ensembles" or (self.mc_enabled and self.num_runs > 1)
        self.draws_masks = self.is_multi and self.mode != "ensembles"
        merge = {"mc_dropout_ensembles": pi.ENSEMBLES_DROPOUT.BOX_MERGE_MODE,
                 "ensembles": pi.ENSEMBLES.BOX_MERGE_MODE}.get(self.mode)
        self.post_nms = merge == "post_nms"
        if pi.SPLIT_HEAD_PROGRAM and (self.post_nms or not self.is_multi):
            raise ValueError(
                "PROBABILISTIC_INFERENCE.SPLIT_HEAD_PROGRAM only applies to multi-run "
                "pre-NMS pipelines (MC dropout or ensembles with pre-NMS/fusion merge)."
            )
        if self.post_nms and not self.is_multi:
            raise ValueError(
                f"{self.mode} with post_nms merge needs several runs "
                "(MC_DROPOUT.ENABLE with NUM_RUNS > 1)"
            )
        rc = cfg.MODEL.RETINANET
        self.nms_thresh = float(rc.NMS_THRESH_TEST)
        self.max_dets = int(cfg.TEST.DETECTIONS_PER_IMAGE)
        self.affinity = float(pi.AFFINITY_THRESHOLD)
        self.bayes_od_merge = (pi.BAYES_OD.BOX_MERGE_MODE, pi.BAYES_OD.CLS_MERGE_MODE)
        pm = cfg.MODEL.PROBABILISTIC_MODELING
        self.core_kwargs = dict(
            topk=int(rc.TOPK_CANDIDATES_TEST),
            level_sizes=self.level_sizes,
            score_thresh=float(rc.SCORE_THRESH_TEST),
            box_reg_weights=tuple(rc.BBOX_REG_WEIGHTS),
            cls_sampling=pi.CLS_SAMPLING,
            box_sampling=pi.BOX_SAMPLING,
            cls_num_samples=int(pm.CLS_VAR_LOSS.NUM_SAMPLES),
            box_num_samples=int(pm.BBOX_COV_LOSS.NUM_SAMPLES),
        )
        self.sampled = pi.CLS_SAMPLING != "analytic" or pi.BOX_SAMPLING != "analytic"
        self.eval()

    # ------------------------------------------------------------ stages
    def _seeds(self, dropout_gen, tower_dropouts) -> Optional[torch.Tensor]:
        """The MC bank's (M, 2, num_convs) seeds from `dropout_gen`, where
        the bank draws its masks with the kernel."""
        if not self.draws_masks or tower_dropouts is not None:
            return None
        return draw_seeds(dropout_gen, (self.num_runs, 2, self.num_convs))

    def _runs(self, images, dropout_seeds, tower_dropouts=None) -> List[dict]:
        if self.mode == "ensembles":
            # Each member's forward is queued on its own card before any
            # output is copied back, so members on several cards overlap.
            with span("pod.head_runs"):
                runs = [model(images.to(d, non_blocking=True))
                        for model, d in zip(self.models, self.member_devices)]
                return [{k: None if v is None else v.to(self.device, non_blocking=True)
                         for k, v in run.items()} for run in runs]
        model = self.models[0]
        with span("pod.backbone"):
            feats = model.backbone_features(images)
            prefix = model.head.prefix(feats)
        with span("pod.head_runs"):
            if not self.is_multi:
                return [model.head.rest(prefix)]
            if tower_dropouts is None:
                offsets = level_offsets(feats, self.batch_shared_masks)
                tower_dropouts = [
                    KernelDropout(s, model.dropout_rate, offsets, self.batch_shared_masks)
                    for s in dropout_seeds
                ]
            return [model.head.rest(prefix, td) for td in tower_dropouts]

    def _head_outputs(self, images, dropout_seeds, tower_dropouts=None):
        with span("pod.head_bank"):
            runs = self._runs(images, dropout_seeds, tower_dropouts)
            if not self.is_multi:
                return runs[0], None
            stacked = _stack(runs)
            mean = {k: None if v is None else v.mean(dim=0) for k, v in stacked.items()}
            return mean, stacked["box_delta"]

    @torch.no_grad()
    def run_outputs(
        self,
        images: torch.Tensor,
        dropout_gen: Optional[torch.Generator] = None,
        tower_dropouts: Optional[Sequence[TowerDropout]] = None,
    ):
        """Every run's head outputs stacked on a leading run axis: (M, B, R, k)
        float32 tensors (None for a head the model lacks). M is the number
        of ensemble members, of MC-dropout runs, or 1.

        The MC-dropout runs draw their masks with the dropout kernel from
        seeds of `dropout_gen`, unless `tower_dropouts` gives one
        `TowerDropout` per run (the tests inject the JAX package's masks)."""
        return _stack(self._runs(images, self._seeds(dropout_gen, tower_dropouts),
                                 tower_dropouts))

    @torch.no_grad()
    def head_outputs(
        self,
        images: torch.Tensor,
        dropout_gen: Optional[torch.Generator] = None,
        tower_dropouts: Optional[Sequence[TowerDropout]] = None,
    ):
        """(outputs, run_deltas): outputs of (B, R, k) float32 tensors,
        averaged over the runs when there are several, and the (M, B, R, 4)
        per-run deltas (None for one run). Arguments as `run_outputs`."""
        return self._head_outputs(images, self._seeds(dropout_gen, tower_dropouts),
                                  tower_dropouts)

    def _mode(self, cands):
        if self.mode == "anchor_statistics":
            return M.anchor_statistics(cands, self.nms_thresh, self.max_dets, self.affinity)
        if self.mode == "bayes_od":
            return M.bayes_od(cands, self.nms_thresh, self.max_dets, self.affinity,
                              *self.bayes_od_merge)
        # standard_nms, and the pre-NMS MC-dropout and ensemble merges
        return M.standard_nms(cands, self.nms_thresh, self.max_dets)

    def sampling_seeds_shape(self, batch: int) -> tuple:
        """Shape of a call's `sampling_seeds`: one seed per image, (batch,),
        or per (image, run) unit on the post-NMS paths, (batch, M)."""
        return (batch, self.num_runs) if self.post_nms else (batch,)

    def _sampling_seeds(self, sampling_seeds: Optional[torch.Tensor], batch: int):
        """`sampling_seeds` checked against the call, or None when nothing
        is sampled (an analytic call reads no seed)."""
        if not self.sampled:
            return None
        want = self.sampling_seeds_shape(batch)
        if sampling_seeds is None or tuple(sampling_seeds.shape) != want:
            raise ValueError(
                f"CLS_SAMPLING {self.core_kwargs['cls_sampling']!r} / BOX_SAMPLING "
                f"{self.core_kwargs['box_sampling']!r} need sampling_seeds of shape {want} "
                f"(seeds.draw_call_seeds), got "
                f"{None if sampling_seeds is None else tuple(sampling_seeds.shape)}")
        return sampling_seeds

    def _rescale(self, dets, b, input_sizes, output_sizes):
        return detector_postprocess(
            dets, input_sizes[b, 0], input_sizes[b, 1], output_sizes[b, 0], output_sizes[b, 1],
        )

    @torch.no_grad()
    def detect(self, outs, run_deltas, input_sizes, output_sizes,
               sampling_seeds: Optional[torch.Tensor] = None) -> Detections:
        """Pre-NMS modes: per-image candidate core, mode and rescale on the
        (mean) outputs of `head_outputs`; batched Detections. Image b's
        Monte-Carlo banks draw from `sampling_seeds[b]` (the (B,) seeds of
        `seeds.draw_call_seeds`; needed only by the sampled impls)."""
        defer = (
            run_deltas is None
            and self.mode == "standard_nms"
            and self.core_kwargs["box_sampling"] == "analytic"
        )
        batch = outs["box_cls"].shape[0]
        seeds = self._sampling_seeds(sampling_seeds, batch)
        per_image = []
        with span("pod.detect"):
            for b in range(batch):
                pick = lambda t: None if t is None else t[b]
                with span("pod.core"):
                    cands = probabilistic_inference_core(
                        self.anchors, outs["box_cls"][b], outs["box_delta"][b],
                        pick(outs["box_cls_var"]), pick(outs["box_reg_var"]),
                        None if run_deltas is None else run_deltas[:, b],
                        seed=None if seeds is None else seeds[b], defer_covariance=defer,
                        **self.core_kwargs,
                    )
                with span("pod.mode"):
                    dets = self._mode(cands)
                with span("pod.rescale"):
                    if defer and outs["box_reg_var"] is not None:
                        dets = deferred_covariance(
                            dets, outs["box_delta"][b], outs["box_reg_var"][b], self.anchors,
                            self.core_kwargs["box_reg_weights"],
                        )
                    per_image.append(self._rescale(dets, b, input_sizes, output_sizes))
            with span("pod.stack"):
                return _stack_images(per_image)

    @torch.no_grad()
    def detect_post_nms(self, run_outs, input_sizes, output_sizes,
                        sampling_seeds: Optional[torch.Tensor] = None) -> Detections:
        """Post-NMS modes on the stacked outputs of `run_outputs`: each
        (image, run) unit through the core, standard NMS and the deferred
        covariance; each image's units concatenated run-major (run 0's
        max_dets detections first) through `black_box_merge`; rescale.
        Unit (b, m)'s Monte-Carlo banks draw from `sampling_seeds[b, m]`
        (the (B, M) seeds of `seeds.draw_call_seeds`)."""
        num_runs, batch = run_outs["box_cls"].shape[:2]
        seeds = self._sampling_seeds(sampling_seeds, batch)
        defer = self.core_kwargs["box_sampling"] == "analytic"
        per_image = []
        with span("pod.detect"):
            for b in range(batch):
                units = []
                with span("pod.mode"):
                    for m in range(num_runs):
                        unit = {k: None if v is None else v[m, b] for k, v in run_outs.items()}
                        with span("pod.core"):
                            cands = probabilistic_inference_core(
                                self.anchors, unit["box_cls"], unit["box_delta"],
                                unit["box_cls_var"], unit["box_reg_var"], None,
                                seed=None if seeds is None else seeds[b, m],
                                defer_covariance=defer, **self.core_kwargs,
                            )
                        dets = M.standard_nms(cands, self.nms_thresh, self.max_dets)
                        if defer and unit["box_reg_var"] is not None:
                            dets = deferred_covariance(
                                dets, unit["box_delta"], unit["box_reg_var"], self.anchors,
                                self.core_kwargs["box_reg_weights"],
                            )
                        units.append(dets)
                    merged = M.black_box_merge(
                        M.concatenate_detections(units), self.nms_thresh, self.max_dets,
                        self.affinity,
                    )
                with span("pod.rescale"):
                    per_image.append(self._rescale(merged, b, input_sizes, output_sizes))
            with span("pod.stack"):
                return _stack_images(per_image)

    @torch.no_grad()
    def forward(self, images: torch.Tensor, input_sizes: torch.Tensor,
                output_sizes: torch.Tensor, dropout_seeds: torch.Tensor,
                sampling_seeds: Optional[torch.Tensor] = None) -> Detections:
        """Images on the device to batched Detections: the head outputs of
        every run, then `detect_post_nms` or `detect`."""
        if self.post_nms:
            with span("pod.head_bank"):
                run_outs = _stack(self._runs(images, dropout_seeds))
            return self.detect_post_nms(run_outs, input_sizes, output_sizes, sampling_seeds)
        outs, run_deltas = self._head_outputs(images, dropout_seeds)
        return self.detect(outs, run_deltas, input_sizes, output_sizes, sampling_seeds)


class ProbabilisticPredictor:
    """Inference pipeline for one INFERENCE_MODE.

    Args:
        cfg: train config + inference config merged.
        image_size: network input (H, W) after resize and padding.
        state_dict: model weights in this package's (detectron2) names.
        device: torch device; None means CUDA.
        state_dicts: for the `ensembles` mode, one state dict per member,
            in the order of ENSEMBLES.RANDOM_SEED_NUMS (`state_dict` unused).
        placement: for the `ensembles` mode, the device of each member
            (``parallel.create_ensemble_placement``; default: every member
            on `device`). A member's model lives on its device, the images
            are copied to it, and its outputs come back to `device` before
            the cross-member merge. A placement of another length than the
            members raises.

    A call is a host prelude (``seeds.draw_call_seeds``) and the pure
    forward of `pipeline`, a ``PipelineModule``; the stages (`run_outputs`,
    `head_outputs`, `detect`, `detect_post_nms`) and the settings (`models`,
    `anchors`, `num_runs`, `post_nms`, `core_kwargs`, ...) are the
    pipeline's, reached through this object.

    On CUDA the constructor sets ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False, process-wide, so that
    float32 convolutions and products run in full float32 as on the CPU.
    ``SPLIT_HEAD_PROGRAM`` lays out XLA programs in the JAX package; here it
    changes nothing, but it is refused where the JAX package refuses it.
    ``HEAD_QUANT`` 'int8' runs the head's tower convs in int8
    (``ops/quant.py``); any value but 'none' and 'int8' raises ValueError.
    """

    def __init__(self, cfg, image_size: Sequence[int], state_dict=None, device=None,
                 state_dicts=None, placement=None):
        mode = cfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE
        if mode not in MODES:
            raise ValueError(f"Invalid inference mode {mode}.")
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if mode == "ensembles":
            if not state_dicts:
                raise ValueError("ensembles mode needs one state dict per member (state_dicts)")
            if placement is not None and len(placement) != len(state_dicts):
                raise ValueError(f"a placement of {len(placement)} devices for "
                                 f"{len(state_dicts)} ensemble members")
            member_devices = [torch.device(d) for d in placement or [device] * len(state_dicts)]
            models = [self._load(sd, d) for sd, d in zip(state_dicts, member_devices)]
        else:
            if state_dict is None:
                raise ValueError(f"{mode} needs the model's state_dict")
            if placement is not None:
                raise ValueError(f"a member placement is for the ensembles mode, not {mode}")
            member_devices = [device]
            models = [self._load(state_dict, device)]
        self.model = models[0]
        self.pipeline = PipelineModule(cfg, image_size, models, device, member_devices)

    def __getattr__(self, name):
        pipeline = self.__dict__.get("pipeline")
        if pipeline is None:
            raise AttributeError(name)
        return getattr(pipeline, name)

    def _load(self, state_dict, device):
        model = build_model(self.cfg, head_quant=self.cfg.PROBABILISTIC_INFERENCE.HEAD_QUANT)
        model.load_state_dict(state_dict)
        return model.cast_convs().to(device).eval()

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
                they never share numbers whatever the run and batch counts
                (``seeds.draw_call_seeds``).
        Returns:
            Batched Detections (leading batch axis) in original-image
            coordinates.
        """
        images = torch.as_tensor(images)
        with span("pod.seeds"):
            dropout_seeds, sampling_seeds = draw_call_seeds(
                generator, self.num_runs, self.num_convs, images.shape[0],
                self.num_runs if self.post_nms else 0)
            images = images.to(self.device, non_blocking=True)
        sizes = lambda s: torch.as_tensor(s, dtype=torch.float32, device=self.device)
        return self.pipeline(images, sizes(input_sizes), sizes(output_sizes), dropout_seeds,
                             sampling_seeds)


def build_predictor(cfg, image_size, state_dict=None, device=None,
                    state_dicts=None, placement=None) -> ProbabilisticPredictor:
    """Dispatch on the meta-architecture, as the JAX `build_predictor` does."""
    if cfg.MODEL.META_ARCHITECTURE in ("ProbabilisticRetinaNet", "RetinaNet"):
        return ProbabilisticPredictor(cfg, image_size, state_dict, device, state_dicts,
                                      placement)
    raise ValueError(f"Invalid meta-architecture {cfg.MODEL.META_ARCHITECTURE}.")
