"""Training loss assembly for the probabilistic RetinaNet.

Counterpart of ``pod_compare_tpu/train/loss.py``: the focal classification
loss, sampled from the predicted logit Gaussians under loss attenuation;
smooth-L1 box regression, or the diagonal (or full) Gaussian NLL,
second-moment matching or the energy score mixed in by the exponential
annealing schedule; and the EMA loss normalizer over the batch's
positive-anchor count. Ground truth comes padded with validity masks.
Everything stays on the device: nothing here reads a value back to the
host.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pod_compare_tpu_torch.ops import losses as L
from pod_compare_tpu_torch.ops.matcher import label_anchors_batch
from pod_compare_tpu_torch.parallel.mesh import BatchShard, all_reduce_sum
from pod_compare_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class LossConfig:
    num_classes: int
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 0.0
    iou_thresholds: Tuple[float, float] = (0.4, 0.5)
    cls_var_loss: str = "none"  # 'none' | 'loss_attenuation'
    cls_var_num_samples: int = 10
    cls_var_shared_batch: bool = False
    cls_var_impl: str = "threefry"  # 'threefry' | 'pallas' (the fused kernel)
    # 'none' | 'negative_log_likelihood' | 'second_moment_matching' | 'energy_loss'
    bbox_cov_loss: str = "none"
    bbox_cov_type: str = "diagonal"  # 'diagonal' | 'full'
    bbox_cov_num_samples: int = 1000  # the energy score's draws
    annealing_step: int = 80000
    loss_normalizer_momentum: float = 0.9
    box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)

    @classmethod
    def from_config(cls, cfg) -> "LossConfig":
        pm = cfg.MODEL.PROBABILISTIC_MODELING
        return cls(
            num_classes=cfg.MODEL.RETINANET.NUM_CLASSES,
            focal_alpha=cfg.MODEL.RETINANET.FOCAL_LOSS_ALPHA,
            focal_gamma=cfg.MODEL.RETINANET.FOCAL_LOSS_GAMMA,
            smooth_l1_beta=cfg.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA,
            iou_thresholds=tuple(cfg.MODEL.RETINANET.IOU_THRESHOLDS),
            cls_var_loss=pm.CLS_VAR_LOSS.NAME,
            cls_var_num_samples=pm.CLS_VAR_LOSS.NUM_SAMPLES,
            cls_var_shared_batch=pm.CLS_VAR_LOSS.SHARED_BATCH_SAMPLES,
            cls_var_impl=pm.CLS_VAR_LOSS.IMPL,
            bbox_cov_loss=pm.BBOX_COV_LOSS.NAME,
            bbox_cov_type=pm.BBOX_COV_LOSS.COVARIANCE_TYPE,
            bbox_cov_num_samples=pm.BBOX_COV_LOSS.NUM_SAMPLES,
            annealing_step=pm.ANNEALING_STEP or cfg.SOLVER.STEPS[1],
            loss_normalizer_momentum=cfg.MODEL.RETINANET.LOSS_NORMALIZER_MOMENTUM,
            box_reg_weights=tuple(cfg.MODEL.RETINANET.BBOX_REG_WEIGHTS),
        )


def encode_deltas(anchors, target_boxes, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Target boxes as (dx, dy, dw, dh) deltas relative to anchors."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = target_boxes[..., 2] - target_boxes[..., 0]
    gh = target_boxes[..., 3] - target_boxes[..., 1]
    gx = target_boxes[..., 0] + 0.5 * gw
    gy = target_boxes[..., 1] + 0.5 * gh
    wx, wy, ww, wh = weights
    return torch.stack(
        [wx * (gx - ax) / aw, wy * (gy - ay) / ah, ww * torch.log(gw / aw),
         wh * torch.log(gh / ah)], dim=-1,
    )


def box_seed(seed: int) -> int:
    """The energy score's generator seed from a step's int32 loss seed: in
    [2^32, 2^33), so never the seed the 'threefry' focal loss gives its own
    generator."""
    return (seed & 0xFFFFFFFF) + 2 ** 32


def compute_losses(
    outputs: Dict[str, Optional[torch.Tensor]],
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    loss_normalizer: torch.Tensor,
    step: int,
    lc: LossConfig,
    seed: int = 0,
    shard: Optional[BatchShard] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """{loss_cls, loss_box_reg, num_pos_anchors} and the updated normalizer.

    Args:
        outputs: head outputs (B, R, ·).
        anchors: (R, 4) anchors.
        gt_*: padded per-image ground truth, (B, G, 4), (B, G), (B, G).
        loss_normalizer: the EMA carry, a float32 tensor on the device.
        step: the iteration, for annealing.
        seed: int32 seed of the stochastic classification loss; the energy
            score draws from a generator on the device seeded with
            `box_seed(seed)`.
        shard: this process's rows of a data-parallel step's global batch
            (None: the batch is the whole). The positive count that feeds
            the normalizer is summed over the processes, as the JAX step's
            global sum, and the draws are the global batch's at these rows;
            each loss is then this process's share of the global loss
            (summed over the processes, the one-process loss), and
            ``num_pos_anchors`` the global count per global image. Collective
            when the shard is part of a larger batch.
    """
    with span("pod.matcher"):
        labels = label_anchors_batch(
            anchors, gt_boxes, gt_classes, gt_valid, lc.num_classes, lc.iou_thresholds
        )
    anchor_classes = labels.gt_classes  # (B, R)
    valid_mask = anchor_classes >= 0
    pos_mask = valid_mask & (anchor_classes != lc.num_classes)
    num_pos = pos_mask.sum().to(torch.float32)
    if shard is not None and not shard.whole:
        num_pos = all_reduce_sum(num_pos)

    new_normalizer = L.ema_loss_normalizer(
        loss_normalizer, num_pos, lc.loss_normalizer_momentum
    )
    norm = torch.clamp_min(new_normalizer, 1.0)

    # One-hot targets without a background column: background rows are all
    # zero, ignored anchors are masked by valid_mask.
    targets = F.one_hot(
        torch.clamp(anchor_classes, 0, lc.num_classes), lc.num_classes + 1
    )[..., :-1].to(torch.float32)

    logits = outputs["box_cls"]
    if lc.cls_var_loss == "loss_attenuation":
        if outputs["box_cls_var"] is None:
            raise ValueError("loss_attenuation requires the cls_var head")
        loss_cls = L.stochastic_focal_loss(
            logits, outputs["box_cls_var"], targets, valid_mask, lc.cls_var_num_samples, seed,
            lc.focal_alpha, lc.focal_gamma, shared_batch=lc.cls_var_shared_batch,
            impl=lc.cls_var_impl, shard=shard,
        ) / norm
    elif lc.cls_var_loss == "none":
        loss_cls = L.masked_sum_focal_loss(
            logits, targets, valid_mask, lc.focal_alpha, lc.focal_gamma
        ) / norm
    else:
        raise ValueError(f"Invalid classification loss name {lc.cls_var_loss}.")

    # Zero where the anchor is not positive: an image without ground truth
    # matches every anchor to an empty padding box, whose log-size delta is
    # -inf, and 0·inf in the NLL's backward would make the covariance head's
    # gradient NaN (the JAX package has that fault; ROADMAP §3).
    gt_deltas = encode_deltas(anchors[None], labels.matched_boxes, lc.box_reg_weights)
    gt_deltas = torch.where(pos_mask[..., None], gt_deltas, torch.zeros((), device=anchors.device))
    pred_deltas = outputs["box_delta"]
    standard_reg = L.masked_sum_smooth_l1(
        pred_deltas, gt_deltas, pos_mask, lc.smooth_l1_beta
    ) / norm
    if lc.bbox_cov_loss == "none":
        loss_box_reg = standard_reg
    elif lc.bbox_cov_loss in ("negative_log_likelihood", "second_moment_matching",
                              "energy_loss"):
        cov = outputs["box_reg_var"]
        if cov is None:
            raise ValueError(f"{lc.bbox_cov_loss} requires the bbox_cov head")
        if lc.bbox_cov_loss == "energy_loss":
            generator = torch.Generator(device=pred_deltas.device).manual_seed(box_seed(seed))
            prob = L.energy_score_box_loss(
                pred_deltas, gt_deltas, cov, pos_mask, lc.bbox_cov_num_samples,
                lc.smooth_l1_beta, generator=generator, shard=shard,
            )
        elif lc.bbox_cov_loss == "second_moment_matching":
            prob = L.second_moment_matching_box_loss(
                pred_deltas, gt_deltas, cov, pos_mask, lc.smooth_l1_beta
            )
        elif lc.bbox_cov_type == "full" and cov.shape[-1] == 10:
            prob = L.mvn_nll_box_loss(pred_deltas, gt_deltas, cov, pos_mask)
        else:
            prob = L.nll_box_loss(
                pred_deltas, gt_deltas, cov[..., 0:4], pos_mask, lc.smooth_l1_beta
            )
        w = L.annealing_weight(step, lc.annealing_step)  # a CPU scalar: no copy
        loss_box_reg = (1.0 - w) * standard_reg + w * (prob / norm)
    else:
        raise ValueError(f"Invalid regression loss name {lc.bbox_cov_loss}.")

    losses = {
        "loss_cls": loss_cls,
        "loss_box_reg": loss_box_reg,
        "num_pos_anchors": num_pos / (gt_boxes.shape[0] if shard is None else shard.total),
    }
    return losses, new_normalizer
