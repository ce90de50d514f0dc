"""Plain training steps of the probabilistic RetinaNet, in float32.

Frozen copies, at commit b304412 of this repository, of the training
mathematics of ``pod_compare_tpu_torch``: ``ops/matcher.py`` (interval
labels on the best IoU, low-quality matches forced positive),
``train/loss.py`` and ``ops/losses.py`` (the loss-attenuation focal loss
averaged over S draws of N(logit, exp(clip(s, +-10))) with K2's normals,
L1 box regression annealed into the diagonal Gaussian NLL, the EMA loss
normalizer), ``train/optim.py`` (SGD with momentum 0.9, no dampening,
weight decay on every trainable tensor, detectron2's warm-up schedule) and
``train/trainer.py`` (the seeds a step draws). The gradients come from
autograd through the plain forward of ``model.py``; nothing here imports
the program.
"""

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import bits, detect, model


@dataclass
class Solver:
    num_classes: int
    base_lr: float
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_factor: float = 1.0 / 1000
    warmup_iters: int = 1000
    steps: Sequence[int] = (60000, 80000)
    gamma: float = 0.1
    num_convs: int = 4
    dropout_rate: float = 0.0
    cls_samples: int = 10
    annealing_step: int = 80000
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    iou_thresholds: Sequence[float] = (0.4, 0.5)
    normalizer_momentum: float = 0.9

    def lr(self, step: int) -> float:
        warm = 1.0
        if step < self.warmup_iters:
            alpha = step / self.warmup_iters
            warm = self.warmup_factor * (1.0 - alpha) + alpha
        decay = 1.0
        for s in self.steps:
            if step >= s:
                decay *= self.gamma
        return self.base_lr * warm * decay


def label_anchors(anc, gt_boxes, gt_classes, gt_valid, num_classes, thresholds):
    """Per-anchor class (K for background, -1 ignored) and matched box."""
    lo, hi = thresholds
    iou = detect.pairwise_iou(gt_boxes, anc)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    idx = torch.argmax(iou, dim=0)
    best = iou.gather(0, idx[None])[0]
    label = torch.where(best >= hi, 1, torch.where(best >= lo, -1, 0))
    per_gt = iou.max(dim=1).values
    forced = ((iou == per_gt[:, None]) & (per_gt > 0)[:, None] & gt_valid[:, None]).any(dim=0)
    label = torch.where(forced, 1, label)
    cls = gt_classes.long()[idx]
    return torch.where(label == 1, cls, torch.where(label == 0, num_classes, -1)), gt_boxes[idx]


def encode(anc, boxes):
    aw = anc[..., 2] - anc[..., 0]
    ah = anc[..., 3] - anc[..., 1]
    ax = anc[..., 0] + 0.5 * aw
    ay = anc[..., 1] + 0.5 * ah
    gw = boxes[..., 2] - boxes[..., 0]
    gh = boxes[..., 3] - boxes[..., 1]
    gx = boxes[..., 0] + 0.5 * gw
    gy = boxes[..., 1] + 0.5 * gh
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                        torch.log(gh / ah)], dim=-1)


def focal(y, t, alpha, gamma):
    p = torch.sigmoid(y)
    ce = torch.clamp_min(y, 0.0) - y * t + torch.log1p(torch.exp(-y.abs()))
    q = (t - p).abs()
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    return alpha_t * ce * q ** gamma


def _masked(loss, mask):
    while mask.dim() < loss.dim():
        mask = mask[..., None]
    return torch.where(mask, loss, torch.zeros((), dtype=loss.dtype, device=loss.device)).sum()


def losses(outs, anc, batch, normalizer, step: int, loss_seed: int, sv: Solver):
    """{loss_cls, loss_box_reg} and the new normalizer of one forward."""
    labels = [label_anchors(anc, b, c, v, sv.num_classes, sv.iou_thresholds)
              for b, c, v in zip(batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"])]
    cls = torch.stack([lab[0] for lab in labels])
    matched = torch.stack([lab[1] for lab in labels])
    valid = cls >= 0
    pos = valid & (cls != sv.num_classes)
    num_pos = pos.sum().to(torch.float32)
    new_norm = sv.normalizer_momentum * normalizer + (1.0 - sv.normalizer_momentum) * \
        torch.clamp_min(num_pos, 1.0)
    norm = torch.clamp_min(new_norm, 1.0)
    targets = F.one_hot(torch.clamp(cls, 0, sv.num_classes),
                        sv.num_classes + 1)[..., :-1].to(torch.float32)
    x, s = outs["box_cls"], outs["box_cls_var"]
    if s is not None:
        z = bits.focal_normals(x.numel(), loss_seed, sv.cls_samples, x.device).reshape(
            (sv.cls_samples,) + tuple(x.shape))
        std = torch.exp(0.5 * torch.clamp(s, -10.0, 10.0))
        elem = focal(x[None] + std[None] * z, targets[None], sv.focal_alpha,
                     sv.focal_gamma).mean(dim=0)
    else:
        elem = focal(x, targets, sv.focal_alpha, sv.focal_gamma)
    loss_cls = _masked(elem, valid) / norm
    gt = torch.where(pos[..., None], encode(anc[None], matched),
                     torch.zeros((), device=anc.device))
    pred = outs["box_delta"]
    l1 = (pred - gt).abs()
    standard = _masked(l1, pos) / norm
    if outs["box_reg_var"] is not None:
        sc = torch.clamp(outs["box_reg_var"][..., 0:4], -7.0, 7.0)
        nll = _masked(0.5 * torch.exp(-sc) * l1 + 0.5 * sc, pos)
        w = min(step / float(max(sv.annealing_step, 1)), 1.0)
        w = (torch.pow(torch.tensor(100.0), torch.tensor(w, dtype=torch.float32)) - 1.0) / 99.0
        loss_box = (1.0 - w.to(anc.device)) * standard + w.to(anc.device) * (nll / norm)
    else:
        loss_box = standard
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}, new_norm


@dataclass
class Readings:
    losses: List[Dict[str, float]]  # per step: loss_cls, loss_box_reg, total_loss
    grad_norms: Dict[str, float]  # per trainable leaf: |g + wd p| of step 1
    update_norms: Dict[str, float]  # per trainable leaf: |p_after - p_before|


def run_steps(sd: Dict[str, torch.Tensor], batches, generator_seed: int, steps: int, sv: Solver,
              canvas, quant: model.Quant = None, half_batch: bool = False) -> Readings:
    """`steps` SGD steps from the weights `sd` on `batches` (dicts of
    images, gt_boxes, gt_classes, gt_valid on the device), with each
    step's seeds drawn as the program's train step draws them from a host
    generator seeded with `generator_seed`. `quant` computes
    the convolutions in a lower precision (the control); `half_batch`
    plants a fault: the step sees only the first half of each batch."""
    model.strict_float32()
    device = next(iter(sd.values())).device
    params = {k: v.detach().clone().requires_grad_(model.trainable(k)) for k, v in sd.items()}
    first = {k: v.detach().clone() for k, v in params.items() if v.requires_grad}
    anc = torch.as_tensor(detect.anchors(canvas)[0], device=device)
    generator = torch.Generator().manual_seed(generator_seed)
    normalizer = torch.tensor(100.0, device=device)
    momentum: Dict[str, torch.Tensor] = {}
    readings = Readings([], {}, {})
    num_classes = sv.num_classes
    for step in range(steps):
        seeds, loss_seed = bits.step_seeds(generator, sv.num_convs)
        batch = batches[step]
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        act = model.Masks(seeds, sv.dropout_rate, batch_shared=False) \
            if sv.dropout_rate > 0 else None
        outs = model.forward(params, batch["images"], sv.num_convs, num_classes, act=act,
                             quant=quant)
        parts, new_norm = losses(outs, anc, batch, normalizer, step, loss_seed, sv)
        total = parts["loss_cls"] + parts["loss_box_reg"]
        leaves = [k for k, v in params.items() if v.requires_grad]
        grads = torch.autograd.grad(total, [params[k] for k in leaves])
        readings.losses.append({k: float(v.detach()) for k, v in parts.items()} |
                               {"total_loss": float(total.detach())})
        lr = sv.lr(step)
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                p = params[k]
                d = g + sv.weight_decay * p
                buf = momentum.get(k)
                buf = d.clone() if buf is None else buf.mul_(sv.momentum).add_(d)
                momentum[k] = buf
                if step == 0:
                    readings.grad_norms[k] = float(torch.linalg.vector_norm(buf))
                p.sub_(lr * buf)
        normalizer = new_norm.detach()
        del outs, parts, total, grads
    with torch.no_grad():
        readings.update_norms = {k: float(torch.linalg.vector_norm(params[k] - first[k]))
                                 for k in first}
    return readings
