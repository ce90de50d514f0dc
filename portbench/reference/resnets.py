"""Plain RetinaNet on a ResNet or ResNeXt of any depth, and its training
steps, in float32.

The backbone is written from the architecture: Xie et al., "Aggregated
Residual Transformations for Deep Neural Networks" (arXiv 1611.05431), as
detectron2 builds it from MODEL.RESNETS (DEPTH, NUM_GROUPS, WIDTH_PER_GROUP,
STRIDE_IN_1X1) and MODEL.PIXEL_MEAN/PIXEL_STD. A bottleneck is

    y = relu(x + BN(conv1x1(relu(BN(conv3x3_g(relu(BN(conv1x1(x)))))))))

with the first 1x1 from `cin` to `mid`, the 3x3 in `num_groups` groups and
the last 1x1 from `mid` to `cout`; `mid` is num_groups * width_per_group at
res2 and doubles each stage, `cout` is 256 at res2 and doubles; the stride
sits in the first 1x1 (`stride_in_1x1`, caffe-style) or in the 3x3; the
shortcut is a 1x1 projection where the shape changes. Departures from the
paper, all detectron2's: BatchNorm is frozen (FrozenBN: a per-channel
multiply-add from the state dict), the stem is one 7x7/2 conv and a 3x3/2
max pool, and FREEZE_AT 2 trains neither the stem nor res2. At (50, 1, 64,
True) and PIXEL_STD 1 this is ``model.py``'s R50 to the bit.

The FPN (P3-P5 from res3-res5, P6/P7 from res5), the probabilistic head,
K1's masks, the losses and SGD are ``model.py``'s and ``train.py``'s; the
training steps here take a batch in chunks of images, so that the float32
backward of a deep backbone at batch 16 fits the card: the labels, the
loss normaliser, the focal normals and the dropout masks are the whole
batch's, each chunk's loss is its share of the batch's (divided by the
batch's normaliser), and its gradients are summed into the batch's. Every
convolution runs in float32, with TF32 off. Nothing here imports the
program.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from portbench.reference import bits, detect, model, train

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


@dataclass(frozen=True)
class Backbone:
    depth: int = 50
    num_groups: int = 1
    width_per_group: int = 64
    stride_in_1x1: bool = True
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @classmethod
    def of(cls, m: dict) -> "Backbone":
        """From a configuration file's `model` (R50's keys where absent)."""
        return cls(int(m.get("depth", 50)), int(m.get("num_groups", 1)),
                   int(m.get("width_per_group", 64)), bool(m.get("stride_in_1x1", True)),
                   tuple(float(s) for s in m.get("pixel_std", (1.0, 1.0, 1.0))))

    def stages(self):
        """(name, blocks, mid, cout, stride) of res2-res5."""
        mid = self.num_groups * self.width_per_group
        return [(f"res{i + 2}", n, mid * 2 ** i, 256 * 2 ** i, 1 if i == 0 else 2)
                for i, n in enumerate(STAGES[self.depth])]


def conv(x, sd, name, stride=1, padding=0, groups=1, quant: model.Quant = None):
    w = sd[name + ".weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, sd.get(name + ".bias"), stride, padding, 1, groups)


def conv_bn(x, sd, name, stride=1, padding=0, groups=1, quant: model.Quant = None):
    return model.frozen_bn(conv(x, sd, name, stride, padding, groups, quant), sd, name + ".norm")


def resnet(sd, x, arch: Backbone, quant: model.Quant = None) -> Dict[str, torch.Tensor]:
    p = "backbone.bottom_up."
    x = F.relu(conv_bn(x, sd, p + "stem.conv1", 2, 3, quant=quant))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for stage, blocks, _, _, stride in arch.stages():
        for b in range(blocks):
            name = f"{p}{stage}.{b}"
            s = stride if b == 0 else 1
            s1, s3 = (s, 1) if arch.stride_in_1x1 else (1, s)
            short = conv_bn(x, sd, name + ".shortcut", s, 0, quant=quant) if b == 0 else x
            y = F.relu(conv_bn(x, sd, name + ".conv1", s1, 0, quant=quant))
            y = F.relu(conv_bn(y, sd, name + ".conv2", s3, 1, arch.num_groups, quant))
            x = F.relu(conv_bn(y, sd, name + ".conv3", 1, 0, quant=quant) + short)
        out[stage] = x
    return out


def fpn(sd, images, arch: Backbone, quant: model.Quant = None):
    """(N, H, W, 3) raw BGR pixels -> [P3, ..., P7], NCHW float32."""
    dev = images.device
    x = (images.float() - torch.tensor(model.PIXEL_MEAN, device=dev)) / \
        torch.tensor(arch.pixel_std, device=dev)
    feats = resnet(sd, x.permute(0, 3, 1, 2).contiguous(), arch, quant)
    p = "backbone."
    merged, prev = {}, None
    for lvl in ("5", "4", "3"):
        cur = model.conv(feats["res" + lvl], sd, p + "fpn_lateral" + lvl, quant=quant)
        if prev is not None:
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            cur = cur + up[:, :, :cur.shape[2], :cur.shape[3]]
        merged[lvl] = prev = cur
    outs = [model.conv(merged[lvl], sd, p + "fpn_output" + lvl, 1, 1, quant) for lvl in "345"]
    p6 = model.conv(feats["res5"], sd, p + "top_block.p6", 2, 1, quant)
    p7 = model.conv(F.relu(p6), sd, p + "top_block.p7", 2, 1, quant)
    return outs + [p6, p7]


def forward(sd, images, arch: Backbone, num_convs: int, num_classes: int, act=None,
            quant: model.Quant = None):
    """One head pass over raw images: the anchorwise outputs."""
    feats = fpn(sd, images, arch, quant)
    return model.head_rest(sd, model.head_prefix(sd, feats, quant), num_convs, num_classes,
                           act=act, quant=quant)


def parameter_shapes(arch: Backbone, num_classes: int, num_anchors: int = 9, num_convs: int = 4,
                     cls_var: bool = True, bbox_cov_dims: int = 4) -> Dict[str, tuple]:
    """Every tensor of the model's state dict with its shape, in
    detectron2's names: ``model.py``'s FPN and head on this backbone."""
    shapes = {}
    p = "backbone.bottom_up."

    def conv_bn_shapes(name, cout, cin_per_group, k):
        shapes[name + ".weight"] = (cout, cin_per_group, k, k)
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.norm.{t}"] = (cout,)

    conv_bn_shapes(p + "stem.conv1", 64, 3, 7)
    cin = 64
    for stage, blocks, mid, out, _ in arch.stages():
        for b in range(blocks):
            name = f"{p}{stage}.{b}"
            if b == 0:
                conv_bn_shapes(name + ".shortcut", out, cin, 1)
            conv_bn_shapes(name + ".conv1", mid, cin, 1)
            conv_bn_shapes(name + ".conv2", mid, mid // arch.num_groups, 3)
            conv_bn_shapes(name + ".conv3", out, mid, 1)
            cin = out
    rest = model.parameter_shapes(num_classes, num_anchors, num_convs, cls_var, bbox_cov_dims)
    shapes.update((k, v) for k, v in rest.items() if not k.startswith(p))
    return shapes


class RowMasks(model.Masks):
    """``model.Masks`` of the rows [first, first + n) of a batch of `total`
    images: the same stream indices the whole batch's per-sample draw
    gives those rows."""

    def __init__(self, seeds, rate: float, first: int, total: int):
        super().__init__(seeds, rate, batch_shared=False)
        self.first, self.total = first, total

    def __call__(self, xs, tower: int, layer: int):
        seed = int(self.seeds[tower][layer])
        whole = [(self.total,) + tuple(x.shape[1:]) for x in xs]
        scale = bits.keep_scale(self.rate)
        out = []
        for x, off in zip(xs, bits.level_offsets(whole, False)):
            n, c, h, w = x.shape
            keep = bits.keep_mask(n * h * w * c, off + self.first * h * w * c, seed, self.rate,
                                  x.device).reshape(n, h, w, c).permute(0, 3, 1, 2)
            out.append(torch.where(keep & (x > 0), x * scale, torch.zeros((), device=x.device)))
        return out


def _chunk_losses(outs, anc, cls, matched, norm, z, step: int, sv: train.Solver):
    """Chunk's shares of ``train.losses``' loss_cls and loss_box_reg, with
    the batch's labels `cls`/`matched` at its rows, the batch's normaliser
    and the batch's focal normals `z` at its rows."""
    valid = cls >= 0
    pos = valid & (cls != sv.num_classes)
    targets = F.one_hot(torch.clamp(cls, 0, sv.num_classes),
                        sv.num_classes + 1)[..., :-1].to(torch.float32)
    x, s = outs["box_cls"], outs["box_cls_var"]
    if s is not None:
        std = torch.exp(0.5 * torch.clamp(s, -10.0, 10.0))
        elem = train.focal(x[None] + std[None] * z, targets[None], sv.focal_alpha,
                           sv.focal_gamma).mean(dim=0)
    else:
        elem = train.focal(x, targets, sv.focal_alpha, sv.focal_gamma)
    loss_cls = train._masked(elem, valid) / norm
    gt = torch.where(pos[..., None], train.encode(anc[None], matched),
                     torch.zeros((), device=anc.device))
    l1 = (outs["box_delta"] - gt).abs()
    standard = train._masked(l1, pos) / norm
    if outs["box_reg_var"] is not None:
        sc = torch.clamp(outs["box_reg_var"][..., 0:4], -7.0, 7.0)
        nll = train._masked(0.5 * torch.exp(-sc) * l1 + 0.5 * sc, pos)
        w = min(step / float(max(sv.annealing_step, 1)), 1.0)
        w = (torch.pow(torch.tensor(100.0), torch.tensor(w, dtype=torch.float32)) - 1.0) / 99.0
        loss_box = (1.0 - w.to(anc.device)) * standard + w.to(anc.device) * (nll / norm)
    else:
        loss_box = standard
    return loss_cls, loss_box


def run_steps(sd: Dict[str, torch.Tensor], batches: Sequence[dict], generator_seed: int,
              steps: int, sv: train.Solver, canvas, arch: Backbone,
              quant: model.Quant = None, half_batch: bool = False,
              chunk: Optional[int] = None) -> train.Readings:
    """``train.run_steps`` on this backbone, each batch's forward and
    backward taken `chunk` images at a time (the whole batch at once when
    None). The seeds, faults and readings are ``train.run_steps``'."""
    model.strict_float32()
    device = next(iter(sd.values())).device
    params = {k: v.detach().clone().requires_grad_(model.trainable(k)) for k, v in sd.items()}
    first = {k: v.detach().clone() for k, v in params.items() if v.requires_grad}
    leaves = list(first)
    anc = torch.as_tensor(detect.anchors(canvas)[0], device=device)
    generator = torch.Generator().manual_seed(generator_seed)
    normalizer = torch.tensor(100.0, device=device)
    momentum: Dict[str, torch.Tensor] = {}
    readings = train.Readings([], {}, {})
    k = sv.num_classes
    for step in range(steps):
        seeds, loss_seed = bits.step_seeds(generator, sv.num_convs)
        batch = batches[step]
        if half_batch:
            batch = {key: v[: v.shape[0] // 2] for key, v in batch.items()}
        n = batch["images"].shape[0]
        with torch.no_grad():
            labels = [train.label_anchors(anc, b, c, v, k, sv.iou_thresholds)
                      for b, c, v in zip(batch["gt_boxes"], batch["gt_classes"],
                                         batch["gt_valid"])]
            cls = torch.stack([lab[0] for lab in labels])
            matched = torch.stack([lab[1] for lab in labels])
            num_pos = ((cls >= 0) & (cls != k)).sum().to(torch.float32)
            new_norm = sv.normalizer_momentum * normalizer + \
                (1.0 - sv.normalizer_momentum) * torch.clamp_min(num_pos, 1.0)
            norm = torch.clamp_min(new_norm, 1.0)
            z = bits.focal_normals(n * anc.shape[0] * k, loss_seed, sv.cls_samples,
                                   device).reshape(sv.cls_samples, n, anc.shape[0], k)
        grads = [torch.zeros_like(params[key]) for key in leaves]
        loss_cls = loss_box = 0.0
        step_chunk = chunk or n
        for a in range(0, n, step_chunk):
            rows = slice(a, min(a + step_chunk, n))
            act = RowMasks(seeds, sv.dropout_rate, a, n) if sv.dropout_rate > 0 else None
            outs = forward(params, batch["images"][rows], arch, sv.num_convs, k, act=act,
                           quant=quant)
            parts = _chunk_losses(outs, anc, cls[rows], matched[rows], norm, z[:, rows], step, sv)
            for g, dg in zip(grads, torch.autograd.grad(parts[0] + parts[1],
                                                        [params[key] for key in leaves])):
                g.add_(dg)
            loss_cls = loss_cls + parts[0].detach()
            loss_box = loss_box + parts[1].detach()
            del outs, parts
        total = loss_cls + loss_box
        readings.losses.append({"loss_cls": float(loss_cls), "loss_box_reg": float(loss_box),
                                "total_loss": float(total)})
        lr = sv.lr(step)
        with torch.no_grad():
            for key, g in zip(leaves, grads):
                p = params[key]
                d = g + sv.weight_decay * p
                buf = momentum.get(key)
                buf = d.clone() if buf is None else buf.mul_(sv.momentum).add_(d)
                momentum[key] = buf
                if step == 0:
                    readings.grad_norms[key] = float(torch.linalg.vector_norm(buf))
                p.sub_(lr * buf)
        normalizer = new_norm.detach()
        del grads, z
    with torch.no_grad():
        readings.update_norms = {key: float(torch.linalg.vector_norm(params[key] - first[key]))
                                 for key in first}
    return readings
