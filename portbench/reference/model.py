"""Plain RetinaNet-R50-FPN with the probabilistic head, in float32.

Written from the architecture (detectron2's RetinaNet as the paper's
configs build it: caffe-style bottlenecks with the stride in the 1x1,
FrozenBN, FPN over res3-res5 with P6/P7 from res5, a shared head of four
256-channel convs per tower, ReLU and dropout after each tower conv) on a
state dict in detectron2's names. Every convolution runs in float32, with
TF32 off (``strict_float32``). Nothing here imports the program.

``conv`` can round its input and weight through a quantizer (``fp8``): the
benchmark's control computes the same convolutions in float8, e4m3 forward
and e5m2 gradients, with per-tensor scales.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.nn import functional as F

from portbench.reference import bits

RESNET_BLOCKS = (("res2", 3, 64, 256, 1), ("res3", 4, 128, 512, 2),
                 ("res4", 6, 256, 1024, 2), ("res5", 3, 512, 2048, 2))
PIXEL_MEAN = (103.530, 116.280, 123.675)


def strict_float32() -> None:
    """Full float32 in convolutions and products (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 `dtype` under a per-tensor scale that maps
    its largest magnitude to the format's largest (`top`), in float32."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Forward values in e4m3, the gradient that flows back in e5m2: the
    formats of float8 training."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x in float8: e4m3 forward, e5m2 gradient, per-tensor scales."""
    return _Fp8.apply(x)



Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def conv(x, sd, name, stride=1, padding=0, quant: Quant = None):
    w = sd[name + ".weight"]
    b = sd.get(name + ".bias")
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, padding)


def frozen_bn(x, sd, name, eps=1e-5):
    mul = sd[name + ".weight"] * torch.rsqrt(sd[name + ".running_var"] + eps)
    add = sd[name + ".bias"] - sd[name + ".running_mean"] * mul
    return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


def conv_bn(x, sd, name, stride=1, padding=0, quant: Quant = None):
    return frozen_bn(conv(x, sd, name, stride, padding, quant), sd, name + ".norm")


def resnet(sd, x, quant: Quant = None) -> Dict[str, torch.Tensor]:
    p = "backbone.bottom_up."
    x = F.relu(conv_bn(x, sd, p + "stem.conv1", 2, 3, quant))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for stage, blocks, _, _, stride in RESNET_BLOCKS:
        for b in range(blocks):
            name = f"{p}{stage}.{b}"
            s = stride if b == 0 else 1
            short = conv_bn(x, sd, name + ".shortcut", s, 0, quant) if b == 0 else x
            y = F.relu(conv_bn(x, sd, name + ".conv1", s, 0, quant))
            y = F.relu(conv_bn(y, sd, name + ".conv2", 1, 1, quant))
            x = F.relu(conv_bn(y, sd, name + ".conv3", 1, 0, quant) + short)
        out[stage] = x
    return out


def fpn(sd, images, quant: Quant = None) -> List[torch.Tensor]:
    """(N, H, W, 3) raw BGR pixels -> [P3, ..., P7], NCHW float32."""
    x = images.float() - torch.tensor(PIXEL_MEAN, device=images.device)
    feats = resnet(sd, x.permute(0, 3, 1, 2).contiguous(), quant)
    p = "backbone."
    merged, prev = {}, None
    for lvl in ("5", "4", "3"):
        cur = conv(feats["res" + lvl], sd, p + "fpn_lateral" + lvl, quant=quant)
        if prev is not None:
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            cur = cur + up[:, :, :cur.shape[2], :cur.shape[3]]
        merged[lvl] = prev = cur
    outs = [conv(merged[lvl], sd, p + "fpn_output" + lvl, 1, 1, quant) for lvl in "345"]
    p6 = conv(feats["res5"], sd, p + "top_block.p6", 2, 1, quant)
    p7 = conv(F.relu(p6), sd, p + "top_block.p7", 2, 1, quant)
    return outs + [p6, p7]


TOWERS = ("cls_subnet", "bbox_subnet")


def tower_conv(sd, x, tower: int, layer: int, quant: Quant = None):
    return conv(x, sd, f"head.{TOWERS[tower]}.{2 * layer}", 1, 1, quant)


def head_prefix(sd, feats, quant: Quant = None):
    """Conv 0 of both towers at every level, before its ReLU."""
    return [[tower_conv(sd, f, t, 0, quant) for f in feats] for t in range(2)]


class Masks:
    """ReLU then dropout after each tower conv, one mask draw per (tower,
    layer) over the levels from `seeds[tower][layer]` (K1's bits)."""

    def __init__(self, seeds, rate: float, batch_shared: bool):
        self.seeds, self.rate, self.batch_shared = seeds, rate, batch_shared

    def __call__(self, xs, tower: int, layer: int):
        seed = int(self.seeds[tower][layer])
        offsets = bits.level_offsets([x.shape for x in xs], self.batch_shared)
        scale = bits.keep_scale(self.rate)
        out = []
        for x, off in zip(xs, offsets):
            keep = bits.keep_nchw(x.shape, off, seed, self.rate, self.batch_shared, x.device)
            out.append(torch.where(keep & (x > 0), x * scale, torch.zeros((), device=x.device)))
        return out


def _relu(xs, tower, layer):
    return [F.relu(x) for x in xs]


def head_rest(sd, prefix, num_convs: int, num_classes: int, num_anchors: int = 9,
              act=None, quant: Quant = None) -> Dict[str, Optional[torch.Tensor]]:
    """Towers after conv 0 and the output convs: (N, H*W*A, k) outputs
    concatenated over the levels, in the order (y, x, anchor)."""
    act = act or _relu
    feats = []
    for t in range(2):
        xs = act(list(prefix[t]), t, 0)
        for layer in range(1, num_convs):
            xs = act([tower_conv(sd, x, t, layer, quant) for x in xs], t, layer)
        feats.append(xs)

    def flat(x, k):
        n, _, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(n, h * w * num_anchors, k)

    outs = {"box_cls": [], "box_delta": [], "box_cls_var": [], "box_reg_var": []}
    for c, b in zip(*feats):
        outs["box_cls"].append(flat(conv(c, sd, "head.cls_score", 1, 1, quant), num_classes))
        outs["box_delta"].append(flat(conv(b, sd, "head.bbox_pred", 1, 1, quant), 4))
        if "head.cls_var.weight" in sd:
            outs["box_cls_var"].append(flat(conv(c, sd, "head.cls_var", 1, 1, quant),
                                            num_classes))
        if "head.bbox_cov.weight" in sd:
            dims = sd["head.bbox_cov.weight"].shape[0] // num_anchors
            outs["box_reg_var"].append(flat(conv(b, sd, "head.bbox_cov", 1, 1, quant), dims))
    return {k: torch.cat(v, dim=1) if v else None for k, v in outs.items()}


def forward(sd, images, num_convs: int, num_classes: int, act=None, quant: Quant = None):
    """One head pass over raw images: the anchorwise outputs."""
    feats = fpn(sd, images, quant)
    return head_rest(sd, head_prefix(sd, feats, quant), num_convs, num_classes, act=act,
                     quant=quant)


def mc_outputs(sd, image, seeds, rate: float, num_convs: int, num_classes: int,
               quant: Quant = None):
    """The MC-dropout bank of one image (1, H, W, 3): the backbone and
    conv 0 once, then one pass per run with batch-shared masks from
    seeds[run]. Returns the mean outputs and the (M, 1, R, 4) deltas."""
    with torch.no_grad():
        feats = fpn(sd, image, quant)
        prefix = head_prefix(sd, feats, quant)
        runs = [head_rest(sd, prefix, num_convs, num_classes,
                          act=Masks(s, rate, batch_shared=True), quant=quant) for s in seeds]
    mean = {k: None if runs[0][k] is None else torch.stack([r[k] for r in runs]).mean(dim=0)
            for k in runs[0]}
    return mean, torch.stack([r["box_delta"] for r in runs])


def single_outputs(sd, image, num_convs: int, num_classes: int, quant: Quant = None):
    with torch.no_grad():
        return forward(sd, image, num_convs, num_classes, quant=quant)


def parameter_shapes(num_classes: int, num_anchors: int = 9, num_convs: int = 4,
                     cls_var: bool = True, bbox_cov_dims: int = 4) -> Dict[str, tuple]:
    """Every tensor of the model's state dict with its shape, in
    detectron2's names (FrozenBN as weight, bias, running_mean and
    running_var)."""
    shapes = {}

    def conv_bn_shapes(name, cout, cin, k):
        shapes[name + ".weight"] = (cout, cin, k, k)
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.norm.{t}"] = (cout,)

    p = "backbone.bottom_up."
    conv_bn_shapes(p + "stem.conv1", 64, 3, 7)
    cin = 64
    for stage, blocks, mid, out, _ in RESNET_BLOCKS:
        for b in range(blocks):
            name = f"{p}{stage}.{b}"
            if b == 0:
                conv_bn_shapes(name + ".shortcut", out, cin, 1)
            conv_bn_shapes(name + ".conv1", mid, cin, 1)
            conv_bn_shapes(name + ".conv2", mid, mid, 3)
            conv_bn_shapes(name + ".conv3", out, mid, 1)
            cin = out
    for lvl, c in (("3", 512), ("4", 1024), ("5", 2048)):
        shapes[f"backbone.fpn_lateral{lvl}.weight"] = (256, c, 1, 1)
        shapes[f"backbone.fpn_lateral{lvl}.bias"] = (256,)
        shapes[f"backbone.fpn_output{lvl}.weight"] = (256, 256, 3, 3)
        shapes[f"backbone.fpn_output{lvl}.bias"] = (256,)
    shapes["backbone.top_block.p6.weight"] = (256, 2048, 3, 3)
    shapes["backbone.top_block.p6.bias"] = (256,)
    shapes["backbone.top_block.p7.weight"] = (256, 256, 3, 3)
    shapes["backbone.top_block.p7.bias"] = (256,)
    for tower in TOWERS:
        for i in range(num_convs):
            shapes[f"head.{tower}.{2 * i}.weight"] = (256, 256, 3, 3)
            shapes[f"head.{tower}.{2 * i}.bias"] = (256,)
    outs = {"cls_score": num_anchors * num_classes, "bbox_pred": num_anchors * 4}
    if cls_var:
        outs["cls_var"] = num_anchors * num_classes
    if bbox_cov_dims:
        outs["bbox_cov"] = num_anchors * bbox_cov_dims
    for name, cout in outs.items():
        shapes[f"head.{name}.weight"] = (cout, 256, 3, 3)
        shapes[f"head.{name}.bias"] = (cout,)
    return shapes


def trainable(name: str) -> bool:
    """FREEZE_AT 2: the stem and res2 are frozen; FrozenBN never trains."""
    if ".norm." in name:
        return False
    return not (name.startswith("backbone.bottom_up.stem.")
                or name.startswith("backbone.bottom_up.res2."))

