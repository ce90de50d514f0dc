"""Plain ResNeXt-FPN RetinaNet with the probabilistic head, in float32.

The tests' reference for ``pod_compare_tpu_torch``'s backbone of any depth,
groups and width (``models/resnet.py``), written from the architecture:
Xie et al., "Aggregated Residual Transformations for Deep Neural Networks"
(CVPR 2017, arXiv 1611.05431), in detectron2's names and as detectron2
builds it from MODEL.RESNETS. A bottleneck is

    y = relu(x + BN(conv1x1(relu(BN(conv3x3_g(relu(BN(conv1x1(x)))))))))

the first 1x1 from `cin` to `mid`, the 3x3 in `num_groups` groups (the
paper's form (c), Fig. 3), the last 1x1 from `mid` to `cout`; `mid` is
num_groups * width_per_group at res2 and doubles each stage (32x8d: 256,
512, 1024, 2048), `cout` is 256 at res2 and doubles; blocks per stage
(3, 4, 6, 3) at depth 50, (3, 4, 23, 3) at 101, (3, 8, 36, 3) at 152; a
stage's stride in the 3x3 (the paper's and torchvision's placement) or,
with `stride_in_1x1`, in the first 1x1 (MSRA's caffe weights); a 1x1
projection shortcut where the shape changes.

Departures from the paper, all detectron2's:
  - BatchNorm is frozen (FrozenBN, eps 1e-5): a per-channel multiply-add
    from the state dict, never a batch statistic;
  - the stem is one 7x7/2 conv, FrozenBN, ReLU and a 3x3/2 max pool;
  - inputs are raw BGR pixels less PIXEL_MEAN over PIXEL_STD, not RGB;
  - FREEZE_AT 2: the stem and res2 are not trained (``trainable``).
The rest is RetinaNet (Lin et al., arXiv 1708.02002) as the paper's configs
build it and as ``portbench/reference/model.py`` writes it: FPN laterals
and nearest 2x top-down sums over res3-res5, P6/P7 by stride-2 3x3s from
res5 (P7 after a ReLU), a head of `num_convs` 256-channel 3x3s per tower
shared over the levels, with ReLU (and, given an `act`, dropout) after each,
and the class logits, deltas, class log-variances and box covariance
outputs as (N, H*W*A, k), levels concatenated in (y, x, anchor) order.

Plain ``torch`` operations only; it imports neither package nor JAX.
``strict_float32`` turns TF32 off for products and cuDNN.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
PIXEL_MEAN = (103.530, 116.280, 123.675)
TOWERS = ("cls_subnet", "bbox_subnet")


@dataclass(frozen=True)
class Arch:
    depth: int = 50
    num_groups: int = 1
    width_per_group: int = 64
    stride_in_1x1: bool = True
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def stages(self):
        """(name, blocks, mid, cout, stride) of res2-res5."""
        mid = self.num_groups * self.width_per_group
        return [(f"res{i + 2}", n, mid * 2 ** i, 256 * 2 ** i, 1 if i == 0 else 2)
                for i, n in enumerate(STAGES[self.depth])]


R50 = Arch()
X101_32X8D = Arch(101, 32, 8, False, (57.375, 57.120, 58.395))


def strict_float32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def conv(x, sd, name, stride=1, padding=0, groups=1):
    return F.conv2d(x, sd[name + ".weight"], sd.get(name + ".bias"), stride, padding, 1, groups)


def frozen_bn(x, sd, name, eps=1e-5):
    mul = sd[name + ".weight"] * torch.rsqrt(sd[name + ".running_var"] + eps)
    add = sd[name + ".bias"] - sd[name + ".running_mean"] * mul
    return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


def conv_bn(x, sd, name, stride=1, padding=0, groups=1):
    return frozen_bn(conv(x, sd, name, stride, padding, groups), sd, name + ".norm")


def normalize(images: torch.Tensor, arch: Arch) -> torch.Tensor:
    """(N, H, W, 3) raw BGR pixels -> NCHW float32, less the mean over the std."""
    dev = images.device
    x = (images.float() - torch.tensor(PIXEL_MEAN, device=dev)) / \
        torch.tensor(arch.pixel_std, device=dev)
    return x.permute(0, 3, 1, 2).contiguous()


def resnet(sd, x, arch: Arch) -> Dict[str, torch.Tensor]:
    p = "backbone.bottom_up."
    x = F.relu(conv_bn(x, sd, p + "stem.conv1", 2, 3))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for stage, blocks, _, _, stride in arch.stages():
        for b in range(blocks):
            name = f"{p}{stage}.{b}"
            s = stride if b == 0 else 1
            s1, s3 = (s, 1) if arch.stride_in_1x1 else (1, s)
            short = conv_bn(x, sd, name + ".shortcut", s) if b == 0 else x
            y = F.relu(conv_bn(x, sd, name + ".conv1", s1))
            y = F.relu(conv_bn(y, sd, name + ".conv2", s3, 1, arch.num_groups))
            x = F.relu(conv_bn(y, sd, name + ".conv3") + short)
        out[stage] = x
    return out


def fpn(sd, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """[P3, ..., P7] from res3-res5."""
    p = "backbone."
    merged, prev = {}, None
    for lvl in ("5", "4", "3"):
        cur = conv(feats["res" + lvl], sd, p + "fpn_lateral" + lvl)
        if prev is not None:
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            cur = cur + up[:, :, :cur.shape[2], :cur.shape[3]]
        merged[lvl] = prev = cur
    outs = [conv(merged[lvl], sd, p + "fpn_output" + lvl, 1, 1) for lvl in "345"]
    p6 = conv(feats["res5"], sd, p + "top_block.p6", 2, 1)
    return outs + [p6, conv(F.relu(p6), sd, p + "top_block.p7", 2, 1)]


Act = Callable[[List[torch.Tensor], int, int], List[torch.Tensor]]


def head(sd, levels: Sequence[torch.Tensor], num_convs: int, num_classes: int,
         num_anchors: int = 9, act: Optional[Act] = None) -> Dict[str, Optional[torch.Tensor]]:
    """The towers and output convs over the levels. `act(xs, tower, layer)`
    takes a tower conv's outputs at every level and returns them after
    ReLU (and dropout); plain ReLU without one."""
    act = act or (lambda xs, tower, layer: [F.relu(x) for x in xs])
    feats = []
    for t, tower in enumerate(TOWERS):
        xs = list(levels)
        for layer in range(num_convs):
            xs = act([conv(x, sd, f"head.{tower}.{2 * layer}", 1, 1) for x in xs], t, layer)
        feats.append(xs)

    def flat(x, k):
        n, _, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(n, h * w * num_anchors, k)

    outs = {"box_cls": [], "box_delta": [], "box_cls_var": [], "box_reg_var": []}
    for c, b in zip(*feats):
        outs["box_cls"].append(flat(conv(c, sd, "head.cls_score", 1, 1), num_classes))
        outs["box_delta"].append(flat(conv(b, sd, "head.bbox_pred", 1, 1), 4))
        if "head.cls_var.weight" in sd:
            outs["box_cls_var"].append(flat(conv(c, sd, "head.cls_var", 1, 1), num_classes))
        if "head.bbox_cov.weight" in sd:
            dims = sd["head.bbox_cov.weight"].shape[0] // num_anchors
            outs["box_reg_var"].append(flat(conv(b, sd, "head.bbox_cov", 1, 1), dims))
    return {k: torch.cat(v, dim=1) if v else None for k, v in outs.items()}


def forward(sd, images, arch: Arch, num_convs: int, num_classes: int,
            act: Optional[Act] = None) -> Dict[str, Optional[torch.Tensor]]:
    """Raw images -> the head's anchorwise outputs."""
    return head(sd, fpn(sd, resnet(sd, normalize(images, arch), arch)), num_convs, num_classes,
                act=act)


def parameter_shapes(arch: Arch, num_classes: int, num_anchors: int = 9, num_convs: int = 4,
                     cls_var: bool = True, bbox_cov_dims: int = 4) -> Dict[str, tuple]:
    """Every tensor of the model's state dict with its shape, in
    detectron2's names (FrozenBN as weight, bias, running_mean and
    running_var)."""
    shapes = {}

    def conv_bn_shapes(name, cout, cin_per_group, k):
        shapes[name + ".weight"] = (cout, cin_per_group, k, k)
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.norm.{t}"] = (cout,)

    p = "backbone.bottom_up."
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


def random_state(shapes: Dict[str, tuple], seed: int, head_std: float = 0.01,
                 residual_scale: float = 0.5) -> Dict[str, torch.Tensor]:
    """Seeded float32 CPU weights: convolutions He-normal over their fan-in
    (a grouped conv's fan-in is its group's), head convs N(0, head_std); biases 0.01 N(0, 1); FrozenBN scale U(0.5, 1.5)
    (times `residual_scale` on each block's last, as a trained network
    keeps its residual branches small), shift 0.1 N(0, 1), mean 0.1 N(0,
    1), variance U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            std = head_std if name.startswith("head.") else math.sqrt(2.0 / fan_in)
            sd[name] = torch.randn(shape, generator=g) * std
        elif name.endswith(".norm.weight"):
            scale = residual_scale if ".conv3.norm." in name else 1.0
            sd[name] = (torch.rand(shape, generator=g) + 0.5) * scale
        elif name.endswith(".norm.running_var"):
            sd[name] = torch.rand(shape, generator=g) + 0.5
        elif name.endswith((".norm.bias", ".norm.running_mean")):
            sd[name] = torch.randn(shape, generator=g) * 0.1
        else:
            sd[name] = torch.randn(shape, generator=g) * 0.01
    return sd


def trainable(name: str) -> bool:
    """FREEZE_AT 2: the stem and res2 are frozen; FrozenBN never trains."""
    if ".norm." in name:
        return False
    return not name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))
