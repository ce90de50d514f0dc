"""Probabilistic RetinaNet: normalize -> R50 -> FPN -> probabilistic head.

Counterpart of ``pod_compare_tpu/models/retinanet.py``. The head's conv
towers run layer by layer over the five levels (each level's chain is the
JAX head's, in another order) and feed both the mean and the variance
output convs; outputs are (N, H·W·A, k) float32 tensors concatenated over
levels in the anchor layout of ``ops.anchors``. Parameter names follow the
reference's detectron2 namespace (``backbone.bottom_up.*``,
``head.cls_subnet.{0,2,4,6}``, ``head.cls_score`` ...).

Dropout in the towers comes from outside, as a ``TowerDropout``: one object
per stochastic head pass, called after each tower conv with the raw conv
outputs of every level and returning ReLU-then-dropout of each.
``KernelDropout`` draws the masks with the counter-based dropout kernel, one
launch per (tower, layer) over the levels (differentiable, its backward
replaying the masks from their seeds, when autograd records the pass);
``InjectedMasks`` multiplies by given masks (the tests feed the JAX package
the same masks). Without one, the towers apply a plain ReLU.

Parameters are float32; the convolutions compute in the model's
``compute_dtype`` (``layers.Conv2d`` casts its weight to the activations'
dtype). ``init_weights`` draws a fresh model from a generator, with the
head initialised as the JAX package initialises it.

``head_quant='int8'`` (PROBABILISTIC_INFERENCE.HEAD_QUANT, inference only)
runs the tower convs through ``ops.quant.quantized_conv3x3`` on their
float32 weights, as the JAX package's ``TowerConv3`` does: conv 0 sees the
signed FPN features, the later convs post-ReLU inputs (the unsigned
activation scale). Their float32 outputs go through ReLU and dropout in
float32, and are cast to the compute dtype for the output convs, which stay
unquantized.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pod_compare_tpu_torch.models.fpn import FPN, FPN_STRIDES
from pod_compare_tpu_torch.models.layers import Conv2d
from pod_compare_tpu_torch.models.resnet import ResNet
from pod_compare_tpu_torch.ops.anchors import AnchorGenerator
from pod_compare_tpu_torch.ops.kernels.dropout import dropout_levels_autograd, dropout_levels_op
from pod_compare_tpu_torch.ops.quant import quantized_conv3x3
from pod_compare_tpu_torch.parallel.mesh import BatchShard

TOWERS = ("cls_subnet", "bbox_subnet")
# The forward-only dropout of a stochastic pass over the levels: the
# operator, whose seed is a tensor.
dropout_levels = dropout_levels_op
HEAD_QUANT_MODES = ("none", "int8")


class TowerDropout:
    """ReLU + dropout after conv `layer` of tower `tower` (0 cls, 1 bbox);
    xs are the raw conv outputs of every FPN level, in level order, and the
    result is a list alike."""

    def __call__(self, xs: List[torch.Tensor], tower: int, layer: int) -> List[torch.Tensor]:
        raise NotImplementedError


class KernelDropout(TowerDropout):
    """One stochastic head pass through the dropout kernel with fused ReLU.

    `seeds[tower][layer]` seeds one mask draw per (tower, layer) that covers
    every FPN level, one launch over the levels: level l uses the stream
    indices that follow those of levels < l (`level_offsets`). With
    `batch_shared` the mask of each level is one (H, W, C) pattern
    broadcast over the batch. When autograd records the pass, the dropout
    is differentiable and its backward replays the masks from the seed in
    one launch. Otherwise it is the operator ``dropout_levels_op``, whose
    seed stays a tensor: a (2, num_convs) int64 tensor of seeds on the CPU
    (nested lists are made one) is then an input of an exported program, not
    a constant baked into it.
    """

    def __init__(self, seeds, rate: float, level_offsets: Sequence[int], batch_shared: bool):
        self.seeds = torch.as_tensor(seeds, dtype=torch.int64)
        self.rate = rate
        self.level_offsets = list(level_offsets)
        self.batch_shared = batch_shared

    def __call__(self, xs, tower, layer):
        args = (self.rate, self.batch_shared, self.level_offsets[:len(xs)], True)
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return dropout_levels_autograd(xs, int(self.seeds[tower, layer]), *args)
        return dropout_levels(xs, self.seeds[tower, layer], *args)


class InjectedMasks(TowerDropout):
    """Masks given from outside: `masks[tower][layer][level]` is a scale
    tensor (0 or 1/keep) of shape (H, W, C) or (N, H, W, C), applied as
    relu(x) * mask, as the JAX head applies its premultiplied masks."""

    def __init__(self, masks):
        self.masks = masks

    def __call__(self, xs, tower, layer):
        outs = []
        for x, mask in zip(xs, self.masks[tower][layer]):
            mask = mask.to(device=x.device, dtype=x.dtype)
            nchw = mask.permute(2, 0, 1)[None] if mask.dim() == 3 else mask.permute(0, 3, 1, 2)
            outs.append(F.relu(x) * nchw)
        return outs


def _relu_levels(xs, tower, layer):
    return [F.relu(x) for x in xs]


def level_offsets(features: Sequence[torch.Tensor], batch_shared: bool,
                  shard=None) -> List[int]:
    """Stream offset of each level in one mask draw over all levels.

    With per-sample masks and a `shard` (``parallel.BatchShard``: these
    features are rows [first, first + size) of a data-parallel step's global
    batch), each level's offset is the global batch's, plus the first row's
    place in it, so a process draws the masks one process draws for its
    rows. Batch-shared masks are the same in every process."""
    offsets, total = [], 0
    for f in features:
        per_image = f[0].numel()
        if batch_shared:
            offsets.append(total)
            total += per_image
            continue
        rows = shard if shard is not None else BatchShard(0, f.shape[0], f.shape[0])
        if f.shape[0] != rows.size:
            raise ValueError(f"features of {f.shape[0]} images for a shard of {rows.size}")
        offsets.append(total + rows.first * per_image)
        total += rows.total * per_image
    return offsets


def _conv3(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1)


class ProbabilisticRetinaNetHead(nn.Module):
    """Shared RetinaNet head with class logits, box deltas, class logit
    log-variances and box covariance parameters."""

    def __init__(
        self,
        num_classes: int,
        num_anchors: int,
        num_convs: int = 4,
        channels: int = 256,
        compute_cls_var: bool = False,
        compute_bbox_cov: bool = False,
        bbox_cov_dims: int = 4,
        prior_prob: float = 0.01,
        quant: str = "none",
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if quant not in HEAD_QUANT_MODES:
            raise ValueError(f"Unknown head quantization mode {quant!r}.")
        self.quant = quant
        self.compute_dtype = compute_dtype
        self.prior_prob = prior_prob
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.num_convs = num_convs
        self.bbox_cov_dims = bbox_cov_dims
        for tower in TOWERS:
            layers = []
            for _ in range(num_convs):
                layers += [_conv3(channels, channels), nn.ReLU()]
            self.add_module(tower, nn.Sequential(*layers))
        self.cls_score = _conv3(channels, num_anchors * num_classes)
        self.bbox_pred = _conv3(channels, num_anchors * 4)
        self.cls_var = _conv3(channels, num_anchors * num_classes) if compute_cls_var else None
        self.bbox_cov = (
            _conv3(channels, num_anchors * bbox_cov_dims) if compute_bbox_cov else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX head's initialisation (``ProbabilisticRetinaNetHead.setup``):
        tower and output weights N(0, 0.01), zero biases, except the class
        logits' bias -log((1 - p)/p), the class log-variances' bias -10 and
        the box covariance weights N(0, 1e-4)."""
        for conv in self._convs(0) + self._convs(1) + [self.cls_score, self.bbox_pred]:
            conv.weight.data.normal_(0.0, 0.01, generator=generator)
            conv.bias.data.zero_()
        self.cls_score.bias.data.fill_(-math.log((1.0 - self.prior_prob) / self.prior_prob))
        if self.cls_var is not None:
            self.cls_var.weight.data.normal_(0.0, 0.01, generator=generator)
            self.cls_var.bias.data.fill_(-10.0)
        if self.bbox_cov is not None:
            self.bbox_cov.weight.data.normal_(0.0, 1e-4, generator=generator)
            self.bbox_cov.bias.data.zero_()

    def _convs(self, tower: int) -> List[nn.Conv2d]:
        return list(getattr(self, TOWERS[tower]))[0::2]

    def tower_conv(self, tower: int, layer: int, x: torch.Tensor) -> torch.Tensor:
        """Tower conv `layer` of `tower`; int8 with `quant`, in float32."""
        conv = self._convs(tower)[layer]
        if self.quant == "int8":
            return quantized_conv3x3(x, conv.weight, conv.bias, act_signed=layer == 0)
        return conv(x)

    def prefix(self, features: Sequence[torch.Tensor]):
        """First tower conv of both towers at every level, before its ReLU.
        It sees no dropout, so a bank of stochastic passes computes it once
        (`rest` runs the other layers per pass)."""
        return tuple([self.tower_conv(t, 0, f) for f in features] for t in range(2))

    def _flatten(self, x: torch.Tensor, k: int) -> torch.Tensor:
        # (N, A*k, H, W) -> (N, H*W*A, k), the reference's permute_to_N_HWA_K.
        n, _, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(n, h * w * self.num_anchors, k)

    def rest(self, prefix, tower_dropout: Optional[TowerDropout] = None):
        """ReLU (+ dropout) after conv 0, convs 1.. with ReLU (+ dropout),
        then the output convs; float32 outputs concatenated over levels.
        The towers run layer by layer, each conv at every level and then one
        dropout call over the levels' outputs."""
        act = tower_dropout or _relu_levels
        feats = []
        for t in range(2):
            xs = act(list(prefix[t]), t, 0)
            for layer in range(1, self.num_convs):
                xs = act([self.tower_conv(t, layer, x) for x in xs], t, layer)
            feats.append([x.to(self.compute_dtype) for x in xs])  # the int8 towers' float32 too
        outs: Dict[str, list] = {"box_cls": [], "box_delta": [], "box_cls_var": [],
                                 "box_reg_var": []}
        for c, b in zip(*feats):
            outs["box_cls"].append(self._flatten(self.cls_score(c), self.num_classes))
            outs["box_delta"].append(self._flatten(self.bbox_pred(b), 4))
            if self.cls_var is not None:
                outs["box_cls_var"].append(self._flatten(self.cls_var(c), self.num_classes))
            if self.bbox_cov is not None:
                outs["box_reg_var"].append(self._flatten(self.bbox_cov(b), self.bbox_cov_dims))
        return {k: (torch.cat(v, dim=1).float() if v else None) for k, v in outs.items()}

    def forward(self, features, tower_dropout: Optional[TowerDropout] = None):
        return self.rest(self.prefix(features), tower_dropout)


class ProbabilisticRetinaNet(nn.Module):
    """Full detector. `backbone_features` and `head` are separate so that
    MC-dropout inference runs the backbone once and the head M times."""

    def __init__(
        self,
        num_classes: int,
        num_anchors: int = 9,
        depth: int = 50,
        fpn_channels: int = 256,
        num_convs: int = 4,
        dropout_rate: float = 0.0,
        compute_cls_var: bool = False,
        compute_bbox_cov: bool = False,
        bbox_cov_dims: int = 4,
        pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675),
        pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0),
        in_features: Sequence[str] = ("p3", "p4", "p5", "p6", "p7"),
        compute_dtype: torch.dtype = torch.float32,
        prior_prob: float = 0.01,
        freeze_at: int = 0,
        head_quant: str = "none",
    ):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.in_features = tuple(in_features)
        self.compute_dtype = compute_dtype
        self.backbone = FPN(ResNet(depth=depth, freeze_at=freeze_at), out_channels=fpn_channels)
        self.head = ProbabilisticRetinaNetHead(
            num_classes, num_anchors, num_convs, fpn_channels,
            compute_cls_var, compute_bbox_cov, bbox_cov_dims, prior_prob,
            head_quant, compute_dtype,
        )
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std), persistent=False)

    def init_weights(self, generator: torch.Generator) -> "ProbabilisticRetinaNet":
        """Fresh weights from `generator` (call before moving the model, so
        that the draw does not depend on the device): detectron2's fills for
        the backbone (MSRA normal, fan out, for the ResNet; uniform, fan in,
        for the FPN), identity FrozenBN, and the JAX head's initialisation."""
        for name, m in self.backbone.named_modules():
            if not isinstance(m, nn.Conv2d):
                continue
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            fan_in = m.weight[0].numel()
            if name.startswith("bottom_up."):
                m.weight.data.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            else:
                bound = math.sqrt(3.0 / fan_in)
                m.weight.data.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.data.zero_()
        self.head.init_weights(generator)
        return self

    def cast_convs(self) -> "ProbabilisticRetinaNet":
        """Cast conv weights to the compute dtype; FrozenBN stays float32, and
        so do the int8 head's tower convs, which quantize their float32
        weights."""
        keep = set()
        if self.head.quant != "none":
            keep = {id(c) for t in range(2) for c in self.head._convs(t)}
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and id(m) not in keep:
                m.to(self.compute_dtype)
        return self

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) raw pixels (uint8 or float) -> normalized NCHW in the
        compute dtype, channels_last in memory."""
        x = (images.float() - self.pixel_mean) / self.pixel_std
        return x.permute(0, 3, 1, 2).to(self.compute_dtype)

    def backbone_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone(self.normalize(images))
        return [feats[f].contiguous(memory_format=torch.channels_last) for f in self.in_features]

    def forward(self, images: torch.Tensor, tower_dropout: Optional[TowerDropout] = None):
        """Raw anchorwise outputs of one head pass."""
        return self.head(self.backbone_features(images), tower_dropout)

    def forward_train(self, images: torch.Tensor, seeds, batch_shared: bool = False,
                      shard=None):
        """One training pass: dropout after every tower conv through the
        kernel, one mask draw per (tower, layer) from `seeds[tower][layer]`,
        per sample unless `batch_shared`; with a `shard`, the images are those
        rows of a global batch and draw its masks (`level_offsets`)."""
        features = self.backbone_features(images)
        tower_dropout = None
        if self.dropout_rate > 0.0:
            tower_dropout = KernelDropout(
                seeds, self.dropout_rate, level_offsets(features, batch_shared, shard),
                batch_shared,
            )
        return self.head(features, tower_dropout)


def build_model(cfg, head_quant: str = "none") -> ProbabilisticRetinaNet:
    """The flagship model from a config node (cf. the JAX `build_model`);
    the inference predictor passes PROBABILISTIC_INFERENCE.HEAD_QUANT as
    `head_quant`."""
    pm = cfg.MODEL.PROBABILISTIC_MODELING
    num_anchors = len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]) * len(
        cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]
    )
    return ProbabilisticRetinaNet(
        num_classes=cfg.MODEL.RETINANET.NUM_CLASSES,
        num_anchors=num_anchors,
        depth=cfg.MODEL.RESNETS.DEPTH,
        fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        num_convs=cfg.MODEL.RETINANET.NUM_CONVS,
        dropout_rate=pm.DROPOUT_RATE,
        compute_cls_var=pm.CLS_VAR_LOSS.NAME != "none",
        compute_bbox_cov=pm.BBOX_COV_LOSS.NAME != "none",
        bbox_cov_dims=4 if pm.BBOX_COV_LOSS.COVARIANCE_TYPE == "diagonal" else 10,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        in_features=tuple(cfg.MODEL.RETINANET.IN_FEATURES),
        compute_dtype=(
            torch.bfloat16 if cfg.PARALLEL.COMPUTE_DTYPE == "bfloat16" else torch.float32
        ),
        prior_prob=cfg.MODEL.RETINANET.PRIOR_PROB,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        head_quant=head_quant,
    )


def build_anchor_generator(cfg) -> AnchorGenerator:
    strides = [FPN_STRIDES[f] for f in cfg.MODEL.RETINANET.IN_FEATURES]
    return AnchorGenerator.from_config(cfg, strides)

