"""Multiply-accumulates of RetinaNet-R50-FPN's convolutions, from shapes.

Fixed to the mathematics, not to an implementation:
  - inference: a convolution whose input no dropout mask touched is
    counted once an image (the backbone, the FPN and tower conv 0, the
    head's prefix); every later tower conv and the output convs once a run;
  - training: the forward once, and in the backward an input gradient for
    every convolution whose input depends on a trainable tensor and a
    weight gradient for every trainable convolution, each as many
    multiply-accumulates as its forward. FREEZE_AT 2: the stem and res2
    are frozen, so neither of their gradients is needed, nor the input
    gradients of res3's first block's conv1 and shortcut.
A FLOP is two of the multiply-accumulates counted here.
"""

from typing import List, NamedTuple, Sequence, Tuple

RESNET = (("res2", 3, 64, 256, 1), ("res3", 4, 128, 512, 2),
          ("res4", 6, 256, 1024, 2), ("res5", 3, 512, 2048, 2))


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    out_hw: Tuple[int, int]
    part: str  # 'backbone', 'prefix' or 'run' (a head conv after conv 0)
    trainable: bool
    input_grad: bool

    @property
    def macs(self) -> int:
        return self.out_hw[0] * self.out_hw[1] * self.cout * self.cin * self.k * self.k


def _out(hw, k, s, p):
    return ((hw[0] + 2 * p - k) // s + 1, (hw[1] + 2 * p - k) // s + 1)


def convs(canvas: Sequence[int], num_classes: int, num_anchors: int = 9, num_convs: int = 4,
          cls_var: bool = True, bbox_cov_dims: int = 4) -> List[Conv]:
    out = []
    hw = _out(tuple(canvas), 7, 2, 3)
    out.append(Conv("stem.conv1", 3, 64, 7, hw, "backbone", False, False))
    hw = _out(hw, 3, 2, 1)
    cin = 64
    stage_hw = {}
    for stage, blocks, mid, cout, stride in RESNET:
        frozen = stage == "res2"
        for b in range(blocks):
            s = stride if b == 0 else 1
            first = stage == "res3" and b == 0
            ohw = _out(hw, 1, s, 0)
            if b == 0:
                out.append(Conv(f"{stage}.{b}.shortcut", cin, cout, 1, ohw, "backbone",
                                not frozen, not frozen and not first))
            out.append(Conv(f"{stage}.{b}.conv1", cin, mid, 1, ohw, "backbone", not frozen,
                            not frozen and not first))
            out.append(Conv(f"{stage}.{b}.conv2", mid, mid, 3, ohw, "backbone", not frozen,
                            not frozen))
            out.append(Conv(f"{stage}.{b}.conv3", mid, cout, 1, ohw, "backbone", not frozen,
                            not frozen))
            hw, cin = ohw, cout
        stage_hw[stage] = hw
    levels = []
    for lvl, c in (("3", 512), ("4", 1024), ("5", 2048)):
        lhw = stage_hw["res" + lvl]
        out.append(Conv("fpn_lateral" + lvl, c, 256, 1, lhw, "backbone", True, True))
        out.append(Conv("fpn_output" + lvl, 256, 256, 3, lhw, "backbone", True, True))
        levels.append(lhw)
    p6 = _out(stage_hw["res5"], 3, 2, 1)
    p7 = _out(p6, 3, 2, 1)
    out.append(Conv("p6", 2048, 256, 3, p6, "backbone", True, True))
    out.append(Conv("p7", 256, 256, 3, p7, "backbone", True, True))
    levels += [p6, p7]
    heads = {"cls_score": num_anchors * num_classes, "bbox_pred": num_anchors * 4}
    if cls_var:
        heads["cls_var"] = num_anchors * num_classes
    if bbox_cov_dims:
        heads["bbox_cov"] = num_anchors * bbox_cov_dims
    for li, lhw in enumerate(levels):
        for tower in ("cls_subnet", "bbox_subnet"):
            for layer in range(num_convs):
                out.append(Conv(f"{tower}.{layer}.p{li + 3}", 256, 256, 3, lhw,
                                "prefix" if layer == 0 else "run", True, True))
        for name, cout in heads.items():
            out.append(Conv(f"{name}.p{li + 3}", 256, cout, 3, lhw, "run", True, True))
    return out


def infer_macs_per_image(cs: List[Conv], runs: int) -> int:
    """An image's multiply-accumulates with `runs` stochastic head passes."""
    return sum(c.macs * (runs if c.part == "run" else 1) for c in cs)


def train_macs_per_image(cs: List[Conv]) -> int:
    """An image's multiply-accumulates of one train step: forward, input
    gradients and weight gradients."""
    return sum(c.macs * (1 + int(c.trainable) + int(c.input_grad)) for c in cs)


def level_positions(canvas: Sequence[int]) -> int:
    """Spatial positions of P3-P7 on the canvas."""
    total = 0
    for s in (8, 16, 32, 64, 128):
        total += (-(-canvas[0] // s)) * (-(-canvas[1] // s))
    return total
