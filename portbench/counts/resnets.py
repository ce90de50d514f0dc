"""Multiply-accumulates of RetinaNet on a ResNet or ResNeXt of any depth,
and the least bytes of its grouped 3x3s, from shapes.

The rules are ``convs.py``'s (the forward once; in training an input
gradient for every convolution whose input depends on a trainable tensor
and a weight gradient for every trainable one, each as many
multiply-accumulates as its forward; FREEZE_AT 2), on the backbone of
(depth, num_groups, width_per_group, stride_in_1x1): a bottleneck's width
is num_groups * width_per_group at res2, doubling each stage; a grouped
convolution does cin / groups multiply-accumulates an output element; the
stride sits in the first 1x1 or in the 3x3, and so sets the size the 1x1
and the 3x3 see. The FPN and the head are ``convs.py``'s own entries (their
input widths, 512-2048, and their sizes do not depend on the backbone's
width or depth). At (50, 1, 64, True) the list is ``convs.convs``'.

A grouped 3x3's least bytes (bf16, each tensor read or written once):
forward reads x and the weight and writes y; the input gradient (dgrad)
reads dy and the weight and writes dx; the weight gradient (wgrad) reads x
and dy and writes dw. A frozen stage runs only its forward.
"""

from typing import List, NamedTuple, Sequence, Tuple

from portbench.counts import convs

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BYTES = 2  # bf16 activations, weights and gradients


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    out_hw: Tuple[int, int]
    part: str
    trainable: bool
    input_grad: bool
    groups: int = 1
    in_hw: Tuple[int, int] = (0, 0)

    @property
    def macs(self) -> int:
        return self.out_hw[0] * self.out_hw[1] * self.cout * (self.cin // self.groups) * \
            self.k * self.k

    def bytes(self, batch: int) -> Tuple[int, int, int]:
        """(forward, dgrad, wgrad) least bytes of one call on `batch`
        images; 0 for a pass that does not run."""
        x = batch * self.in_hw[0] * self.in_hw[1] * self.cin * BYTES
        y = batch * self.out_hw[0] * self.out_hw[1] * self.cout * BYTES
        w = self.cout * (self.cin // self.groups) * self.k * self.k * BYTES
        return (x + w + y, (y + w + x) if self.input_grad else 0,
                (x + y + w) if self.trainable else 0)


def backbone(canvas: Sequence[int], depth: int = 50, num_groups: int = 1,
             width_per_group: int = 64, stride_in_1x1: bool = True) -> List[Conv]:
    out = []
    hw = convs._out(tuple(canvas), 7, 2, 3)
    out.append(Conv("stem.conv1", 3, 64, 7, hw, "backbone", False, False, 1, tuple(canvas)))
    hw = convs._out(hw, 3, 2, 1)
    cin, mid = 64, num_groups * width_per_group
    for i, blocks in enumerate(STAGES[depth]):
        stage, cout, frozen = f"res{i + 2}", 256 * 2 ** i, i == 0
        for b in range(blocks):
            s = (1 if i == 0 else 2) if b == 0 else 1
            s1, s3 = (s, 1) if stride_in_1x1 else (1, s)
            first = stage == "res3" and b == 0
            mid_hw = convs._out(hw, 1, s1, 0)
            ohw = convs._out(mid_hw, 3, s3, 1)
            if b == 0:
                out.append(Conv(f"{stage}.{b}.shortcut", cin, cout, 1, ohw, "backbone",
                                not frozen, not frozen and not first, 1, hw))
            out.append(Conv(f"{stage}.{b}.conv1", cin, mid, 1, mid_hw, "backbone", not frozen,
                            not frozen and not first, 1, hw))
            out.append(Conv(f"{stage}.{b}.conv2", mid, mid, 3, ohw, "backbone", not frozen,
                            not frozen, num_groups, mid_hw))
            out.append(Conv(f"{stage}.{b}.conv3", mid, cout, 1, ohw, "backbone", not frozen,
                            not frozen, 1, ohw))
            hw, cin = ohw, cout
        mid *= 2
    return out


def model_convs(canvas: Sequence[int], model: dict) -> List[Conv]:
    """Every convolution of a configuration file's `model`: this backbone,
    then ``convs.convs``' FPN and head."""
    bb = backbone(canvas, int(model.get("depth", 50)), int(model.get("num_groups", 1)),
                  int(model.get("width_per_group", 64)), bool(model.get("stride_in_1x1", True)))
    rest = [Conv(*c) for c in convs.convs(canvas, model["num_classes"], model["num_anchors"],
                                          model["num_convs"], model["cls_var"],
                                          model["bbox_cov_dims"])
            if not c.name.startswith(("stem.", "res"))]
    return bb + rest


def grouped(cs: List[Conv]) -> List[Conv]:
    return [c for c in cs if c.groups > 1]


def grouped_train_bytes(cs: List[Conv], batch: int) -> int:
    """The grouped 3x3s' least bytes in one train step of `batch` images:
    forward, dgrad and wgrad."""
    return sum(sum(c.bytes(batch)) for c in grouped(cs))
