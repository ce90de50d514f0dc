"""The least bytes of a ResNet or ResNeXt backbone's FrozenBN epilogues in
one training step, from shapes (``resnets.backbone``).

Every backbone convolution but a projection shortcut ends in one epilogue,
the shortcut's FrozenBN running inside its block's conv3's. Forward: read
the convolution's raw output and write the activation, 2 x BYTES an output
element, plus BYTES for conv3's identity residual or projection shortcut's
raw output. Backward, for a trainable convolution only (FREEZE_AT 2: the
stem and res2 run none): read the gradient and the activation and write
the input gradient, 3 x BYTES an element, plus BYTES for conv3's second
gradient, the residual's or the shortcut's. The FrozenBN buffers, a few
floats a channel, are left out.
"""

from typing import List, Tuple

from portbench.counts.resnets import BYTES, Conv


def step_bytes(cs: List[Conv], batch: int) -> Tuple[int, int]:
    """(forward, backward) least bytes of the epilogues of the backbone's
    convolutions among `cs` in one step of `batch` images."""
    forward = backward = 0
    for c in cs:
        if not c.name.startswith(("stem.", "res")) or c.name.endswith(".shortcut"):
            continue
        elements = batch * c.out_hw[0] * c.out_hw[1] * c.cout
        side = int(c.name.endswith(".conv3"))
        forward += elements * BYTES * (2 + side)
        if c.trainable:
            backward += elements * BYTES * (3 + side)
    return forward, backward
