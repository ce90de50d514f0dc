"""Device-side image preprocessing: resize and pad on the card.

Counterpart of ``pod_compare_tpu/ops/preprocess.py``. The loaders resize
on the host with cv2, since source resolutions vary; this is the serving
path for a camera of one fixed resolution: the raw images go to the card
once, and the shortest-edge resize and the padding onto the static canvas
run there (the model normalises in its own forward).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from pod_compare_tpu_torch.data.loader import resize_shortest_edge


def resize_and_pad(
    images: torch.Tensor,
    source_size: Tuple[int, int],
    min_size: int,
    max_size: int,
    canvas: Tuple[int, int],
    antialias: bool = True,
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Resize a batch of raw images by the shortest-edge rule and pad them
    onto the canvas, on the images' device.

    Args:
        images: (B, H0, W0, 3) raw pixels (BGR, unnormalised), NHWC as the
            JAX function takes them; a float dtype is kept, integers are
            resized in float32, as ``jax.image.resize`` promotes them.
        source_size: (H0, W0).
        canvas: the padded output's (H, W).
        antialias: when shrinking, bilinear with the triangle filter
            widened by the scale, as ``jax.image.resize(..., antialias=True)``
            (``F.interpolate``'s antialias). When enlarging, JAX's filter is
            the plain triangle, which is ``F.interpolate``'s bilinear without
            antialias: its antialiased enlargement is another filter, up to
            0.02 off on a 0-255 scale at 720x1280 -> 750x1333.
    Returns:
        (B, H, W, 3) padded batch, zero outside the resized image, and the
        resized (h, w): the `input_sizes` to hand to the predictor.
    """
    nh, nw = resize_shortest_edge(source_size[0], source_size[1], min_size, max_size)
    if nh > canvas[0] or nw > canvas[1]:
        raise ValueError(f"resized {(nh, nw)} exceeds canvas {tuple(canvas)}")
    if tuple(images.shape[1:3]) != tuple(source_size):
        raise ValueError(f"images of {tuple(images.shape[1:3])}, not the source size "
                         f"{tuple(source_size)}")
    x = images if images.is_floating_point() else images.float()
    if (nh, nw) != tuple(source_size):
        shrink = nh < source_size[0] or nw < source_size[1]
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=antialias and shrink)
        x = x.permute(0, 2, 3, 1)
    padded = x.new_zeros((x.shape[0], canvas[0], canvas[1], x.shape[3]))
    padded[:, :nh, :nw] = x
    return padded, (nh, nw)
