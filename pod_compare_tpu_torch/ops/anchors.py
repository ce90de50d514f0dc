"""Static anchor generation (numpy; the predictor moves them to its device).

Counterpart of ``pod_compare_tpu/ops/anchors.py``, line for line: anchors
are precomputed as constant (R, 4) arrays per input resolution. Anchor
layout matches the reference's ``permute_to_N_HWA_K`` flattening: within a
level, index = ((y * W + x) * A + a); levels are concatenated p3..p7.
"""

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np


def generate_cell_anchors(
    sizes: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """(A, 4) anchors centered at the origin, size-major then aspect-ratio."""
    anchors = []
    for size in sizes:
        anchor_area = float(size) ** 2
        for aspect in aspect_ratios:
            w = math.sqrt(anchor_area / aspect)
            h = aspect * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def feature_map_size(image_size: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """Feature-map H, W for an input padded to `image_size` at `stride`."""
    return (
        -(-image_size[0] // stride),
        -(-image_size[1] // stride),
    )


def grid_anchors(
    grid_size: Tuple[int, int],
    stride: int,
    cell_anchors: np.ndarray,
    offset: float = 0.0,
) -> np.ndarray:
    """(H*W*A, 4) anchors for one level; y-major, x, then anchor index."""
    h, w = grid_size
    shifts_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(h, dtype=np.float32) + offset) * stride
    shift_y, shift_x = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack(
        [shift_x.ravel(), shift_y.ravel(), shift_x.ravel(), shift_y.ravel()], axis=1
    )
    out = shifts[:, None, :] + cell_anchors[None, :, :]
    return out.reshape(-1, 4)


class AnchorGenerator:
    """Per-level static anchors for RetinaNet-FPN feature maps.

    Args:
        sizes: per-level anchor sizes, e.g. 5 lists of 3 scales
            (reference: src/configs/Base-RetinaNet.yaml:8).
        aspect_ratios: shared or per-level aspect ratios.
        strides: per-level feature strides (p3..p7 → 8..128).
        offset: sub-stride center offset (detectron2 default 0.0).
    """

    def __init__(
        self,
        sizes: Sequence[Sequence[float]],
        aspect_ratios: Sequence[Sequence[float]],
        strides: Sequence[int],
        offset: float = 0.0,
    ):
        if len(aspect_ratios) == 1:
            aspect_ratios = list(aspect_ratios) * len(sizes)
        assert len(sizes) == len(strides) == len(aspect_ratios)
        self.strides = list(strides)
        self.offset = offset
        self.cell_anchors = [
            generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)
        ]
        num_cell = {c.shape[0] for c in self.cell_anchors}
        assert len(num_cell) == 1, "anchor count must match across levels"
        self.num_cell_anchors = num_cell.pop()

    @classmethod
    def from_config(cls, cfg, strides: Sequence[int]) -> "AnchorGenerator":
        return cls(
            sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
            aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
            strides=strides,
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        )

    def grid_sizes(self, image_size: Tuple[int, int]) -> List[Tuple[int, int]]:
        return [feature_map_size(image_size, s) for s in self.strides]

    @lru_cache(maxsize=16)
    def _anchors_cached(self, image_size: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
        return tuple(
            grid_anchors(gs, stride, cell, self.offset)
            for gs, stride, cell in zip(
                self.grid_sizes(image_size), self.strides, self.cell_anchors
            )
        )

    def per_level(self, image_size: Tuple[int, int]) -> List[np.ndarray]:
        """List of (Hi*Wi*A, 4) float32 anchor arrays, one per level."""
        return list(self._anchors_cached(tuple(image_size)))

    def concatenated(self, image_size: Tuple[int, int]) -> np.ndarray:
        """(R, 4) anchors concatenated over levels (R = sum Hi*Wi*A)."""
        return np.concatenate(self.per_level(image_size), axis=0)

    def num_anchors(self, image_size: Tuple[int, int]) -> int:
        return sum(a.shape[0] for a in self.per_level(image_size))
