"""Covariance-aware detection visualizer.

The port's copy of ``pod_compare_tpu/visualization/visualizer.py``: boxes
are drawn with 2σ covariance ellipses at both corners, the ellipse axes from
the eigendecomposition of each 2x2 corner covariance scaled by the χ²
quantile. Rendering uses OpenCV (no display server needed), as there, so the
two packages draw the same pixels.
"""

from typing import Optional, Sequence, Tuple

import cv2
import numpy as np
from scipy.stats import chi2, norm


def cov_ellipse(
    cov: np.ndarray, q: Optional[float] = None, nsig: int = 2
) -> Tuple[float, float, float]:
    """(width, height, rotation_deg) of the nsig-confidence ellipse of a 2x2
    covariance: q = 2·Φ(nsig) − 1, r² = χ²₂-quantile(q), axes 2√(λ·r²)
    (reference: probabilistic_visualizer.py:322-354)."""
    if q is not None:
        q = np.asarray(q)
    elif nsig is not None:
        q = 2 * norm.cdf(nsig) - 1
    else:
        raise ValueError("One of `q` and `nsig` should be specified.")
    r2 = chi2.ppf(q, 2)
    vals, vecs = np.linalg.eigh(cov)
    width, height = 2 * np.sqrt(np.clip(vals, 0, None) * r2)
    rotation = float(np.degrees(np.arctan2(*vecs[::-1, 0])))
    return float(width), float(height), rotation


def _color_for(idx: int) -> Tuple[int, int, int]:
    palette = [
        (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
        (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
    ]
    return palette[idx % len(palette)]


def entropy_color(entropy: float, max_entropy: float = 2.0) -> Tuple[int, int, int]:
    """Low entropy (confident) → green, high entropy → red (BGR)."""
    t = float(np.clip(entropy / max_entropy, 0.0, 1.0))
    return (0, int(255 * (1 - t)), int(255 * t))


class ProbabilisticVisualizer:
    """Draws boxes + corner covariance ellipses on a BGR uint8 image."""

    def __init__(self, image: np.ndarray):
        self.image = np.ascontiguousarray(image).astype(np.uint8)

    def draw_box(self, box, color=(0, 255, 0), thickness=2, label: str = ""):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        cv2.rectangle(self.image, (x1, y1), (x2, y2), color, thickness)
        if label:
            cv2.putText(
                self.image, label, (x1, max(y1 - 4, 10)),
                cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1, cv2.LINE_AA,
            )
        return self

    def draw_ellipse(self, center, cov2x2, color=(0, 255, 0), nsig=2):
        """2σ covariance ellipse around a box corner
        (reference: probabilistic_visualizer.py:127-195)."""
        w, h, rot = cov_ellipse(np.asarray(cov2x2, float), nsig=nsig)
        if not (np.isfinite(w) and np.isfinite(h)):
            return self
        cv2.ellipse(
            self.image,
            (int(round(center[0])), int(round(center[1]))),
            (max(int(round(w / 2)), 1), max(int(round(h / 2)), 1)),
            rot, 0, 360, color, 1, cv2.LINE_AA,
        )
        return self

    def overlay_covariance_instances(
        self,
        boxes: np.ndarray,
        covariance_matrices: Optional[np.ndarray] = None,
        labels: Optional[Sequence[str]] = None,
        colors: Optional[Sequence[Tuple[int, int, int]]] = None,
        nsig: int = 2,
    ) -> "ProbabilisticVisualizer":
        """Draw each box with ellipses at its two corners using the
        (x1,y1) and (x2,y2) blocks of the 4x4 covariance
        (reference: probabilistic_visualizer.py:22-125)."""
        boxes = np.asarray(boxes)
        for i, box in enumerate(boxes):
            color = colors[i] if colors is not None else _color_for(i)
            label = labels[i] if labels is not None else ""
            self.draw_box(box, color=color, label=label)
            if covariance_matrices is not None:
                cov = np.asarray(covariance_matrices[i])
                self.draw_ellipse((box[0], box[1]), cov[0:2, 0:2], color, nsig)
                self.draw_ellipse((box[2], box[3]), cov[2:4, 2:4], color, nsig)
        return self

    def get_image(self) -> np.ndarray:
        return self.image
