"""Box geometry in PyTorch: IoU, delta decode, decode moments, transforms.

Counterpart of ``pod_compare_tpu/ops/boxes.py`` for the functions the
inference path uses. Boxes are (..., 4) tensors in XYXY absolute
coordinates unless stated; every function broadcasts over leading axes.
"""

import math
from typing import Tuple

import torch

# Clamp preventing exp() overflow in box decode (detectron2's
# `_DEFAULT_SCALE_CLAMP`).
SCALE_CLAMP = math.log(1000.0 / 16)

# Saturation cap (in scaled log-size variance) for the analytic decode
# moments, shared by `decoded_box_moments` and `decoded_box_mean`.
_MOMENT_VAR_CLAMP = 2.0

# Box corners are affine in t = (px, py, pw, ph): b = A t.
_CORNERS_FROM_T = (
    (1.0, 0.0, -0.5, 0.0),
    (0.0, 1.0, 0.0, -0.5),
    (1.0, 0.0, 0.5, 0.0),
    (0.0, 1.0, 0.0, 0.5),
)
# Jacobian of (x1, y1, x2, y2) -> (x1, y1, w, h), for COCO json covariances.
_XYXY_TO_XYWH_J = (
    (1.0, 0.0, 0.0, 0.0),
    (0.0, 1.0, 0.0, 0.0),
    (-1.0, 0.0, 1.0, 0.0),
    (0.0, -1.0, 0.0, 1.0),
)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas; negative extents clip to zero."""
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU matrix; IoU is 0 where the union is empty."""
    x1 = torch.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = torch.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = torch.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = torch.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    ok = union > 0
    return torch.where(ok, inter / torch.where(ok, union, torch.ones_like(union)), 0.0)


def _anchor_terms(anchors: torch.Tensor):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    return anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah, aw, ah


def decode_deltas(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on anchors into XYXY boxes."""
    ax, ay, aw, ah = _anchor_terms(anchors)
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp_max(SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp_max(SCALE_CLAMP)
    px = dx * aw + ax
    py = dy * ah + ay
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    return torch.stack(
        [px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], dim=-1
    )


def _decoded_mean_terms(deltas, sww, shh, anchors, weights):
    """Shared prefix of `decoded_box_moments` and `decoded_box_mean`:
    elementwise only, so both return bit-identical means. `sww`/`shh` are
    the raw log-size delta variances; the returned pair is weight-scaled
    and clamped."""
    ax, ay, aw, ah = _anchor_terms(anchors)
    w = torch.tensor(weights, dtype=deltas.dtype, device=deltas.device)
    m = deltas / w
    sww = sww / (w[2] * w[2])
    shh = shh / (w[3] * w[3])

    mx, my = m[..., 0], m[..., 1]
    mw = m[..., 2].clamp_max(SCALE_CLAMP)
    mh = m[..., 3].clamp_max(SCALE_CLAMP)
    fw = torch.sqrt(_MOMENT_VAR_CLAMP / sww.clamp_min(_MOMENT_VAR_CLAMP))
    fh = torch.sqrt(_MOMENT_VAR_CLAMP / shh.clamp_min(_MOMENT_VAR_CLAMP))
    sww = sww * fw * fw
    shh = shh * fh * fh

    ew = torch.exp(mw + 0.5 * sww)  # E[exp(dw)]
    eh = torch.exp(mh + 0.5 * shh)
    px = ax + aw * mx
    py = ay + ah * my
    pw = aw * ew
    ph = ah * eh
    mean_boxes = torch.stack(
        [px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1
    )
    return mean_boxes, (ax, ay, aw, ah), (fw, fh), (sww, shh), (ew, eh)


def decoded_box_moments(
    deltas: torch.Tensor,
    cov: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form mean and covariance of decoded boxes when the deltas are
    N(deltas, cov): the decoded box is affine in (dx, dy, exp(dw), exp(dh)),
    whose moments are Gaussian/lognormal cross-moments (see the JAX
    counterpart for the derivation).

    Returns (mean_boxes (..., 4) XYXY, box_covs (..., 4, 4)).
    """
    mean_boxes, (ax, ay, aw, ah), (fw, fh), (sww, shh), (ew, eh) = (
        _decoded_mean_terms(deltas, cov[..., 2, 2], cov[..., 3, 3], anchors, weights)
    )
    w = torch.tensor(weights, dtype=deltas.dtype, device=deltas.device)
    s = cov / (w[:, None] * w[None, :])
    sxx, syy = s[..., 0, 0], s[..., 1, 1]
    sxy, sxw, sxh = s[..., 0, 1], s[..., 0, 2], s[..., 0, 3]
    syw, syh, swh = s[..., 1, 2], s[..., 1, 3], s[..., 2, 3]

    # Complete the saturation guard PSD-safely on the off-diagonals.
    swh = swh * fw * fh
    sxw, syw = sxw * fw, syw * fw
    sxh, syh = sxh * fh, syh * fh

    c00 = aw * aw * sxx
    c01 = aw * ah * sxy
    c02 = aw * aw * sxw * ew
    c03 = aw * ah * sxh * eh
    c11 = ah * ah * syy
    c12 = ah * aw * syw * ew
    c13 = ah * ah * syh * eh
    c22 = aw * aw * ew * ew * torch.expm1(sww)
    c23 = aw * ah * ew * eh * torch.expm1(swh)
    c33 = ah * ah * eh * eh * torch.expm1(shh)
    t_cov = torch.stack(
        [
            torch.stack([c00, c01, c02, c03], -1),
            torch.stack([c01, c11, c12, c13], -1),
            torch.stack([c02, c12, c22, c23], -1),
            torch.stack([c03, c13, c23, c33], -1),
        ],
        -2,
    )
    a_mat = torch.tensor(_CORNERS_FROM_T, dtype=deltas.dtype, device=deltas.device)
    box_covs = torch.einsum("ij,...jk,lk->...il", a_mat, t_cov, a_mat)
    return mean_boxes, box_covs


def decoded_box_mean(
    deltas: torch.Tensor,
    diag_cov: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Mean of `decoded_box_moments` without the covariance; it needs only
    the delta-covariance diagonal (..., 4)."""
    return _decoded_mean_terms(
        deltas, diag_cov[..., 2], diag_cov[..., 3], anchors, weights
    )[0]


def decode_delta_samples(
    delta_samples: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Decode an (S, N, 4) bank of delta samples on (N, 4) anchors into
    (S, N, 4) XYXY boxes (the anchors broadcast over the sample axis)."""
    return decode_deltas(delta_samples, anchors[None], weights)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip XYXY boxes to [0, W] x [0, H]; sizes may be tensors."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), width)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), height)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), width)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with positive width and height."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold
    )


def _xyxy_scale(scale_x, scale_y, like: torch.Tensor) -> torch.Tensor:
    sx = torch.as_tensor(scale_x, dtype=like.dtype, device=like.device)
    sy = torch.as_tensor(scale_y, dtype=like.dtype, device=like.device)
    return torch.stack([sx, sy, sx, sy])


def scale_boxes(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """Scale XYXY boxes by (scale_x, scale_y)."""
    return boxes * _xyxy_scale(scale_x, scale_y, boxes)


def scale_covariance(covs: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """Conjugate 4x4 box covariances by the diagonal scale matrix: S Σ Sᵀ."""
    s = _xyxy_scale(scale_x, scale_y, covs)
    return covs * s[:, None] * s[None, :]


def covar_xyxy_to_xywh(covs: torch.Tensor) -> torch.Tensor:
    """Transform corner-corner covariances to corner-size (J Σ Jᵀ)."""
    j = torch.tensor(_XYXY_TO_XYWH_J, dtype=covs.dtype, device=covs.device)
    return torch.einsum("ij,...jk,lk->...il", j, covs, j)
