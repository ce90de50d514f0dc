"""Plain anchors, analytic candidate core, standard NMS, BayesOD and the
rescale, for one image.

Frozen copies, at commit b304412 of this repository, of the analytic path
of ``pod_compare_tpu_torch``: ``ops/anchors.py`` (the grid anchors),
``inference/core.py`` (Gauss-Hermite class probabilities, per-level top-k,
the closed-form decode moments, the epistemic covariance of the runs'
boxes, the deferred covariance of NMS survivors), ``ops/boxes.py``,
``ops/gaussian.py`` (Cholesky inverses), ``ops/nms.py`` (the padded greedy
NMS), ``inference/modes.py`` and ``ops/fusion.py`` (``standard_nms``,
``bayes_od`` with Bayesian box fusion and either class merge) and
``inference/postprocess.py::detector_postprocess``. They are written out
again here in plain tensor operations and import nothing of the program.
``Dets`` holds what the program's ``Detections`` hold, minus its
bookkeeping fields.

``probs_dtype`` computes the class probabilities in another dtype: the
control of the core (bfloat16 where the program computes float32).
"""

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

SCALE_CLAMP = math.log(1000.0 / 16)
_MOMENT_VAR_CLAMP = 2.0
_CORNERS_FROM_T = ((1.0, 0.0, -0.5, 0.0), (0.0, 1.0, 0.0, -0.5),
                   (1.0, 0.0, 0.5, 0.0), (0.0, 1.0, 0.0, 0.5))
_FUSION_JITTER = 1e-5
_NEG_INF = -1e10
COV_CONDITIONING = 1e-4


class Dets(NamedTuple):
    boxes: torch.Tensor  # (D, 4)
    covs: torch.Tensor  # (D, 4, 4)
    scores: torch.Tensor  # (D,)
    classes: torch.Tensor  # (D,)
    prob_vectors: torch.Tensor  # (D, K)
    valid: torch.Tensor  # (D,)


# ------------------------------------------------------------ anchors
def anchor_sizes(min_size=32, num_levels=5, scales_per_octave=3):
    return [[min_size * 2 ** lvl * 2 ** (i / scales_per_octave) for i in range(scales_per_octave)]
            for lvl in range(num_levels)]


def anchors(canvas: Sequence[int], strides=(8, 16, 32, 64, 128),
            aspect_ratios=(0.5, 1.0, 2.0)) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """(R, 4) float32 anchors over P3-P7, (y, x, anchor) within a level, and
    the anchor count of each level."""
    per_level = []
    for sizes, stride in zip(anchor_sizes(), strides):
        cell = []
        for size in sizes:
            for aspect in aspect_ratios:
                w = math.sqrt(float(size) ** 2 / aspect)
                h = aspect * w
                cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        cell = np.asarray(cell, np.float32)
        gh, gw = -(-canvas[0] // stride), -(-canvas[1] // stride)
        sx = np.arange(gw, dtype=np.float32) * stride
        sy = np.arange(gh, dtype=np.float32) * stride
        yy, xx = np.meshgrid(sy, sx, indexing="ij")
        shifts = np.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()], axis=1)
        per_level.append((shifts[:, None, :] + cell[None]).reshape(-1, 4))
    return np.concatenate(per_level), tuple(a.shape[0] for a in per_level)


# ------------------------------------------------------------ geometry
def area(b):
    wh = (b[..., 2:4] - b[..., 0:2]).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a, b):
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    union = area(a)[:, None] + area(b)[None, :] - inter
    ok = union > 0
    return torch.where(ok, inter / torch.where(ok, union, torch.ones_like(union)), 0.0)


def _anchor_terms(a):
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    return a[..., 0] + 0.5 * aw, a[..., 1] + 0.5 * ah, aw, ah


def decode(deltas, a):
    ax, ay, aw, ah = _anchor_terms(a)
    dw = deltas[..., 2].clamp_max(SCALE_CLAMP)
    dh = deltas[..., 3].clamp_max(SCALE_CLAMP)
    px = deltas[..., 0] * aw + ax
    py = deltas[..., 1] * ah + ay
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], dim=-1)


def _mean_terms(deltas, sww, shh, a):
    ax, ay, aw, ah = _anchor_terms(a)
    mx, my = deltas[..., 0], deltas[..., 1]
    mw = deltas[..., 2].clamp_max(SCALE_CLAMP)
    mh = deltas[..., 3].clamp_max(SCALE_CLAMP)
    fw = torch.sqrt(_MOMENT_VAR_CLAMP / sww.clamp_min(_MOMENT_VAR_CLAMP))
    fh = torch.sqrt(_MOMENT_VAR_CLAMP / shh.clamp_min(_MOMENT_VAR_CLAMP))
    sww = sww * fw * fw
    shh = shh * fh * fh
    ew = torch.exp(mw + 0.5 * sww)
    eh = torch.exp(mh + 0.5 * shh)
    px, py = ax + aw * mx, ay + ah * my
    pw, ph = aw * ew, ah * eh
    mean = torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)
    return mean, (aw, ah), (fw, fh), (sww, shh), (ew, eh)


def decode_moments(deltas, cov, a):
    """Mean and covariance of the boxes decoded from N(deltas, cov)."""
    mean, (aw, ah), (fw, fh), (sww, shh), (ew, eh) = _mean_terms(
        deltas, cov[..., 2, 2], cov[..., 3, 3], a)
    s = cov
    sxx, syy = s[..., 0, 0], s[..., 1, 1]
    sxy, sxw, sxh = s[..., 0, 1], s[..., 0, 2], s[..., 0, 3]
    syw, syh, swh = s[..., 1, 2], s[..., 1, 3], s[..., 2, 3]
    swh = swh * fw * fh
    sxw, syw = sxw * fw, syw * fw
    sxh, syh = sxh * fh, syh * fh
    c00, c01 = aw * aw * sxx, aw * ah * sxy
    c02, c03 = aw * aw * sxw * ew, aw * ah * sxh * eh
    c11, c12, c13 = ah * ah * syy, ah * aw * syw * ew, ah * ah * syh * eh
    c22 = aw * aw * ew * ew * torch.expm1(sww)
    c23 = aw * ah * ew * eh * torch.expm1(swh)
    c33 = ah * ah * eh * eh * torch.expm1(shh)
    t_cov = torch.stack([torch.stack([c00, c01, c02, c03], -1),
                         torch.stack([c01, c11, c12, c13], -1),
                         torch.stack([c02, c12, c22, c23], -1),
                         torch.stack([c03, c13, c23, c33], -1)], -2)
    m = torch.tensor(_CORNERS_FROM_T, dtype=deltas.dtype, device=deltas.device)
    return mean, torch.einsum("ij,...jk,lk->...il", m, t_cov, m)


def cholesky_from_head(var):
    """Diagonal Cholesky factor of the head's 4 log-variances."""
    return torch.diag_embed(torch.sqrt(torch.exp(var[..., 0:4])))


def inv4x4(cov):
    chol = torch.linalg.cholesky_ex(cov).L
    eye = torch.eye(4, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("...ki,...kj->...ij", inv_l, inv_l)


# ------------------------------------------------------------ core
def class_probs(logits, log_var):
    """Mean sigmoid under N(logit, exp(log_var)): 32-node Gauss-Hermite."""
    if log_var is None:
        return torch.sigmoid(logits)
    std = torch.sqrt(torch.exp(log_var))
    nodes, weights = np.polynomial.hermite.hermgauss(32)
    nodes = torch.as_tensor(np.sqrt(2.0) * nodes, dtype=logits.dtype, device=logits.device)
    weights = torch.as_tensor(weights / np.sqrt(np.pi), dtype=logits.dtype,
                              device=logits.device)
    z = logits[None] + nodes[:, None, None] * std[None]
    return torch.einsum("s,sak->ak", weights, torch.sigmoid(z))


def _topk_per_level(scores, k, level_sizes):
    vals, idxs, start = [], [], 0
    for n in level_sizes:
        v, i = torch.sort(scores[start:start + n], descending=True, stable=True)
        m = min(k, int(n))
        vals.append(v[:m])
        idxs.append(i[:m] + start)
        start += n
    return torch.cat(vals), torch.cat(idxs)


class Cands(NamedTuple):
    boxes: torch.Tensor
    covs: torch.Tensor
    has_cov: bool
    scores: torch.Tensor
    classes: torch.Tensor
    prob_vectors: torch.Tensor
    valid: torch.Tensor
    anchor_idx: torch.Tensor


def core(anc, outs, run_deltas, level_sizes, topk=1000, score_thresh=0.05, defer=False,
         probs_dtype=torch.float32) -> Cands:
    """The analytic candidate core of one image: `outs` holds its (R, k)
    mean head outputs, `run_deltas` its (M, R, 4) per-run deltas or None."""
    cls, var = outs["box_cls"], outs["box_cls_var"]
    if probs_dtype != torch.float32:
        cls = cls.to(probs_dtype)
        var = None if var is None else var.to(probs_dtype)
    probs = class_probs(cls, var).float()
    scores_all = probs.amax(dim=1)
    classes_all = probs.argmax(dim=1)
    scores, idx = _topk_per_level(scores_all, topk, level_sizes)
    valid = scores > score_thresh
    deltas, a = outs["box_delta"][idx], anc[idx]
    epistemic = None
    if run_deltas is not None:
        runs = decode(run_deltas[:, idx, :], a)
        resid = runs - runs.mean(dim=0)[None]
        epistemic = torch.einsum("s...i,s...j->...ij", resid, resid) / max(runs.shape[0] - 1, 1)
    reg = outs["box_reg_var"]
    if reg is not None and defer and epistemic is None:
        chol = cholesky_from_head(reg[idx])
        diag = torch.einsum("cij,cij->ci", chol, chol)
        boxes = _mean_terms(deltas, diag[..., 2], diag[..., 3], a)[0]
        covs, has_cov = boxes.new_zeros(boxes.shape[:-1] + (4, 4)), False
    elif reg is not None:
        chol = cholesky_from_head(reg[idx])
        boxes, covs = decode_moments(deltas, torch.einsum("cij,ckj->cik", chol, chol), a)
        if epistemic is not None:
            covs = covs + epistemic
        has_cov = True
    else:
        boxes = decode(deltas, a)
        has_cov = epistemic is not None
        covs = epistemic if has_cov else boxes.new_zeros(boxes.shape[:-1] + (4, 4))
    return Cands(boxes, covs, has_cov, scores, classes_all[idx], probs[idx], valid, idx)


# ------------------------------------------------------------ NMS and modes
def batched_nms(boxes, scores, classes, valid, thresh, max_out):
    """Class-aware greedy NMS, `max_out` steps: (indices, valid) padded."""
    max_coord = torch.where(valid[:, None], boxes, 0.0).max() + 1.0
    b = boxes + classes.to(boxes.dtype)[:, None] * max_coord
    cur = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    indices, oks = [], []
    for _ in range(max_out):
        i = torch.argmax(cur).reshape(1)
        ok = cur.index_select(0, i) > _NEG_INF / 2
        iou = pairwise_iou(b.index_select(0, i), b)[0]
        cur = torch.where(ok & (iou > thresh), _NEG_INF, cur).index_fill(0, i, _NEG_INF)
        indices.append(i)
        oks.append(ok)
    return torch.cat(indices), torch.cat(oks)


def standard_nms(c: Cands, thresh, max_dets) -> Tuple[Dets, torch.Tensor]:
    keep, ok = batched_nms(c.boxes, c.scores, c.classes, c.valid, thresh, max_dets)
    d = Dets(c.boxes[keep], c.covs[keep], c.scores[keep], c.classes[keep],
             c.prob_vectors[keep], c.valid[keep] & ok)
    return d, c.anchor_idx[keep]


def deferred_covariance(d: Dets, anchor_idx, outs, anc) -> Dets:
    chol = cholesky_from_head(outs["box_reg_var"][anchor_idx])
    _, covs = decode_moments(outs["box_delta"][anchor_idx],
                             torch.einsum("cij,ckj->cik", chol, chol), anc[anchor_idx])
    return d._replace(covs=covs)


def bayes_od(c: Cands, thresh, max_dets, affinity, cls_merge="max_score") -> Dets:
    """NMS centers, clusters of IoU > affinity (of the center's class for
    the box fusion), precision-weighted Gaussian fusion of the members."""
    keep, ok = batched_nms(c.boxes, c.scores, c.classes, c.valid, thresh, max_dets)
    iou = pairwise_iou(c.boxes[keep], c.boxes)
    cluster = (iou > affinity) & c.valid[None, :]
    fusion = cluster & (c.classes[None, :] == c.classes[keep][:, None])
    if c.has_cov:
        mean_diag = torch.diagonal(c.covs, dim1=-2, dim2=-1).mean(dim=-1, keepdim=True)
        eps = _FUSION_JITTER * mean_diag.clamp_min(1.0)[..., None]
        covs = c.covs + eps * torch.eye(4, dtype=c.covs.dtype, device=c.covs.device)
    else:
        covs = (1e-4 * torch.eye(4, dtype=c.boxes.dtype, device=c.boxes.device)).expand(
            c.covs.shape)
    precs = inv4x4(covs)
    m = fusion.to(c.boxes.dtype)
    prec_sum = torch.einsum("cn,nij->cij", m, precs) + 1e-8 * torch.eye(
        4, dtype=c.boxes.dtype, device=c.boxes.device)
    fused_cov = inv4x4(prec_sum)
    fused = torch.einsum("cij,cj->ci", fused_cov, m @ torch.einsum("nij,nj->ni", precs, c.boxes))
    if cls_merge == "bayesian_inference":
        w = cluster.to(c.prob_vectors.dtype)
        probs = (w @ c.prob_vectors) / w.sum(dim=1).clamp_min(1.0)[:, None]
        scores, classes = probs.amax(dim=1), probs.argmax(dim=1)
    else:
        probs, scores, classes = c.prob_vectors[keep], c.scores[keep], c.classes[keep]
    return Dets(fused, fused_cov, scores, classes, probs, ok)


def rescale(d: Dets, input_hw, output_hw) -> Dets:
    """Boxes and covariances to the original image size, clipped; empty
    boxes dropped."""
    sx = output_hw[1] / input_hw[1]
    sy = output_hw[0] / input_hw[0]
    s = torch.tensor([sx, sy, sx, sy], dtype=d.boxes.dtype, device=d.boxes.device)
    b = d.boxes * s
    hi = torch.tensor([output_hw[1], output_hw[0]] * 2, dtype=b.dtype, device=b.device)
    b = torch.minimum(torch.maximum(b, torch.zeros_like(b)), hi)
    valid = d.valid & ((b[:, 2] - b[:, 0]) > 0) & ((b[:, 3] - b[:, 1]) > 0)
    eye = torch.eye(4, dtype=d.covs.dtype, device=d.covs.device)
    covs = (d.covs + COV_CONDITIONING * eye) * s[:, None] * s[None, :]
    return d._replace(boxes=b, covs=covs, valid=valid)


def detect(anc, level_sizes, outs, run_deltas, mode: str, input_hw, output_hw,
           nms_thresh=0.5, max_dets=100, affinity=0.9, cls_merge="max_score",
           topk=1000, score_thresh=0.05, probs_dtype=torch.float32) -> Dets:
    """One image's detections from its head outputs: the core, the mode
    ('bayes_od' or 'standard_nms') and the rescale."""
    if mode == "bayes_od":
        c = core(anc, outs, run_deltas, level_sizes, topk, score_thresh,
                 probs_dtype=probs_dtype)
        d = bayes_od(c, nms_thresh, max_dets, affinity, cls_merge)
    elif mode == "standard_nms":
        defer = run_deltas is None
        c = core(anc, outs, run_deltas, level_sizes, topk, score_thresh, defer=defer,
                 probs_dtype=probs_dtype)
        d, anchor_idx = standard_nms(c, nms_thresh, max_dets)
        if defer and outs["box_reg_var"] is not None:
            d = deferred_covariance(d, anchor_idx, outs, anc)
    else:
        raise ValueError(f"the reference has no mode {mode!r}")
    return rescale(d, input_hw, output_hw)
