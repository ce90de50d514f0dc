"""First-party COCO detection mAP evaluator (numpy and C++).

The port's copy of ``pod_compare_tpu/evaluation/coco_eval.py``, in float64
as there. The C++ engine is the port's own build
(``pod_compare_tpu_torch/native``), and it does not fall back: ``run``
uses it unless the caller asks for the numpy engine, and logs which ran.

The reference leans on pycocotools' C COCOeval
(reference: compute_average_precision.py:9-10,35-44); that package is not
available in this environment, so the evaluator is reimplemented faithfully:
same greedy IoU matching with crowd/ignore semantics, same 101-point
interpolated precision accumulation, same 12 summary stats, and the
reference's optimal-micro-F1 score-threshold computation on top
(compute_average_precision.py:46-68).

Inputs are plain COCO-format dicts (GT json + detection records), so this
runs off the hot path on host.
"""

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU on xywh boxes; crowd gts use intersection/det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0:1], dets[:, 1:2]
    dx2, dy2 = dx1 + dets[:, 2:3], dy1 + dets[:, 3:4]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gx1 + gts[:, 2], gy1 + gts[:, 3]
    iw = np.clip(np.minimum(dx2, gx2[None]) - np.maximum(dx1, gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2, gy2[None]) - np.maximum(dy1, gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class COCOEvaluator:
    """COCOeval('bbox')-equivalent evaluator.

    Args:
        gt: COCO GT dict with 'images' and 'annotations'.
        detections: list of {'image_id', 'category_id', 'bbox', 'score'}.
        cat_ids: category ids to evaluate (the reference restricts to
            [1, 3] — car, person; compute_average_precision.py:39).
    """

    def __init__(
        self,
        gt: Dict,
        detections: List[dict],
        cat_ids: Optional[Sequence[int]] = None,
        iou_thrs: np.ndarray = IOU_THRS,
        rec_thrs: np.ndarray = REC_THRS,
        max_dets: Sequence[int] = MAX_DETS,
    ):
        self.iou_thrs = np.asarray(iou_thrs)
        self.rec_thrs = np.asarray(rec_thrs)
        self.max_dets = list(max_dets)
        self.img_ids = [im["id"] for im in gt["images"]]
        if cat_ids is None:
            cat_ids = sorted({c["id"] for c in gt.get("categories", [])})
        self.cat_ids = list(cat_ids)

        self._gts = defaultdict(list)
        for ann in gt["annotations"]:
            if ann["category_id"] in set(self.cat_ids):
                a = dict(ann)
                a.setdefault("area", a["bbox"][2] * a["bbox"][3])
                a.setdefault("iscrowd", 0)
                a["ignore"] = a.get("ignore", 0) or a["iscrowd"]
                self._gts[(ann["image_id"], ann["category_id"])].append(a)
        self._dts = defaultdict(list)
        for det in detections:
            if det["category_id"] in set(self.cat_ids):
                d = dict(det)
                d.setdefault("area", d["bbox"][2] * d["bbox"][3])
                self._dts[(det["image_id"], det["category_id"])].append(d)

        self.eval: Dict = {}
        self.stats: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- match
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts[(img_id, cat_id)]
        dts = sorted(
            self._dts[(img_id, cat_id)], key=lambda d: -d["score"]
        )[:max_det]
        if not gts and not dts:
            return None

        g_ignore = np.array(
            [
                g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
                for g in gts
            ],
            float,
        )
        # pycocotools sorts gts ignored-last (stable)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_crowd = np.array([g["iscrowd"] for g in gts])

        ious = iou_xywh(
            np.array([d["bbox"] for d in dts], float).reshape(-1, 4),
            np.array([g["bbox"] for g in gts], float).reshape(-1, 4),
            g_crowd if len(gts) else np.zeros(0),
        )

        T, D, G = len(self.iou_thrs), len(dts), len(gts)
        dt_match = np.zeros((T, D), dtype=np.int64)
        gt_match = np.zeros((T, G), dtype=np.int64)
        dt_ignore = np.zeros((T, D))
        for t_idx, t in enumerate(self.iou_thrs):
            for d_idx in range(D):
                best_iou = min(t, 1.0 - 1e-10)
                m = -1
                for g_idx in range(G):
                    if gt_match[t_idx, g_idx] > 0 and not g_crowd[g_idx]:
                        continue
                    # non-ignored matches found earlier beat ignored ones
                    if m > -1 and g_ignore[m] == 0 and g_ignore[g_idx] == 1:
                        break
                    if ious[d_idx, g_idx] < best_iou:
                        continue
                    best_iou = ious[d_idx, g_idx]
                    m = g_idx
                if m == -1:
                    continue
                dt_ignore[t_idx, d_idx] = g_ignore[m]
                # nonzero marker (m+1, not the raw gt id): dt_match is only
                # tested for nonzero-ness downstream, and raw ids of 0 —
                # legal in ad-hoc fixtures — would silently unmatch
                dt_match[t_idx, d_idx] = m + 1
                gt_match[t_idx, m] = 1
        dt_out_of_range = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts],
            dtype=bool,
        )
        dt_ignore = np.logical_or(
            dt_ignore, (dt_match == 0) & dt_out_of_range[None]
        )
        return {
            "dt_matches": dt_match,
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_ignore": dt_ignore,
            "gt_ignore": g_ignore,
            "num_gt": int((g_ignore == 0).sum()),
        }

    # ----------------------------------------------------------- accumulate
    def evaluate(self) -> None:
        self._img_evals = {}
        for cat in self.cat_ids:
            for area_name, area_rng in AREA_RNGS.items():
                for img_id in self.img_ids:
                    self._img_evals[(cat, area_name, img_id)] = self._evaluate_img(
                        img_id, cat, area_rng, max(self.max_dets)
                    )

    def accumulate(self) -> None:
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(AREA_RNGS)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat in enumerate(self.cat_ids):
            for a, area_name in enumerate(AREA_RNGS):
                evals = [
                    self._img_evals[(cat, area_name, img_id)]
                    for img_id in self.img_ids
                ]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                for m, max_det in enumerate(self.max_dets):
                    dt_scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in evals]
                    )
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[order]
                    dt_m = np.concatenate(
                        [e["dt_matches"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evals], axis=1
                    )[:, order]
                    num_gt = sum(e["num_gt"] for e in evals)
                    if num_gt == 0:
                        continue
                    tps = (dt_m > 0) & ~dt_ig.astype(bool)
                    fps = (dt_m == 0) & ~dt_ig.astype(bool)
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0
                        # monotone precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------ summarize
    def _summarize(self, ap=True, iou_thr=None, area="all", max_det=100):
        a = list(AREA_RNGS).index(area)
        m = self.max_dets.index(max_det)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[self.iou_thrs == iou_thr]
            s = s[:, :, :, a, m]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[self.iou_thrs == iou_thr]
            s = s[:, :, a, m]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        """The 12 standard COCO bbox stats."""
        st = np.array(
            [
                self._summarize(True),
                self._summarize(True, iou_thr=0.5),
                self._summarize(True, iou_thr=0.75),
                self._summarize(True, area="small"),
                self._summarize(True, area="medium"),
                self._summarize(True, area="large"),
                self._summarize(False, max_det=1),
                self._summarize(False, max_det=10),
                self._summarize(False, max_det=100),
                self._summarize(False, area="small"),
                self._summarize(False, area="medium"),
                self._summarize(False, area="large"),
            ]
        )
        self.stats = st
        if verbose:
            names = [
                "AP@[.50:.95]", "AP@.50", "AP@.75", "AP-small", "AP-medium",
                "AP-large", "AR@1", "AR@10", "AR@100", "AR-small",
                "AR-medium", "AR-large",
            ]
            for n, v in zip(names, st):
                print(f"{n:>12s} = {v:.4f}")
        return st

    # -------------------------------------------------------- native engine
    def _run_native(self) -> None:
        """Evaluate+accumulate through the C++ engine
        (pod_compare_tpu_torch/native/cocoeval.cpp); raises when the
        native library cannot be built or loaded."""
        from pod_compare_tpu_torch import native

        img_index = {img_id: i for i, img_id in enumerate(self.img_ids)}
        cat_index = {cat: i for i, cat in enumerate(self.cat_ids)}

        det_img, det_cat, det_bbox, det_score = [], [], [], []
        for (img_id, cat), dets in self._dts.items():
            if img_id not in img_index:
                continue
            for d in dets:
                det_img.append(img_index[img_id])
                det_cat.append(cat_index[cat])
                det_bbox.append(d["bbox"])
                det_score.append(d["score"])
        gt_img, gt_cat, gt_bbox, gt_area, gt_crowd, gt_ign = [], [], [], [], [], []
        for (img_id, cat), gts in self._gts.items():
            if img_id not in img_index:
                continue
            for g in gts:
                gt_img.append(img_index[img_id])
                gt_cat.append(cat_index[cat])
                gt_bbox.append(g["bbox"])
                gt_area.append(g["area"])
                gt_crowd.append(g["iscrowd"])
                gt_ign.append(g["ignore"])

        area_rngs = np.asarray(list(AREA_RNGS.values()), np.float64)
        precision, recall, scores = native.cocoeval_run(
            np.asarray(det_img, np.int64),
            np.asarray(det_cat, np.int64),
            np.asarray(det_bbox, np.float64).reshape(-1, 4),
            np.asarray(det_score, np.float64),
            np.asarray(gt_img, np.int64),
            np.asarray(gt_cat, np.int64),
            np.asarray(gt_bbox, np.float64).reshape(-1, 4),
            np.asarray(gt_area, np.float64),
            np.asarray(gt_crowd, np.uint8),
            np.asarray(gt_ign, np.uint8),
            len(self.img_ids),
            len(self.cat_ids),
            self.iou_thrs,
            self.rec_thrs,
            area_rngs,
            self.max_dets,
        )
        self.eval = {"precision": precision, "recall": recall, "scores": scores}

    def run(self, verbose: bool = True, use_native: bool = True) -> np.ndarray:
        """Full evaluation with the C++ engine, or with the numpy one when
        `use_native` is False (the tests hold the two equal)."""
        logger.info(
            f"COCO evaluation engine: {'native C++' if use_native else 'numpy'} "
            f"({len(self.img_ids)} images, {len(self.cat_ids)} categories)"
        )
        if use_native:
            self._run_native()
        else:
            self.evaluate()
            self.accumulate()
        return self.summarize(verbose)


def optimal_score_threshold(evaluator: COCOEvaluator) -> float:
    """Classification score at the optimal micro-F1 point, averaged over
    classes (reference: compute_average_precision.py:46-68)."""
    precisions = evaluator.eval["precision"].mean(0)[:, :, 0, -1]  # (R, K)
    recalls = evaluator.rec_thrs[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = 2 * (precisions * recalls) / (precisions + recalls)
    f1 = np.nan_to_num(f1, nan=0.0)
    best = f1.argmax(0)
    scores = evaluator.eval["scores"].mean(0)[:, :, 0, -1]
    opt = np.array([scores[bi, i] for i, bi in enumerate(best)])
    opt = opt[opt != 0]
    return float(opt.mean()) if opt.size else 0.0
