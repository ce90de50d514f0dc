// C++ GT↔prediction matching engine for uncertainty evaluation.
//
// The port's copy of pod_compare_tpu/native/match_engine.cpp, the native
// counterpart of pod_compare_tpu_torch/evaluation/matching.py
// (reference semantics: evaluation_utils.py:191-367 — a per-image python
// loop slow enough that the reference disk-caches its results). Partitions
// detections into true-positive / duplicate / false-positive /
// false-negative sets with the iou_min / iou_correct thresholds and the
// highest-score-per-gt rule.
//
// Inputs are flat arrays sorted by image: per-image segments given by
// offset arrays. Outputs are index pairs into the original det/gt arrays;
// Python gathers the payload columns.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

double iou_xyxy(const double* a, const double* b) {
  const double ix1 = std::max(a[0], b[0]);
  const double iy1 = std::max(a[1], b[1]);
  const double ix2 = std::min(a[2], b[2]);
  const double iy2 = std::min(a[3], b[3]);
  const double iw = ix2 - ix1, ih = iy2 - iy1;
  if (iw <= 0 || ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double ua = (a[2] - a[0]) * (a[3] - a[1]) +
                    (b[2] - b[0]) * (b[3] - b[1]) - inter;
  return ua > 0 ? inter / ua : 0.0;
}

struct Outputs {
  std::vector<int64_t> tp_det, tp_gt;
  std::vector<double> tp_iou;
  std::vector<int64_t> dup_det, dup_gt;
  std::vector<double> dup_iou;
  std::vector<int64_t> fp_det;
  std::vector<int64_t> fn_gt;
};

Outputs* g_out = nullptr;  // per-call scratch (single-threaded API)

}  // namespace

extern "C" {

// det_boxes: (D,4) xyxy; det_scores: (D,) max class prob.
// gt_boxes: (G,4) xyxy.
// image segmentation: num_images+1 offsets into det and gt arrays; image i
// owns dets [det_off[i], det_off[i+1]) and gts [gt_off[i], gt_off[i+1]).
// Returns counts via out_counts = {n_tp, n_dup, n_fp, n_fn}; results are
// fetched with match_engine_fetch.
int match_engine_run(
    const double* det_boxes, const double* det_scores,
    const double* gt_boxes,
    const int64_t* det_off, const int64_t* gt_off, int64_t num_images,
    double iou_min, double iou_correct,
    int64_t* out_counts) {
  delete g_out;
  g_out = new Outputs();
  Outputs& o = *g_out;

  std::vector<double> iou;   // per-image scratch (G x D)
  for (int64_t img = 0; img < num_images; ++img) {
    const int64_t d0 = det_off[img], d1 = det_off[img + 1];
    const int64_t g0 = gt_off[img], g1 = gt_off[img + 1];
    const int64_t D = d1 - d0, G = g1 - g0;
    if (D == 0 && G == 0) continue;
    if (G == 0) {
      for (int64_t d = d0; d < d1; ++d) o.fp_det.push_back(d);
      continue;
    }
    if (D == 0) {
      for (int64_t g = g0; g < g1; ++g) o.fn_gt.push_back(g);
      continue;
    }
    iou.assign((size_t)(G * D), 0.0);
    for (int64_t g = 0; g < G; ++g) {
      for (int64_t d = 0; d < D; ++d) {
        iou[(size_t)(g * D + d)] =
            iou_xyxy(gt_boxes + 4 * (g0 + g), det_boxes + 4 * (d0 + d));
      }
    }
    // false negatives: gt rows with all ious <= iou_min
    for (int64_t g = 0; g < G; ++g) {
      bool missed = true;
      for (int64_t d = 0; d < D && missed; ++d) {
        if (iou[(size_t)(g * D + d)] > iou_min) missed = false;
      }
      if (missed) o.fn_gt.push_back(g0 + g);
    }
    // false positives: det cols with all ious <= iou_min
    for (int64_t d = 0; d < D; ++d) {
      bool unmatched = true;
      for (int64_t g = 0; g < G && unmatched; ++g) {
        if (iou[(size_t)(g * D + d)] > iou_min) unmatched = false;
      }
      if (unmatched) o.fp_det.push_back(d0 + d);
    }
    // true positives + duplicates (per gt; a det may serve several gts —
    // preserving the reference's un-deduplicated behavior,
    // evaluation_utils.py:272-286).
    for (int64_t g = 0; g < G; ++g) {
      int64_t best = -1;
      double best_score = -1.0;
      for (int64_t d = 0; d < D; ++d) {
        if (iou[(size_t)(g * D + d)] >= iou_correct) {
          const double s = det_scores[d0 + d];
          if (s > best_score) {
            best_score = s;
            best = d;
          }
        }
      }
      if (best < 0) continue;
      o.tp_det.push_back(d0 + best);
      o.tp_gt.push_back(g0 + g);
      o.tp_iou.push_back(iou[(size_t)(g * D + best)]);
      for (int64_t d = 0; d < D; ++d) {
        if (d != best && iou[(size_t)(g * D + d)] >= iou_correct) {
          o.dup_det.push_back(d0 + d);
          o.dup_gt.push_back(g0 + g);
          o.dup_iou.push_back(iou[(size_t)(g * D + d)]);
        }
      }
    }
  }
  out_counts[0] = (int64_t)o.tp_det.size();
  out_counts[1] = (int64_t)o.dup_det.size();
  out_counts[2] = (int64_t)o.fp_det.size();
  out_counts[3] = (int64_t)o.fn_gt.size();
  return 0;
}

// Copies results into caller-allocated buffers (sizes from out_counts).
int match_engine_fetch(
    int64_t* tp_det, int64_t* tp_gt, double* tp_iou,
    int64_t* dup_det, int64_t* dup_gt, double* dup_iou,
    int64_t* fp_det, int64_t* fn_gt) {
  if (!g_out) return 1;
  const Outputs& o = *g_out;
  std::copy(o.tp_det.begin(), o.tp_det.end(), tp_det);
  std::copy(o.tp_gt.begin(), o.tp_gt.end(), tp_gt);
  std::copy(o.tp_iou.begin(), o.tp_iou.end(), tp_iou);
  std::copy(o.dup_det.begin(), o.dup_det.end(), dup_det);
  std::copy(o.dup_gt.begin(), o.dup_gt.end(), dup_gt);
  std::copy(o.dup_iou.begin(), o.dup_iou.end(), dup_iou);
  std::copy(o.fp_det.begin(), o.fp_det.end(), fp_det);
  std::copy(o.fn_gt.begin(), o.fn_gt.end(), fn_gt);
  delete g_out;
  g_out = nullptr;
  return 0;
}

}  // extern "C"
