// C++ COCO detection evaluation engine.
//
// The port's copy of pod_compare_tpu/native/cocoeval.cpp, the native
// counterpart of pod_compare_tpu_torch/evaluation/coco_eval.py — the role
// pycocotools' C extension plays for the reference
// (reference: compute_average_precision.py:9-10). The full evaluate +
// accumulate pipeline runs in one call over flat arrays; Python only
// marshals inputs and reads back the (T,R,K,A,M) precision/scores tensors.
//
// Matching semantics replicate pycocotools COCOeval('bbox') exactly:
// greedy per-detection matching in score order with crowd/ignore handling,
// ignored-gt-sorted-last, area-range det ignoring, 101-point interpolated
// precision with score recording, mergesort-stable ordering.
//
// Built with g++ into build/ by pod_compare_tpu_torch/native/__init__.py
// and bound with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <numeric>
#include <vector>

namespace {

struct Det {
  double bbox[4];  // xywh
  double score;
  double area;
  int64_t index;  // original order (for stable sorts)
};

struct Gt {
  double bbox[4];
  double area;
  bool iscrowd;
  bool ignore_base;  // iscrowd || explicit ignore
  int64_t id;        // 1-based unique id
};

double iou_xywh(const double d[4], const double g[4], bool crowd) {
  const double dx2 = d[0] + d[2], dy2 = d[1] + d[3];
  const double gx2 = g[0] + g[2], gy2 = g[1] + g[3];
  const double iw = std::min(dx2, gx2) - std::max(d[0], g[0]);
  const double ih = std::min(dy2, gy2) - std::max(d[1], g[1]);
  if (iw <= 0 || ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double darea = d[2] * d[3];
  const double garea = g[2] * g[3];
  const double uni = crowd ? darea : darea + garea - inter;
  return uni > 0 ? inter / uni : 0.0;
}

struct ImgEval {
  // [T x D] flattened
  std::vector<int64_t> dt_matches;
  std::vector<uint8_t> dt_ignore;
  std::vector<double> dt_scores;
  int num_gt = 0;  // non-ignored
  int D = 0;
  bool present = false;
};

}  // namespace

extern "C" {

// Evaluates all detections/gts and fills precision/recall/scores tensors.
//
// det_*: D detections; gt_*: G ground truths. img/cat values are
// contiguous indices in [0, num_images) / [0, num_cats).
// area_rngs: A pairs (lo, hi). iou_thrs: T thresholds. rec_thrs: R recall
// points. max_dets: M values (ascending; last = overall cap).
// Outputs (pre-allocated by caller, filled with -1):
//   precision: T*R*K*A*M, recall: T*K*A*M, scores: T*R*K*A*M.
int cocoeval_run(
    const int64_t* det_img, const int64_t* det_cat, const double* det_bbox,
    const double* det_score, int64_t num_det,
    const int64_t* gt_img, const int64_t* gt_cat, const double* gt_bbox,
    const double* gt_area, const uint8_t* gt_iscrowd, const uint8_t* gt_ignore,
    int64_t num_gt,
    int64_t num_images, int64_t num_cats,
    const double* iou_thrs, int64_t T,
    const double* rec_thrs, int64_t R,
    const double* area_rngs, int64_t A,
    const int64_t* max_dets, int64_t M,
    double* precision, double* recall, double* scores_out) {
  // ------------------------------------------------------------- grouping
  std::vector<std::vector<Det>> dets((size_t)num_images * num_cats);
  std::vector<std::vector<Gt>> gts((size_t)num_images * num_cats);
  for (int64_t i = 0; i < num_det; ++i) {
    Det d;
    std::memcpy(d.bbox, det_bbox + 4 * i, sizeof(d.bbox));
    d.score = det_score[i];
    d.area = d.bbox[2] * d.bbox[3];
    d.index = i;
    dets[(size_t)(det_img[i] * num_cats + det_cat[i])].push_back(d);
  }
  for (int64_t i = 0; i < num_gt; ++i) {
    Gt g;
    std::memcpy(g.bbox, gt_bbox + 4 * i, sizeof(g.bbox));
    g.area = gt_area[i];
    g.iscrowd = gt_iscrowd[i] != 0;
    g.ignore_base = g.iscrowd || gt_ignore[i] != 0;
    g.id = i + 1;
    gts[(size_t)(gt_img[i] * num_cats + gt_cat[i])].push_back(g);
  }
  // sort detections by score desc (stable on original order)
  for (auto& v : dets) {
    std::stable_sort(v.begin(), v.end(), [](const Det& a, const Det& b) {
      return a.score > b.score;
    });
  }
  const int64_t max_det_cap = max_dets[M - 1];

  const int64_t Rn = R;
  // per (cat, area): evaluate each image, then accumulate
  for (int64_t k = 0; k < num_cats; ++k) {
    for (int64_t a = 0; a < A; ++a) {
      const double lo = area_rngs[2 * a], hi = area_rngs[2 * a + 1];
      std::vector<ImgEval> evals((size_t)num_images);
      for (int64_t img = 0; img < num_images; ++img) {
        const auto& gv = gts[(size_t)(img * num_cats + k)];
        const auto& dv_all = dets[(size_t)(img * num_cats + k)];
        ImgEval& ev = evals[(size_t)img];
        if (gv.empty() && dv_all.empty()) continue;
        ev.present = true;
        const int64_t D =
            std::min<int64_t>((int64_t)dv_all.size(), max_det_cap);
        ev.D = (int)D;

        // gt ignore flags for this area range; ignored sorted last (stable)
        std::vector<int> g_order(gv.size());
        std::iota(g_order.begin(), g_order.end(), 0);
        std::vector<uint8_t> g_ig(gv.size());
        for (size_t gi = 0; gi < gv.size(); ++gi) {
          g_ig[gi] = gv[gi].ignore_base || gv[gi].area < lo || gv[gi].area > hi;
        }
        std::stable_sort(g_order.begin(), g_order.end(),
                         [&](int x, int y) { return g_ig[x] < g_ig[y]; });

        ev.dt_matches.assign((size_t)(T * D), 0);
        ev.dt_ignore.assign((size_t)(T * D), 0);
        ev.dt_scores.resize((size_t)D);
        for (int64_t di = 0; di < D; ++di) ev.dt_scores[(size_t)di] = dv_all[(size_t)di].score;
        for (size_t gi = 0; gi < gv.size(); ++gi) {
          if (!g_ig[g_order[gi]]) ev.num_gt++;
        }

        // IoU matrix (D x G) in sorted-gt order
        const size_t G = gv.size();
        std::vector<double> ious((size_t)D * G);
        for (int64_t di = 0; di < D; ++di) {
          for (size_t gi = 0; gi < G; ++gi) {
            const Gt& g = gv[(size_t)g_order[gi]];
            ious[(size_t)di * G + gi] =
                iou_xywh(dv_all[(size_t)di].bbox, g.bbox, g.iscrowd);
          }
        }
        std::vector<int64_t> gtm((size_t)T * G, 0);
        for (int64_t t = 0; t < T; ++t) {
          for (int64_t di = 0; di < D; ++di) {
            double best = std::min(iou_thrs[t], 1.0 - 1e-10);
            int m = -1;
            for (size_t gi = 0; gi < G; ++gi) {
              const Gt& g = gv[(size_t)g_order[gi]];
              if (gtm[(size_t)t * G + gi] > 0 && !g.iscrowd) continue;
              if (m > -1 && !g_ig[g_order[(size_t)m]] && g_ig[g_order[gi]])
                break;
              const double iou = ious[(size_t)di * G + gi];
              if (iou < best) continue;
              best = iou;
              m = (int)gi;
            }
            if (m == -1) continue;
            ev.dt_ignore[(size_t)(t * D + di)] = g_ig[g_order[(size_t)m]];
            ev.dt_matches[(size_t)(t * D + di)] = gv[(size_t)g_order[(size_t)m]].id;
            gtm[(size_t)t * G + (size_t)m] = dv_all[(size_t)di].index + 1;
          }
        }
        // unmatched dets outside the area range are ignored
        for (int64_t di = 0; di < D; ++di) {
          const double darea = dv_all[(size_t)di].area;
          const bool oor = darea < lo || darea > hi;
          if (!oor) continue;
          for (int64_t t = 0; t < T; ++t) {
            if (ev.dt_matches[(size_t)(t * D + di)] == 0) {
              ev.dt_ignore[(size_t)(t * D + di)] = 1;
            }
          }
        }
      }

      // ------------------------------------------------------ accumulate
      for (int64_t m = 0; m < M; ++m) {
        const int64_t cap = max_dets[m];
        // gather scores with (img-order, inner-order) then mergesort desc
        std::vector<double> all_scores;
        std::vector<std::pair<int64_t, int64_t>> origin;  // (img, det idx)
        int64_t npig = 0;
        for (int64_t img = 0; img < num_images; ++img) {
          const ImgEval& ev = evals[(size_t)img];
          if (!ev.present) continue;
          npig += ev.num_gt;
          const int64_t D = std::min<int64_t>(ev.D, cap);
          for (int64_t di = 0; di < D; ++di) {
            all_scores.push_back(ev.dt_scores[(size_t)di]);
            origin.emplace_back(img, di);
          }
        }
        if (npig == 0) continue;
        std::vector<int64_t> order(all_scores.size());
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
          return all_scores[(size_t)x] > all_scores[(size_t)y];
        });

        const int64_t nd = (int64_t)order.size();
        std::vector<double> pr((size_t)nd), rc((size_t)nd);
        for (int64_t t = 0; t < T; ++t) {
          double tp = 0, fp = 0;
          for (int64_t i = 0; i < nd; ++i) {
            const auto& o = origin[(size_t)order[(size_t)i]];
            const ImgEval& ev = evals[(size_t)o.first];
            const bool matched =
                ev.dt_matches[(size_t)(t * ev.D + o.second)] > 0;
            const bool ign = ev.dt_ignore[(size_t)(t * ev.D + o.second)] != 0;
            if (!ign && matched) tp += 1;
            if (!ign && !matched) fp += 1;
            rc[(size_t)i] = tp / (double)npig;
            pr[(size_t)i] =
                tp / std::max(tp + fp, std::numeric_limits<double>::min());
          }
          const size_t rec_base =
              (size_t)(((t * Rn) * num_cats + k) * A + a) * M + m;
          // recall tensor is (T,K,A,M)
          recall[(size_t)(((t * num_cats + k) * A + a) * M + m)] =
              nd ? rc[(size_t)(nd - 1)] : 0.0;
          // monotone precision envelope
          for (int64_t i = nd - 1; i > 0; --i) {
            if (pr[(size_t)i] > pr[(size_t)(i - 1)])
              pr[(size_t)(i - 1)] = pr[(size_t)i];
          }
          for (int64_t ri = 0; ri < Rn; ++ri) {
            // searchsorted(rc, rec_thrs[ri], side='left')
            const double thr = rec_thrs[ri];
            int64_t pi =
                std::lower_bound(rc.begin(), rc.end(), thr) - rc.begin();
            double q = 0.0, s = 0.0;
            if (pi < nd) {
              q = pr[(size_t)pi];
              s = all_scores[(size_t)order[(size_t)pi]];
            }
            const size_t idx =
                (size_t)((((t * Rn + ri) * num_cats + k) * A + a) * M + m);
            precision[idx] = q;
            scores_out[idx] = s;
          }
          (void)rec_base;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
