/* Native matching kernel for the slender COCOeval fork.
 *
 * The greedy per-(image,category) matcher is the hot loop of COCO
 * evaluation — pycocotools implements it in C for the same reason. This
 * kernel reproduces slender_cocoeval.evaluateImg (itself bit-faithful to
 * the reference's forked cocoeval.py:253-310) for ALL aspect-ratio ranges
 * and IoU thresholds of one (image, category) pair in a single call:
 *
 *   - gt ignore per range: base ignore (crowd) OR gt ratio outside range
 *   - gt processed in stable order of ignore (kept, then ignored)
 *   - detections in score order greedily take the best still-free gt with
 *     IoU >= threshold (crowd gts are matchable many times; an ignored gt
 *     is only taken if no kept gt qualifies)
 *   - unmatched detections whose bbox w/h falls outside the range are
 *     marked ignored
 *
 * Compiled with plain cc into a shared object and called through ctypes
 * (see evaluation/native.py); no Python.h dependency.
 */

#include <stdint.h>

/* stable two-pass order: indices with key 0 first, then key 1 */
static void stable_order_by_ignore(const uint8_t *ignore, int g_count,
                                   int32_t *order) {
  int n = 0;
  for (int g = 0; g < g_count; ++g)
    if (!ignore[g]) order[n++] = g;
  for (int g = 0; g < g_count; ++g)
    if (ignore[g]) order[n++] = g;
}

/* All outputs are dense row-major:
 *   dtm   (A, T, D) double  — matched gt id or 0
 *   gtm   (A, T, G) double  — matching dt id or 0, in SORTED gt order
 *   dt_ig (A, T, D) uint8
 *   gt_ig (A, G)    uint8   — per-range ignore, SORTED gt order
 *   gt_order (A, G) int32   — sorted-order -> original gt index
 */
void slender_match_pair(
    int T, int A, int D, int G,
    const double *iou_thrs,       /* (T,) */
    const double *rng_lo,         /* (A,) */
    const double *rng_hi,         /* (A,) */
    const double *ious,           /* (D, G) in ORIGINAL gt order */
    const double *gt_ratio,       /* (G,) oriented slenderness ratio */
    const uint8_t *gt_crowd,      /* (G,) */
    const uint8_t *gt_ignore_base,/* (G,) */
    const int64_t *gt_ids,        /* (G,) */
    const int64_t *dt_ids,        /* (D,) score-sorted */
    const double *dt_ratio,       /* (D,) bbox w/h */
    double *dtm, double *gtm, uint8_t *dt_ig, uint8_t *gt_ig,
    int32_t *gt_order) {
  for (int a = 0; a < A; ++a) {
    const double lo = rng_lo[a], hi = rng_hi[a];
    uint8_t *ig_a = gt_ig + (int64_t)a * G;
    int32_t *ord_a = gt_order + (int64_t)a * G;
    for (int g = 0; g < G; ++g) {
      double r = gt_ratio[g];
      ig_a[g] = (gt_ignore_base[g] || r < lo || r > hi) ? 1 : 0;
    }
    /* sorted gt view for this range; re-express ignore in sorted order
     * (matches evaluateImg's gtIg). G <= 4096 enforced by the wrapper. */
    stable_order_by_ignore(ig_a, G, ord_a);
    uint8_t sorted_ig[4096];
    for (int g = 0; g < G; ++g) sorted_ig[g] = ig_a[ord_a[g]];
    for (int g = 0; g < G; ++g) ig_a[g] = sorted_ig[g];

    for (int t = 0; t < T; ++t) {
      double *dtm_at = dtm + ((int64_t)a * T + t) * D;
      double *gtm_at = gtm + ((int64_t)a * T + t) * G;
      uint8_t *dig_at = dt_ig + ((int64_t)a * T + t) * D;
      for (int d = 0; d < D; ++d) {
        double best = iou_thrs[t];
        if (best > 1.0 - 1e-10) best = 1.0 - 1e-10;
        int m = -1;
        for (int g = 0; g < G; ++g) {
          int orig = ord_a[g];
          if (gtm_at[g] > 0 && !gt_crowd[orig]) continue;
          if (m > -1 && ig_a[m] == 0 && ig_a[g] == 1) break;
          double v = ious[(int64_t)d * G + orig];
          if (v < best) continue;
          best = v;
          m = g;
        }
        if (m == -1) {
          /* unmatched: ignore when the dt bbox ratio is out of range */
          double r = dt_ratio[d];
          if (r < lo || r > hi) dig_at[d] = 1;
          continue;
        }
        dig_at[d] = ig_a[m];
        dtm_at[d] = (double)gt_ids[ord_a[m]];
        gtm_at[m] = (double)dt_ids[d];
      }
    }
  }
}
