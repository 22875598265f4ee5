/* Native renderer for the BorderMasks supervision maps.
 *
 * A copy of slenderobjdet_tpu/structures/csrc/border_render.c, the port's
 * own. It mirrors the vectorized numpy renderer in ../borders.py (same
 * closed-form radial fraction, edge-segment distance, and triangle-fan
 * size fill; see borders.py for the formulas and the reference
 * citations), but walks each instance window once in C instead of
 * allocating O(k) full-window numpy temporaries per formula. It is the
 * host-side hot loop for mask-supervised training (FCOSV3 center
 * sampling, ProposalNetworkWithMasks) and for packing precomputed maps
 * (python -m slenderobjdet_torch.tools.coco_to_pack --sizes).
 *
 * Built by ../native.py with `cc -O3 -shared -fPIC` into build/.
 */

#include <math.h>
#include <stddef.h>

#define MAX_HULL 64

typedef struct {
  double nx, ny, h;   /* outward normal and its height over the center */
  int valid;
} Edge;

static int prep_edges(const double *hull, int k, double ox, double oy,
                      Edge *edges) {
  if (k > MAX_HULL) return 0;
  for (int i = 0; i < k; ++i) {
    double ax = hull[2 * i], ay = hull[2 * i + 1];
    double bx = hull[2 * ((i + 1) % k)], by = hull[2 * ((i + 1) % k) + 1];
    double ex = bx - ax, ey = by - ay;
    double nx = ey, ny = -ex;
    if (nx * (ax - ox) + ny * (ay - oy) < 0.0) { nx = -nx; ny = -ny; }
    double h = nx * (ax - ox) + ny * (ay - oy);
    edges[i].nx = nx; edges[i].ny = ny; edges[i].h = h;
    edges[i].valid = h > 1e-9;
  }
  return 1;
}

static inline double radial_t(const Edge *edges, int k, double ox, double oy,
                              double x, double y) {
  double t = -INFINITY;
  for (int i = 0; i < k; ++i) {
    if (!edges[i].valid) continue;
    double v = (edges[i].nx * (x - ox) + edges[i].ny * (y - oy)) / edges[i].h;
    if (v > t) t = v;
  }
  return t < 0.0 ? 0.0 : t;
}

/* min SQUARED distance from (x,y) to any hull edge segment — the numpy
 * _min_edge_distance cos-rule form (itself mirroring the reference's
 * compute_distance, borders.py:167-192) in squared arithmetic:
 * sign(cosin) == sign(absq - d1sq - d2sq) since the denominator is
 * positive, and perp^2 = d1sq*d2sq*sinsq/absq with
 * sinsq = 1 - (absq-d1sq-d2sq)^2 / (4*max(d1sq*d2sq, 1e-12)). One sqrt
 * total at the caller. Parity with the numpy/reference formula matters
 * more than exact geometry here (the cos-rule deviates from the true
 * segment distance under cancellation, and the maps are supervision
 * targets pinned by golden tests). */
static inline double min_edge_dist_sq(const double *hull, int k,
                                      const double *absq_arr,
                                      double x, double y) {
  double best = INFINITY;
  for (int i = 0; i < k; ++i) {
    double ax = hull[2 * i], ay = hull[2 * i + 1];
    double bx = hull[2 * ((i + 1) % k)], by = hull[2 * ((i + 1) % k) + 1];
    double d1sq = (x - ax) * (x - ax) + (y - ay) * (y - ay);
    double d2sq = (x - bx) * (x - bx) + (y - by) * (y - by);
    double absq = absq_arr[i];
    double num = absq - d1sq - d2sq;
    double dsq;
    if (num < 0.0) {
      dsq = d1sq < d2sq ? d1sq : d2sq;
    } else {
      double prod = d1sq * d2sq;
      double cos2 = num * num / (4.0 * (prod > 1e-12 ? prod : 1e-12));
      double sinsq = 1.0 - cos2;
      if (sinsq < 0.0) sinsq = 0.0;
      dsq = prod * sinsq / (absq > 1e-12 ? absq : 1e-12);
    }
    if (dsq < best) best = dsq;
  }
  return best;
}

/* Renders border/center/sizes for ONE instance window into the full-image
 * maps (row stride W; sizes has 2 channels). hull is (k,2) float64,
 * (ox,oy) its mean, dilate_dist = 0.1*sqrt(area). Window [x0,x1)x[y0,y1)
 * is pre-clipped by the caller. Returns 0 if k exceeds the edge buffer. */
int render_instance_maps(int k, int x0, int y0, int x1, int y1, int W,
                         const double *hull, double ox, double oy,
                         double dilate_dist,
                         float *border, float *center, float *sizes) {
  Edge edges[MAX_HULL];
  if (!prep_edges(hull, k, ox, oy, edges)) return 0;

  /* per-edge fan-triangle size values (numpy _triangle_fan_sizes) */
  double val0[MAX_HULL], val1[MAX_HULL];
  for (int i = 0; i < k; ++i) {
    double ax = hull[2 * i], ay = hull[2 * i + 1];
    double bx = hull[2 * ((i + 1) % k)], by = hull[2 * ((i + 1) % k) + 1];
    double mx = 0.5 * (ax + bx), my = 0.5 * (ay + by);
    if (i < k - 1) {
      val0[i] = fabs(mx - ox);
      val1[i] = fabs(my - oy);
    } else {
      double l2 = sqrt((mx - ox) * (mx - ox) + (my - oy) * (my - oy));
      val0[i] = l2;
      val1[i] = l2;
    }
  }
  double inv_dd = 1.0 / (dilate_dist > 1e-9 ? dilate_dist : 1e-9);
  double inv_dd_sq = inv_dd * inv_dd;
  double absq_arr[MAX_HULL];
  for (int i = 0; i < k; ++i) {
    double ax = hull[2 * i], ay = hull[2 * i + 1];
    double bx = hull[2 * ((i + 1) % k)], by = hull[2 * ((i + 1) % k) + 1];
    absq_arr[i] = (ax - bx) * (ax - bx) + (ay - by) * (ay - by);
  }

  for (int yi = y0; yi < y1; ++yi) {
    double y = (double)yi;
    for (int xi = x0; xi < x1; ++xi) {
      double x = (double)xi;
      size_t idx = (size_t)yi * W + xi;

      double t = radial_t(edges, k, ox, oy, x, y);
      int inside = t <= 1.0;

      double dsq = min_edge_dist_sq(hull, k, absq_arr, x, y);
      /* band > 0 iff d < dilate_dist; skip the sqrt otherwise */
      double band = dsq * inv_dd_sq < 1.0 ? 1.0 - sqrt(dsq) * inv_dd : 0.0;
      double ramp = inside ? t : 0.0;
      float bv = (float)(band > ramp ? band : ramp);
      if (bv > border[idx]) border[idx] = bv;

      if (inside) {
        float cv = (float)(1.0 - t);
        if (cv > center[idx]) center[idx] = cv;
      }

      /* the fan triangles tile the hull; pixels with t > 1 (plus an FP
       * guard band for exactly-on-boundary pixels) cannot be contained,
       * so the fan test is skipped there — numpy runs it everywhere but
       * it never fires outside */
      if (t < 1.0 + 1e-6) {
        double s0 = 0.0, s1 = 0.0;
        for (int i = 0; i < k; ++i) {
          double ax = hull[2 * i], ay = hull[2 * i + 1];
          double bx = hull[2 * ((i + 1) % k)];
          double by = hull[2 * ((i + 1) % k) + 1];
          double d1 = (x - ax) * (oy - ay) - (y - ay) * (ox - ax);
          double d2 = (x - bx) * (ay - by) - (y - by) * (ax - bx);
          double d3 = (x - ox) * (by - oy) - (y - oy) * (bx - ox);
          int neg = (d1 < 0.0) || (d2 < 0.0) || (d3 < 0.0);
          int pos = (d1 > 0.0) || (d2 > 0.0) || (d3 > 0.0);
          if (!(neg && pos)) {
            if (val0[i] > s0) s0 = val0[i];
            if (val1[i] > s1) s1 = val1[i];
          }
        }
        float *sp = sizes + 2 * idx;
        /* numpy fmax semantics: the map starts at 0 and values are >= 0,
         * so per-edge max then global fmax is identical */
        if ((float)s0 > sp[0]) sp[0] = (float)s0;
        if ((float)s1 > sp[1]) sp[1] = (float)s1;
      }
    }
  }
  return 1;
}

/* Center-score map for one instance window (BorderMasks.center_masks):
 * standard 0 = linear clip(1-t, 0, 1); 1 = gaussian exp(-t^2/(2 sigma^2))
 * inside the hull, 0 outside. */
int render_center_score(int k, int x0, int y0, int x1, int y1, int W,
                        const double *hull, double ox, double oy,
                        int standard, double sigma, float *out) {
  Edge edges[MAX_HULL];
  if (!prep_edges(hull, k, ox, oy, edges)) return 0;
  double inv2s2 = 1.0 / (2.0 * sigma * sigma);
  for (int yi = y0; yi < y1; ++yi) {
    for (int xi = x0; xi < x1; ++xi) {
      double t = radial_t(edges, k, ox, oy, (double)xi, (double)yi);
      double score;
      if (standard == 0) {
        score = 1.0 - t;
        if (score < 0.0) score = 0.0;
        if (score > 1.0) score = 1.0;
      } else {
        score = t <= 1.0 ? exp(-(t * t) * inv2s2) : 0.0;
      }
      size_t idx = (size_t)yi * W + xi;
      if ((float)score > out[idx]) out[idx] = (float)score;
    }
  }
  return 1;
}
