// Rotated-box geometry on the card: the pairwise IoU of XYWHA boxes and
// greedy rotated NMS, both exact convex-polygon intersections.
//
// Replaces: the XLA compositions of slenderobjdet_tpu/ops/rotated.py
// (`pairwise_rotated_iou` and `rotated_nms` over `_pair_intersection_area`,
// vmapped; no Pallas kernel), whose plain PyTorch versions are
// slenderobjdet_torch/ops/rotated.py. On the same corners and areas both
// kernels give the plain versions' results bit for bit. The wrappers form
// the corners and areas with `rotated_corners_kernel`, which transcribes the
// plain `rotated_to_corners` operation for operation (CUDA's `cosf` and
// `sinf`, as torch's kernels use them; `chip_smoke.py` holds the two equal).
//
// The intersection of polygon P (a box's 4 corners) with box Q is
// Sutherland-Hodgman: P is clipped by the half-plane left of each of Q's
// four edges in Q's corner order. A clip walks P's ring and emits, for
// each vertex, the vertex if it lies inside (d >= 0) and then the crossing
// point if the edge to the next vertex changes side, keeping the first 16
// emitted (the plain version's fixed 16-slot buffer); the area is the
// shoelace sum accumulated vertex by vertex, the closing edge last, which
// is the plain version's sequential sum over its forward-filled buffer
// (the filled slots add exact zeros). Fewer than 3 vertices give area 0.
// Every operation is an explicitly rounded intrinsic (`__fmul_rn`,
// `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`), so that nothing is contracted
// into an FMA and each rounding is the plain version's. A thread's two
// rings live in shared memory, slot k of thread t at [k * threads + t]
// (no bank conflicts whatever the slot), never in local memory.
//
// Pairs that cannot overlap are not clipped (`apart`, the plain rule
// `extents_apart` of ops/rotated.py). Each box gets its axis-aligned extent
// and a scale s: M = the largest |coordinate| of its corners when the box
// is regular (finite corners, every edge's larger component >= 2^-16 M,
// and its first turn counter-clockwise, e0 x e1 > 0), else +inf. A pair is
// apart when one of its four extent gaps exceeds m = 2^-17 max(s1, s2);
// its intersection is then +0, the plain clip's own result, as follows
// (u = 2^-24, M = the pair's largest |coordinate|; say P lies left of Q):
//  - While t stays in [0, 1], every emitted crossing lies within 5uR of
//    a convex combination of two ring vertices (R bounds the ring's
//    coordinates), so after four clips every ring vertex lies within 20uM
//    of P's extent, and every vertex left after clip k lies within 18.4uM
//    of Q's k-th half-plane (the rounded side test misjudges by at most
//    2.0001u|e||v - e0|, the crossing by as much again plus its own
//    rounding), each later clip adding at most 7.1uM, and the line through
//    e0 with the rounded direction passing within 2.9uM of e1: at most
//    43uM in all.
//  - Regular boxes' rounded corners lie within 6.3uM of an exact rectangle
//    (sides >= 2^-16 M), so every corner angle is within 0.19 rad of 90
//    degrees. At Q's leftmost corner both edges run rightwards, so a point
//    within 43uM of both half-planes lies at most 2 * 43uM / 0.98 = 88uM
//    left of it. A vertex would need to be both there and within 20uM of
//    P's extent: a gap of 108uM at most, below m = 128uM. So the ring is
//    empty after the last clip, count 0, area +0, IoU +0.
//  - The one branch this does not cover is the plain clip's floor: where
//    |d_i - d_j| < 1e-12 with d_i < 0 it divides by +1e-12 and t falls in
//    (-1, 0). That needs both |d| below 1e-12, two consecutive ring
//    vertices on the clipping edge's line to a cross product of 1e-12;
//    `tests/test_torch_rotated_kernel_rules.py` pins the rule on 2e5 pairs
//    placed within a few margins of touching at the models' angles and
//    offsets, where the plain clip gives +0 on every pair the rule skips.
//
// A pair whose clipped polygon P has four equal corners (a padded ground
// truth row of zeros) is not clipped either: P's ring then holds copies of
// that point or nothing (equal points are on one side of every edge, so
// no crossing is made), and the shoelace sum of copies of one point is
// exactly 0 (x * y - x * y), so the area is +0 whatever the box Q.
//
// rotated_iou: a block of 128 threads owns 128 consecutive columns, one a
// thread, whose corners, area and extent stay in registers; the block walks
// its rows (all of them, or a share when the columns are few), staging 128
// rows' corners, areas and extents in shared memory a tile at a time, so a
// column is read once a block and a row once a tile. Each thread writes its
// column of the row: the block's 512-byte row segments are coalesced. IoU =
// inter / max(a_row + a_col - inter, 1e-12) where the union is > 0, else 0,
// the row's polygon clipped by the column's box. The bound is the output
// write; the few pairs not apart clip in shared memory.
//
// rotated_nms: three kernels, the middle two once a window of sorted
// positions (the first window 2 max_out rounded to 64, clamped to
// [256, 2048], then doubling up to 4096), so that rows no walk reaches are
// never clipped:
//  (a) sort: one block of 1024 an image sorts 64-bit keys (order-
//      preserving score bits, then ~index) of the selectable candidates
//      (valid and score > -5e9, the plain version's test) with a bitonic
//      network in shared memory, then writes their sorted order, corners,
//      areas, extents and scales to scratch, contiguous, and a removed
//      bitmask with the positions past the selectable count set.
//  (b) bits: a block a (image, 64-row tile of the window, 64-column tile
//      at or after it). Rows and columns already removed are left out.
//      The block tests every pair's extents, lists the pairs not apart,
//      and clips them densely (its 128 threads over the list): the row's
//      (earlier) polygon clipped by the column's box, the plain roles; the
//      pair's bit is iou > thr. One 64-bit word a (row, column tile).
//  (c) walk: one block an image walks its window a 64-position word at a
//      time: the live positions are the word's clear removed bits; warp 0
//      resolves them in order from the rows' diagonal words (keep the
//      first, clear what it suppresses, repeat; stop at max_out), then the
//      block ORs the kept rows' later words into the removed mask. The
//      image is done at max_out or at the last selectable position, and
//      its slots past the last kept box are written 0 / invalid.
// Greedy NMS by repeated argmax (ties to the lowest index) visits the
// selectable candidates in exactly this order and skips the suppressed,
// so the keep lists are the plain version's.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 16;            // the plain version's vertex buffer
constexpr int kIouThreads = 128;      // columns a block, one a thread
constexpr int kIouRows = 128;         // rows staged at a time
constexpr int kIouTargetBlocks = 1056;  // 8 a streaming multiprocessor
constexpr int kSortThreads = 1024;
constexpr int kTile = 64;             // sorted positions a mask word
constexpr int kBitsThreads = 128;
constexpr int kWalkThreads = 256;
constexpr int kOrLoads = 8;           // a walk thread's loads in flight
constexpr int kFirstWindowMin = 256;
constexpr int kFirstWindowMax = 2048;
constexpr int kMaxWindow = 4096;      // rows of suppression words held at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinLive = -5e9f;     // NEG_INF / 2: selectable scores lie above
constexpr float kMarginScale = 0x1p-17f;
constexpr float kSideScale = 0x1p-16f;
constexpr float kDegToRad = (float)(3.14159265358979323846 / 180.0);

typedef unsigned long long u64;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Signed distance-like test of (x, y) against the edge e0 -> e1 (ex, ey):
// ex * (y - e0y) - ey * (x - e0x), >= 0 inside.
__device__ __forceinline__ float side(float ex, float ey, float e0x, float e0y,
                                      float x, float y) {
  return sub(mul(ex, sub(y, e0y)), mul(ey, sub(x, e0x)));
}

// A box's axis-aligned extent (x0, x1, y0, y1), margin scale, and whether
// its four corners are one point.
struct Extent {
  float4 box;
  float s;
  bool point;
};

__device__ __forceinline__ Extent box_extent(const float (&c)[8]) {
  Extent e;
  e.box.x = fminf(fminf(c[0], c[2]), fminf(c[4], c[6]));
  e.box.y = fmaxf(fmaxf(c[0], c[2]), fmaxf(c[4], c[6]));
  e.box.z = fminf(fminf(c[1], c[3]), fminf(c[5], c[7]));
  e.box.w = fmaxf(fmaxf(c[1], c[3]), fmaxf(c[5], c[7]));
  const float mag = fmaxf(fmaxf(fabsf(e.box.x), fabsf(e.box.y)),
                          fmaxf(fabsf(e.box.z), fabsf(e.box.w)));
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) finite = finite && isfinite(c[k]);
  float shortest = INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k + 1) & 3;
    shortest = fminf(shortest, fmaxf(fabsf(sub(c[2 * j], c[2 * k])),
                                     fabsf(sub(c[2 * j + 1], c[2 * k + 1]))));
  }
  const float turn = sub(mul(sub(c[2], c[0]), sub(c[5], c[3])),
                         mul(sub(c[3], c[1]), sub(c[4], c[2])));
  const bool regular = finite && shortest >= mul(kSideScale, mag) && turn > 0.f;
  e.s = regular ? mag : INFINITY;
  e.point = c[0] == c[2] && c[0] == c[4] && c[0] == c[6] && c[1] == c[3] && c[1] == c[5] &&
            c[1] == c[7];
  return e;
}

// The pair's intersection is +0 without a clip (the note above).
__device__ __forceinline__ bool apart(const float4 a, float as, const float4 b, float bs) {
  const float m = mul(kMarginScale, fmaxf(as, bs));
  const float g = fmaxf(fmaxf(sub(b.x, a.y), sub(a.x, b.y)),
                        fmaxf(sub(b.z, a.w), sub(a.z, b.w)));
  return g > m;
}

// Clip the ring src[0:n] (slot k at src[k * stride]) by the half-plane left
// of e0 -> e1 into dst; returns the new vertex count (at most kSlots).
__device__ int clip(const float2* src, int n, float e0x, float e0y, float e1x, float e1y,
                    float2* dst, int stride) {
  if (n == 0) return 0;
  const float ex = sub(e1x, e0x), ey = sub(e1y, e0y);
  const float2 s0 = src[0];
  const float d0 = side(ex, ey, e0x, e0y, s0.x, s0.y);
  float dc = d0;
  float2 sc = s0;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1 == n) ? 0 : i + 1;
    const float2 sn = (j == 0) ? s0 : src[j * stride];
    const float dn = (j == 0) ? d0 : side(ex, ey, e0x, e0y, sn.x, sn.y);
    const bool in = dc >= 0.f, in_next = dn >= 0.f;
    if (in && m < kSlots) {
      dst[m * stride] = sc;
      ++m;
    }
    if (in != in_next && m < kSlots) {
      const float diff = sub(dc, dn);
      const float t = __fdiv_rn(dc, fabsf(diff) < 1e-12f ? 1e-12f : diff);
      dst[m * stride] = make_float2(add(sc.x, mul(t, sub(sn.x, sc.x))),
                                    add(sc.y, mul(t, sub(sn.y, sc.y))));
      ++m;
    }
    dc = dn;
    sc = sn;
  }
  return m;
}

// Area of the intersection of polygon `p` (4 corners, x0 y0 .. x3 y3) with
// box `q` (4 corners): p clipped by q's edges in q's order, in the rings
// ra and rb (shared memory, slot k at [k * stride]).
__device__ float inter_area(const float (&p)[8], const float (&q)[8], float2* ra, float2* rb,
                            int stride) {
#pragma unroll
  for (int k = 0; k < 4; ++k) ra[k * stride] = make_float2(p[2 * k], p[2 * k + 1]);
  int n = clip(ra, 4, q[0], q[1], q[2], q[3], rb, stride);
  n = clip(rb, n, q[2], q[3], q[4], q[5], ra, stride);
  n = clip(ra, n, q[4], q[5], q[6], q[7], rb, stride);
  n = clip(rb, n, q[6], q[7], q[0], q[1], ra, stride);
  if (n < 3) return 0.f;
  float2 v0 = ra[0], a = v0, b = ra[stride];
  float acc = sub(mul(a.x, b.y), mul(b.x, a.y));
  for (int k = 1; k < n - 1; ++k) {
    a = b;
    b = ra[(k + 1) * stride];
    acc = add(acc, sub(mul(a.x, b.y), mul(b.x, a.y)));
  }
  acc = add(acc, sub(mul(b.x, v0.y), mul(v0.x, b.y)));
  return mul(0.5f, fabsf(acc));
}

__device__ __forceinline__ void load8(const float* src, float (&dst)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void from_float4(const float4 a, const float4 b, float (&dst)[8]) {
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// A corner at (dx, dy) from the centre: (cx + dx * c) + dy * s and
// (cy - dx * s) + dy * c. (The corner kernel's 32-byte stack frame is
// cosf's and sinf's argument reduction for huge angles.)
__device__ __forceinline__ float corner_x(float cx, float c, float s, float dx, float dy) {
  return add(add(cx, mul(dx, c)), mul(dy, s));
}
__device__ __forceinline__ float corner_y(float cy, float c, float s, float dx, float dy) {
  return add(sub(cy, mul(dx, s)), mul(dy, c));
}

// rotated_to_corners and w * h, operation for operation: theta = a *
// float(pi / 180); (cx + dx * c) + dy * s and (cy - dx * s) + dy * c with
// dx = -+w / 2, dy = -+h / 2 in the corner order (-,-), (+,-), (+,+), (-,+).
__global__ void rotated_corners_kernel(const float* __restrict__ boxes, int n,
                                       float* __restrict__ corners,
                                       float* __restrict__ areas) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* b = boxes + (size_t)i * 5;
  const float cx = b[0], cy = b[1], w = b[2], h = b[3], a = b[4];
  const float theta = mul(a, kDegToRad);
  const float c = cosf(theta), s = sinf(theta);
  const float hw = mul(w, 0.5f), hh = mul(h, 0.5f);
  float4* dst = reinterpret_cast<float4*>(corners + (size_t)i * 8);
  dst[0] = make_float4(corner_x(cx, c, s, -hw, -hh), corner_y(cy, c, s, -hw, -hh),
                       corner_x(cx, c, s, hw, -hh), corner_y(cy, c, s, hw, -hh));
  dst[1] = make_float4(corner_x(cx, c, s, hw, hh), corner_y(cy, c, s, hw, hh),
                       corner_x(cx, c, s, -hw, hh), corner_y(cy, c, s, -hw, hh));
  areas[i] = mul(w, h);
}

__global__ void __launch_bounds__(kIouThreads, 4)
rotated_iou_kernel(const float* __restrict__ c1, const float* __restrict__ a1,
                   const float* __restrict__ c2, const float* __restrict__ a2,
                   int n1, int n2, int rows_per_block, float* __restrict__ out) {
  __shared__ float4 rc[kIouRows * 2];
  __shared__ float4 rbox[kIouRows];
  __shared__ float ra[kIouRows], rs[kIouRows];
  __shared__ bool rpt[kIouRows];
  __shared__ float2 ring[2 * kSlots * kIouThreads];

  const int tid = threadIdx.x;
  const int col = blockIdx.x * kIouThreads + tid;
  const bool has = col < n2;
  float q[8];
  float qa = 0.f;
  Extent qe;
  if (has) {
    load8(c2 + (size_t)col * 8, q);
    qa = __ldg(a2 + col);
    qe = box_extent(q);
  }
  float2* ring_a = ring + tid;
  float2* ring_b = ring + kSlots * kIouThreads + tid;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(n1, r_begin + rows_per_block);
  for (int r0 = r_begin; r0 < r_end; r0 += kIouRows) {
    const int rn = min(kIouRows, r_end - r0);
    __syncthreads();
    for (int i = tid; i < rn; i += kIouThreads) {
      float p[8];
      load8(c1 + (size_t)(r0 + i) * 8, p);
      rc[2 * i] = make_float4(p[0], p[1], p[2], p[3]);
      rc[2 * i + 1] = make_float4(p[4], p[5], p[6], p[7]);
      ra[i] = __ldg(a1 + r0 + i);
      const Extent e = box_extent(p);
      rbox[i] = e.box;
      rs[i] = e.s;
      rpt[i] = e.point;
    }
    __syncthreads();
    if (!has) continue;
    for (int i = 0; i < rn; ++i) {
      // a pair not clipped has inter +0, so IoU +0 whatever the union
      float iou = 0.f;
      if (!rpt[i] && !apart(rbox[i], rs[i], qe.box, qe.s)) {
        float p[8];
        from_float4(rc[2 * i], rc[2 * i + 1], p);
        const float inter = inter_area(p, q, ring_a, ring_b, kIouThreads);
        const float uni = sub(add(ra[i], qa), inter);
        iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
      }
      out[(size_t)(r0 + i) * n2 + col] = iou;
    }
  }
}

// ------------------------------------------------------------------ NMS
// Descending key order == (score descending, index ascending); -0 and +0
// are one score. A selectable key is never 0.
__device__ __forceinline__ u64 make_key(float s, int idx) {
  uint32_t u = (s == 0.f) ? 0u : __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (uint32_t)~(uint32_t)idx;
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The scratch of one call, carved from one buffer (`nms_layout`).
struct NmsScratch {
  int32_t* order;     // (B, N) sorted position -> index
  float4* corners;    // (B, N, 2) sorted candidates' corners
  float* areas;       // (B, N)
  float4* box;        // (B, N) extents
  float* scale;       // (B, N) margin scales
  uint8_t* point;     // (B, N) four corners one point
  int32_t* count;     // (B) selectable candidates
  int32_t* kept;      // (B) kept so far
  int32_t* done;      // (B) 1 once max_out or the last position is reached
  u64* removed;       // (B, T) removed positions, one bit each
  u64* mask;          // (B, rows, T) suppression words of the window's rows
  int rows;           // rows of suppression words an image
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline size_t nms_layout(void* base, int batch, int n, NmsScratch* s) {
  const int T = (n + kTile - 1) / kTile;
  const int rows = n < kMaxWindow ? (n + kTile - 1) / kTile * kTile : kMaxWindow;
  const size_t bn = (size_t)batch * n;
  size_t off = 0;
  char* p = static_cast<char*>(base);
  size_t o_order = off;   off = align16(off + bn * 4);
  size_t o_corners = off; off = align16(off + bn * 32);
  size_t o_areas = off;   off = align16(off + bn * 4);
  size_t o_box = off;     off = align16(off + bn * 16);
  size_t o_scale = off;   off = align16(off + bn * 4);
  size_t o_point = off;   off = align16(off + bn);
  size_t o_count = off;   off = align16(off + (size_t)batch * 4);
  size_t o_kept = off;    off = align16(off + (size_t)batch * 4);
  size_t o_done = off;    off = align16(off + (size_t)batch * 4);
  size_t o_removed = off; off = align16(off + (size_t)batch * T * 8);
  size_t o_mask = off;    off = align16(off + (size_t)batch * rows * T * 8);
  if (s) {
    s->order = reinterpret_cast<int32_t*>(p + o_order);
    s->corners = reinterpret_cast<float4*>(p + o_corners);
    s->areas = reinterpret_cast<float*>(p + o_areas);
    s->box = reinterpret_cast<float4*>(p + o_box);
    s->scale = reinterpret_cast<float*>(p + o_scale);
    s->point = reinterpret_cast<uint8_t*>(p + o_point);
    s->count = reinterpret_cast<int32_t*>(p + o_count);
    s->kept = reinterpret_cast<int32_t*>(p + o_kept);
    s->done = reinterpret_cast<int32_t*>(p + o_done);
    s->removed = reinterpret_cast<u64*>(p + o_removed);
    s->mask = reinterpret_cast<u64*>(p + o_mask);
    s->rows = rows;
  }
  return off;
}

__global__ void __launch_bounds__(kSortThreads)
rotated_nms_sort_kernel(const float* __restrict__ corners, const float* __restrict__ areas,
                        const float* __restrict__ scores, const uint8_t* __restrict__ valid,
                        int n, NmsScratch s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pn = next_pow2(n);
  u64* keys = reinterpret_cast<u64*>(smem);
  __shared__ int selectable;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int T = (n + kTile - 1) / kTile;
  const float* bc = corners + (size_t)b * n * 8;
  const float* ba = areas + (size_t)b * n;
  const float* bs = scores + (size_t)b * n;
  const uint8_t* bv = valid ? valid + (size_t)b * n : nullptr;

  if (tid == 0) selectable = 0;
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < pn; i += kSortThreads) {
    u64 key = 0;
    if (i < n) {
      const float sc = bs[i];
      if ((bv == nullptr || bv[i]) && sc > kMinLive) {
        key = make_key(sc, i);
        ++mine;
      }
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(&selectable, mine);
  __syncthreads();

  // bitonic sort, descending: each step's pn / 2 compare-exchanges (i,
  // i + j), i with bit j clear, spread over the block
  for (int k = 2; k <= pn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < pn / 2; q += kSortThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1)), ixj = i + j;
        const u64 a = keys[i], c = keys[ixj];
        if (((i & k) == 0) ? (a < c) : (a > c)) {
          keys[i] = c;
          keys[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  const int m = selectable;
  const size_t o = (size_t)b * n;
  for (int p = tid; p < m; p += kSortThreads) {
    const int idx = (int)~(uint32_t)keys[p];
    float c[8];
    load8(bc + (size_t)idx * 8, c);
    const Extent e = box_extent(c);
    s.order[o + p] = idx;
    s.corners[2 * (o + p)] = make_float4(c[0], c[1], c[2], c[3]);
    s.corners[2 * (o + p) + 1] = make_float4(c[4], c[5], c[6], c[7]);
    s.areas[o + p] = ba[idx];
    s.box[o + p] = e.box;
    s.scale[o + p] = e.s;
    s.point[o + p] = e.point;
  }
  for (int w = tid; w < T; w += kSortThreads) {
    const int lo = w * kTile;
    s.removed[(size_t)b * T + w] =
        lo + kTile <= m ? 0ull : (lo >= m ? ~0ull : ~0ull << (m - lo));
  }
  if (tid == 0) {
    s.count[b] = m;
    s.kept[b] = 0;
    s.done[b] = 0;
  }
}

// Dynamic shared memory of the bits kernel: the rows' and columns' data,
// the pair list, the rings.
constexpr int kBitsSmem = 2 * kTile * (32 + 16 + 4 + 4)   // corners, extents, areas, scales
                          + kTile * kTile * 2                // the pair list (u16)
                          + 2 * kSlots * kBitsThreads * 8;   // two rings a thread

__global__ void __launch_bounds__(kBitsThreads)
rotated_nms_bits_kernel(NmsScratch s, int n, int ws, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sc = reinterpret_cast<float4*>(smem);            // [2 * kTile][2]: rows, then columns
  float4* sbox = sc + 4 * kTile;                            // [2 * kTile]
  float* sa = reinterpret_cast<float*>(sbox + 2 * kTile);  // [2 * kTile]
  float* ss = sa + 2 * kTile;                               // [2 * kTile]
  uint16_t* list = reinterpret_cast<uint16_t*>(ss + 2 * kTile);  // [kTile * kTile]
  float2* ring = reinterpret_cast<float2*>(list + kTile * kTile);
  __shared__ uint32_t res[kTile][2];
  __shared__ bool rpt[kTile];
  __shared__ int warp_total[kBitsThreads / 32];

  const int b = blockIdx.z, tid = threadIdx.x;
  const int T = (n + kTile - 1) / kTile;
  const int rt = ws / kTile + blockIdx.y, ct = ws / kTile + blockIdx.x;
  if (ct < rt) return;
  const int m = s.count[b];
  if (s.done[b] || rt * kTile >= m || ct * kTile >= m) return;
  const u64 row_removed = s.removed[(size_t)b * T + rt];
  const u64 col_removed = s.removed[(size_t)b * T + ct];
  if (row_removed == ~0ull || col_removed == ~0ull) return;

  {  // stage: threads 0-63 the rows, 64-127 the columns
    const int pos = (tid < kTile ? rt : ct) * kTile + (tid & (kTile - 1));
    if (pos < m) {
      const size_t o = (size_t)b * n + pos;
      sc[2 * tid] = s.corners[2 * o];
      sc[2 * tid + 1] = s.corners[2 * o + 1];
      sbox[tid] = s.box[o];
      sa[tid] = s.areas[o];
      ss[tid] = s.scale[o];
      if (tid < kTile) rpt[tid] = s.point[o];
    }
  }
  if (tid < kTile) res[tid][0] = res[tid][1] = 0u;
  __syncthreads();

  // every pair's extents: thread (row r, half h) the columns 32h .. 32h + 31
  const int r = tid & (kTile - 1), h = tid >> 6;
  const int rpos = rt * kTile + r;
  uint32_t need = 0;
  if (rpos < m && !((row_removed >> r) & 1) && !rpt[r]) {
    const float4 rb = sbox[r];
    const float rsc = ss[r];
    for (int j = 0; j < 32; ++j) {
      const int c = h * 32 + j, cpos = ct * kTile + c;
      if (cpos > rpos && cpos < m && !((col_removed >> c) & 1)) {
        if (!apart(rb, rsc, sbox[kTile + c], ss[kTile + c])) need |= 1u << j;
      }
    }
  }
  // the pair list, in (thread, bit) order
  const int lane = tid & 31, warp = tid >> 5;
  const int cnt = __popc(need);
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  int off = x - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < kBitsThreads / 32; ++w) {
    if (w < warp) off += warp_total[w];
    total += warp_total[w];
  }
  for (uint32_t bits = need; bits; bits &= bits - 1)
    list[off++] = (uint16_t)((r << 6) | (h * 32 + __ffs(bits) - 1));
  __syncthreads();

  // clip the listed pairs, all threads over the list
  float2* ring_a = ring + tid;
  float2* ring_b = ring + kSlots * kBitsThreads + tid;
  for (int k = tid; k < total; k += kBitsThreads) {
    const int pr = list[k] >> 6, pc = list[k] & (kTile - 1);
    float p[8], q[8];
    from_float4(sc[2 * pr], sc[2 * pr + 1], p);
    from_float4(sc[2 * (kTile + pc)], sc[2 * (kTile + pc) + 1], q);
    const float inter = inter_area(p, q, ring_a, ring_b, kBitsThreads);
    const float uni = fmaxf(sub(add(sa[pr], sa[kTile + pc]), inter), 1e-12f);
    if (__fdiv_rn(inter, uni) > thr) atomicOr(&res[pr][pc >> 5], 1u << (pc & 31));
  }
  __syncthreads();
  if (tid < kTile && rpos < m)
    s.mask[((size_t)b * s.rows + (rpos - ws)) * T + ct] =
        ((u64)res[tid][1] << 32) | res[tid][0];
}

__global__ void __launch_bounds__(kWalkThreads)
rotated_nms_walk_kernel(NmsScratch s, int n, int ws, int we, int max_out,
                        int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid) {
  __shared__ u64 rem[kMaxWindow / kTile];
  __shared__ u64 kept_bits;
  __shared__ int s_cnt;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  if (s.done[b]) return;
  const int T = (n + kTile - 1) / kTile;
  const int m = s.count[b];
  const int t0 = ws / kTile;
  const int nw = (we - ws + kTile - 1) / kTile;   // the window's words
  const int t_end = (min(we, m) + kTile - 1) / kTile;
  const int t_m = (m + kTile - 1) / kTile;
  u64* removed = s.removed + (size_t)b * T;
  const u64* mask = s.mask + (size_t)b * s.rows * T;
  const int32_t* order = s.order + (size_t)b * n;
  int32_t* out_idx = keep_idx + (size_t)b * max_out;
  uint8_t* out_valid = keep_valid + (size_t)b * max_out;
  for (int i = tid; i < nw; i += kWalkThreads) rem[i] = removed[t0 + i];
  int cnt = s.kept[b];
  __syncthreads();
  for (int t = t0; t < t_end && cnt < max_out; ++t) {
    const u64 live = ~rem[t - t0];
    if (!live) continue;
    if (tid < 32) {
      const int p_lo = t * kTile + lane, p_hi = p_lo + 32;
      u64 d_lo = 0, d_hi = 0;
      int o_lo = 0, o_hi = 0;
      if (p_lo < m) {
        d_lo = mask[(size_t)(p_lo - ws) * T + t];
        o_lo = order[p_lo];
      }
      if (p_hi < m) {
        d_hi = mask[(size_t)(p_hi - ws) * T + t];
        o_hi = order[p_hi];
      }
      u64 left = live, kb = 0;
      int c = cnt;
      while (left && c < max_out) {
        const int i = __ffsll((long long)left) - 1;      // the same in every lane
        const u64 d = __shfl_sync(kFull, i < 32 ? d_lo : d_hi, i & 31);
        const int idx = __shfl_sync(kFull, i < 32 ? o_lo : o_hi, i & 31);
        if (lane == 0) {
          out_idx[c] = idx;
          out_valid[c] = 1;
        }
        ++c;
        kb |= 1ull << i;
        left &= ~(1ull << i);
        left &= ~d;
      }
      if (lane == 0) {
        kept_bits = kb;
        s_cnt = c;
      }
    }
    __syncthreads();
    cnt = s_cnt;
    const u64 kb = kept_bits;
    if (cnt < max_out) {
      for (int u = t + 1 + tid; u < t_m; u += kWalkThreads) {
        // the kept rows' words of column tile u, kOrLoads loads in flight
        u64 w = 0;
        for (u64 bits = kb; bits;) {
          u64 v[kOrLoads];
#pragma unroll
          for (int k = 0; k < kOrLoads; ++k) {
            v[k] = 0;
            if (bits) {
              const int i = __ffsll((long long)bits) - 1;
              bits &= bits - 1;
              v[k] = mask[(size_t)(t * kTile + i - ws) * T + u];
            }
          }
#pragma unroll
          for (int k = 0; k < kOrLoads; ++k) w |= v[k];
        }
        if (u < t0 + nw) rem[u - t0] |= w;
        else removed[u] |= w;
      }
    }
    __syncthreads();
  }
  if (cnt >= max_out || we >= m) {
    for (int k = cnt + tid; k < max_out; k += kWalkThreads) {
      out_idx[k] = 0;
      out_valid[k] = 0;
    }
    if (tid == 0) s.done[b] = 1;
  }
  if (tid == 0) s.kept[b] = cnt;
}

// The windows of sorted positions: the first 2 max_out rounded up to 64,
// clamped to [256, 2048], then each twice the one before, up to 4096.
__host__ inline int first_window(int n, int max_out) {
  long long w = 2LL * max_out;
  w = (w + kTile - 1) / kTile * kTile;
  w = w < kFirstWindowMin ? kFirstWindowMin : (w > kFirstWindowMax ? kFirstWindowMax : w);
  return (int)(w < n ? w : n);
}

}  // namespace

extern "C" {

// boxes (n, 5) float32 XYWHA -> corners (n, 8) and areas (n) float32, as
// the plain rotated_to_corners and w * h form them.
int rotated_corners_launch(const void* boxes, int n, void* corners, void* areas,
                           void* stream) {
  if (n < 1) return (int)cudaSuccess;
  rotated_corners_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, n, (float*)corners, (float*)areas);
  return (int)cudaGetLastError();
}

// corners1 (n1, 8) and areas1 (n1) float32: the clipped polygons (rows);
// corners2 (n2, 8), areas2 (n2): the clipping boxes (columns); out (n1, n2)
// float32.
int rotated_iou_launch(const void* corners1, const void* areas1, const void* corners2,
                       const void* areas2, int n1, int n2, void* out, void* stream) {
  if (n1 < 1 || n2 < 1) return (int)cudaSuccess;
  const int col_blocks = (n2 + kIouThreads - 1) / kIouThreads;
  int splits = (kIouTargetBlocks + col_blocks - 1) / col_blocks;
  splits = splits < 1 ? 1 : (splits > n1 ? n1 : splits);
  const int rows = (n1 + splits - 1) / splits;
  const dim3 grid(col_blocks, (n1 + rows - 1) / rows);
  rotated_iou_kernel<<<grid, kIouThreads, 0, (cudaStream_t)stream>>>(
      (const float*)corners1, (const float*)areas1, (const float*)corners2,
      (const float*)areas2, n1, n2, rows, (float*)out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the sort for n candidates an image: the keys
// over the next power of two.
int rotated_nms_smem_bytes(int n) {
  if (n < 1 || n > (1 << 16)) return INT_MAX;
  return 8 * next_pow2(n);
}

// Bytes of the scratch buffer rotated_nms_launch takes, or -1 past 2 GiB.
int rotated_nms_scratch_bytes(int batch, int n) {
  if (batch < 1 || n < 1) return -1;
  const size_t bytes = nms_layout(nullptr, batch, n, nullptr);
  return bytes > (size_t)INT_MAX ? -1 : (int)bytes;
}

// corners (B, n, 8), areas (B, n), scores (B, n) float32; valid (B, n) bytes
// or null; keep_idx (B, max_out) int32, keep_valid (B, max_out) bytes;
// scratch of rotated_nms_scratch_bytes(B, n) bytes, 16-byte aligned.
// Launches the sort, then the bits and the walk once a window. Returns
// cudaGetLastError() after the launches.
int rotated_nms_launch(const void* corners, const void* areas, const void* scores,
                       const void* valid, int batch, int n, float thr, int max_out,
                       void* keep_idx, void* keep_valid, void* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  NmsScratch s;
  nms_layout(scratch, batch, n, &s);
  const int smem = rotated_nms_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(rotated_nms_sort_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rotated_nms_sort_kernel<<<batch, kSortThreads, smem, st>>>(
      (const float*)corners, (const float*)areas, (const float*)scores,
      (const uint8_t*)valid, n, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rotated_nms_bits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBitsSmem);
  if (err != cudaSuccess) return (int)err;
  const int T = (n + kTile - 1) / kTile;
  int w = first_window(n, max_out);
  for (int ws = 0; ws < n; ) {
    const int we = ws + w < n ? ws + w : n;
    const dim3 grid(T - ws / kTile, (we - ws + kTile - 1) / kTile, batch);
    rotated_nms_bits_kernel<<<grid, kBitsThreads, kBitsSmem, st>>>(s, n, ws, thr);
    rotated_nms_walk_kernel<<<batch, kWalkThreads, 0, st>>>(
        s, n, ws, we, max_out, (int32_t*)keep_idx, (uint8_t*)keep_valid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ws = we;
    w = 2 * w < kMaxWindow ? 2 * w : kMaxWindow;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
