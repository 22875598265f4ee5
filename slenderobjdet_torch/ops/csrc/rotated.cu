// Rotated-box geometry on the card: the pairwise IoU of XYWHA boxes and
// greedy rotated NMS, both exact convex-polygon intersections.
//
// Replaces: the XLA compositions of slenderobjdet_tpu/ops/rotated.py
// (`pairwise_rotated_iou` and `rotated_nms` over `_pair_intersection_area`,
// vmapped; no Pallas kernel), whose plain PyTorch versions are
// slenderobjdet_torch/ops/rotated.py. On the same corners and areas (the
// wrappers form them with the plain `rotated_to_corners` and `w * h`) both
// kernels give the plain versions' results bit for bit.
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
// into an FMA and each rounding is the plain version's. Disjoint pairs are
// not skipped: the clip itself ends early when a ring empties.
//
// rotated_iou: one thread per (row, column) pair, the row's polygon
// clipped by the column box, IoU = inter / max(a_row + a_col - inter,
// 1e-12) where the union is > 0, else 0. A block takes 256 columns of one
// row (rows on grid.y), so the row's corners are one broadcast load and
// the column boxes and the output row are read and written coalesced.
//
// rotated_nms: one block of 1024 threads per image. Greedy NMS by repeated
// argmax (ties to the lowest index) visits the selectable candidates (valid
// and score > -5e9, the plain version's test) in the order (score
// descending, index ascending) and skips the suppressed, so the block sorts
// 64-bit keys (order-preserving score bits, then ~index) once in shared
// memory with a bitonic network, then walks the sorted list: warp 0 finds
// the next live position by ballots, the block keeps it, and every thread
// tests its share of the live candidates behind it (the kept box's polygon
// clipped by the candidate, the plain version's roles), clearing those
// whose IoU exceeds the threshold. One launch a call; no host loop.
//
// `work`, where given, receives the fp32 operations the arithmetic took
// (counted per loop iteration, as the code below does them), for the
// bound of a measured run; the timed launches pass null.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 16;            // the plain version's vertex buffer
constexpr int kIouThreads = 256;
constexpr int kNmsThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinLive = -5e9f;     // NEG_INF / 2: selectable scores lie above

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

// Clip the ring (sx, sy)[0:n] by the half-plane left of e0 -> e1 into
// (dx, dy); returns the new vertex count (at most kSlots).
template <bool kCount>
__device__ int clip(const float* sx, const float* sy, int n, float e0x, float e0y,
                    float e1x, float e1y, float* dx, float* dy, u64& ops) {
  if (n == 0) return 0;
  const float ex = sub(e1x, e0x), ey = sub(e1y, e0y);
  const float d0 = side(ex, ey, e0x, e0y, sx[0], sy[0]);
  if (kCount) ops += 7;
  float dc = d0;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1 == n) ? 0 : i + 1;
    const float dn = (j == 0) ? d0 : side(ex, ey, e0x, e0y, sx[j], sy[j]);
    if (kCount && j != 0) ops += 5;
    const bool in = dc >= 0.f, in_next = dn >= 0.f;
    if (in && m < kSlots) {
      dx[m] = sx[i];
      dy[m] = sy[i];
      ++m;
    }
    if (in != in_next && m < kSlots) {
      const float diff = sub(dc, dn);
      const float t = __fdiv_rn(dc, fabsf(diff) < 1e-12f ? 1e-12f : diff);
      dx[m] = add(sx[i], mul(t, sub(sx[j], sx[i])));
      dy[m] = add(sy[i], mul(t, sub(sy[j], sy[i])));
      ++m;
      if (kCount) ops += 9;
    }
    dc = dn;
  }
  return m;
}

// Area of the intersection of polygon `p` (4 corners, x0 y0 .. x3 y3) with
// box `q` (4 corners): p clipped by q's edges in q's order.
template <bool kCount>
__device__ float inter_area(const float (&p)[8], const float (&q)[8], u64& ops) {
  float ax[kSlots], ay[kSlots], bx[kSlots], by[kSlots];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = p[2 * k];
    ay[k] = p[2 * k + 1];
  }
  int n = clip<kCount>(ax, ay, 4, q[0], q[1], q[2], q[3], bx, by, ops);
  n = clip<kCount>(bx, by, n, q[2], q[3], q[4], q[5], ax, ay, ops);
  n = clip<kCount>(ax, ay, n, q[4], q[5], q[6], q[7], bx, by, ops);
  n = clip<kCount>(bx, by, n, q[6], q[7], q[0], q[1], ax, ay, ops);
  if (n < 3) return 0.f;
  float acc = sub(mul(ax[0], ay[1]), mul(ax[1], ay[0]));
  for (int k = 1; k < n - 1; ++k)
    acc = add(acc, sub(mul(ax[k], ay[k + 1]), mul(ax[k + 1], ay[k])));
  acc = add(acc, sub(mul(ax[n - 1], ay[0]), mul(ax[0], ay[n - 1])));
  if (kCount) ops += 4 * (u64)n + 1;
  return mul(0.5f, fabsf(acc));
}

__device__ __forceinline__ void load8(const float* src, float (&dst)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void add_work(u64* work, u64 ops) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) ops += __shfl_xor_sync(kFull, ops, o);
  if ((threadIdx.x & 31) == 0 && ops) atomicAdd(work, ops);
}

template <bool kCount>
__global__ void __launch_bounds__(kIouThreads)
rotated_iou_kernel(const float* __restrict__ c1, const float* __restrict__ a1,
                   const float* __restrict__ c2, const float* __restrict__ a2,
                   int n1, int n2, float* __restrict__ out, u64* work) {
  const int col = blockIdx.x * kIouThreads + threadIdx.x;
  u64 ops = 0;
  float q[8];
  if (col < n2) load8(c2 + (size_t)col * 8, q);
  for (int row = blockIdx.y; row < n1; row += gridDim.y) {
    if (col >= n2) break;
    float p[8];
    load8(c1 + (size_t)row * 8, p);
    const float inter = inter_area<kCount>(p, q, ops);
    const float uni = sub(add(__ldg(a1 + row), __ldg(a2 + col)), inter);
    out[(size_t)row * n2 + col] = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
    if (kCount) ops += 4;
  }
  if (kCount) add_work(work, ops);
}

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

template <bool kCount>
__global__ void __launch_bounds__(kNmsThreads)
rotated_nms_kernel(const float* __restrict__ corners, const float* __restrict__ areas,
                   const float* __restrict__ scores, const uint8_t* __restrict__ valid,
                   int n, float thr, int max_out, int32_t* __restrict__ keep_idx,
                   uint8_t* __restrict__ keep_valid, u64* work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pn = next_pow2(n);
  u64* keys = reinterpret_cast<u64*>(smem);
  int* order = reinterpret_cast<int*>(keys + pn);
  uint8_t* live = reinterpret_cast<uint8_t*>(order + pn);
  __shared__ float pick[9];
  __shared__ int pick_pos;
  __shared__ int selectable;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bc = corners + (size_t)b * n * 8;
  const float* ba = areas + (size_t)b * n;
  const float* bs = scores + (size_t)b * n;
  const uint8_t* bv = valid ? valid + (size_t)b * n : nullptr;
  int32_t* out_idx = keep_idx + (size_t)b * max_out;
  uint8_t* out_valid = keep_valid + (size_t)b * max_out;

  if (tid == 0) selectable = 0;
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < pn; i += kNmsThreads) {
    u64 key = 0;
    if (i < n) {
      const float s = bs[i];
      if ((bv == nullptr || bv[i]) && s > kMinLive) {
        key = make_key(s, i);
        ++mine;
      }
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(&selectable, mine);
  __syncthreads();

  // bitonic sort, descending
  for (int k = 2; k <= pn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < pn; i += kNmsThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const u64 a = keys[i], c = keys[ixj];
          if (((i & k) == 0) ? (a < c) : (a > c)) {
            keys[i] = c;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int m = selectable;
  for (int p = tid; p < m; p += kNmsThreads) {
    order[p] = (int)~(uint32_t)keys[p];
    live[p] = 1;
  }
  __syncthreads();

  u64 ops = 0;
  int cnt = 0, cursor = 0;
  while (cnt < max_out) {
    if (warp == 0) {
      int p = cursor;
      while (p < m) {
        const unsigned w = __ballot_sync(kFull, p + lane < m && live[p + lane]);
        if (w) {
          p += __ffs(w) - 1;
          break;
        }
        p += 32;
      }
      if (lane == 0) pick_pos = p < m ? p : m;
    }
    __syncthreads();
    const int p = pick_pos;
    if (p >= m) break;
    const int idx = order[p];
    if (tid == 0) {
      out_idx[cnt] = idx;
      out_valid[cnt] = 1;
    }
    if (tid < 8) pick[tid] = bc[(size_t)idx * 8 + tid];
    if (tid == 8) pick[8] = ba[idx];
    ++cnt;
    __syncthreads();
    if (cnt == max_out) break;
    float pc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) pc[k] = pick[k];
    const float pa = pick[8];
    for (int q = p + 1 + tid; q < m; q += kNmsThreads) {
      if (!live[q]) continue;
      const int jdx = order[q];
      float qc[8];
      load8(bc + (size_t)jdx * 8, qc);
      const float inter = inter_area<kCount>(pc, qc, ops);
      const float uni = fmaxf(sub(add(pa, __ldg(ba + jdx)), inter), 1e-12f);
      if (kCount) ops += 4;
      if (__fdiv_rn(inter, uni) > thr) live[q] = 0;
    }
    cursor = p + 1;
    __syncthreads();
  }
  for (int s = cnt + tid; s < max_out; s += kNmsThreads) {
    out_idx[s] = 0;
    out_valid[s] = 0;
  }
  if (kCount) add_work(work, ops);
}

}  // namespace

extern "C" {

// corners1 (n1, 8) and areas1 (n1) float32: the clipped polygons (rows);
// corners2 (n2, 8), areas2 (n2): the clipping boxes (columns); out (n1, n2)
// float32. work: null, or a u64 that receives the fp32 operations.
int rotated_iou_launch(const void* corners1, const void* areas1, const void* corners2,
                       const void* areas2, int n1, int n2, void* out, void* work,
                       void* stream) {
  if (n1 < 1 || n2 < 1) return (int)cudaSuccess;
  const dim3 grid((n2 + kIouThreads - 1) / kIouThreads, n1 < 65535 ? n1 : 65535);
  const cudaStream_t s = (cudaStream_t)stream;
  if (work)
    rotated_iou_kernel<true><<<grid, kIouThreads, 0, s>>>(
        (const float*)corners1, (const float*)areas1, (const float*)corners2,
        (const float*)areas2, n1, n2, (float*)out, (u64*)work);
  else
    rotated_iou_kernel<false><<<grid, kIouThreads, 0, s>>>(
        (const float*)corners1, (const float*)areas1, (const float*)corners2,
        (const float*)areas2, n1, n2, (float*)out, nullptr);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of rotated_nms_launch for n candidates an image:
// the keys and the sorted order over the next power of two, the live flags.
int rotated_nms_smem_bytes(int n) {
  if (n < 1 || n > (1 << 16)) return INT_MAX;
  const int p = next_pow2(n);
  return 13 * p;
}

// corners (B, n, 8), areas (B, n), scores (B, n) float32; valid (B, n) bytes
// or null; keep_idx (B, max_out) int32, keep_valid (B, max_out) bytes; work
// null or a u64 that receives the fp32 operations. Returns
// cudaGetLastError() after the launch.
int rotated_nms_launch(const void* corners, const void* areas, const void* scores,
                       const void* valid, int batch, int n, float thr, int max_out,
                       void* keep_idx, void* keep_valid, void* work, void* stream) {
  const int smem = rotated_nms_smem_bytes(n);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (work) {
    err = cudaFuncSetAttribute(rotated_nms_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    rotated_nms_kernel<true><<<batch, kNmsThreads, smem, s>>>(
        (const float*)corners, (const float*)areas, (const float*)scores,
        (const uint8_t*)valid, n, thr, max_out, (int32_t*)keep_idx, (uint8_t*)keep_valid,
        (u64*)work);
  } else {
    err = cudaFuncSetAttribute(rotated_nms_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    rotated_nms_kernel<false><<<batch, kNmsThreads, smem, s>>>(
        (const float*)corners, (const float*)areas, (const float*)scores,
        (const uint8_t*)valid, n, thr, max_out, (int32_t*)keep_idx, (uint8_t*)keep_valid,
        nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
