// Fixed-shape greedy NMS, one thread block per image: sort once, then resolve
// 32 candidates a round.
//
// Replaces: slenderobjdet_tpu/ops/pallas_nms.py `_nms_kernel` (the Pallas
// kernel behind `pallas_nms` / `pallas_batched_nms`) and the `nms_select`
// scan of slenderobjdet_tpu/ops/nms.py, whose results it reproduces bit for
// bit: the same keep_idx and keep_valid. The class offset of `batched_nms`
// (box + float(class) * (largest finite coordinate of the image + 1)) is
// formed inside the kernel, so a class-aware call is one launch.
//
// Rows instead of images: a launch may also take a per-row offset that is
// added to every box of the row (box + offset, as the reference adds a
// class offset). The RPN's level-aware NMS (ops/nms.py:level_batched_nms)
// runs one row per (image, level), each shifted by float(level) * (the
// whole image's largest finite coordinate + 1), the offset the reference's
// single call gives that level; levels never suppress each other, so the
// rows' kept lists merged by (score descending, index ascending) are that
// call's result.
//
// What bounds it on an H100: neither bytes nor FLOPs of the roofline (an
// image's candidates are 0.1 MB, read once). The TPU kernel is a loop of
// max_out steps (argmax, pick, suppress), each waiting for the one before,
// because Mosaic has neither a sort nor a per-row gather. On this card such a
// chain costs a few block-wide barriers a step, a hundred times over. With
// the chain cut, what is left is (1) the sort, two thirds of the kernel at
// 5000 candidates, and (2) the sweep: every kept box meets every candidate
// that could still be chosen.
//
// Design:
// 1. Sort once. Greedy NMS by repeated argmax (ties to the lowest index)
//    visits the candidates in the order (score descending, index ascending)
//    and skips the suppressed. Each selectable candidate (valid and score >
//    -5e9, the reference's test) gets a 64-bit key, the score's bits made
//    order-preserving in the high word and ~index in the low word; the keys
//    are compacted into shared memory and sorted descending by a bitonic
//    network over the next power of two of their count, so the sort's cost
//    follows the number of selectable candidates, not N. A warp owns 256
//    consecutive keys, 8 a thread in registers: compare-exchange steps with a
//    stride below 256 are register moves and warp shuffles, and only strides
//    of 256 and more go through shared memory under a block-wide barrier,
//    two strides a barrier (15 of the 91 steps at 8192 keys, 9 barriers).
// 2. Resolve a group of 32 a round. Warp 0 takes the next 32 live candidates
//    in sorted order from the live bitmask (lane t the t-th set bit). Nothing
//    live lies between them, so the greedy choice among them needs only
//    their 32 x 32 IoUs: thread (w, l) of the block computes the pair (w, l),
//    a ballot gives the group's suppression matrix, and warp 0 resolves it
//    in order in registers (keep the first; keep each later one that no kept
//    one before it suppresses; stop at max_out). Then the block sweeps the
//    candidates behind the group, one mask word a warp, and kills those that
//    any of the group's kept boxes suppresses: first a branch-free test of
//    which kept boxes overlap the candidate in x at all, then the IoU for
//    those few, leaving at the first hit. Four barriers a round, and a
//    hundred detections take about four rounds where the step-by-step loop
//    takes a hundred; when every group keeps one box it is that loop's count
//    and no worse.
//    Only a window of sorted positions is swept, 1024 from the cursor on:
//    a hundred detections are found among the first few hundred candidates,
//    and the rest never need their boxes loaded. When the cursor comes
//    within 256 positions of the window's end the window is opened again,
//    and the candidates that enter it first meet every box kept so far.
// 3. Divide only where the division decides. `RN(inter / uni) > thr` is
//    false at once where the boxes do not overlap (most pairs: other classes
//    are a class offset away). Otherwise, with t = RN(thr * uni) in the
//    normal range, t = thr * uni * (1 + e), |e| <= 2^-24. RN is monotonic,
//    so inter / uni <= thr gives RN(inter / uni) <= thr, and inter / uni >=
//    thr * (1 + 2^-23) >= nextup(thr) gives RN(inter / uni) > thr. Now
//    RN(t * (1 - 2^-21)) <= thr * uni * (1 + 2^-24)^2 * (1 - 2^-21) < thr *
//    uni, so inter below it is surely not suppressed; and RN(t * (1 +
//    2^-21)) >= thr * uni * (1 - 2^-24)^2 * (1 + 2^-21) > thr * uni * (1 +
//    2^-22), so inter above it surely is. Only inside that band of about 32
//    ulps, or where t leaves [1e-30, 1e30], is `__fdiv_rn` called.
//    Every operation keeps the reference's order with explicitly rounded
//    intrinsics (no FMA contraction); min, max and + commute, so the IoU of
//    a pair is the same bits from either side, which step 2 relies on.
//
// Not handled beyond the reference's own behaviour on them: NaN scores or
// coordinates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;            // candidates resolved a round
constexpr int kPerThread = 8;         // keys a thread holds in the sort
constexpr int kWarpSpan = 32 * kPerThread;
constexpr int kAhead = 8;             // mask words kept open ahead of the cursor
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinLive = -5e9f;     // NEG_INF / 2: selectable scores lie above

typedef unsigned long long u64;

// Descending key order == (score descending, index ascending). -0 and +0
// are one score to the reference's argmax. A selectable key is never 0.
__device__ __forceinline__ u64 make_key(float s, int idx) {
  uint32_t u = (s == 0.f) ? 0u : __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (uint32_t)~(uint32_t)idx;
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)~(uint32_t)key;
}

// The compare-exchange steps of phase k with strides jstart, jstart / 2, ...,
// 1 (jstart <= 128) on the 256 keys a warp owns: key r * 32 + lane of the
// span that starts at ibase sits in v[r]. After the whole network position 0
// holds the largest key.
__device__ __forceinline__ void warp_steps(u64 (&v)[kPerThread], int k,
                                           int jstart, int ibase, int lane) {
#pragma unroll
  for (int jr = kPerThread / 2; jr >= 1; jr >>= 1) {
    if (32 * jr <= jstart) {    // then k >= 64: the lane's bits are not in k
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        if ((r & jr) == 0) {
          const bool up = ((ibase + r * 32) & k) == 0;
          const u64 a = v[r], b = v[r | jr];
          if ((a < b) == up) {
            v[r] = b;
            v[r | jr] = a;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    if (j <= jstart) {
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const bool up = ((ibase + r * 32 + lane) & k) == 0;
        const u64 o = __shfl_xor_sync(kFull, v[r], j);
        if ((v[r] < o) == (lower == up)) v[r] = o;
      }
    }
  }
}

// Sort keys[0, P) descending; P is a power of two, 256 <= P <= 32 * 256.
__device__ void sort_descending(u64* keys, int P, int tid) {
  const int lane = tid & 31;
  const int ibase = (tid >> 5) * kWarpSpan;
  const bool active = ibase < P;
  u64 v[kPerThread];
  if (active) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) v[r] = keys[ibase + r * 32 + lane];
#pragma unroll 1
    for (int k = 2; k <= kWarpSpan; k <<= 1) warp_steps(v, k, k >> 1, ibase, lane);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) keys[ibase + r * 32 + lane] = v[r];
  }
  __syncthreads();
#pragma unroll 1
  for (int k = 2 * kWarpSpan; k <= P; k <<= 1) {
    int j = k >> 1;
    while (j >= kWarpSpan) {
      if (j >= 2 * kWarpSpan) {
        // strides j and j / 2 on the four keys i, i + h, i + j, i + j + h
        const int h = j >> 1;
        for (int t = tid; t < (P >> 2); t += kThreads) {
          const int i = ((t & ~(h - 1)) << 2) | (t & (h - 1));
          const bool up = (i & k) == 0;
          u64 a0 = keys[i], a1 = keys[i + h], a2 = keys[i + j], a3 = keys[i + j + h];
          u64 s;
          if ((a0 < a2) == up) { s = a0; a0 = a2; a2 = s; }
          if ((a1 < a3) == up) { s = a1; a1 = a3; a3 = s; }
          if ((a0 < a1) == up) { s = a0; a0 = a1; a1 = s; }
          if ((a2 < a3) == up) { s = a2; a2 = a3; a3 = s; }
          keys[i] = a0;
          keys[i + h] = a1;
          keys[i + j] = a2;
          keys[i + j + h] = a3;
        }
        j >>= 2;
      } else {
        for (int t = tid; t < (P >> 1); t += kThreads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const bool up = (i & k) == 0;
          const u64 a = keys[i], b = keys[i + j];
          if ((a < b) == up) {
            keys[i] = b;
            keys[i + j] = a;
          }
        }
        j >>= 1;
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) v[r] = keys[ibase + r * 32 + lane];
      warp_steps(v, k, kWarpSpan / 2, ibase, lane);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) keys[ibase + r * 32 + lane] = v[r];
    }
    __syncthreads();
  }
}

// RN(inter / uni) > thr, dividing only inside the band around thr * uni
// (the header comment, point 3, argues the margins).
__device__ __forceinline__ bool iou_exceeds(float inter, float uni, float thr) {
  const float t = __fmul_rn(thr, uni);
  if (t >= 1e-30f && t <= 1e30f) {
    if (inter > __fmul_rn(t, 1.f + 0x1p-21f)) return true;
    if (inter < __fmul_rn(t, 1.f - 0x1p-21f)) return false;
  }
  return __fdiv_rn(inter, uni) > thr;
}

// Whether the selected box b suppresses the candidate a: the reference's
// iou = inter / max((areas + barea) - inter, 1e-12) > thr. `quick` (thr >= 0)
// lets a pair without overlap leave early: its inter is 0 or NaN.
__device__ __forceinline__ bool suppresses(const float4 a, float a_area,
                                           const float4 b, float b_area,
                                           float thr, bool quick) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  if (quick && !(iw > 0.f)) return false;
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  if (quick && !(ih > 0.f)) return false;
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      fmaxf(__fsub_rn(__fadd_rn(a_area, b_area), inter), 1e-12f);
  return iou_exceeds(inter, uni, thr);
}

// The position of the n-th set bit of w (n from 0, below popc(w)).
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int at = 0;
#pragma unroll
  for (int span = 16; span >= 1; span >>= 1) {
    const int c = __popc((w >> at) & ((1u << span) - 1u));
    if (n >= c) {
      n -= c;
      at += span;
    }
  }
  return at;
}

__host__ __device__ __forceinline__ int next_pow2(int x) {
  int p = kWarpSpan;
  while (p < x) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const void* __restrict__ cls, int cls_is_64,
           const float* __restrict__ row_offset,
           const uint8_t* __restrict__ valid, int n, float thr, int max_out,
           int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid,
           int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pmax = next_pow2(n);
  u64* keys = reinterpret_cast<u64*>(smem);                       // pmax
  float4* sbox = reinterpret_cast<float4*>(keys + pmax);          // n, sorted
  float4* kbox = sbox + n;                                        // max_out, kept
  float* sarea = reinterpret_cast<float*>(kbox + max_out);        // n, sorted
  float* karea = sarea + n;                                       // max_out, kept
  unsigned* mask = reinterpret_cast<unsigned*>(karea + max_out);  // pmax / 32
  __shared__ float4 gbox[kGroup];
  __shared__ float2 gspan[kGroup];     // the group's x1, x2
  __shared__ float garea[kGroup];
  __shared__ int grp[kGroup];
  __shared__ __align__(16) unsigned col[kGroup];
  __shared__ float red[kWarps];
  __shared__ int nv_s, g_s;
  __shared__ unsigned kept_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const float4* bb = reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  const float* sc = scores + (size_t)b * n;
  const uint8_t* vl = valid ? valid + (size_t)b * n : nullptr;
  int32_t* out_idx = keep_idx + (size_t)b * max_out;
  uint8_t* out_valid = keep_valid + (size_t)b * max_out;

  if (tid == 0) nv_s = 0;
  // The class offset's factor: the image's largest finite coordinate
  // (non-finite ones count as 0), a maximum that no order changes.
  if (cls) {
    float m = -INFINITY;
    for (int j = tid; j < n; j += kThreads) {
      const float4 q = bb[j];
      m = fmaxf(m, fabsf(q.x) < INFINITY ? q.x : 0.f);
      m = fmaxf(m, fabsf(q.y) < INFINITY ? q.y : 0.f);
      m = fmaxf(m, fabsf(q.z) < INFINITY ? q.z : 0.f);
      m = fmaxf(m, fabsf(q.w) < INFINITY ? q.w : 0.f);
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) red[warp] = m;
  }
  __syncthreads();

  // Keys of the selectable candidates, compacted in any order (the sort
  // orders them; every key is distinct).
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + tid;
    float s = 0.f;
    bool sel = false;
    if (j < n) {
      s = sc[j];
      sel = s > kMinLive && (vl == nullptr || vl[j] != 0);
    }
    const unsigned vote = __ballot_sync(kFull, sel);
    int start = 0;
    if (lane == 0 && vote) start = atomicAdd(&nv_s, __popc(vote));
    start = __shfl_sync(kFull, start, 0);
    if (sel) keys[start + __popc(vote & lt_mask)] = make_key(s, j);
  }
  __syncthreads();
  const int nv = nv_s;
  const int P = next_pow2(nv);
  for (int p = nv + tid; p < P; p += kThreads) keys[p] = 0;
  float coord = 0.f;
  if (cls) {
    float m = red[lane];
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    coord = __fadd_rn(m, 1.f);
  }
  __syncthreads();

  sort_descending(keys, P, tid);

  const int nwords = (nv + 31) >> 5;
  for (int w = tid; w < nwords; w += kThreads)
    mask[w] = (nv - 32 * w >= 32) ? kFull : ((1u << (nv - 32 * w)) - 1u);
  __syncthreads();

  const bool quick = thr >= 0.f;
  int cnt = 0;       // slots written so far
  int cursor = 0;    // every sorted position below it is kept or dead
  int open = 0;      // mask words whose candidates have met every kept box
  int rounds = 0;
  while (cnt < max_out) {
    // The window. Only the candidates near the cursor can be chosen soon, so
    // only they are loaded and swept: words [cursor / 32, open). When fewer
    // than kAhead words lie ahead it is opened to 32 words, one a warp: the
    // new candidates' boxes are fetched (with the class offset, as the
    // reference forms it: box + float(class) * coord) and meet the boxes
    // kept so far.
    const int cw = cursor >> 5;
    if (open < nwords && open - cw < kAhead) {
      const int target = min(nwords, cw + kWarps);
      const int wi = open + warp;
      const int p = wi * 32 + lane;
      bool hit = false;
      if (wi < target && p < nv) {
        const int j = key_index(keys[p]);
        float4 q = bb[j];
        if (cls) {
          const size_t at = (size_t)b * n + j;
          const float c = cls_is_64
              ? __ll2float_rn(reinterpret_cast<const long long*>(cls)[at])
              : __int2float_rn(reinterpret_cast<const int*>(cls)[at]);
          const float off = __fmul_rn(c, coord);
          q.x = __fadd_rn(q.x, off);
          q.y = __fadd_rn(q.y, off);
          q.z = __fadd_rn(q.z, off);
          q.w = __fadd_rn(q.w, off);
        } else if (row_offset) {
          const float off = row_offset[b];
          q.x = __fadd_rn(q.x, off);
          q.y = __fadd_rn(q.y, off);
          q.z = __fadd_rn(q.z, off);
          q.w = __fadd_rn(q.w, off);
        }
        // areas = clip(x2 - x1, 0) * clip(y2 - y1, 0)
        const float q_area = __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.f),
                                       fmaxf(__fsub_rn(q.w, q.y), 0.f));
        sbox[p] = q;
        sarea[p] = q_area;
        for (int i = 0; i < cnt && !hit; ++i)
          hit = suppresses(q, q_area, kbox[i], karea[i], thr, quick);
      }
      if (wi < target) {
        const unsigned vote = __ballot_sync(kFull, hit);
        if (lane == 0 && vote) mask[wi] &= ~vote;
      }
      open = target;
      __syncthreads();
    }

    // Warp 0: the next (up to) 32 live positions of the window, lane i
    // looking at word cw + i; lane t then takes the t-th live bit.
    if (warp == 0) {
      unsigned w = cw + lane < open ? mask[cw + lane] : 0u;
      if (lane == 0) w &= kFull << (cursor & 31);
      const int c = __popc(w);
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      const int excl = incl - c;
      const int g = min(kGroup, __shfl_sync(kFull, incl, 31));
      int pos = 0;
      for (unsigned nz = __ballot_sync(kFull, c > 0); nz != 0u; nz &= nz - 1u) {
        const int j = __ffs(nz) - 1;
        const unsigned wj = __shfl_sync(kFull, w, j);
        const int before = __shfl_sync(kFull, excl, j);
        if (before >= kGroup) break;    // word j starts past the 32nd live bit
        const int nth = lane - before;
        if (nth >= 0 && nth < __popc(wj)) pos = (cw + j) * 32 + nth_set_bit(wj, nth);
      }
      if (lane < g) {
        const float4 q = sbox[pos];
        grp[lane] = pos;
        gbox[lane] = q;
        gspan[lane] = make_float2(q.x, q.z);
        garea[lane] = sarea[pos];
      }
      if (lane == 0) g_s = g;
    }
    __syncthreads();
    const int g = g_s;
    if (g == 0) {
      if (open >= nwords) break;    // nothing live is left
      cursor = open * 32;           // the window is used up: open the next
      continue;
    }
    ++rounds;

    // Pair (warp, lane): does the earlier candidate `warp` suppress `lane`?
    {
      bool hit = false;
      if (warp < lane && lane < g)
        hit = suppresses(gbox[lane], garea[lane], gbox[warp], garea[warp], thr, quick);
      const unsigned vote = __ballot_sync(kFull, hit);
      if (lane == 0) col[warp] = vote;
    }
    __syncthreads();

    // Warp 0 resolves the group in order: candidate j is kept unless a kept
    // one before it suppresses it. col[j] has bits above j only, so bit j of
    // `dead` is final when the loop reaches it. Stopping at max_out drops
    // the last kept ones, which changes nothing before them.
    if (warp == 0) {
      unsigned dead = 0u;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) dead |= ((dead >> j) & 1u) ? 0u : col[j];
      unsigned kept = ~dead & (kFull >> (kGroup - g));
      const int room = max_out - cnt;
      if (__popc(kept) > room) kept &= (1u << nth_set_bit(kept, room)) - 1u;
      if ((kept >> lane) & 1u) {
        const int slot = cnt + __popc(kept & lt_mask);
        out_idx[slot] = key_index(keys[grp[lane]]);
        out_valid[slot] = 1;
        kbox[slot] = gbox[lane];
        karea[slot] = garea[lane];
      }
      if (lane == 0) kept_s = kept;
    }
    __syncthreads();
    const unsigned kept = kept_s;
    cnt += __popc(kept);
    cursor = grp[g - 1] + 1;

    // The sweep of the window behind the group, one mask word a warp. First,
    // without a branch, which of the group's boxes overlap the candidate in
    // x at all (iw > 0 exactly where min(x2) > max(x1): the difference of two
    // unequal floats is never 0); other classes lie a class offset away, so
    // few do. Only those go on to the IoU.
    const int wi = (cursor >> 5) + warp;
    if (cnt < max_out && wi < open) {
      const int p = wi * 32 + lane;
      const unsigned w = mask[wi];
      bool hit = false;
      if (((w >> lane) & 1u) && p >= cursor) {
        const float4 a = sbox[p];
        unsigned near = kept;
        if (quick) {
          near = 0u;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float2 x = gspan[j];
            if (fminf(a.z, x.y) > fmaxf(a.x, x.x)) near |= 1u << j;
          }
          near &= kept;
        }
        const float a_area = sarea[p];
        for (; near != 0u; near &= near - 1u) {
          const int j = __ffs(near) - 1;
          if (suppresses(a, a_area, gbox[j], garea[j], thr, quick)) {
            hit = true;
            break;
          }
        }
      }
      const unsigned vote = __ballot_sync(kFull, hit);
      if (lane == 0 && vote) mask[wi] = w & ~vote;
    }
    __syncthreads();
  }

  for (int s = cnt + tid; s < max_out; s += kThreads) {
    out_idx[s] = 0;
    out_valid[s] = 0;
  }
  if (rounds_out != nullptr && tid == 0) rounds_out[b] = rounds;
}

}  // namespace

extern "C" {

// Dynamic shared memory for n candidates and max_out slots: the keys over
// the next power of two (at least 256), the sorted and the kept boxes and
// areas, the live bitmask. The sort holds 8 keys a thread, so 8192
// candidates are the most an image may have.
int nms_smem_bytes(int n, int max_out) {
  if (n < 1 || n > kThreads * kPerThread || max_out < 1 || max_out > (1 << 20))
    return INT_MAX;
  const int p = next_pow2(n);
  return 8 * p + 20 * (n + max_out) + p / 8;
}

// boxes (B, N, 4) float32 XYXY, scores (B, N) float32; cls (B, N) int32 or
// int64 (cls_is_64) or null for class-free NMS; row_offset (B) float32 or
// null, added to every box of a row (only where cls is null); valid (B, N)
// bytes or null;
// keep_idx (B, max_out) int32, keep_valid (B, max_out) bytes; rounds (B)
// int32 or null: the block-wide rounds each image took. Returns
// cudaGetLastError() after the launch.
int nms_launch(const void* boxes, const void* scores, const void* cls,
               int cls_is_64, const void* row_offset, const void* valid,
               int batch, int n, float thr, int max_out, void* keep_idx,
               void* keep_valid, void* rounds, void* stream) {
  const int smem = nms_smem_bytes(n, max_out);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, cls, cls_is_64,
      (const float*)row_offset, (const uint8_t*)valid, n, thr, max_out,
      (int32_t*)keep_idx, (uint8_t*)keep_valid, (int32_t*)rounds);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
