// Corner pooling (CornerNet): tl_pool(a, b) = top_pool(a) + left_pool(b)
// and br_pool(a, b) = bottom_pool(a) + right_pool(b) over (B, C, H, W)
// tensors stored channels last (NHWC), in bf16 or fp32, and their backward.
//
// Replaces: slenderobjdet_tpu/ops/corner_pool.py (`tl_pool`, `br_pool`: a
// directional cumulative max by `jax.lax.associative_scan`, no Pallas
// kernel), whose plain PyTorch versions are the `torch.cummax` compositions
// of slenderobjdet_torch/ops/corner_pool.py; and the reference's own native
// op (slender_det/layers/csrc/corner_pool).
//
// Directions: top = max over y' >= y (a scan from the bottom row up),
// left = max over x' >= x (from the right), bottom = max over y' <= y,
// right = max over x' <= x. "Scan order" below is that order: rows from
// the bottom and columns from the right for TL, from the top and the left
// for BR.
//
// The running max takes a value v when v >= max or v is NaN, torch.cummax's
// rule: a tie goes to the element found later in scan order, which is the
// element the backward credits. Starting from -inf takes the first element
// whatever it is, so -inf is the rule's identity; and the rule is
// associative (its result is the last NaN if there is one, else the last
// element equal to the max), so partial results of consecutive pieces
// combine exactly, in any grouping, in scan order.
//
// Bound: bytes. The forward must read a and b and write out (3 passes,
// 484 MB at (8, 128, 224, 352) bf16: 0.1446 ms at 3.35 TB/s); the backward
// must read a, b and g and write g_a and g_b (5 passes). Each does a few
// fp32 operations an element.
//
// Forward (`corner_pool_forward_kernel`), one launch, a, b read once and out
// written once. A CTA owns a band of R consecutive rows (in scan order) of
// one (image, chunk of channels): a pixel's chunk is two 16-byte vectors
// (16 bf16 or 8 fp32 channels, one 32-byte sector). It
//   1. copies its band of a into shared memory (cp.async, 16 bytes a copy)
//      and, at once, its thread's segment of 16 pixels of one row of b into
//      registers, so a CTA has a whole band of both in flight;
//   2. folds the band's column maxima (the band's aggregate) and publishes
//      them in a global scratch slot with flag 1, unless the band before it
//      has already published its inclusive maxima;
//   3. looks back over the bands before it in the same (image, chunk), as a
//      decoupled look-back scan does: an inclusive slot (flag 2) ends the
//      walk, an aggregate (flag 1) is folded in and the walk goes on. Bands
//      take their place from an atomic ticket, in band-major order, so a
//      CTA waits only on bands that started before it: no deadlock;
//   4. walks its rows in scan order from that carry, turning the band in
//      shared memory into the vertical maxima, and publishes the last row
//      (its inclusive maxima, flag 2) over the aggregate. A reader that met
//      flag 1 and reads the inclusive values gets the same result: folding
//      the bands before it in again changes nothing (the rule is idempotent);
//   5. scans each row of b across threads: each thread folds its segment,
//      the segments' aggregates meet in shared memory, each thread folds
//      those before its own, then walks its segment again in registers and
//      writes out = round(vertical + horizontal), formed in fp32 and rounded
//      once, with 16-byte stores.
// Maxima of bf16 values are bf16 values, so the carries and the vertical
// maxima are stored exactly and the output is the plain version's bit for
// bit; bf16 maxima are taken on packed pairs (`take_bf16x2`: two compares
// and a select for two elements, no conversion). R is the most rows whose
// band of a fits kBandBytes* of shared memory and whose segments fit 512
// threads: 8 rows of 352 pixels in bf16 (352 threads, 107,008 bytes), 5 in
// fp32. No row exchanges anything with another CTA: the only traffic
// between CTAs is one slot of W x 32 bytes a band (and its flag). The
// scratch (the slots, the flags and the ticket) comes from the wrapper; the
// launcher zeroes the flags and the ticket before the kernel, on the same
// stream. -Xptxas -v (sm_90a): 120-127 registers with 16-byte vectors,
// 56-64 with single elements, no spills, 16 bytes of static shared memory.
//
// Backward (`corner_pool_backward_kernel`), one launch, no index tensor: a
// thread a line (an (image, column) of a for the vertical scan, an (image,
// row) of b for the horizontal one) and a 16-byte vector of channels,
// walking the line in scan order, 8 positions loaded at once. It keeps each
// channel's running max, argmax and, in fp32, the gradient received since
// the argmax last changed. At each position it writes 0 to the whole vector
// of the input's gradient; when a channel's argmax moves, the sum is
// written to the old argmax over that 0 (the same thread, in program
// order), and the last argmax gets the last sum, so each credited element's
// sum is rounded once. The vertical lines read a and g and write g_a, the
// horizontal ones read b and g and write g_b: g is read twice (6 passes, not
// 5), because a vertical argmax's run crosses the forward's bands, and
// carrying (argmax, fp32 sum) state from band to band would move 8 bytes a
// column element a band boundary and a chain of waits like the forward's.
// At 4 CTAs of 128 threads an SM the heads' lines (74k threads) do not all
// fit at once; the longer lines take the lower thread numbers so that they
// start first. -Xptxas -v: 124-128 registers with 16-byte vectors (8-16
// bytes of spill in bf16), 70-78 with single elements.
//
// Channels: a pixel's C channels are read as 16-byte vectors when C * size
// is a multiple of 16 and the pointers are 16-byte aligned; else (odd C,
// say) both kernels take single elements, the forward's chunks 2 channels.
// A last chunk of fewer channels leaves its missing vectors idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSeg = 16;                  // forward: pixels of a row a thread scans
constexpr int kVecs = 2;                  // forward: vectors in a chunk
constexpr int kMaxThreads = 512;          // forward: a CTA's threads
constexpr long long kMaxSmem = 226 * 1024;   // dynamic: 227 KB less the static part
// forward: the shared memory for a band of a (measured best of 24-128 KB
// at the heads' shapes: 8 rows of 352 pixels in bf16, 5 in fp32)
constexpr long long kBandBytesBf16 = 96 * 1024, kBandBytesFp32 = 64 * 1024;
constexpr int kAhead = 8;                 // backward: positions loaded at once
constexpr int kBwdMinBlocks = 4;          // backward: at most 128 registers a thread
constexpr int kBwdThreads = 128;

// A vector of VW elements as it lies in memory: 16 bytes, or one element.
template <typename T, int VW>
struct RawOf {
  using type = uint4;
};
template <>
struct RawOf<float, 1> {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16, 1> {
  using type = unsigned short;
};

template <typename T, int VW>
using Raw = typename RawOf<T, VW>::type;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T, int VW>
__device__ __forceinline__ void unpack(const Raw<T, VW>& r, float (&f)[VW]) {
  if constexpr (VW == 1) {
    if constexpr (std::is_same<T, float>::value)
      f[0] = r;
    else
      f[0] = __uint_as_float((uint32_t)r << 16);
  } else if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  } else {
    f[0] = bf16_lo(r.x), f[1] = bf16_hi(r.x), f[2] = bf16_lo(r.y), f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z), f[5] = bf16_hi(r.z), f[6] = bf16_lo(r.w), f[7] = bf16_hi(r.w);
  }
}

// Rounds each value to T once (exact for values that are T values).
template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> pack(const float (&f)[VW]) {
  Raw<T, VW> r;
  if constexpr (VW == 1) {
    if constexpr (std::is_same<T, float>::value)
      r = f[0];
    else
      r = (unsigned short)bf16_bits(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    r = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                   __float_as_uint(f[3]));
  } else {
    r.x = bf16_bits(f[0]) | bf16_bits(f[1]) << 16;
    r.y = bf16_bits(f[2]) | bf16_bits(f[3]) << 16;
    r.z = bf16_bits(f[4]) | bf16_bits(f[5]) << 16;
    r.w = bf16_bits(f[6]) | bf16_bits(f[7]) << 16;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The running max's step: m after meeting v (torch.cummax's rule).
__device__ __forceinline__ float take(float m, float v) { return (v >= m || v != v) ? v : m; }

// take() on two bf16 pairs at once, on their bits: v where v >= m
// (ordered) or v is NaN (unordered v != v), else m.
__device__ __forceinline__ uint32_t take_bf16x2(uint32_t m, uint32_t v) {
  const __nv_bfloat162 m2 = *reinterpret_cast<const __nv_bfloat162*>(&m);
  const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const uint32_t mask = __hge2_mask(v2, m2) | __hneu2_mask(v2, v2);
  return (v & mask) | (m & ~mask);
}

// take() on each element of two vectors as they lie in memory.
template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> take_raw(const Raw<T, VW>& m, const Raw<T, VW>& v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VW > 1) {
    return make_uint4(take_bf16x2(m.x, v.x), take_bf16x2(m.y, v.y), take_bf16x2(m.z, v.z),
                      take_bf16x2(m.w, v.w));
  } else {
    float fm[VW], fv[VW];
    unpack<T, VW>(m, fm);
    unpack<T, VW>(v, fv);
#pragma unroll
    for (int e = 0; e < VW; ++e) fm[e] = take(fm[e], fv[e]);
    return pack<T, VW>(fm);
  }
}

template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> neg_inf_raw() {
  float f[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) f[e] = -INFINITY;
  return pack<T, VW>(f);
}

// round(x + y) of two vectors, formed in fp32 and rounded once.
template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> add_raw(const Raw<T, VW>& x, const Raw<T, VW>& y) {
  float fx[VW], fy[VW];
  unpack<T, VW>(x, fx);
  unpack<T, VW>(y, fy);
#pragma unroll
  for (int e = 0; e < VW; ++e) fx[e] += fy[e];
  return pack<T, VW>(fx);
}

// --------------------------------------------------- memory helpers

template <typename R>
__device__ __forceinline__ void copy_to_shared(R* dst, const R* src) {
  if constexpr (sizeof(R) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void copies_commit_and_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// A scratch slot's element, read at L2 (another CTA wrote it).
template <typename R>
__device__ __forceinline__ R load_l2(const R* p) {
  if constexpr (sizeof(R) == 16) {
    return __ldcg(p);
  } else if constexpr (sizeof(R) == 4) {
    return __ldcg(p);
  } else {
    unsigned short v;
    asm volatile("ld.global.cg.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
    return v;
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// ----------------------------------------------------------- forward

// Shapes of one forward call; the same on the host (scratch size, launch)
// and in the kernel.
struct FwdPlan {
  int vw, nv, nchunks, R, nbands, S, threads;
  long long smem, flag_bytes, carry_bytes;
};

template <typename T, bool kReverse, int VW, int NV>
__global__ void __launch_bounds__(kMaxThreads)
corner_pool_forward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           T* __restrict__ out, int* __restrict__ flags,
                           Raw<T, VW>* __restrict__ carries, int B, int C, int H, int W,
                           int R, int nbands, int nchunks, int S) {
  using V = Raw<T, VW>;
  constexpr int CC = VW * NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* band = reinterpret_cast<V*>(smem_raw);   // [R][W][NV]: a, then the vertical maxima
  V* cin = band + (size_t)R * W * NV;         // [W][NV]: the maxima of the bands before
  V* segs = cin + (size_t)W * NV;             // [R][S][NV]: the row segments' maxima
  __shared__ int s_ticket, s_flag;

  const int nchains = B * nchunks;
  if (threadIdx.x == 0) s_ticket = atomicAdd(flags + nchains * nbands, 1);
  __syncthreads();
  const int k = s_ticket / nchains, chain = s_ticket % nchains;
  const int img = chain / nchunks, c0 = (chain % nchunks) * CC;
  const int nvalid = min(NV, (C - c0) / VW);
  const int s0 = k * R, rows = min(R, H - s0);
  const bool last = k == nbands - 1;
  const T* a_img = a + (size_t)img * H * W * C + c0;
  const int columns = W * NV;                 // (x, vector) pairs of a row

  // 1. The band of a into shared memory; this thread's segment of b into
  // registers.
  for (int i = threadIdx.x; i < rows * columns; i += blockDim.x) {
    const int v = i % NV, x = (i / NV) % W, rr = i / columns;
    if (v < nvalid) {
      const int y = kReverse ? H - 1 - (s0 + rr) : s0 + rr;
      copy_to_shared(band + i, reinterpret_cast<const V*>(a_img + ((size_t)y * W + x) * C) + v);
    }
  }
  const int hv = threadIdx.x % NV, hs = (threadIdx.x / NV) % S, hr = threadIdx.x / (NV * S);
  const bool h_on = hr < rows && hv < nvalid;
  const int hy = kReverse ? H - 1 - (s0 + hr) : s0 + hr;
  const size_t h_row = (((size_t)img * H + hy) * W) * C + c0 + hv * VW;
  V seg[kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const int p = hs * kSeg + i;
    if (h_on && p < W) {
      const int x = kReverse ? W - 1 - p : p;
      seg[i] = *reinterpret_cast<const V*>(b + h_row + (size_t)x * C);
    }
  }
  copies_commit_and_wait();
  if (threadIdx.x == 0) s_flag = k > 0 ? load_acquire(flags + chain * nbands + k - 1) : 2;
  __syncthreads();
  const int before = s_flag;
  int* my_flag = flags + chain * nbands + k;
  V* my_slot = carries + ((size_t)chain * nbands + k) * columns;

  // 2. The band's aggregate, for the bands after it, unless the band
  // before has its inclusive maxima out already.
  if (before != 2 && !last) {
    for (int col = threadIdx.x; col < columns; col += blockDim.x) {
      V m = neg_inf_raw<T, VW>();
      for (int rr = 0; rr < rows; ++rr) m = take_raw<T, VW>(m, band[rr * columns + col]);
      my_slot[col] = m;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_release(my_flag, 1);
  }

  // 3. Look back: cin = the maxima of the rows before the band.
  for (int col = threadIdx.x; col < columns; col += blockDim.x) cin[col] = neg_inf_raw<T, VW>();
  for (int j = k - 1; j >= 0; --j) {
    __syncthreads();
    if (threadIdx.x == 0) {
      int f;
      while ((f = load_acquire(flags + chain * nbands + j)) == 0) {
      }
      s_flag = f;
    }
    __syncthreads();
    const int f = s_flag;
    const V* slot = carries + ((size_t)chain * nbands + j) * columns;
    for (int col = threadIdx.x; col < columns; col += blockDim.x)
      cin[col] = take_raw<T, VW>(load_l2(slot + col), cin[col]);
    if (f == 2) break;
  }

  // 4. The vertical maxima, in place; the inclusive maxima out.
  for (int col = threadIdx.x; col < columns; col += blockDim.x) {
    V m = cin[col];
    for (int rr = 0; rr < rows; ++rr) {
      m = take_raw<T, VW>(m, band[rr * columns + col]);
      band[rr * columns + col] = m;
    }
    if (!last) my_slot[col] = m;
  }
  if (!last) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_release(my_flag, 2);
  }

  // 5. The rows of b: each segment's maxima, then the segments before it,
  // then the segment again, adding the vertical maxima.
  V h = neg_inf_raw<T, VW>();
  if (h_on) {
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      if (hs * kSeg + i < W) h = take_raw<T, VW>(h, seg[i]);
    segs[(hr * S + hs) * NV + hv] = h;
  }
  __syncthreads();
  if (h_on) {
    h = neg_inf_raw<T, VW>();
    for (int s = 0; s < hs; ++s) h = take_raw<T, VW>(h, segs[(hr * S + s) * NV + hv]);
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int p = hs * kSeg + i;
      if (p < W) {
        const int x = kReverse ? W - 1 - p : p;
        h = take_raw<T, VW>(h, seg[i]);
        *reinterpret_cast<V*>(out + h_row + (size_t)x * C) =
            add_raw<T, VW>(band[(hr * W + x) * NV + hv], h);
      }
    }
  }
}

template <typename T>
bool vectorised(int C, const void* const* ptrs, int n) {
  if ((C * (int)sizeof(T)) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
}

// The forward's plan; threads == 0 where a row is too wide for one CTA
// (W > 4,096, or a band row and the carries over 227 KB: W > ~3,500 with
// 16-byte vectors).
template <typename T>
FwdPlan forward_plan(bool vec, int B, int C, int H, int W) {
  FwdPlan p{};
  p.vw = vec ? 16 / (int)sizeof(T) : 1;
  p.nv = kVecs;
  const int cc = p.vw * p.nv;
  const long long pixel = (long long)cc * sizeof(T);
  p.nchunks = (C + cc - 1) / cc;
  p.S = (W + kSeg - 1) / kSeg;
  // forward: the shared memory for a band of a
  const long long band_bytes = std::is_same<T, float>::value ? kBandBytesFp32 : kBandBytesBf16;
  const long long by_smem = (band_bytes / pixel) / W;
  const long long by_threads = kMaxThreads / ((long long)p.nv * p.S);
  long long R = by_smem < by_threads ? by_smem : by_threads;
  R = R < H ? R : H;
  if (R < 1) R = by_threads >= 1 ? 1 : 0;
  p.R = (int)R;
  if (p.R < 1) return p;
  p.nbands = (H + p.R - 1) / p.R;
  p.threads = (p.R * p.nv * p.S + 31) / 32 * 32;
  p.smem = ((long long)p.R * W + W + (long long)p.R * p.S) * pixel;
  if (p.smem > kMaxSmem) {
    p.threads = 0;
    return p;
  }
  const long long slots = (long long)B * p.nchunks * p.nbands;
  p.flag_bytes = ((slots + 1) * 4 + 255) / 256 * 256;
  p.carry_bytes = slots * W * pixel;
  return p;
}

template <typename T, bool kReverse, int VW, int NV>
int forward(const void* a, const void* b, void* out, void* scratch, const FwdPlan& p, int B,
            int C, int H, int W, cudaStream_t s) {
  auto kernel = corner_pool_forward_kernel<T, kReverse, VW, NV>;
  static long long allowed = 48 * 1024;   // the dynamic shared memory allowed so far
  if (p.smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
    allowed = p.smem;
  }
  int* flags = (int*)scratch;
  const cudaError_t e = cudaMemsetAsync(flags, 0, p.flag_bytes, s);
  if (e != cudaSuccess) return (int)e;
  auto* carries = (Raw<T, VW>*)((char*)scratch + p.flag_bytes);
  kernel<<<B * p.nchunks * p.nbands, p.threads, p.smem, s>>>(
      (const T*)a, (const T*)b, (T*)out, flags, carries, B, C, H, W, p.R, p.nbands,
      p.nchunks, p.S);
  return (int)cudaGetLastError();
}

template <typename T, bool kReverse>
int forward_any(const void* a, const void* b, void* out, void* scratch, int B, int C, int H,
                int W, cudaStream_t s) {
  const void* ptrs[] = {a, b, out};
  const bool vec = vectorised<T>(C, ptrs, 3);
  const FwdPlan p = forward_plan<T>(vec, B, C, H, W);
  if (p.threads == 0) return (int)cudaErrorInvalidValue;
  return vec ? forward<T, kReverse, (int)(16 / sizeof(T)), kVecs>(a, b, out, scratch, p, B, C, H, W, s)
             : forward<T, kReverse, 1, kVecs>(a, b, out, scratch, p, B, C, H, W, s);
}

// ---------------------------------------------------------- backward

template <typename T, bool kReverse, int VW>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
corner_pool_backward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ g, T* __restrict__ ga, T* __restrict__ gb,
                            int B, int C, int H, int W) {
  using V = Raw<T, VW>;
  const int CV = C / VW;
  // The longer lines take the lower thread numbers, so that they start
  // first wherever the grid does not fit on the card at once.
  long long t = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  const long long vertical_lines = (long long)B * W * CV, horizontal_lines = (long long)B * H * CV;
  bool vertical;
  if (H >= W) {
    vertical = t < vertical_lines;
    if (!vertical) t -= vertical_lines;
  } else {
    vertical = t >= horizontal_lines;
    if (vertical) t -= horizontal_lines;
  }
  if (t >= (vertical ? vertical_lines : horizontal_lines)) return;
  const int cv = (int)(t % CV);
  const long long line = t / CV;
  size_t base, step;
  int n;
  if (vertical) {               // (image, x): positions y
    base = ((size_t)(line / W) * H * W + line % W) * C + (size_t)cv * VW;
    step = (size_t)W * C;
    n = H;
  } else {                      // (image, y): positions x
    base = (size_t)line * W * C + (size_t)cv * VW;
    step = C;
    n = W;
  }
  const T* in = vertical ? a : b;
  T* g_in = vertical ? ga : gb;

  float m[VW], acc[VW];
  int arg[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) m[e] = -INFINITY, acc[e] = 0.0f, arg[e] = -1;
  for (int i0 = 0; i0 < n; i0 += kAhead) {
    V rin[kAhead], rg[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (i0 + j < n) {
        const int pos = kReverse ? n - 1 - (i0 + j) : i0 + j;
        rin[j] = *reinterpret_cast<const V*>(in + base + pos * step);
        rg[j] = *reinterpret_cast<const V*>(g + base + pos * step);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (i0 + j < n) {
        const int pos = kReverse ? n - 1 - (i0 + j) : i0 + j;
        float v[VW], gv[VW], zero[VW];
        unpack<T, VW>(rin[j], v);
        unpack<T, VW>(rg[j], gv);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (v[e] >= m[e] || v[e] != v[e]) {
            if (arg[e] >= 0) g_in[base + arg[e] * step + e] = from_float<T>(acc[e]);
            m[e] = v[e];
            arg[e] = pos;
            acc[e] = 0.0f;
          }
          acc[e] += gv[e];
          zero[e] = 0.0f;
        }
        *reinterpret_cast<V*>(g_in + base + pos * step) = pack<T, VW>(zero);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VW; ++e) g_in[base + arg[e] * step + e] = from_float<T>(acc[e]);
}

template <typename T, bool kReverse>
int backward(const void* a, const void* b, const void* g, void* ga, void* gb, int B, int C,
             int H, int W, cudaStream_t s) {
  const void* ptrs[] = {a, b, g, ga, gb};
  const bool vec = vectorised<T>(C, ptrs, 5);
  const int vw = vec ? 16 / (int)sizeof(T) : 1;
  const long long lines = (long long)B * (H + W) * (C / vw);
  const unsigned blocks = (unsigned)((lines + kBwdThreads - 1) / kBwdThreads);
  if (vec)
    corner_pool_backward_kernel<T, kReverse, (int)(16 / sizeof(T))><<<blocks, kBwdThreads, 0, s>>>(
        (const T*)a, (const T*)b, (const T*)g, (T*)ga, (T*)gb, B, C, H, W);
  else
    corner_pool_backward_kernel<T, kReverse, 1><<<blocks, kBwdThreads, 0, s>>>(
        (const T*)a, (const T*)b, (const T*)g, (T*)ga, (T*)gb, B, C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch one forward call needs (flags, ticket and band slots),
// or -1 where a row is too wide for one CTA.
long long corner_pool_forward_scratch_bytes(int dtype, int B, int C, int H, int W) {
  if (B < 1 || C < 1 || H < 1 || W < 1) return 0;
  // The launch takes either layout (by C and the pointers' alignment).
  const FwdPlan v = dtype == 0 ? forward_plan<float>(true, B, C, H, W)
                               : forward_plan<__nv_bfloat16>(true, B, C, H, W);
  const FwdPlan e = dtype == 0 ? forward_plan<float>(false, B, C, H, W)
                               : forward_plan<__nv_bfloat16>(false, B, C, H, W);
  if (v.threads == 0 || e.threads == 0) return -1;
  const long long bv = v.flag_bytes + v.carry_bytes, be = e.flag_bytes + e.carry_bytes;
  return bv > be ? bv : be;
}

// a, b, out: (B, C, H, W) channels last (NHWC contiguous); dtype 0 float32,
// 1 bfloat16; corner 0 tl, 1 br; scratch: corner_pool_forward_scratch_bytes.
int corner_pool_forward_launch(int dtype, const void* a, const void* b, void* out,
                               void* scratch, int B, int C, int H, int W, int corner,
                               void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return corner == 0 ? forward_any<float, true>(a, b, out, scratch, B, C, H, W, s)
                       : forward_any<float, false>(a, b, out, scratch, B, C, H, W, s);
  return corner == 0 ? forward_any<__nv_bfloat16, true>(a, b, out, scratch, B, C, H, W, s)
                     : forward_any<__nv_bfloat16, false>(a, b, out, scratch, B, C, H, W, s);
}

// g: the output's gradient; ga, gb: the gradients of a and b, all (B, C, H,
// W) channels last in the inputs' dtype.
int corner_pool_backward_launch(int dtype, const void* a, const void* b, const void* g,
                                void* ga, void* gb, int B, int C, int H, int W, int corner,
                                void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return corner == 0 ? backward<float, true>(a, b, g, ga, gb, B, C, H, W, s)
                       : backward<float, false>(a, b, g, ga, gb, B, C, H, W, s);
  return corner == 0 ? backward<__nv_bfloat16, true>(a, b, g, ga, gb, B, C, H, W, s)
                     : backward<__nv_bfloat16, false>(a, b, g, ga, gb, B, C, H, W, s);
}

}  // extern "C"
