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
// right = max over x' <= x.
//
// One kernel, `scan_max_kernel`, with the axis and direction as template
// parameters: one thread a line (an (image, column) for a vertical scan,
// an (image, row) for a horizontal one) and a channel, walking the line in
// scan order and keeping the running max. Threads of a warp take
// consecutive channels, so every step of a warp is one coalesced read of
// 32 neighbouring elements. A forward call is two launches on one stream:
// the vertical scan of `a` writes its max to `out`, then the horizontal
// scan of `b` adds its max to what `out` holds, in fp32, rounded once.
// Maxima of bf16 values are bf16 values, so the vertical result is stored
// exactly, and the sum rounds as PyTorch's bf16 add does: the output is the
// plain version's bit for bit.
//
// The running max takes a value v when v >= max or v is NaN, torch.cummax's
// rule: a tie goes to the element found later in scan order, which is the
// element the backward credits.
//
// Backward (`scan_max_backward_kernel`), no index tensor: the same walk
// keeps the running argmax and, in fp32, the gradient received since it
// last changed. When the argmax moves, the sum is written to the old
// argmax; every other position a line passes gets 0; the last argmax gets
// the last sum. Each input position is written exactly once. A backward
// call is two launches: the vertical scan (a, g) -> g_a and the horizontal
// scan (b, g) -> g_b.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The line of thread `t`: the offset of its first element (position 0 of
// the line) and the step between positions, in elements; n positions.
struct Line {
  long long base, step;
  int n;
};

template <bool kVertical>
__device__ __forceinline__ bool line_of(long long t, int B, int C, int H, int W, Line& l) {
  const long long lines = kVertical ? (long long)B * W : (long long)B * H;
  if (t >= lines * C) return false;
  const int c = (int)(t % C);
  const long long line = t / C;
  if (kVertical) {            // (b, x): positions y
    const long long b = line / W, x = line % W;
    l.base = (b * H * W + x) * C + c;
    l.step = (long long)W * C;
    l.n = H;
  } else {                    // (b, y): positions x
    l.base = line * W * C + c;
    l.step = C;
    l.n = W;
  }
  return true;
}

// out[p] = max over the line's positions at or before p in scan order of
// in[.]; with kAccumulate, out[p] = round(out[p] + that max) instead.
template <typename T, bool kVertical, bool kReverse, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
scan_max_kernel(const T* __restrict__ in, T* __restrict__ out, int B, int C, int H, int W) {
  Line l;
  if (!line_of<kVertical>((long long)blockIdx.x * kThreads + threadIdx.x, B, C, H, W, l))
    return;
  float m = 0.0f;
#pragma unroll 4
  for (int i = 0; i < l.n; ++i) {
    const long long off = l.base + (long long)(kReverse ? l.n - 1 - i : i) * l.step;
    const float v = to_float(in[off]);
    if (i == 0 || v >= m || isnan(v)) m = v;
    out[off] = kAccumulate ? from_float<T>(to_float(out[off]) + m) : from_float<T>(m);
  }
}

// g_in: the gradient of the scan's input, from the output gradient g.
template <typename T, bool kVertical, bool kReverse>
__global__ void __launch_bounds__(kThreads)
scan_max_backward_kernel(const T* __restrict__ in, const T* __restrict__ g,
                         T* __restrict__ g_in, int B, int C, int H, int W) {
  Line l;
  if (!line_of<kVertical>((long long)blockIdx.x * kThreads + threadIdx.x, B, C, H, W, l))
    return;
  float m = 0.0f, acc = 0.0f;
  long long arg = l.base;
#pragma unroll 4
  for (int i = 0; i < l.n; ++i) {
    const long long off = l.base + (long long)(kReverse ? l.n - 1 - i : i) * l.step;
    const float v = to_float(in[off]);
    if (i == 0 || v >= m || isnan(v)) {
      if (i > 0) g_in[arg] = from_float<T>(acc);
      m = v;
      arg = off;
      acc = 0.0f;
    } else {
      g_in[off] = from_float<T>(0.0f);
    }
    acc += to_float(g[off]);
  }
  g_in[arg] = from_float<T>(acc);
}

inline unsigned blocks_for(long long lines, int C) {
  return (unsigned)((lines * C + kThreads - 1) / kThreads);
}

// corner 0: tl (top, left: reverse scans); 1: br (bottom, right: forward).
template <typename T, bool kReverse>
void forward(const void* a, const void* b, void* out, int B, int C, int H, int W,
             cudaStream_t s) {
  scan_max_kernel<T, true, kReverse, false><<<blocks_for((long long)B * W, C), kThreads, 0, s>>>(
      (const T*)a, (T*)out, B, C, H, W);
  scan_max_kernel<T, false, kReverse, true><<<blocks_for((long long)B * H, C), kThreads, 0, s>>>(
      (const T*)b, (T*)out, B, C, H, W);
}

template <typename T, bool kReverse>
void backward(const void* a, const void* b, const void* g, void* ga, void* gb, int B, int C,
              int H, int W, cudaStream_t s) {
  scan_max_backward_kernel<T, true, kReverse>
      <<<blocks_for((long long)B * W, C), kThreads, 0, s>>>(
          (const T*)a, (const T*)g, (T*)ga, B, C, H, W);
  scan_max_backward_kernel<T, false, kReverse>
      <<<blocks_for((long long)B * H, C), kThreads, 0, s>>>(
          (const T*)b, (const T*)g, (T*)gb, B, C, H, W);
}

}  // namespace

extern "C" {

// a, b, out: (B, C, H, W) channels last (NHWC contiguous); dtype 0 float32,
// 1 bfloat16; corner 0 tl, 1 br.
int corner_pool_forward_launch(int dtype, const void* a, const void* b, void* out, int B,
                               int C, int H, int W, int corner, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    corner == 0 ? forward<float, true>(a, b, out, B, C, H, W, s)
                : forward<float, false>(a, b, out, B, C, H, W, s);
  else
    corner == 0 ? forward<__nv_bfloat16, true>(a, b, out, B, C, H, W, s)
                : forward<__nv_bfloat16, false>(a, b, out, B, C, H, W, s);
  return (int)cudaGetLastError();
}

// g: the output's gradient; ga, gb: the gradients of a and b, all (B, C, H,
// W) channels last in the inputs' dtype.
int corner_pool_backward_launch(int dtype, const void* a, const void* b, const void* g,
                                void* ga, void* gb, int B, int C, int H, int W, int corner,
                                void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    corner == 0 ? backward<float, true>(a, b, g, ga, gb, B, C, H, W, s)
                : backward<float, false>(a, b, g, ga, gb, B, C, H, W, s);
  else
    corner == 0 ? backward<__nv_bfloat16, true>(a, b, g, ga, gb, B, C, H, W, s)
                : backward<__nv_bfloat16, false>(a, b, g, ga, gb, B, C, H, W, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
