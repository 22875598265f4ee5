// Copy-bandwidth probe: y = x * 0.5 over a bf16 (B, H, W, C) tensor, one
// block per (image, TH rows), with two store patterns.
//
// Replaces: tools/pallas_bw_probe.py `run.one` (the Pallas kernel at :37-45:
// a (1, TH, W, C) BlockSpec copy with one full-width store, `blocked`, or
// stores in 128-lane slices as the fused kernel's conv3 chunk loop does,
// `chunked`). On Hopper there is no auto-pipelined block: each thread moves
// 16-byte vectors, four loads in flight before their stores.
//   blocked  consecutive threads take consecutive 16-byte vectors along the
//            tile's full rows (W * C contiguous elements);
//   chunked  the tile is walked in 128-channel slices: slice c0 of every
//            pixel, then the next slice (256 contiguous bytes every C * 2).
//
// What bounds it on an H100: device-memory bandwidth, one read and one
// write of every byte (3.35 TB/s published peak for the SXM part). x * 0.5
// is exact in bf16, so both modes equal the plain `x * 0.5` bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint4 half8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(__low2float(h[i]) * 0.5f,
                                 __high2float(h[i]) * 0.5f);
  return v;
}

// Vector e of the tile (in the mode's walk order) -> its index in the
// tile's own vectors. cv vectors per pixel; a slice holds sw of them.
template <bool kChunked>
__device__ __forceinline__ long long vec_index(long long e, int cv, int c0,
                                               int sw) {
  if (!kChunked) return e;
  return (e / sw) * cv + c0 + e % sw;
}

// grid (nH, B): block (i, b) copies rows [i * TH, min((i + 1) * TH, H)).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
bw_probe_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int H,
                int W, int C, int TH) {
  const int i = blockIdx.x, b = blockIdx.y;
  const int rows = min(TH, H - i * TH);
  const int cv = C / 8;
  const long long base = ((long long)b * H + (long long)i * TH) * W * cv;
  const int slice = kChunked ? 16 : cv;   // 128 channels = 16 vectors
  for (int c0 = 0; c0 < cv; c0 += slice) {
    const int sw = min(slice, cv - c0);
    const long long n = (long long)rows * W * sw;
    for (long long e0 = threadIdx.x; e0 < n; e0 += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = e0 + (long long)u * kThreads;
        if (e < n) v[u] = x[base + vec_index<kChunked>(e, cv, c0, sw)];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = e0 + (long long)u * kThreads;
        if (e < n) y[base + vec_index<kChunked>(e, cv, c0, sw)] = half8(v[u]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x, y (B, H, W, C) bf16, contiguous and 16-byte aligned, C % 8 == 0;
// mode 0 blocked, 1 chunked; 1 <= TH. Returns cudaGetLastError() after the
// launch.
int bw_probe_launch(int mode, const void* x, void* y, int batch, int H,
                    int W, int C, int TH, void* stream) {
  if (C % 8 != 0 || TH < 1 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)y % 16 != 0 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + TH - 1) / TH, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    bw_probe_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, H, W, C, TH);
  else
    bw_probe_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, H, W, C, TH);
  return (int)cudaGetLastError();
}

}  // extern "C"
