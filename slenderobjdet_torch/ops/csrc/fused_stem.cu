// Fused ResNet stem: 7x7/2 conv (pad 3) over 3 channels with the FrozenBN
// scale folded into the weights, + bias, relu, then 3x3/2 max-pool (pad 1).
//
// Replaces: slenderobjdet_tpu/ops/fused_stem.py `_fused_forward` (the Pallas
// kernel built by `_make_kernel`). Semantics are `reference_stem`'s: fp32
// accumulation of products of dtype values, bias added in fp32, relu, cast
// to dtype, then the pool.
//
// What bounds it on an H100: at B = 8, 800x1344 the conv is 20 GMAC
// (147 MAC for each of 138 M conv outputs), the input is 52 MB in bf16 and
// the pooled output 69 MB, so it is compute bound; with a contraction depth
// of only 147 it maps poorly onto tensor-core tiles, and this first version
// uses fp32 FMA on the CUDA cores. The unfused path also writes and rereads
// the 275 MB conv output just to pool it.
//
// Design: one block per (image, TP x TQ tile of pooled outputs). The block
// stages the (4TP+7) x (4TQ+7) x 3 input window and all folded weights in
// shared memory, computes the (2TP+1) x (2TQ+1) conv outputs the tile's pool
// windows cover (thread = one output channel of one conv row, holding the
// row's 2TQ+1 sums in registers and each input row in registers across the
// 7 horizontal taps), rounds them to dtype into shared memory, and pools
// there. Only the pooled map is written. Conv positions outside the image
// hold 0, which equals the pool's -inf padding because every pool window
// holds at least one real relu output >= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 4;            // pooled rows per block
constexpr int TQ = 8;            // pooled cols per block
constexpr int CR = 2 * TP + 1;   // conv rows per block
constexpr int CC = 2 * TQ + 1;   // conv cols per block
constexpr int IR = 4 * TP + 7;   // input rows per block
constexpr int IC = 4 * TQ + 7;   // input cols per block
constexpr int CG = 64;           // output channels per pass
constexpr int kThreads = CG * CR;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ out, int H, int W,
            int Cs) {
  extern __shared__ float smem[];
  float* s_in = smem;                  // [3][IR][IC]
  float* s_w = s_in + 3 * IR * IC;     // [7][7][3][Cs]
  float* s_conv = s_w + 147 * Cs;      // [CR][CC][CG]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TP;
  const int q0 = blockIdx.x * TQ;
  const int Hc = H / 2, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int row0 = 4 * p0 - 5;
  const int col0 = 4 * q0 - 5;

  const T* xb = x + (size_t)b * H * W * 3;
  for (int e = tid; e < IR * IC * 3; e += kThreads) {
    const int c = e % 3;
    const int rc = e / 3;
    const int cc = rc % IC;
    const int r = rc / IC;
    const int gy = row0 + r, gx = col0 + cc;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f(xb[((size_t)gy * W + gx) * 3 + c]);
    s_in[(c * IR + r) * IC + cc] = v;
  }
  for (int e = tid; e < 147 * Cs; e += kThreads) s_w[e] = w[e];
  __syncthreads();

  const int cl = tid % CG;     // channel within the pass
  const int r = tid / CG;      // conv row within the tile
  const int gr = 2 * p0 - 1 + r;
  const bool row_ok = gr >= 0 && gr < Hc;

  for (int c0 = 0; c0 < Cs; c0 += CG) {
    const int c = c0 + cl;
    float acc[CC];
#pragma unroll
    for (int j = 0; j < CC; ++j) acc[j] = 0.f;
    if (c < Cs) {
      for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          const float* row = s_in + (ci * IR + 2 * r + ky) * IC;
          float in[IC];
#pragma unroll
          for (int u = 0; u < IC; ++u) in[u] = row[u];
#pragma unroll
          for (int kx = 0; kx < 7; ++kx) {
            const float wv = s_w[((ky * 7 + kx) * 3 + ci) * Cs + c];
#pragma unroll
            for (int j = 0; j < CC; ++j)
              acc[j] = fmaf(in[2 * j + kx], wv, acc[j]);
          }
        }
      }
    }
    const float bc = c < Cs ? bias[c] : 0.f;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const int gc = 2 * q0 - 1 + j;
      float v = 0.f;
      if (c < Cs && row_ok && gc >= 0 && gc < Wc)
        v = to_f(from_f<T>(fmaxf(acc[j] + bc, 0.f)));
      s_conv[(r * CC + j) * CG + cl] = v;
    }
    __syncthreads();

    for (int e = tid; e < TP * TQ * CG; e += kThreads) {
      const int l = e % CG;
      const int pq = e / CG;
      const int q = pq % TQ;
      const int p = pq / TQ;
      const int cc = c0 + l;
      const int gp = p0 + p, gq = q0 + q;
      if (cc >= Cs || gp >= Hp || gq >= Wp) continue;
      float m = s_conv[((2 * p) * CC + 2 * q) * CG + l];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          m = fmaxf(m, s_conv[((2 * p + dy) * CC + 2 * q + dx) * CG + l]);
      out[(((size_t)b * Hp + gp) * Wp + gq) * Cs + cc] = from_f<T>(m);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out,
           int batch, int H, int W, int Cs, cudaStream_t stream) {
  const int smem =
      (3 * IR * IC + 147 * Cs + CR * CC * CG) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int Hp = H / 4, Wp = W / 4;
  dim3 grid((Wp + TQ - 1) / TQ, (Hp + TP - 1) / TP, batch);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (T*)out, H, W, Cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_stem_smem_bytes(int Cs) {
  return (3 * IR * IC + 147 * Cs + CR * CC * CG) * (int)sizeof(float);
}

// x (B, H, W, 3) in dtype (0 = float32, 1 = bfloat16), H and W divisible by
// 4; w (7, 7, 3, Cs) float32 holding the folded weights already rounded to
// dtype; bias (Cs,) float32; out (B, H/4, W/4, Cs) in dtype.
int fused_stem_launch(int dtype, const void* x, const void* w,
                      const void* bias, void* out, int batch, int H, int W,
                      int Cs, void* stream) {
  if (dtype == 0)
    return launch<float>(x, w, bias, out, batch, H, W, Cs,
                         (cudaStream_t)stream);
  return launch<__nv_bfloat16>(x, w, bias, out, batch, H, W, Cs,
                               (cudaStream_t)stream);
}

}  // extern "C"
