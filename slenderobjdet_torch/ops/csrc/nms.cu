// Fixed-shape greedy NMS, one thread block per image.
//
// Replaces: slenderobjdet_tpu/ops/pallas_nms.py `_nms_kernel` (the Pallas
// kernel behind `pallas_nms` / `pallas_batched_nms`) and the `nms_select`
// scan of slenderobjdet_tpu/ops/nms.py, whose results it reproduces bit for
// bit: the same keep_idx and keep_valid.
//
// What bounds it on an H100: neither bytes nor FLOPs. The candidates of one
// image (N = 5000 on the FCOS predict path: 80 KB of boxes) are read once;
// the work is max_out = 100 dependent steps, each a block-wide argmax and a
// suppression sweep over N, so the kernel is latency bound (barriers and
// shuffles), and only B blocks run.
//
// Design: the candidates' x1, y1, x2, y2, area and live score sit in dynamic
// shared memory for the whole selection (6 * 4 B * N = 120 KB at N = 5000),
// so no step touches device memory. Each step is a warp-shuffle argmax whose
// ties go to the lowest index (jnp.argmax's rule), then one sweep that
// computes the IoU with the selected box in the reference's operation order
// with explicitly rounded intrinsics (no FMA contraction can change a
// decision at the threshold). Once a step finds no live box, every later
// step would find none either, so the remaining slots are written invalid
// at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e10f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ live_in,
           int n, float thr, int max_out, int32_t* __restrict__ keep_idx,
           uint8_t* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* live = area + n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int sel_i;
  __shared__ float sel_v;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* bb = reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  for (int j = tid; j < n; j += kThreads) {
    const float4 q = bb[j];
    x1[j] = q.x;
    y1[j] = q.y;
    x2[j] = q.z;
    y2[j] = q.w;
    // areas = clip(x2 - x1, 0) * clip(y2 - y1, 0)
    area[j] = __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.f),
                        fmaxf(__fsub_rn(q.w, q.y), 0.f));
    live[j] = live_in[(size_t)b * n + j];
  }
  __syncthreads();

  int32_t* out_idx = keep_idx + (size_t)b * max_out;
  uint8_t* out_valid = keep_valid + (size_t)b * max_out;
  for (int t = 0; t < max_out; ++t) {
    float bv = -INFINITY;
    int bi = n;
    for (int j = tid; j < n; j += kThreads) {
      const float v = live[j];
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        sel_i = bi;
        sel_v = bv;
      }
    }
    __syncthreads();
    const int i = sel_i;
    const bool ok = sel_v > kNegInf / 2;
    if (!ok) {
      // Nothing live is left: this and every later slot is invalid.
      for (int s = t + tid; s < max_out; s += kThreads) {
        out_idx[s] = 0;
        out_valid[s] = 0;
      }
      return;
    }
    if (tid == 0) {
      out_idx[t] = i;
      out_valid[t] = 1;
    }
    const float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i];
    const float barea = area[i];
    for (int j = tid; j < n; j += kThreads) {
      const float iw =
          fmaxf(__fsub_rn(fminf(x2[j], bx2), fmaxf(x1[j], bx1)), 0.f);
      const float ih =
          fmaxf(__fsub_rn(fminf(y2[j], by2), fmaxf(y1[j], by1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      // iou = inter / max((areas + barea) - inter, 1e-12)
      const float uni =
          fmaxf(__fsub_rn(__fadd_rn(area[j], barea), inter), 1e-12f);
      const float iou = __fdiv_rn(inter, uni);
      if (iou > thr || j == i) live[j] = kNegInf;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int nms_smem_bytes(int n) { return 6 * n * (int)sizeof(float); }

// boxes (B, N, 4) float32 XYXY, live (B, N) float32 (scores with invalid
// entries already set to -1e10); keep_idx (B, max_out) int32, keep_valid
// (B, max_out) uint8. Returns cudaGetLastError() after the launch.
int nms_launch(const void* boxes, const void* live, int batch, int n,
               float thr, int max_out, void* keep_idx, void* keep_valid,
               void* stream) {
  const int smem = nms_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)live, n, thr, max_out,
      (int32_t*)keep_idx, (uint8_t*)keep_valid);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
