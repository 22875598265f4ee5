// Fused ResNet stem: 7x7/2 conv (pad 3) over 3 channels with the FrozenBN
// scale folded into the weights, + bias, relu, then 3x3/2 max-pool (pad 1).
//
// Replaces: slenderobjdet_tpu/ops/fused_stem.py `_fused_forward` (the Pallas
// kernel built by `_make_kernel`). Semantics are `reference_stem`'s: fp32
// accumulation of products of dtype values, bias added in fp32, relu, cast
// to dtype, then the pool. Only the pooled map is written. Conv positions
// outside the image hold 0, which equals the pool's -inf padding because
// every pool window holds at least one real relu output >= 0.
//
// What bounds it on an H100: at B = 8, 800x1344 the conv is 20 GMAC
// (147 MAC for each of 138 M conv outputs: 0.041 ms at the bf16 tensor
// cores' 989 TFLOP/s), the input is 52 MB in bf16 and the pooled output
// 69 MB (0.036 ms at 3.35 TB/s), so operations bound it, narrowly. The
// unfused path also writes and rereads the 275 MB conv output to pool it.
//
// Two kernels; `stem_plan` in ops/fused_stem.py says which one a call takes.
//
// `stem_mma_kernel`: bf16 with 64 output channels (every ResNet's stem), on
// the tensor cores. The conv is an implicit GEMM, M = the (2TP+1) x (2TQ+1)
// conv outputs under a TP x TQ tile of pooled pixels, N = 64, and K = 7 ky
// x 24 slots = 168, padded to 176 = 11 `mma.sync.m16n8k16` steps. In NHWC
// with 3 channels the 21 (kx, ci) values of one patch row are contiguous in
// the input row and start 6 elements after the neighbouring conv column's,
// so no im2col buffer exists: the raw bf16 window is staged in shared
// memory and the A fragments are 4-byte loads from it. A staged row starts
// one element before the window, so that it starts on an 8-byte boundary of
// the image row (the window itself starts 2 bytes past one) and every
// (k, k + 1) pair is 4-byte aligned; slot 0 of a ky group is that lead
// element and slots 22, 23 the next pixel's: all three meet zero weights
// (`pack_stem_weights`). What the design does about the data movement:
// - a persistent grid, one CTA an SM walking over tiles; the packed weights
//   (22 KB, in B-fragment order) arrive once per CTA by one bulk copy;
// - the window is staged by 8-byte `cp.async` into a ring of two, zero
//   filled outside the image, the next tile's while this tile computes;
// - 12 warps take 3 m16 tiles each of the flattened 561 conv outputs (36
//   tiles, 2.6% padding; the halo recompute is 561 / 512 = 1.096), so each
//   B fragment read from shared memory feeds 3 MMAs;
// - the accumulators start from the bias; relu + round to bf16 go from
//   them to a shared conv tile (pitch 72: conflict-free), the pool reads it
//   as 16-byte vectors and writes the pooled rows with 16-byte stores, 128
//   B a pixel.
//
// `stem_cuda_core_kernel`: fp32 FMA on the CUDA cores, for float32 and for
// other widths. One block per (image, 4 x 8 pooled tile) stages the window
// as fp32 and all folded weights, computes the conv outputs (thread = one
// output channel of one conv row, the row's sums in registers), rounds them
// to dtype into shared memory, and pools there.

#include "hopper.cuh"

namespace {

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

// ------------------------------------------------- tensor cores (bf16, 64)
namespace tc {

constexpr int TP = 8;                  // pooled rows per tile
constexpr int TQ = 16;                 // pooled cols per tile
constexpr int CR = 2 * TP + 1;         // conv rows per tile
constexpr int CC = 2 * TQ + 1;         // conv cols per tile
constexpr int M = CR * CC;             // GEMM rows per tile (561)
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTW = 3;                // m16 tiles per warp
static_assert(kWarps * kMTW * 16 >= M, "the warps cover the tile");
constexpr int CS = 64;                 // output channels
constexpr int NT = CS / 8;             // n8 tiles
constexpr int KSLOTS = 24;             // K slots per ky: 1 lead + 21 + 2
constexpr int KREAL = 7 * KSLOTS;      // 168
constexpr int KSTEPS = 11;             // k16 steps (K padded to 176)
constexpr int IR = 4 * TP + 7;         // staged input rows
constexpr int PITCH = 12 * TQ + 24;    // staged row, elements: 6 (CC-1) + 24
constexpr int ROWCH = PITCH / 4;       // 8-byte chunks per staged row
constexpr int CPITCH = CS + 8;         // conv tile row, elements
constexpr int kWBytes = KSTEPS * (NT / 2) * 32 * 16;   // packed weights
constexpr int kBiasOff = 128;          // after the weights' mbarrier
constexpr int kWOff = kBiasOff + CS * 4;
constexpr int kInOff = kWOff + kWBytes;
constexpr int kInBytes = IR * PITCH * 2;
constexpr int kConvOff = kInOff + 2 * kInBytes;
constexpr int kSmemBytes = kConvOff + M * CPITCH * 2;
static_assert(kWOff % 16 == 0 && kInOff % 16 == 0 && kInBytes % 16 == 0 &&
                  kConvOff % 16 == 0,
              "bulk copy and 16-byte vectors need 16-byte offsets");

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row major) @ b (16 x 8 bf16, column
// major). Lane = 4 g + t: a0 a1 a2 a3 = rows g, g + 8, g, g + 8 at k = 2t
// (a0 a1) and 2t + 8 (a2 a3); b0 b1 = column g at k = 2t and 2t + 8; d0 d1 =
// row g, columns 2t and 2t + 1, d2 d3 the same of row g + 8.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __hmax2(x[i], y[i]);
  return a;
}

// Persistent grid: CTA c takes tiles c, c + gridDim.x, ... of the B x
// ceil(Hp / TP) x ceil(Wp / TQ) list (columns fastest).
__global__ void __launch_bounds__(kThreads, 1)
stem_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const unsigned char* __restrict__ wpack,
                const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int batch, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem);
  float* s_bias = reinterpret_cast<float*>(smem + kBiasOff);
  const uint4* s_w = reinterpret_cast<const uint4*>(smem + kWOff);
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + kInOff);
  __nv_bfloat16* s_conv = reinterpret_cast<__nv_bfloat16*>(smem + kConvOff);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Hc = H / 2, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int ntq = (Wp + TQ - 1) / TQ, ntp = (Hp + TP - 1) / TP;
  const int tiles = batch * ntp * ntq;

  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  if (tid < CS) s_bias[tid] = bias[tid];
  __syncthreads();
  if (tid == 0 && (int)blockIdx.x < tiles) {   // waited for before tile 0
    mbar_expect_tx(wbar, kWBytes);
    bulk_copy(smem + kWOff, wpack, kWBytes, wbar);
  }

  // Stage a tile's input window: rows 4 p0 - 5 .. + IR, and of each row
  // the PITCH elements from 3 (4 q0 - 5) - 1 on. W % 4 == 0 makes every
  // 8-byte chunk lie wholly inside the image row or wholly outside it.
  auto stage = [&](int tile, int slot) {
    const int tq = tile % ntq, tp = (tile / ntq) % ntp, b = tile / (ntq * ntp);
    const int row0 = 4 * tp * TP - 5, e0 = 12 * tq * TQ - 16;
    const __nv_bfloat16* xb = x + (size_t)b * H * W * 3;
    __nv_bfloat16* dst = s_in + slot * (IR * PITCH);
    for (int c = tid; c < IR * ROWCH; c += kThreads) {
      const int r = c / ROWCH, cc = c - r * ROWCH;
      const int gy = row0 + r, e = e0 + 4 * cc;
      const bool in = gy >= 0 && gy < H && e >= 0 && e < 3 * W;
      cp_async8(dst + r * PITCH + 4 * cc,
                in ? xb + ((size_t)gy * W * 3 + e) : x, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, 0);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int slot = it & 1;
    if (tile + (int)gridDim.x < tiles) {
      stage(tile + gridDim.x, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (it == 0) mbar_wait(wbar, 0);
    __syncthreads();   // the window has landed; the last tile's pool is done

    const int q0 = (tile % ntq) * TQ, p0 = ((tile / ntq) % ntp) * TP;
    const int b = tile / (ntq * ntp);
    const __nv_bfloat16* win = s_in + slot * (IR * PITCH);

    // GEMM rows of this lane: m = 16 (3 warp + u) + g (+ 8), conv position
    // (m / CC, m % CC); rows past M compute row 0 again and are dropped.
    int aoff[kMTW][2], mrow[kMTW][2];
#pragma unroll
    for (int u = 0; u < kMTW; ++u)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = (warp * kMTW + u) * 16 + g + 8 * hr;
        const int mm = m < M ? m : 0;
        const int i = mm / CC, j = mm - i * CC;
        mrow[u][hr] = m;
        aoff[u][hr] = 2 * i * PITCH + 6 * j + 2 * t4;
      }
    // the sums start from the bias (fp32), so the epilogue only clamps
    float acc[kMTW][NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bv = *reinterpret_cast<const float2*>(s_bias + 8 * n + 2 * t4);
#pragma unroll
      for (int u = 0; u < kMTW; ++u) {
        acc[u][n][0] = acc[u][n][2] = bv.x;
        acc[u][n][1] = acc[u][n][3] = bv.y;
      }
    }

#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const uint4 v = s_w[(ks * (NT / 2) + q) * 32 + lane];
        bf[2 * q][0] = v.x;
        bf[2 * q][1] = v.y;
        bf[2 * q + 1][0] = v.z;
        bf[2 * q + 1][1] = v.w;
      }
#pragma unroll
      for (int u = 0; u < kMTW; ++u) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // k = 16 ks + 8 h + 2 t (+ 1): a multiple of 8 plus at most 7
          // never crosses a ky group of 24
          const int kb = 16 * ks + 8 * h;
          if (kb >= KREAL) {
            a[2 * h] = a[2 * h + 1] = 0u;   // K padding: zero weights too
          } else {
            const int o = (kb / KSLOTS) * PITCH + kb % KSLOTS;
            a[2 * h] = *reinterpret_cast<const uint32_t*>(win + aoff[u][0] + o);
            a[2 * h + 1] =
                *reinterpret_cast<const uint32_t*>(win + aoff[u][1] + o);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_m16n8k16(acc[u][n], a, bf[n][0], bf[n][1]);
      }
    }

    // relu + round, 0 outside the image, into the conv tile
#pragma unroll
    for (int u = 0; u < kMTW; ++u)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = mrow[u][hr];
        if (m >= M) continue;
        const int i = m / CC, j = m - i * CC;
        const int gr = 2 * p0 - 1 + i, gc = 2 * q0 - 1 + j;
        const bool in = gr >= 0 && gr < Hc && gc >= 0 && gc < Wc;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = 8 * n + 2 * t4;
          const float v0 = in ? fmaxf(acc[u][n][2 * hr], 0.f) : 0.f;
          const float v1 = in ? fmaxf(acc[u][n][2 * hr + 1], 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(s_conv + m * CPITCH + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    __syncthreads();   // the conv tile is whole; this window is free

    // pool: thread = 8 channels of one pooled pixel
    for (int e = tid; e < TP * TQ * (CS / 8); e += kThreads) {
      const int cg = e % (CS / 8), q = (e / (CS / 8)) % TQ,
                p = e / (CS / 8 * TQ);
      const int gp = p0 + p, gq = q0 + q;
      if (gp >= Hp || gq >= Wp) continue;
      const __nv_bfloat16* c = s_conv + (2 * p * CC + 2 * q) * CPITCH + 8 * cg;
      uint4 mx = *reinterpret_cast<const uint4*>(c);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy + dx > 0)
            mx = max8(mx, *reinterpret_cast<const uint4*>(
                              c + (dy * CC + dx) * CPITCH));
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * Hp + gp) * Wp + gq) * CS + 8 * cg) = mx;
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------- CUDA cores
namespace cc {

constexpr int TP = 4;            // pooled rows per block
constexpr int TQ = 8;            // pooled cols per block
constexpr int CR = 2 * TP + 1;   // conv rows per block
constexpr int CC = 2 * TQ + 1;   // conv cols per block
constexpr int IR = 4 * TP + 7;   // input rows per block
constexpr int IC = 4 * TQ + 7;   // input cols per block
constexpr int CG = 64;           // output channels per pass
constexpr int kThreads = CG * CR;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_cuda_core_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int H, int W, int Cs) {
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

constexpr int smem_bytes(int Cs) {
  return (3 * IR * IC + 147 * Cs + CR * CC * CG) * (int)sizeof(float);
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out,
           int batch, int H, int W, int Cs, cudaStream_t stream) {
  const int smem = smem_bytes(Cs);
  cudaError_t err = cudaFuncSetAttribute(
      stem_cuda_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int Hp = H / 4, Wp = W / 4;
  dim3 grid((Wp + TQ - 1) / TQ, (Hp + TP - 1) / TP, batch);
  stem_cuda_core_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (T*)out, H, W, Cs);
  return (int)cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" {

int fused_stem_cuda_core_smem_bytes(int Cs) { return cc::smem_bytes(Cs); }

// The CUDA-core kernel. x (B, H, W, 3) in dtype (0 = float32, 1 =
// bfloat16), H and W divisible by 4; w (7, 7, 3, Cs) float32 holding the
// folded weights already rounded to dtype; bias (Cs,) float32; out
// (B, H/4, W/4, Cs) in dtype.
int fused_stem_cuda_core_launch(int dtype, const void* x, const void* w,
                                const void* bias, void* out, int batch, int H,
                                int W, int Cs, void* stream) {
  if (dtype == 0)
    return cc::launch<float>(x, w, bias, out, batch, H, W, Cs,
                             (cudaStream_t)stream);
  return cc::launch<__nv_bfloat16>(x, w, bias, out, batch, H, W, Cs,
                                   (cudaStream_t)stream);
}

// The tensor-core kernel: bf16, 64 output channels. x (B, H, W, 3) bf16, 8-
// byte aligned, H and W divisible by 4; wpack the 22,528 bytes of
// `pack_stem_weights`, 16-byte aligned; bias (64,) float32; out
// (B, H/4, W/4, 64) bf16, 16-byte aligned; grid CTAs walk the tiles.
int fused_stem_mma_launch(const void* x, const void* wpack, const void* bias,
                          void* out, int batch, int H, int W, int grid,
                          void* stream) {
  if (H % 4 != 0 || W % 4 != 0 || grid < 1 || (uintptr_t)x % 8 != 0 ||
      (uintptr_t)wpack % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tc::stem_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  tc::stem_mma_kernel<<<grid, tc::kThreads, tc::kSmemBytes,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const unsigned char*)wpack, (const float*)bias,
      (__nv_bfloat16*)out, batch, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
