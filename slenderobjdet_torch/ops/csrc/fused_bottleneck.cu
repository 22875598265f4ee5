// Fused ResNet bottleneck block: relu(1x1) -> relu(3x3, pad 1) -> 1x1
// + shortcut (identity or 1x1 projection) -> relu, FrozenBN pre-folded into
// each conv's (weight, bias).
//
// Replaces: slenderobjdet_tpu/ops/fused_bottleneck.py `_fused_forward` (the
// Pallas kernel built by `_make_kernel`). Semantics are
// `reference_bottleneck`'s: each conv accumulates products of dtype values
// in fp32, adds its fp32 bias and applies relu, then rounds to dtype; an
// identity shortcut is added in fp32.
//
// What bounds it on an H100: each of R-50's stride-1 blocks at 800x1344 is
// about 4.7 GMAC per image (1x1 + 3x3 + 1x1 over the stage's pixels), against
// an input plus output of 2 x 34 MB per image at res2 in bf16 and far less
// deeper down, so it is compute bound. The unfused path writes and rereads
// both intermediate activations and the pre-shortcut sum in device memory;
// that is the traffic the fusion removes.
//
// Design: one block of 256 threads per (image, TH x TW tile of output
// pixels). Every conv is a GEMM over the tile's pixels (M), output channels
// (N) and input channels (K), run as 64 x 64 output chunks with K streamed
// through shared memory 32 channels at a time.
//   1. a1 = relu(x @ w1 + b1) over the tile plus a 1-pixel halo, streaming
//      x over Cin; halo pixels outside the image are stored as 0 (the 3x3
//      conv's zero padding), not relu(b1). a1 stays in shared memory in
//      dtype, which is exact since the semantics round it to dtype.
//   2. a2 = relu(sum over the 9 taps of shifted a1 @ w2[tap] + b2) over the
//      tile, in shared memory.
//   3. out = relu(a2 @ w3 + b3 + shortcut), chunk by chunk over Cout; only
//      this leaves the chip.
// bf16 blocks whose channel counts are multiples of 32 (all of R-50's) run
// the products on the tensor cores (`bottleneck_tc_kernel`: mma.sync with
// fp32 accumulation, a cp.async ring for the weights). Everything else,
// fp32 included, runs `bottleneck_kernel`: fp32 FMA on the CUDA cores, each
// thread owning a 4 x 4 register tile of the chunk. The tile is the largest
// of a fixed list whose a1 + a2 fit in shared memory: 8x16 pixels for
// res2-res4 in bf16, 8x8 for res5.
//
// The tensor-core kernel takes a compile-time ProbeMode. The model runs
// kFull; the other modes strip one part each for the bisection probe
// (`fused_probe_launch`), which also replaces tools/fused_kernel_probe.py's
// Pallas variants (`make_kernel`). They are separate instantiations, so the
// model's kernel is the same machine code with or without them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int MT = 64;           // pixels per GEMM chunk
constexpr int NT = 64;           // output channels per GEMM chunk
constexpr int KC = 32;           // input channels staged per step
constexpr int LDA = MT + 4;      // row stride of the staged A tile

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
struct Args {
  const T* x;
  const T* w1;
  const float* b1;
  const T* w2;
  const float* b2;
  const T* w3;
  const float* b3;
  const T* wsc;  // nullptr: identity shortcut
  const float* bsc;
  T* out;
  int H, W, Cin, Cm, Cout, TH, TW;
};

// As[k][m] = load(m, k0 + k) for the chunk's 64 pixels and 32 channels.
template <typename F>
__device__ __forceinline__ void stage_a(float* As, int k0, F load) {
  for (int e = threadIdx.x; e < KC * MT; e += kThreads) {
    const int k = e % KC;
    const int m = e / KC;
    As[k * LDA + m] = load(m, k0 + k);
  }
}

// Bs[k][n] = w[(k0 + k) * ldw + n0 + n], zero outside K x N.
template <typename T>
__device__ __forceinline__ void stage_b(float* Bs, const T* __restrict__ w,
                                        int ldw, int K, int N, int k0,
                                        int n0) {
  for (int e = threadIdx.x; e < KC * NT; e += kThreads) {
    const int k = e / NT;
    const int n = e % NT;
    float v = 0.f;
    if (k0 + k < K && n0 + n < N) v = to_f(w[(size_t)(k0 + k) * ldw + n0 + n]);
    Bs[k * NT + n] = v;
  }
}

// acc[i][j] += sum_k As[k][ty*4 + i] * Bs[k][tx*4 + j]
__device__ __forceinline__ void gemm_step(const float* As, const float* Bs,
                                          float acc[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * LDA + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * NT + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One K loop of a GEMM chunk: stage A and B, multiply, repeat.
template <typename T, typename F>
__device__ __forceinline__ void gemm_chunk(float* As, float* Bs, int K,
                                           const T* __restrict__ w, int ldw,
                                           int N, int n0, F load,
                                           float acc[4][4]) {
  for (int k0 = 0; k0 < K; k0 += KC) {
    stage_a(As, k0, load);
    stage_b(Bs, w, ldw, K, N, k0, n0);
    __syncthreads();
    gemm_step(As, Bs, acc);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bottleneck_kernel(Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [KC][LDA]
  float* Bs = As + KC * LDA;                        // [KC][NT]
  const int TH = p.TH, TW = p.TW, HW2 = TW + 2;
  const int P = TH * TW;
  const int P1 = (TH + 2) * HW2;
  const int H = p.H, W = p.W, Cin = p.Cin, Cm = p.Cm, Cout = p.Cout;
  T* a1 = reinterpret_cast<T*>(Bs + KC * NT);       // [P1][Cm]
  T* a2 = a1 + (size_t)P1 * Cm;                     // [P][Cm]

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* __restrict__ xb = p.x + (size_t)b * H * W * Cin;

  // ---- 1. a1 over the halo tile
  for (int m0 = 0; m0 < P1; m0 += MT) {
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      float acc[4][4] = {};
      gemm_chunk(As, Bs, Cin, p.w1, Cm, Cm, n0,
                 [&](int m, int k) -> float {
                   const int hp = m0 + m;
                   if (hp >= P1 || k >= Cin) return 0.f;
                   const int gy = h0 - 1 + hp / HW2;
                   const int gx = w0 - 1 + hp % HW2;
                   if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 0.f;
                   return to_f(xb[((size_t)gy * W + gx) * Cin + k]);
                 },
                 acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hp = m0 + ty * 4 + i;
        if (hp >= P1) continue;
        const int gy = h0 - 1 + hp / HW2;
        const int gx = w0 - 1 + hp % HW2;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n >= Cm) continue;
          a1[(size_t)hp * Cm + n] =
              inside ? from_f<T>(fmaxf(acc[i][j] + p.b1[n], 0.f))
                     : from_f<T>(0.f);
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. a2 = 3x3 conv of a1 over the tile
  for (int m0 = 0; m0 < P; m0 += MT) {
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      float acc[4][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        gemm_chunk(As, Bs, Cm, p.w2 + (size_t)tap * Cm * Cm, Cm, Cm, n0,
                   [&](int m, int k) -> float {
                     const int pm = m0 + m;
                     if (pm >= P || k >= Cm) return 0.f;
                     const int hp = (pm / TW + dy) * HW2 + pm % TW + dx;
                     return to_f(a1[(size_t)hp * Cm + k]);
                   },
                   acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pm = m0 + ty * 4 + i;
        if (pm >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n >= Cm) continue;
          a2[(size_t)pm * Cm + n] = from_f<T>(fmaxf(acc[i][j] + p.b2[n], 0.f));
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. out = relu(a2 @ w3 + b3 + shortcut)
  for (int m0 = 0; m0 < P; m0 += MT) {
    for (int n0 = 0; n0 < Cout; n0 += NT) {
      float acc[4][4] = {};
      gemm_chunk(As, Bs, Cm, p.w3, Cout, Cout, n0,
                 [&](int m, int k) -> float {
                   const int pm = m0 + m;
                   if (pm >= P || k >= Cm) return 0.f;
                   return to_f(a2[(size_t)pm * Cm + k]);
                 },
                 acc);
      if (p.wsc != nullptr) {
        gemm_chunk(As, Bs, Cin, p.wsc, Cout, Cout, n0,
                   [&](int m, int k) -> float {
                     const int pm = m0 + m;
                     if (pm >= P || k >= Cin) return 0.f;
                     const int gy = h0 + pm / TW;
                     const int gx = w0 + pm % TW;
                     if (gy >= H || gx >= W) return 0.f;
                     return to_f(xb[((size_t)gy * W + gx) * Cin + k]);
                   },
                   acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pm = m0 + ty * 4 + i;
        if (pm >= P) continue;
        const int gy = h0 + pm / TW;
        const int gx = w0 + pm % TW;
        if (gy >= H || gx >= W) continue;
        const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n >= Cout) continue;
          float v = acc[i][j] + p.b3[n];
          if (p.wsc != nullptr)
            v += p.bsc[n];
          else
            v += to_f(p.x[pix * Cin + n]);
          p.out[pix * Cout + n] = from_f<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: the same three stages, each 64 x 64 output chunk an
// mma.sync.m16n8k16 GEMM with fp32 accumulation over K steps of 32 channels.
// Warp w computes rows 16*(w%4).. and columns 32*(w/4).. of the chunk (one
// m16 x four n8 tiles). Weights stream through a 2-slot cp.async ring in
// shared memory; the A rows of the 3x3 conv and of conv3 are read by
// ldmatrix straight from a1 / a2 (each lane supplies the address of its
// row, which gathers the shifted rows of a tap for free), and x streams
// through the same ring for conv1 and the projection shortcut.

using bf16 = __nv_bfloat16;

constexpr int KT = 32;              // channels per pipeline step
constexpr int LDS_A = KT + 8;       // staged A row stride (bf16): 80 B
constexpr int LDS_B = NT + 8;       // staged B row stride (bf16): 144 B
constexpr int A_SLOT = MT * LDS_A;
constexpr int B_SLOT = KT * LDS_B;
constexpr int RING_BYTES = 2 * (A_SLOT + B_SLOT) * (int)sizeof(bf16);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; writes zeros (and reads nothing) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += sum over steps s < nsteps of A_s (64 x KT) @ B_s (KT x 64).
// brow(s, k): global address of row k of step s's weights at the chunk's
//   first column; columns at or past ncols are zero.
// kStagedA: arow(s, m) is the global address of pixel m's KT channels for
//   step s, or nullptr for a zero row; it goes through the ring.
// otherwise: arow(s, m) is the shared address of those KT channels (rows
//   past the tile may point anywhere finite: they are never stored).
template <bool kStagedA, typename ARow, typename BRow>
__device__ __forceinline__ void tc_chunk(bf16* As, bf16* Bs, int nsteps,
                                         int ncols, ARow arow, BRow brow,
                                         float acc[4][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;
  const int wn = tid >> 7;
  auto load = [&](int s, int slot) {
    const int k = tid >> 3, c = tid & 7;
    const bf16* brow_k = brow(s, k);
    cp_async16(Bs + slot * B_SLOT + k * LDS_B + c * 8, brow_k + c * 8,
               c * 8 < ncols);
    if (kStagedA) {
      const int m = tid >> 2, q = tid & 3;
      const bf16* src = arow(s, m);
      cp_async16(As + slot * A_SLOT + m * LDS_A + q * 8,
                 src != nullptr ? src + q * 8 : brow_k, src != nullptr);
    }
  };
  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) load(s + 1, (s + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const bf16* as = As + (s & 1) * A_SLOT;
    const bf16* bs = Bs + (s & 1) * B_SLOT;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      const int r = lane & 15, c8 = (lane >> 4) * 8;
      uint32_t a[4];
      if (kStagedA)
        ldmatrix_x4(a, as + (wm * 16 + r) * LDS_A + ks * 16 + c8);
      else
        ldmatrix_x4(a, arow(s, wm * 16 + r) + ks * 16 + c8);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bs + (ks * 16 + r) * LDS_B + wn * 32 + nh * 16 + c8);
        mma_bf16(acc[2 * nh], a, b[0], b[1]);
        mma_bf16(acc[2 * nh + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
}

// Calls f(m, n, v_n, v_n+1) for the chunk-local row m and even column n of
// every accumulator pair this thread holds.
template <typename F>
__device__ __forceinline__ void tc_epilogue(const float acc[4][4], F f) {
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) & 3;
  const int wn = threadIdx.x >> 7;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(wm * 16 + (lane >> 2) + h * 8, wn * 32 + j * 8 + (lane & 3) * 2,
        acc[j][2 * h], acc[j][2 * h + 1]);
}

__device__ __forceinline__ __nv_bfloat162 relu_pair(float a, float b) {
  return __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
}

// Variants of the tensor-core kernel for the bisection probe
// (slenderobjdet_torch/tools/fused_kernel_probe.py; the TPU counterpart is
// tools/fused_kernel_probe.py:make_kernel). kFull is the kernel the model
// runs; each other mode is a separate instantiation that strips one part:
//   kNoRolls  every 3x3 tap reads a1 without its column shift (the TPU
//             probe's dropped pltpu.roll): the ldmatrix row gather keeps the
//             tap's row shift only;
//   kNoTap    conv2 is the centre tap only (Cm/32 steps instead of 9x that);
//   kNoConv2  a2 = the a1 centre rows, no conv2;
//   kDmaOnly  every channel of the halo tile streams through the cp.async
//             ring, as conv1 reads it; out[p, c] = x[p, c % cc] * 0.5 with
//             cc = min(Cin, Cout, 128) (the TPU probe's channel chunk);
//   kNoDma    no read: out[b, y, x, c] = b + y, the output write alone.
enum ProbeMode { kFull = 0, kNoRolls, kNoTap, kNoConv2, kDmaOnly, kNoDma };

__device__ __forceinline__ uint4 half_bf16x8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(__low2float(h[i]) * 0.5f,
                                 __high2float(h[i]) * 0.5f);
  return v;
}

// kDmaOnly: stream the halo tile of x through the ring 32 channels at a
// time, keep the centre pixels' first cc channels in `keep` ([P][cc + 8]),
// then write the output from them.
__device__ __forceinline__ void probe_dma_only(const Args<bf16>& p, bf16* As,
                                               bf16* keep, int b, int h0,
                                               int w0) {
  const int TH = p.TH, TW = p.TW, HW2 = TW + 2;
  const int P = TH * TW, P1 = (TH + 2) * HW2;
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int cc = min(min(Cin, Cout), 128), ldk = cc + 8;
  const int tid = threadIdx.x, m = tid >> 2, q = tid & 3;
  const bf16* xb = p.x + (size_t)b * H * W * Cin;
  const int nsteps = Cin / KT;
  for (int m0 = 0; m0 < P1; m0 += MT) {
    const int hp = m0 + m;
    const int gy = h0 - 1 + hp / HW2, gx = w0 - 1 + hp % HW2;
    const bool inside = hp < P1 && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = xb + ((size_t)gy * W + gx) * Cin + q * 8;
    const int cy = hp / HW2 - 1, cx = hp % HW2 - 1;   // centre coordinates
    const bool centre = hp < P1 && cy >= 0 && cy < TH && cx >= 0 && cx < TW;
    auto load = [&](int s) {
      cp_async16(As + (s & 1) * A_SLOT + m * LDS_A + q * 8,
                 inside ? src + s * KT : p.x, inside);
    };
    load(0);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int s = 0; s < nsteps; ++s) {
      if (s + 1 < nsteps) load(s + 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      if (centre && s * KT + q * 8 < cc)
        *reinterpret_cast<uint4*>(keep + (size_t)(cy * TW + cx) * ldk +
                                  s * KT + q * 8) =
            *reinterpret_cast<const uint4*>(As + (s & 1) * A_SLOT +
                                            m * LDS_A + q * 8);
      __syncthreads();
    }
  }
  const int cv = Cout / 8;
  for (int e = tid; e < P * cv; e += kThreads) {
    const int pm = e / cv, c = (e % cv) * 8;
    const int gy = h0 + pm / TW, gx = w0 + pm % TW;
    if (gy >= H || gx >= W) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(keep + (size_t)pm * ldk + c % cc);
    *reinterpret_cast<uint4*>(p.out + (((size_t)b * H + gy) * W + gx) * Cout +
                              c) = half_bf16x8(v);
  }
}

// kNoDma: out[b, y, x, c] = b + y over the tile, nothing read.
__device__ __forceinline__ void probe_no_dma(const Args<bf16>& p, int b,
                                             int h0, int w0) {
  const int TW = p.TW, P = p.TH * TW, cv = p.Cout / 8;
  for (int e = threadIdx.x; e < P * cv; e += kThreads) {
    const int pm = e / cv, c = (e % cv) * 8;
    const int gy = h0 + pm / TW, gx = w0 + pm % TW;
    if (gy >= p.H || gx >= p.W) continue;
    const __nv_bfloat162 v = __float2bfloat162_rn((float)(b + gy));
    uint4 o;
    o.x = o.y = o.z = o.w = *reinterpret_cast<const uint32_t*>(&v);
    *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.H + gy) * p.W + gx) *
                                          p.Cout + c) = o;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
bottleneck_tc_kernel(Args<bf16> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);     // [2][MT][LDS_A]
  bf16* Bs = As + 2 * A_SLOT;                       // [2][KT][LDS_B]
  const int TH = p.TH, TW = p.TW, HW2 = TW + 2;
  const int P = TH * TW;
  const int P1 = (TH + 2) * HW2;
  const int H = p.H, W = p.W, Cin = p.Cin, Cm = p.Cm, Cout = p.Cout;
  const int lda = Cm + 8;                           // a1/a2 row stride
  bf16* a1 = Bs + 2 * B_SLOT;                       // [P1][lda]
  bf16* a2 = a1 + (size_t)P1 * lda;                 // [P][lda]

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const bf16* __restrict__ xb = p.x + (size_t)b * H * W * Cin;
  auto x_at = [&](int gy, int gx) -> const bf16* {
    return xb + ((size_t)gy * W + gx) * Cin;
  };
  if constexpr (kMode == kNoDma) {
    probe_no_dma(p, b, h0, w0);
    return;
  }
  if constexpr (kMode == kDmaOnly) {
    probe_dma_only(p, As, a1, b, h0, w0);
    return;
  }

  // ---- 1. a1 over the halo tile
  for (int m0 = 0; m0 < P1; m0 += MT) {
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      float acc[4][4] = {};
      tc_chunk<true>(
          As, Bs, Cin / KT, Cm - n0,
          [&](int s, int m) -> const bf16* {
            const int hp = m0 + m;
            if (hp >= P1) return nullptr;
            const int gy = h0 - 1 + hp / HW2, gx = w0 - 1 + hp % HW2;
            if (gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
            return x_at(gy, gx) + s * KT;
          },
          [&](int s, int k) { return p.w1 + (size_t)(s * KT + k) * Cm + n0; },
          acc);
      tc_epilogue(acc, [&](int m, int n, float v0, float v1) {
        const int hp = m0 + m;
        n += n0;
        if (hp >= P1 || n >= Cm) return;
        const int gy = h0 - 1 + hp / HW2, gx = w0 - 1 + hp % HW2;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        *reinterpret_cast<__nv_bfloat162*>(a1 + (size_t)hp * lda + n) =
            inside ? relu_pair(v0 + p.b1[n], v1 + p.b1[n + 1])
                   : __floats2bfloat162_rn(0.f, 0.f);
      });
    }
  }
  __syncthreads();

  // ---- 2. a2 = 3x3 conv of a1 over the tile: 9 taps x Cm/KT steps
  const int kc = Cm / KT;
  if constexpr (kMode == kNoConv2) {
    for (int e = threadIdx.x; e < P * (Cm / 8); e += kThreads) {
      const int pm = e / (Cm / 8), c = (e % (Cm / 8)) * 8;
      const int hp = (pm / TW + 1) * HW2 + pm % TW + 1;
      *reinterpret_cast<uint4*>(a2 + (size_t)pm * lda + c) =
          *reinterpret_cast<const uint4*>(a1 + (size_t)hp * lda + c);
    }
  }
  for (int m0 = 0; m0 < P && kMode != kNoConv2; m0 += MT) {
    for (int n0 = 0; n0 < Cm; n0 += NT) {
      float acc[4][4] = {};
      tc_chunk<false>(
          As, Bs, (kMode == kNoTap ? 1 : 9) * kc, Cm - n0,
          [&](int s, int m) -> const bf16* {
            const int tap = kMode == kNoTap ? 4 : s / kc;
            const int pm = min(m0 + m, P - 1);
            const int hp = (pm / TW + tap / 3) * HW2 + pm % TW +
                           (kMode == kNoRolls ? 1 : tap % 3);
            return a1 + (size_t)hp * lda + (s % kc) * KT;
          },
          [&](int s, int k) {
            const int tap = kMode == kNoTap ? 4 : s / kc;
            return p.w2 + ((size_t)tap * Cm + (s % kc) * KT + k) * Cm + n0;
          },
          acc);
      tc_epilogue(acc, [&](int m, int n, float v0, float v1) {
        const int pm = m0 + m;
        n += n0;
        if (pm >= P || n >= Cm) return;
        *reinterpret_cast<__nv_bfloat162*>(a2 + (size_t)pm * lda + n) =
            relu_pair(v0 + p.b2[n], v1 + p.b2[n + 1]);
      });
    }
  }
  __syncthreads();

  // ---- 3. out = relu(a2 @ w3 + b3 + shortcut)
  for (int m0 = 0; m0 < P; m0 += MT) {
    for (int n0 = 0; n0 < Cout; n0 += NT) {
      float acc[4][4] = {};
      tc_chunk<false>(
          As, Bs, kc, Cout - n0,
          [&](int s, int m) -> const bf16* {
            return a2 + (size_t)min(m0 + m, P - 1) * lda + s * KT;
          },
          [&](int s, int k) { return p.w3 + (size_t)(s * KT + k) * Cout + n0; },
          acc);
      if (p.wsc != nullptr) {
        tc_chunk<true>(
            As, Bs, Cin / KT, Cout - n0,
            [&](int s, int m) -> const bf16* {
              const int pm = m0 + m;
              if (pm >= P) return nullptr;
              const int gy = h0 + pm / TW, gx = w0 + pm % TW;
              if (gy >= H || gx >= W) return nullptr;
              return x_at(gy, gx) + s * KT;
            },
            [&](int s, int k) {
              return p.wsc + (size_t)(s * KT + k) * Cout + n0;
            },
            acc);
      }
      tc_epilogue(acc, [&](int m, int n, float v0, float v1) {
        const int pm = m0 + m;
        n += n0;
        if (pm >= P || n >= Cout) return;
        const int gy = h0 + pm / TW, gx = w0 + pm % TW;
        if (gy >= H || gx >= W) return;
        v0 += p.b3[n];
        v1 += p.b3[n + 1];
        if (p.wsc != nullptr) {
          v0 += p.bsc[n];
          v1 += p.bsc[n + 1];
        } else {
          const __nv_bfloat162 s =
              *reinterpret_cast<const __nv_bfloat162*>(x_at(gy, gx) + n);
          v0 += __low2float(s);
          v1 += __high2float(s);
        }
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        *reinterpret_cast<__nv_bfloat162*>(p.out + pix * Cout + n) =
            relu_pair(v0, v1);
      });
    }
  }
}

int smem_bytes(int th, int tw, int cm, int itemsize) {
  const int p1 = (th + 2) * (tw + 2);
  return (KC * LDA + KC * NT) * (int)sizeof(float) +
         (p1 + th * tw) * cm * itemsize;
}

int tc_smem_bytes(int th, int tw, int cm) {
  const int p1 = (th + 2) * (tw + 2);
  return RING_BYTES + (p1 + th * tw) * (cm + 8) * (int)sizeof(bf16);
}

// The tensor-core path takes bf16 blocks whose channel counts fill its K
// steps and whose buffers allow 16-byte copies.
bool tc_eligible(const void* const* ptrs, int n, int Cin, int Cm, int Cout) {
  if (Cin % KT != 0 || Cm % KT != 0 || Cout % 8 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && (uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
}

// The largest tile of a fixed list whose buffers fit in `limit` bytes of
// shared memory.
bool pick_tile(bool tc, int Cm, int itemsize, int limit, int* th, int* tw,
               int* smem) {
  static const int kTiles[][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4},
                                  {2, 4},  {2, 2}, {1, 2}, {1, 1}};
  for (const auto& t : kTiles) {
    *smem = tc ? tc_smem_bytes(t[0], t[1], Cm)
               : smem_bytes(t[0], t[1], Cm, itemsize);
    if (*smem <= limit) {
      *th = t[0];
      *tw = t[1];
      return true;
    }
  }
  return false;
}

int smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename T>
Args<T> make_args(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, const void* wsc, const void* bsc, void* out,
                  int H, int W, int Cin, int Cm, int Cout, int th, int tw) {
  return Args<T>{(const T*)x,   (const T*)w1,      (const float*)b1,
                 (const T*)w2,  (const float*)b2,  (const T*)w3,
                 (const float*)b3, (const T*)wsc,  (const float*)bsc,
                 (T*)out, H, W, Cin, Cm, Cout, th, tw};
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wsc,
           const void* bsc, void* out, int batch, int H, int W, int Cin,
           int Cm, int Cout, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = (cudaError_t)smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  bool tc = false;
  if constexpr (std::is_same<T, bf16>::value) {
    const void* ptrs[] = {x, w1, w2, w3, wsc, out};
    tc = tc_eligible(ptrs, 6, Cin, Cm, Cout);
  }
  int th = 0, tw = 0, smem = 0;
  if (!pick_tile(tc, Cm, (int)sizeof(T), limit, &th, &tw, &smem))
    return (int)cudaErrorInvalidConfiguration;
  const Args<T> a = make_args<T>(x, w1, b1, w2, b2, w3, b3, wsc, bsc, out, H,
                                 W, Cin, Cm, Cout, th, tw);
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, batch);
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc) {
      err = cudaFuncSetAttribute(bottleneck_tc_kernel<kFull>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      bottleneck_tc_kernel<kFull><<<grid, kThreads, smem, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  err = cudaFuncSetAttribute(bottleneck_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  bottleneck_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One probe variant on the tile the model's kernel picks for these shapes.
template <int kMode>
int probe_launch(const Args<bf16>& a, dim3 grid, int smem,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_tc_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  bottleneck_tc_kernel<kMode><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) in dtype (0 = float32, 1 = bfloat16); w1 (Cin, Cm),
// w2 (3, 3, Cm, Cm), w3 (Cm, Cout) and wsc (Cin, Cout) in dtype, already
// folded; b1, b2 (Cm,), b3, bsc (Cout,) float32; wsc and bsc null for the
// identity shortcut (Cin == Cout); out (B, H, W, Cout) in dtype. All
// contiguous. Returns cudaGetLastError() after the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* wsc,
                            const void* bsc, void* out, int batch, int H,
                            int W, int Cin, int Cm, int Cout, void* stream) {
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, wsc, bsc, out, batch, H,
                         W, Cin, Cm, Cout, (cudaStream_t)stream);
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, wsc, bsc, out,
                               batch, H, W, Cin, Cm, Cout,
                               (cudaStream_t)stream);
}

// One variant of the bf16 tensor-core kernel (see ProbeMode) for an
// identity block: mode 0 full, 1 norolls, 2 notap, 3 noconv2, 4 dmaonly,
// 5 nodma. Other arguments as for fused_bottleneck_launch, bf16 only.
// Returns cudaErrorInvalidValue for blocks the tensor-core kernel does not
// take, else cudaGetLastError().
int fused_probe_launch(int mode, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       const void* w3, const void* b3, void* out, int batch,
                       int H, int W, int Cin, int Cm, int Cout, void* stream) {
  const void* ptrs[] = {x, w1, w2, w3, out};
  if (!tc_eligible(ptrs, 5, Cin, Cm, Cout) || Cin != Cout || mode < 0 ||
      mode > kNoDma)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = (cudaError_t)smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  int th = 0, tw = 0, smem = 0;
  if (!pick_tile(true, Cm, 2, limit, &th, &tw, &smem))
    return (int)cudaErrorInvalidConfiguration;
  // kDmaOnly keeps P x (cc + 8) values where the other modes keep a1 and a2
  const int keep = RING_BYTES + th * tw * ((Cin < 128 ? Cin : 128) + 8) * 2;
  if (mode == kDmaOnly && keep > smem) smem = keep;
  if (smem > limit) return (int)cudaErrorInvalidConfiguration;
  const Args<bf16> a = make_args<bf16>(x, w1, b1, w2, b2, w3, b3, nullptr,
                                       nullptr, out, H, W, Cin, Cm, Cout, th,
                                       tw);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, batch);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kFull: return probe_launch<kFull>(a, grid, smem, s);
    case kNoRolls: return probe_launch<kNoRolls>(a, grid, smem, s);
    case kNoTap: return probe_launch<kNoTap>(a, grid, smem, s);
    case kNoConv2: return probe_launch<kNoConv2>(a, grid, smem, s);
    case kDmaOnly: return probe_launch<kDmaOnly>(a, grid, smem, s);
    default: return probe_launch<kNoDma>(a, grid, smem, s);
  }
}

}  // extern "C"
