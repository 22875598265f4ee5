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
// about 4.7 GMAC per image (1x1 + 3x3 + 1x1 over the stage's pixels), so at
// res3-res5 it is bound by the tensor cores' rate, and what keeps a kernel
// from that rate is how many operand bytes each product needs and how well
// their arrival overlaps the products. At res2 the block's input and output
// are 2 x 34 MB per image, so there the bytes are the bound.
//
// Two kernels; the wrapper (ops/fused_bottleneck.py: bottleneck_plan) picks
// one by dtype and shape and lays out its tiles and weights:
// - `conv_wgmma_kernel`, bf16 blocks with Cin, Cm and Cout % 64 == 0 (all
//   of R-50's): the block as three implicit-GEMM launches (conv1, 3x3
//   conv2, conv3 + shortcut) with a1 and a2 in device memory; wgmma fed by
//   an mbarrier ring (see below).
// - `bottleneck_kernel`, everything else, fp32 included: the whole block on
//   chip, one CTA of 256 threads per (image, TH x TW tile):
//   1. a1 = relu(x @ w1 + b1) over the tile plus a 1-pixel halo, streaming
//      x over Cin; halo pixels outside the image are stored as 0 (the 3x3
//      conv's zero padding), not relu(b1). a1 stays in shared memory in
//      dtype, which is exact since the semantics round it to dtype.
//   2. a2 = relu(sum over the 9 taps of shifted a1 @ w2[tap] + b2) over the
//      tile, in shared memory.
//   3. out = relu(a2 @ w3 + b3 + shortcut), chunk by chunk over Cout; only
//      this leaves the chip.
//   Each 64 x 64 output chunk is a GEMM of fp32 FMA on the CUDA cores, each
//   thread owning a 4 x 4 register tile of it, K staged 32 channels at a
//   time.
//
// The wgmma kernel takes a compile-time mode (ConvMode). The model runs the
// full one; the other modes strip one part each for the bisection probe
// (`conv_wgmma_launch`), which also replaces tools/fused_kernel_probe.py's
// Pallas variants (`make_kernel`). They are separate instantiations, so the
// model's kernels are the same machine code with or without them.

#include "hopper.cuh"

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
// bf16 wgmma path.

using bf16 = __nv_bfloat16;

// 16-byte async copy; writes zeros (and reads nothing) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ __nv_bfloat162 relu_pair(float a, float b) {
  return __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
}

__device__ __forceinline__ uint4 half_bf16x8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(__low2float(h[i]) * 0.5f,
                                 __high2float(h[i]) * 0.5f);
  return v;
}

// The block runs as three implicit-GEMM launches of `conv_wgmma_kernel`:
// a1 = relu(x @ w1 + b1), a2 = relu(3x3 conv of a1 + b2), out = relu(a2 @
// w3 + b3 + shortcut), with a1 and a2 in device memory (B x H x W x Cm bf16
// each: 8.6 MB per image at res2, 4.3 at res3, 2.2 at res4, 1.1 at res5, so
// from res3 on they stay in the 50 MB L2 between launches at B = 8).
// Unfusing is what lifts weight reuse: an on-chip tile must hold its a1
// halo and a2, which caps it at 64 pixels at res5, and every CTA then
// streams every weight of the block; here a CTA owns 128 pixels (of the
// B x H x W flattened, so only the last tile is ragged) x BN (64, 128 or
// 256) output channels, so each weight byte read serves 128 pixels and
// each activation byte BN channels.
//
// Each CTA is two consumer warpgroups (64 pixel rows each) and two producer
// warps that keep a ring of `stages` (3 or 4) slots full. A slot holds one K
// step of 64 channels: the tile's 128 A rows, each 128-byte row copied by
// eight producer lanes with cp.async from the pixel the tap shifts it to (or
// zeros, for the 3x3 conv's padding and past the last pixel), and the step's
// 64 x BN weights as one `cp.async.bulk` (the wrapper pre-lays the weights
// in the wgmma layout, contiguous per N tile and K step). Both complete on
// the slot's `full` mbarrier; the eight consumer warps release it on its
// `empty` mbarrier, so the K loop has no block-wide barrier. A consumer
// issues m64n128k16 wgmma (m64n64k16 at BN = 64) with both operands read
// from the slot through matrix descriptors, fp32 accumulators in registers,
// and keeps one step's group in flight while it waits for the next slot.
// The epilogue stages acc + bias through the idle ring, then adds the
// residual and writes 16-byte rows.

constexpr int GM = 128;                      // pixels per tile
constexpr int GK = 64;                       // channels per ring slot
constexpr int G_A_SLOT = GM * GK * 2;        // bytes of a slot's A tile
constexpr int kGemmThreads = 320;           // 2 consumer warpgroups + 2 warps
constexpr int kMaxStages = 8;
constexpr int kHeadBytes = 128 + GM * 8;    // full[8], empty[8], rows[GM]
// Both operands of a slot are K-major in the wgmma no-swizzle layout, 8 x 8
// core matrices of 128 contiguous bytes (8 rows of 16 B):
// - A (the producer's cp.async): [row group r / 8][k chunk < 8][r % 8]
//   [8 k], core matrices 128 B apart along K, 1024 B along M;
// - B (pack_conv_weights in ops/fused_bottleneck.py): [k16 slice j < 4]
//   [n group < BN / 8][k half < 2][8 n][8 k], 128 B apart along K, 256 B
//   along N.
constexpr uint32_t kLBO = 128, kSBO_A = 1024, kSBO_B = 256;

// A row of zeros (GK bf16): the source of every A row outside the image or
// the tile.
__device__ __align__(128) uint4 kZeroRow[GK * 2 / 16];

// Modes of the kernel: kConvFull is what the model runs; the others serve
// the bisection probe (slenderobjdet_torch/tools/fused_kernel_probe.py; the
// TPU counterpart is tools/fused_kernel_probe.py:make_kernel), whose other
// variants (centre tap only, no conv2) the wrapper builds from full
// launches: kConvNoRolls drops the 3x3 taps' column shift (the TPU probe's
// dropped pltpu.roll); kConvDmaOnly streams the A rows through the ring and
// writes out[m, c] = a0[m, c % cc] * 0.5 (cc = min(c0, N, 128), the TPU
// probe's channel chunk); kConvNoDma reads nothing and writes
// out[b, y, x, c] = b + y.
enum ConvMode { kConvFull = 0, kConvNoRolls, kConvDmaOnly, kConvNoDma };

struct ConvArgs {
  const bf16* a0;     // first A source, NHWC (B, H, W, c0)
  const bf16* a1;     // second A source (B, H, W, c1), or null
  int c0, c1;         // channels of the sources (c1 = 0: none)
  int taps;           // taps of a0: 1 (1x1) or 9 (3x3, padding 1)
  const bf16* w;      // packed weights, [N / BN][ksteps][GK x BN]
  const float* bias0; // (N,)
  const float* bias1; // (N,) or null
  const bf16* res;    // (B, H, W, N) added before the relu, or null
  bf16* out;          // (B, H, W, N)
  int batch, H, W, N, stages;
};

// The producer warps: warp pw < 2 fills rows 64 pw .. 64 pw + 63 of each
// slot's A tile with 16-byte cp.async (eight lanes per 128-byte row, zeros
// outside the image or the tile), which arrive on the slot's full barrier
// when they land; warp 0's lane 0 also posts the step's weights as one bulk
// copy on the same barrier.
template <int BN, int kMode>
__device__ __forceinline__ void conv_produce(const ConvArgs& p, bf16* As,
                                             unsigned char* Bs, int2* rows,
                                             uint64_t* full, uint64_t* empty,
                                             int ksteps, int k0steps) {
  constexpr int B_BYTES = GK * BN * 2;
  constexpr bool kWeights = kMode != kConvDmaOnly;
  const int pw = threadIdx.x / 32 - 8, lane = threadIdx.x & 31;
  const int r8 = lane & 7, q4 = lane >> 3;
  const int H = p.H, W = p.W, HW = H * W, M = p.batch * HW;
  const int m0 = blockIdx.x * GM;
  // rows[r] = {pixel m, y << 16 | x}, m = -1 past the last pixel
  for (int r = pw * 64 + lane; r < pw * 64 + 64; r += 32) {
    const int m = m0 + r;
    rows[r] = m < M ? make_int2(m, (m % HW / W) << 16 | m % W)
                    : make_int2(-1, 0);
  }
  __syncwarp();
  const bf16* wt = p.w + (size_t)blockIdx.y * ksteps * GK * BN;
  const bf16* zero = reinterpret_cast<const bf16*>(kZeroRow);
  const int kc0 = p.c0 / GK;
  for (int t = 0; t < ksteps; ++t) {
    const int s = t % p.stages;
    mbar_wait(&empty[s], ((t / p.stages) & 1) ^ 1);
    if (pw == 0 && lane == 0) {
      if (kWeights) {
        mbar_expect_tx(&full[s], B_BYTES);
        bulk_copy(Bs + (size_t)s * B_BYTES, wt + (size_t)t * GK * BN, B_BYTES,
                  &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    const bf16* src = p.a0;
    int c = p.c0, k, dy = 0, dx = 0;
    if (t < k0steps) {
      const int tap = t / kc0;
      k = (t % kc0) * GK;
      if (p.taps == 9) {
        dy = tap / 3 - 1;
        dx = kMode == kConvNoRolls ? 0 : tap % 3 - 1;
      }
    } else {
      src = p.a1;
      c = p.c1;
      k = (t - k0steps) * GK;
    }
    // lane: row r % 8 = lane % 8 of each row group, chunks lane / 8 and
    // lane / 8 + 4, so a warp's 16-byte writes fill all 32 banks
    unsigned char* as = reinterpret_cast<unsigned char*>(As) +
                        (size_t)s * G_A_SLOT + r8 * 16;
    const int shift = dy * W + dx;
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int rg = pw * 8 + i;            // row group
      const int2 e = rows[rg * 8 + r8];
      const int y = (e.y >> 16) + dy, x = (e.y & 0xFFFF) + dx;
      const bool in = e.x >= 0 && y >= 0 && y < H && x >= 0 && x < W;
      const bf16* g = in ? src + (size_t)(e.x + shift) * c + k : zero;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q4 + 4 * h;
        cp_async16(as + (rg * 8 + q) * 128, in ? g + q * 8 : zero, in);
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     smem_addr(&full[s]))
                 : "memory");
  }
}

// The consumer warpgroups: wgmma over the ring's slots, then the epilogue.
template <int BN, int kMode>
__device__ __forceinline__ void conv_consume(const ConvArgs& p, bf16* As,
                                             unsigned char* Bs,
                                             uint64_t* full, uint64_t* empty,
                                             int ksteps) {
  constexpr int B_BYTES = GK * BN * 2;
  constexpr int WN = BN < 128 ? BN : 128;       // columns per wgmma
  constexpr int NH = BN / WN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int H = p.H, W = p.W, N = p.N, M = p.batch * H * W;
  const int row0 = blockIdx.x * GM + wg * 64;   // this warpgroup's rows
  const int n0 = blockIdx.y * BN;
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  if constexpr (kMode == kConvNoDma) {
    for (int e = threadIdx.x & 127; e < 64 * (N / 8); e += 128) {
      const int m = row0 + e / (N / 8), c = e % (N / 8) * 8;
      if (m >= M) continue;
      const int b = m / (H * W), y = m % (H * W) / W;
      const __nv_bfloat162 v = __float2bfloat162_rn((float)(b + y));
      uint4 o;
      o.x = o.y = o.z = o.w = *reinterpret_cast<const uint32_t*>(&v);
      *reinterpret_cast<uint4*>(p.out + (size_t)m * N + c) = o;
    }
    return;
  }
  float acc[NH][WN / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[h][i] = 0.f;
  const int cc = min(min(p.c0, N), 128);
  for (int t = 0; t < ksteps; ++t) {
    const int s = t % p.stages;
    mbar_wait(&full[s], (t / p.stages) & 1);
    const unsigned char* as =
        reinterpret_cast<const unsigned char*>(As) + (size_t)s * G_A_SLOT;
    if constexpr (kMode == kConvDmaOnly) {
      // out[m, c] = x[m, c % cc] * 0.5 for the channels this slot holds
      for (int e = threadIdx.x & 127; e < 64 * 8 && t * GK < cc; e += 128) {
        const int r = wg * 64 + e / 8, q = e % 8, m = blockIdx.x * GM + r;
        if (m >= M) continue;
        const uint4 v = half_bf16x8(*reinterpret_cast<const uint4*>(
            as + ((r / 8) * 8 + q) * 128 + r % 8 * 16));
        for (int c = t * GK + q * 8; c < N; c += cc)
          *reinterpret_cast<uint4*>(p.out + (size_t)m * N + c) = v;
      }
    } else {
      const unsigned char* bs = Bs + (size_t)s * B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t da =
              wgmma_desc(as + wg * 8 * 1024 + j * 256, kLBO, kSBO_A);
          const uint64_t db =
              wgmma_desc(bs + j * BN * 32 + h * WN * 32, kLBO, kSBO_B);
          if constexpr (WN == 128)
            wgmma_m64n128k16(acc[h], da, db);
          else
            wgmma_m64n64k16(acc[h], da, db);
        }
      wgmma_commit();
      // keep this step's products in flight; the previous step's are
      // done, so its slot goes back to the producer
      wgmma_wait<1>();
    }
    __syncwarp();
    if (kMode == kConvDmaOnly)
      release(s);
    else if (t > 0)
      release((t - 1) % p.stages);
  }
  if constexpr (kMode == kConvDmaOnly) return;
  wgmma_wait<0>();
  // Epilogue through shared memory: once both warpgroups are done with
  // the ring, each stages acc + bias of its 64 rows there in fp32, then
  // adds the residual and writes the rows with 16-byte loads and stores.
  const int ld = BN + 4;
  float* stage = reinterpret_cast<float*>(As) + wg * 64 * ld;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int n = h * WN + j * 8 + tq * 2;
      float2 bias = *reinterpret_cast<const float2*>(p.bias0 + n0 + n);
      if (p.bias1 != nullptr) {
        const float2 b1 = *reinterpret_cast<const float2*>(p.bias1 + n0 + n);
        bias.x += b1.x;
        bias.y += b1.y;
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        *reinterpret_cast<float2*>(stage + (warp * 16 + g + 8 * r2) * ld + n) =
            make_float2(acc[h][4 * j + 2 * r2] + bias.x,
                        acc[h][4 * j + 2 * r2 + 1] + bias.y);
    }
  // Each thread owns kChunks 16-byte chunks of the 64 rows; their residual
  // loads are all issued before the first is used, so they overlap one
  // another (and the barrier) instead of paying a memory latency each.
  constexpr int kChunks = 64 * (BN / 8) / 128;
  const int tid = threadIdx.x & 127;
  uint4 sc[kChunks];
  if (p.res != nullptr) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = tid + i * 128, m = row0 + e / (BN / 8);
      if (m < M)
        sc[i] = __ldg(reinterpret_cast<const uint4*>(
            p.res + (size_t)m * N + n0 + e % (BN / 8) * 8));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int e = tid + i * 128;
    const int r = e / (BN / 8), n = e % (BN / 8) * 8, m = row0 + r;
    if (m >= M) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + r * ld + n);
    const float4 hi = *reinterpret_cast<const float4*>(stage + r * ld + n + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = (size_t)m * N + n0 + n;
    if (p.res != nullptr) {
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sc[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] += __low2float(s2[k]);
        v[2 * k + 1] += __high2float(s2[k]);
      }
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) o2[k] = relu_pair(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p.out + off) = o;
  }
}

// Two CTAs share an SM at BN <= 128 (at most 96 registers a thread, and
// the launcher shortens their ring), so one CTA's prologue and epilogue
// overlap the other's K loop; a BN = 256 CTA needs 168 registers a thread
// for its accumulators and has the SM alone.
template <int BN, int kMode>
__global__ void __launch_bounds__(kGemmThreads, BN <= 128 ? 2 : 1)
conv_wgmma_kernel(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int2* rows = reinterpret_cast<int2*>(smem + 128);
  bf16* As = reinterpret_cast<bf16*>(smem + kHeadBytes);
  unsigned char* Bs = smem + kHeadBytes + (size_t)p.stages * G_A_SLOT;
  const int k0steps = p.taps * (p.c0 / GK);
  const int ksteps = kMode == kConvNoDma ? 0 : k0steps + p.c1 / GK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 65);   // 64 producer lanes' cp.async, 1 expect_tx
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256)
    conv_produce<BN, kMode>(p, As, Bs, rows, full, empty, ksteps, k0steps);
  else
    conv_consume<BN, kMode>(p, As, Bs, full, empty, ksteps);
}

int smem_bytes(int th, int tw, int cm, int itemsize) {
  const int p1 = (th + 2) * (tw + 2);
  return (KC * LDA + KC * NT) * (int)sizeof(float) +
         (p1 + th * tw) * cm * itemsize;
}

bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && (uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
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

template <typename K>
int launch_kernel(K kernel, dim3 grid, int threads, int smem,
                  cudaStream_t stream, const void* args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<void*>(args)};
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(threads), params,
                         (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The on-chip CUDA-core kernel on a th x tw tile.
template <typename T>
int launch_onchip(const Args<T>& a, int batch, int smem, cudaStream_t stream) {
  const dim3 grid((a.W + a.TW - 1) / a.TW, (a.H + a.TH - 1) / a.TH, batch);
  return launch_kernel(bottleneck_kernel<T>, grid, kThreads, smem, stream,
                       &a);
}

template <int BN, int kMode>
int launch_conv(const ConvArgs& a, int smem, cudaStream_t stream) {
  const int M = a.batch * a.H * a.W;
  const dim3 grid((M + GM - 1) / GM, kMode >= kConvDmaOnly ? 1 : a.N / BN);
  return launch_kernel(conv_wgmma_kernel<BN, kMode>, grid, kGemmThreads, smem,
                       stream, &a);
}

}  // namespace

extern "C" {

// The on-chip fused block on the CUDA cores, one launch over th x tw pixel
// tiles (the tile plan is the wrapper's, ops/fused_bottleneck.py:
// onchip_tile): x (B, H, W, Cin) in dtype (0 = float32, 1 = bfloat16); w1
// (Cin, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, Cout) and wsc (Cin, Cout) in dtype,
// already folded; b1, b2 (Cm,), b3, bsc (Cout,) float32; wsc and bsc null
// for the identity shortcut (Cin == Cout); out (B, H, W, Cout) in dtype. All
// contiguous. Returns cudaErrorInvalidValue for a tile of no pixels,
// cudaErrorInvalidConfiguration for a tile that does not fit in shared
// memory, else cudaGetLastError() after the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* wsc,
                            const void* bsc, void* out, int batch, int H,
                            int W, int Cin, int Cm, int Cout, int th, int tw,
                            void* stream) {
  if (th < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = (cudaError_t)smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(th, tw, Cm, dtype == 0 ? 4 : 2);
  if (smem > limit) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_onchip<float>(
        make_args<float>(x, w1, b1, w2, b2, w3, b3, wsc, bsc, out, H, W, Cin,
                         Cm, Cout, th, tw),
        batch, smem, s);
  return launch_onchip<bf16>(
      make_args<bf16>(x, w1, b1, w2, b2, w3, b3, wsc, bsc, out, H, W, Cin, Cm,
                      Cout, th, tw),
      batch, smem, s);
}

// One convolution of the wgmma path (see conv_wgmma_kernel), bf16:
// out (B, H, W, N) = relu(sum over the K steps of A @ w + bias0 [+ bias1]
// [+ res]). a0 (B, H, W, c0) with taps 1 or 9; a1 (B, H, W, c1) or null
// with c1 = 0; w packed by ops/fused_bottleneck.py:pack_conv_weights for
// N tiles of bn (64, 128 or 256) columns; mode a ConvMode (0 full, 1 norolls,
// 2 dmaonly, 3 nodma; the last two take no weights). c0, c1 % 64 == 0,
// N % bn == 0, every pointer 16-byte aligned. Returns cudaErrorInvalidValue
// for arguments the kernel does not take, else cudaGetLastError() after the
// launch.
int conv_wgmma_launch(int mode, const void* a0, int c0, int taps,
                      const void* a1, int c1, const void* w,
                      const void* bias0, const void* bias1, const void* res,
                      void* out, int batch, int H, int W, int N, int bn,
                      void* stream) {
  const void* ptrs[] = {a0, a1, w, res, out};
  if (mode < kConvFull || mode > kConvNoDma || c0 < GK || c0 % GK != 0 ||
      c1 % GK != 0 || (c1 > 0) != (a1 != nullptr) ||
      (taps != 1 && taps != 9) || (bn != 64 && bn != 128 && bn != 256) ||
      N % bn != 0 || !aligned16(ptrs, 5) || batch * H * W < 1)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = (cudaError_t)smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int slot = G_A_SLOT + GK * bn * 2;
  // rings of 4 slots at bn = 64 (98 KB) and 3 at bn = 128 (97 KB) leave
  // room for a second CTA on the SM
  const int most = bn == 64 ? 4 : bn == 128 ? 3 : kMaxStages;
  int stages = (limit - kHeadBytes) / slot;
  if (stages > most) stages = most;
  if (stages < 3) return (int)cudaErrorInvalidConfiguration;
  const ConvArgs a{(const bf16*)a0,     (const bf16*)a1,     c0,
                   c1,                  taps,                (const bf16*)w,
                   (const float*)bias0, (const float*)bias1, (const bf16*)res,
                   (bf16*)out,          batch,               H,
                   W,                   N,                   stages};
  const int smem = kHeadBytes + stages * slot;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kConvFull:
      return bn == 256   ? launch_conv<256, kConvFull>(a, smem, s)
             : bn == 128 ? launch_conv<128, kConvFull>(a, smem, s)
                         : launch_conv<64, kConvFull>(a, smem, s);
    case kConvNoRolls:
      return bn == 256   ? launch_conv<256, kConvNoRolls>(a, smem, s)
             : bn == 128 ? launch_conv<128, kConvNoRolls>(a, smem, s)
                         : launch_conv<64, kConvNoRolls>(a, smem, s);
    case kConvDmaOnly: return launch_conv<128, kConvDmaOnly>(a, smem, s);
    default: return launch_conv<128, kConvNoDma>(a, smem, s);
  }
}

}  // extern "C"
