// Copy-bandwidth probe: y = x * 0.5 over a bf16 (B, H, W, C) tensor, moved
// in blocks of TH rows of one image, with two store patterns.
//
// Replaces: tools/pallas_bw_probe.py `run.one` (the Pallas kernel at :37-45:
// a (1, TH, W, C) BlockSpec copy with one full-width store, `blocked`, or
// stores in 128-lane slices as the fused kernel's conv3 chunk loop does,
// `chunked`). There TH is the size of the DMA'd block one core walks in
// sequence; it never decided how much of the chip worked, and it does not
// here: TH fixes the unit that is moved and the order of its bytes, and the
// grid is sized from the chunk list, not from TH.
//
// What bounds it on an H100: device-memory bandwidth, one read and one
// write of every byte (3.35 TB/s published peak for the SXM part). x * 0.5
// is exact in bf16, so both modes equal the plain `x * 0.5` bit for bit.
//
// Design: every TH-row block is cut into chunks of at most kChunk bytes
// (whole pixels), and the grid is one CTA a chunk of the (image, block,
// chunk) list (`copy_chunks` in ops/bw_probe.py is the same arithmetic). The
// chunk arrives in shared memory by one `cp.async.bulk` on an mbarrier, so
// the load costs no registers. 512 threads let four CTAs share an SM and
// overlap its loads and stores; on the H100 eight CTAs of 256 threads, or
// chunks of 32-64 KB, copy 0.5-1.5% slower.
//   blocked  the chunk is halved in place in shared memory and leaves by
//            one `cp.async.bulk` shared-to-global (a bulk group);
//   chunked  threads halve in registers and store 16-byte vectors in
//            128-channel slices: slice c0 of every pixel of the chunk, then
//            the next slice (256 contiguous bytes every C * 2).

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 16 * 1024;   // bytes a CTA moves
constexpr int kBarBytes = 128;      // the mbarrier, before the chunk
constexpr int kSmemBytes = kBarBytes + kChunk;

__device__ __forceinline__ uint4 half8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(__low2float(h[i]) * 0.5f,
                                 __high2float(h[i]) * 0.5f);
  return v;
}

// The chunk list: images of H rows of `row` bytes, cut into blocks of TH
// rows (the last may be shorter), each block into chunks of `chunk` bytes
// (its last may be shorter).
struct Geometry {
  int batch, H, TH;
  long long row;     // bytes of one image row, W * C * 2
  int chunk;         // bytes of a full chunk: whole pixels, <= kChunk
  int nH;            // blocks per image
  int per_block;     // chunks of a full block
  int per_image;     // chunks of an image
  long long total;   // chunks in all
};

// Chunk `idx` of the list: its byte offset in x and y, and its bytes.
__device__ __forceinline__ void chunk_at(const Geometry& g, long long idx,
                                         long long& off, int& bytes) {
  const int b = (int)(idx / g.per_image);
  const int r = (int)(idx - (long long)b * g.per_image);
  const int i = min(r / g.per_block, g.nH - 1);
  const int k = r - i * g.per_block;
  const long long block_bytes = (long long)min(g.TH, g.H - i * g.TH) * g.row;
  off = ((long long)b * g.H + (long long)i * g.TH) * g.row +
        (long long)k * g.chunk;
  bytes = (int)min((long long)g.chunk, block_bytes - (long long)k * g.chunk);
}

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
bw_probe_kernel(const unsigned char* __restrict__ x,
                unsigned char* __restrict__ y, Geometry g, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint4* v = reinterpret_cast<uint4*>(smem + kBarBytes);
  const int tid = threadIdx.x;
  long long off;
  int bytes;
  chunk_at(g, blockIdx.x, off, bytes);

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_fence_init();
    mbar_expect_tx(full, bytes);
    bulk_copy(v, x + off, bytes, full);
  }
  __syncthreads();
  mbar_wait(full, 0);
  if (!kChunked) {
    for (int e = tid; e < bytes / 16; e += kThreads) v[e] = half8(v[e]);
    // the bulk store reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(y + off),
          "r"(smem_addr(v)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the chunk must outlive the store that reads it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    uint4* dst = reinterpret_cast<uint4*>(y + off);
    const int cv = C / 8;               // vectors per pixel
    const int pixels = bytes / (2 * C);
    for (int c0 = 0; c0 < cv; c0 += 16) {   // 128 channels = 16 vectors
      const int sw = min(16, cv - c0);
      for (int e = tid; e < pixels * sw; e += kThreads) {
        const int idx = (e / sw) * cv + c0 + e % sw;
        dst[idx] = half8(v[idx]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x, y (B, H, W, C) bf16, contiguous and 16-byte aligned, C % 8 == 0 and a
// pixel no larger than a chunk; mode 0 blocked, 1 chunked; 1 <= TH. Returns
// cudaGetLastError() after the launch.
int bw_probe_launch(int mode, const void* x, void* y, int batch, int H,
                    int W, int C, int TH, void* stream) {
  if (C % 8 != 0 || 2 * C > kChunk || TH < 1 || batch < 1 || H < 1 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0 || mode < 0 ||
      mode > 1)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.batch = batch;
  g.H = H;
  g.TH = TH < H ? TH : H;
  g.row = (long long)W * C * 2;
  g.chunk = kChunk / (2 * C) * (2 * C);   // whole pixels
  g.nH = (H + g.TH - 1) / g.TH;
  g.per_block = (int)((g.TH * g.row + g.chunk - 1) / g.chunk);
  const long long last = (long long)(H - (g.nH - 1) * g.TH) * g.row;
  g.per_image =
      (g.nH - 1) * g.per_block + (int)((last + g.chunk - 1) / g.chunk);
  g.total = (long long)batch * g.per_image;
  if (g.total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)g.total;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* xs = (const unsigned char*)x;
  unsigned char* ys = (unsigned char*)y;
  if (mode == 0)
    bw_probe_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(xs, ys, g, C);
  else
    bw_probe_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(xs, ys, g, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
