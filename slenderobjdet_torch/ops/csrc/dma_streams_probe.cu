// Read-bandwidth probe: each block reads one (TH, W, C) tile of x through
// shared memory, with every chunk of the copy split into N bulk asynchronous
// copies in flight together, and writes a small token computed from the tile.
//
// Replaces: tools/dma_streams_probe.py `run.one` (the Pallas kernel at
// :28-43 splits a tile's HBM->VMEM copy into N concurrent DMAs on one
// semaphore each). The TPU tile (TH, W, C) = 6.9 MB at TH = 40 never fits in
// the 227 KB of shared memory a Hopper block may use, so the tile streams
// through a ring of kStages chunks of kChunk bytes; each chunk is N
// `cp.async.bulk` copies (the TMA engine's plain byte copy) that complete on
// the chunk's mbarrier. The question the probe asks stays the TPU one: does
// splitting one copy into N concurrent ones raise read bandwidth?
//
// What bounds it on an H100: device-memory read bandwidth (3.35 TB/s
// published peak for the SXM part). Each block keeps up to kStages x kChunk
// = 96 KB in flight, two blocks fit on an SM, and the writes are 4 KB a tile.
//
// Token: out[b, i, r, c] = sum over w < 8 of tile[r, w, c] * 1e-6 for
// r < 8, c < 128 (the TPU kernel's `sum(xbuf[:8, :8, :128], axis=1) *
// 1e-6`), summed in fp32 in w order; one token per tile, so every block's
// read is checked.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kChunk = 48 * 1024;   // bytes per ring slot
constexpr int kBarBytes = 128;      // the ring's mbarriers, before the slots
constexpr int kSmemBytes = kBarBytes + kStages * kChunk;

// grid (nH, B): block (i, b) reads rows [i * TH, (i + 1) * TH) of image b.
__global__ void __launch_bounds__(kThreads)
dma_streams_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                   int H, int W, int C, int TH, int nstreams) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  const int i = blockIdx.x, b = blockIdx.y, nH = gridDim.x;
  const int tid = threadIdx.x;
  const long long row = (long long)W * C;              // elements
  const long long tile_bytes = (long long)TH * row * 2;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      x + ((long long)b * H + (long long)i * TH) * row);
  const int nchunks = (int)((tile_bytes + kChunk - 1) / kChunk);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 posts chunk k: the byte count on the slot's barrier, then the
  // chunk as nstreams bulk copies of 16-byte multiples.
  auto post = [&](int k) {
    const int slot = k % kStages;
    const int bytes =
        (int)min((long long)kChunk, tile_bytes - (long long)k * kChunk);
    mbar_expect_tx(&bars[slot], bytes);
    const int piece = ((bytes + nstreams - 1) / nstreams + 15) / 16 * 16;
    for (int off = 0; off < bytes; off += piece)
      bulk_copy(ring + slot * kChunk + off, src + (long long)k * kChunk + off,
                min(piece, bytes - off), &bars[slot]);
  };
  if (tid == 0)
    for (int k = 0; k < kStages && k < nchunks; ++k) post(k);

  // token pairs (r, c): tid + 256 j for j < 4
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < nchunks; ++k) {
    const int slot = k % kStages;
    mbar_wait(&bars[slot], (uint32_t)((k / kStages) & 1));
    const long long lo = (long long)k * (kChunk / 2);   // first element
    const long long hi =
        lo + min((long long)kChunk, tile_bytes - (long long)k * kChunk) / 2;
    if (lo < 7 * row + 8LL * C) {   // the token's elements lie in rows < 8
      const __nv_bfloat16* v =
          reinterpret_cast<const __nv_bfloat16*>(ring + slot * kChunk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pr = tid + kThreads * j, r = pr / 128, c = pr % 128;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const long long e = r * row + (long long)w * C + c;
          if (e >= lo && e < hi) acc[j] += __bfloat162float(v[e - lo]);
        }
      }
    }
    __syncthreads();   // every thread is done with the slot before its refill
    if (tid == 0 && k + kStages < nchunks) post(k + kStages);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pr = tid + kThreads * j;
    out[(((long long)b * nH + i) * 8 + pr / 128) * 128 + pr % 128] =
        acc[j] * 1e-6f;
  }
}

}  // namespace

extern "C" {

// x (B, H, W, C) bf16, contiguous, 16-byte aligned, C % 8 == 0, C >= 128,
// W >= 8, 8 <= TH <= H; out (B, H / TH, 8, 128) float32. Reads the first
// (H / TH) * TH rows of each image. Returns cudaGetLastError() after the
// launch.
int dma_streams_launch(const void* x, void* out, int batch, int H, int W,
                       int C, int TH, int nstreams, void* stream) {
  if (C % 8 != 0 || C < 128 || W < 8 || TH < 8 || TH > H || nstreams < 1 ||
      (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dma_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / TH, batch);
  dma_streams_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (float*)out, H, W, C, TH, nstreams);
  return (int)cudaGetLastError();
}

}  // extern "C"
