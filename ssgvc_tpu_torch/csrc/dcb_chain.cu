// Kernel 2: N adaptor-free, shortcut-free DepthConvBlocks in one persistent
// launch, forward, bf16 NHWC (B, H, W, C); the last block's output is
// optionally multiplied by q_last. Each block runs the per-tile routine of
// csrc/dcb_tile.cuh (the math and rounding points of ops/dcb.py); each
// block's output is rounded to bf16 before the next block reads it.
//
// Replaces the TPU kernel _chain_kernel (ssgvc_tpu/ops/pallas_dcb_chain.py,
// reached through _chain_call / pl.pallas_call).
//
// Bound on an H100 SXM: compute. A block is 16 C^2 + 18 C operations per
// pixel: the N=4 chain at 136x240, C=256 is 137.5 GFLOP, at least 139 us at
// 989 TFLOP/s bf16 dense, while its input and output are 33 MB (10 us at
// 3.35 TB/s).
//
// What the design does about it:
// - One cooperative launch walks the blocks j = 0 .. N-1; for each, every
//   thread block walks its share of the 8x8 output tiles, and a grid-wide
//   barrier separates block j from block j+1. Activations move between the
//   caller's y and one scratch tensor (ops/dcb_chain.py:buffer_plan), both
//   L2-resident at the main path's sizes, so no halo of N pixels is carried:
//   a tile reads a 10x10 window (one-pixel halo) and recomputes dc_0 on its
//   100 pixels, at most 1/8 extra products whatever N is. A batch is B x
//   tiles per block, each tile's halo inside its own image, and still one
//   grid barrier per block.
// - Per tile, wgmma on canonical weight slabs that one producer thread
//   streams by bulk copies into two mbarrier rings, feeding two consumer
//   warpgroups (csrc/dcb_tile.cuh). Between blocks the producer prefetches
//   the next block's first W0 slabs before the grid barrier.
// Left for later: sharing a weight slab across more pixels (128-pixel tiles,
// or a 2-CTA cluster with multicast), the 128-byte swizzle, and overlapping
// the epilogues with the next products.
//
// Widths: every C that is a multiple of 8 from 8 to 384, computed at CP (C
// rounded up to 64): per CP an instance for C == CP and one with the real C
// passed at run time, as in csrc/dcb.cu.

#include <cooperative_groups.h>

#include "dcb_tile.cuh"

namespace chain {

namespace cg = cooperative_groups;
using namespace dcbt;

template <int CP, bool Padded>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const bf16* x, bf16* y, bf16* s, const bf16* __restrict__ w,
             const bf16* __restrict__ q, int C, int H, int W, int n,
             int tiles_y, int tiles_x, int batch) {
  constexpr int NA = (CP / KC) * (CP / KS_A);  // W0 slabs per tile
  constexpr size_t BLK = 8 * (size_t)CP * CP + 17 * CP;  // elements per block

  extern __shared__ __align__(128) unsigned char smem[];
  Smem<CP> sm(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) sm.init_barriers();
  __syncthreads();

  const int tiles = tiles_y * tiles_x, total = batch * tiles;

  if (warp >= kConsumers / 32) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const bool issuer = warp == kConsumers / 32 && lane == 0;
    uint32_t ntile = 0;
    int pre = 0;              // W0 slabs of this block's first tile in flight
    for (int j = 0; j < n; ++j) {
      const bf16* wj = w + j * BLK;
      if (issuer) {
        for (int t = blockIdx.x; t < total; t += gridDim.x)
          produce_tile<CP>(sm, wj, t == (int)blockIdx.x ? pre : 0, ntile);
        pre = 0;
        if (j + 1 < n) {
          pre = NA < RING_A ? NA : RING_A;
          for (int i = 0; i < pre; ++i)
            issue(sm.ra, wj + BLK + (size_t)i * KC * KS_A, SLAB_A);
        }
      }
      __syncwarp();
      if (j + 1 < n) cg::this_grid().sync();
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  for (int j = 0; j < n; ++j) {
    // ops/dcb_chain.py:buffer_plan: the last block writes y
    const bf16* src = j == 0 ? x : ((n - j) % 2 == 0 ? y : s);
    bf16* dst = (n - 1 - j) % 2 == 0 ? y : s;
    const bf16* qj = j == n - 1 ? q : nullptr;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / tiles, tt = t - b * tiles, y_lo = b * H;
      consume_tile<CP, false, Padded>(sm, src, dst, w + j * BLK, qj, C,
                                      y_lo, y_lo + H, W,
                                      y_lo + (tt / tiles_x) * TILE,
                                      (tt % tiles_x) * TILE, tid);
    }
    if (j + 1 < n) cg::this_grid().sync();
  }
}

template <int CP, bool Padded>
int launch_kernel(const void* x, void* y, void* s, const void* w,
                  const void* q, int B, int H, int W, int C, int n,
                  cudaStream_t stream) {
  if (n <= 0 || B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  int tiles_y = (H + TILE - 1) / TILE, tiles_x = (W + TILE - 1) / TILE;
  const int smem = smem_bytes(CP);
  auto kern = chain_kernel<CP, Padded>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int total = B * tiles_y * tiles_x;
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  bf16* sp = static_cast<bf16*>(s);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* qp = static_cast<const bf16*>(q);
  void* args[] = {&xp, &yp, &sp, &wp, &qp, &C, &H, &W, &n, &tiles_y,
                  &tiles_x, &B};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int CP>
int launch(const void* x, void* y, void* s, const void* w, const void* q,
           int B, int H, int W, int C, int n, cudaStream_t stream) {
  return C == CP
             ? launch_kernel<CP, false>(x, y, s, w, q, B, H, W, C, n, stream)
             : launch_kernel<CP, true>(x, y, s, w, q, B, H, W, C, n, stream);
}

}  // namespace chain

extern "C" int ssgvc_dcb_chain_forward(const void* x, void* y, void* s,
                                       const void* w, const void* q, int B,
                                       int H, int W, int C, int n,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 8 || C > 384 || C % 8) return cudaErrorInvalidValue;
  switch (dcbt::padded(C)) {
    case 64: return chain::launch<64>(x, y, s, w, q, B, H, W, C, n, st);
    case 128: return chain::launch<128>(x, y, s, w, q, B, H, W, C, n, st);
    case 192: return chain::launch<192>(x, y, s, w, q, B, H, W, C, n, st);
    case 256: return chain::launch<256>(x, y, s, w, q, B, H, W, C, n, st);
    case 320: return chain::launch<320>(x, y, s, w, q, B, H, W, C, n, st);
    case 384: return chain::launch<384>(x, y, s, w, q, B, H, W, C, n, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
