// Kernel 2: N adaptor-free, shortcut-free DepthConvBlocks in one launch,
// forward, B=1, bf16; the last block's output is optionally multiplied by
// q_last.
//
// Replaces the TPU kernel _chain_kernel (ssgvc_tpu/ops/pallas_dcb_chain.py,
// reached through _chain_call / pl.pallas_call). Same math per block as
// csrc/dcb.cu; each block's output is rounded to bf16 before the next block
// reads it, as on the TPU.
//
// Bound on an H100 SXM: N times the single block's, compute: the N=4 chain
// at 136x240, C=256 is 137.5 GFLOP, at least 139 us at 989 TFLOP/s bf16
// dense; the chain's input and output are 33 MB (10 us at 3.35 TB/s).
//
// What the design does about it: the tile's activations stay in shared
// memory for all N blocks (one read of x, one write of y), every product
// runs on the tensor cores. The input tile carries a halo of N pixels on all
// four sides and each block's live region shrinks by one pixel per side, so
// the chain recomputes its halo instead of exchanging it; the price is extra
// work that grows with N and shrinks with the tile. ops/dcb_chain.py picks
// the largest tile whose working set fits in 227 KB and splits a chain that
// no tile fits. Left for later: wgmma, TMA, and an L2-resident variant that
// trades the recomputed halo for a grid-wide barrier between blocks.

#include "dcb_core.cuh"

template <int C>
__global__ void __launch_bounds__(dcb::kThreads, 1)
dcb_chain_kernel(const dcb::bf16* __restrict__ x, dcb::bf16* __restrict__ y,
                 const dcb::bf16* __restrict__ w,
                 const dcb::bf16* __restrict__ q, int H, int W, int n, int th,
                 int tw) {
  dcb::run_tile<C>(x, y, w, q, H, W, n, th, tw, false);
}

template <int C>
static int launch(const void* x, void* y, const void* w, const void* q, int H,
                  int W, int n, int th, int tw, int smem,
                  cudaStream_t stream) {
  if (n <= 0 || th <= 0 || tw <= 0 || H <= 0 || W <= 0 ||
      dcb::smem_bytes(C, n, th, tw) != smem)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dcb_chain_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  dcb_chain_kernel<C><<<grid, dcb::kThreads, smem, stream>>>(
      static_cast<const dcb::bf16*>(x), static_cast<dcb::bf16*>(y),
      static_cast<const dcb::bf16*>(w), static_cast<const dcb::bf16*>(q), H, W,
      n, th, tw);
  return cudaGetLastError();
}

extern "C" int ssgvc_dcb_chain_forward(const void* x, void* y, const void* w,
                                       const void* q, int H, int W, int C,
                                       int n, int th, int tw, int smem,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128>(x, y, w, q, H, W, n, th, tw, smem, s);
    case 256: return launch<256>(x, y, w, q, H, W, n, th, tw, smem, s);
    case 320: return launch<320>(x, y, w, q, H, W, n, th, tw, smem, s);
    case 384: return launch<384>(x, y, w, q, H, W, n, th, tw, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
