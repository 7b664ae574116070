// Kernel 1: one DepthConvBlock after its adaptor, forward, B=1, bf16.
//
// Replaces the TPU kernel _dcb_kernel (ssgvc_tpu/ops/pallas_dcb.py, reached
// through _dcb_fused / pl.pallas_call). Same math and rounding points:
// h = wsilu(x W0 + b0) zeroed outside the frame, depthwise 3x3 with zero
// padding in h space, u = x + h W3 + b3, f = wsilu(u Wf0a + bf0a) +
// wsilu(u Wf0b + bf0b), y = u + f Wf2 + bf2 [+ x] [* q].
//
// Bound on an H100 SXM: 16 C^2 + 18 C operations per pixel against 4 C bytes
// moved, so compute: a 136x240 frame at C=256 is 34.4 GFLOP, at least 35 us
// at 989 TFLOP/s bf16 dense, while its 33 MB of activations take 10 us at
// 3.35 TB/s.
//
// What the design does about it: every product goes to the tensor cores
// (mma.sync bf16, fp32 accumulate) and no intermediate leaves the SM, so the
// kernel reads x once and writes y once. The TPU kernel keeps full-width row
// tiles in ~10 MB of VMEM; an SM has 227 KB, so the tile here is 8x8 pixels
// with a one-pixel halo on all four sides (the halo costs 100/64 of the dc_0
// work) and both intermediates of width C or 4C are streamed in channel
// chunks (csrc/dcb_core.cuh). Left for later: wgmma, TMA, staging the
// weights through shared memory, more than one block per SM.

#include "dcb_core.cuh"

template <int C>
__global__ void __launch_bounds__(dcb::kThreads, 1)
dcb_kernel(const dcb::bf16* __restrict__ x, dcb::bf16* __restrict__ y,
           const dcb::bf16* __restrict__ w, const dcb::bf16* __restrict__ q,
           int H, int W, int th, int tw, int shortcut) {
  dcb::run_tile<C>(x, y, w, q, H, W, 1, th, tw, shortcut != 0);
}

template <int C>
static int launch(const void* x, void* y, const void* w, const void* q, int H,
                  int W, int th, int tw, int shortcut, int smem,
                  cudaStream_t stream) {
  if (th <= 0 || tw <= 0 || H <= 0 || W <= 0 ||
      dcb::smem_bytes(C, 1, th, tw) != smem)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dcb_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  dcb_kernel<C><<<grid, dcb::kThreads, smem, stream>>>(
      static_cast<const dcb::bf16*>(x), static_cast<dcb::bf16*>(y),
      static_cast<const dcb::bf16*>(w), static_cast<const dcb::bf16*>(q), H, W,
      th, tw, shortcut);
  return cudaGetLastError();
}

extern "C" int ssgvc_dcb_forward(const void* x, void* y, const void* w,
                                 const void* q, int H, int W, int C, int th,
                                 int tw, int shortcut, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128>(x, y, w, q, H, W, th, tw, shortcut, smem, s);
    case 256: return launch<256>(x, y, w, q, H, W, th, tw, shortcut, smem, s);
    case 320: return launch<320>(x, y, w, q, H, W, th, tw, shortcut, smem, s);
    case 384: return launch<384>(x, y, w, q, H, W, th, tw, shortcut, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
