// Kernel 1: one DepthConvBlock after its adaptor, forward, bf16 NHWC
// (B, H, W, C), with the optional shortcut (+ x) and per-channel q (* q) of
// the output.
// Runs the per-tile routine of csrc/dcb_tile.cuh (the math and rounding
// points of ops/dcb.py).
//
// Replaces the TPU kernel _dcb_kernel (ssgvc_tpu/ops/pallas_dcb.py:68,
// reached through _dcb_fused / pl.pallas_call).
//
// Bound on an H100 SXM: compute. 16 C^2 + 18 C operations per pixel against
// 4 C bytes moved: a 136x240 frame at C=256 is 34.4 GFLOP, at least 35 us
// at 989 TFLOP/s bf16 dense, while its 33 MB of activations take 10 us at
// 3.35 TB/s.
//
// What the design does about it: every product runs on wgmma with both
// operands in shared memory and no intermediate leaves the SM, so the
// kernel reads x once (and a one-pixel halo) and writes y once. A persistent
// grid, one 384-thread block per SM, walks the 8x8 output tiles; per tile, a
// producer thread streams the block's canonical weight slabs by bulk copies
// into mbarrier rings that feed two consumer warpgroups, and runs into the
// next tile's W0 slabs while the consumers finish this tile's FFN
// (csrc/dcb_tile.cuh). Each tile still copies the block's 8 C^2 bf16
// weights into shared memory once. A batch is B x tiles: tile t belongs to
// image t / tiles, and its halo reads that image alone (rows and columns -1,
// H and W are zero padding for each image, as at B=1). Left for later:
// sharing a weight slab across more pixels (128-pixel tiles, or a 2-CTA
// cluster with multicast).
//
// Widths: every C that is a multiple of 8 from 8 to 512, computed at CP (C
// rounded up to 64: 64, 128, ..., 384, and 512 for every C over 384): per
// CP an instance for C == CP and one with the real C passed at run time
// (csrc/dcb_tile.cuh). C = 368 is computed at 384 with zero-padded weights
// (8.9% more products than its own), C = 448 at 512 (31%), C = 8 at 64
// (64x); C = 512 holds a 104-row window and a 3-slot ring B to fit in
// shared memory, CP = 64 a ring B of its own.

#include "dcb_tile.cuh"

namespace single {

using namespace dcbt;

template <int CP, bool Shortcut, bool Padded>
__global__ void __launch_bounds__(kThreads, 1)
dcb_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
           const bf16* __restrict__ w, const bf16* __restrict__ q, int C,
           int H, int W, int tiles_x, int tiles, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<CP> sm(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      uint32_t ntile = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x)
        produce_tile<CP>(sm, w, 0, ntile);
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int b = t / tiles, tt = t - b * tiles, y_lo = b * H;
    consume_tile<CP, Shortcut, Padded>(sm, x, y, w, q, C, y_lo, y_lo + H,
                                       W, y_lo + (tt / tiles_x) * TILE,
                                       (tt % tiles_x) * TILE, tid);
  }
}

template <int CP, bool Shortcut, bool Padded>
int launch_kernel(const void* x, void* y, const void* w, const void* q, int B,
                  int H, int W, int C, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles = (H + TILE - 1) / TILE * tiles_x;
  const int total = B * tiles;
  const int smem = smem_bytes(CP);
  auto kern = dcb_kernel<CP, Shortcut, Padded>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  kern<<<total < sms ? total : sms, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(w), static_cast<const bf16*>(q), C, H, W,
      tiles_x, tiles, total);
  return cudaGetLastError();
}

template <int CP>
int launch(const void* x, void* y, const void* w, const void* q, int B, int H,
           int W, int C, int shortcut, cudaStream_t stream) {
  auto kern = C == CP ? (shortcut ? launch_kernel<CP, true, false>
                                  : launch_kernel<CP, false, false>)
                      : (shortcut ? launch_kernel<CP, true, true>
                                  : launch_kernel<CP, false, true>);
  return kern(x, y, w, q, B, H, W, C, stream);
}

}  // namespace single

extern "C" int ssgvc_dcb_forward(const void* x, void* y, const void* w,
                                 const void* q, int B, int H, int W, int C,
                                 int shortcut, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 8 || C > 512 || C % 8) return cudaErrorInvalidValue;
  switch (dcbt::padded(C)) {
    case 64: return single::launch<64>(x, y, w, q, B, H, W, C, shortcut, s);
    case 128: return single::launch<128>(x, y, w, q, B, H, W, C, shortcut, s);
    case 192: return single::launch<192>(x, y, w, q, B, H, W, C, shortcut, s);
    case 256: return single::launch<256>(x, y, w, q, B, H, W, C, shortcut, s);
    case 320: return single::launch<320>(x, y, w, q, B, H, W, C, shortcut, s);
    case 384: return single::launch<384>(x, y, w, q, B, H, W, C, shortcut, s);
    case 512: return single::launch<512>(x, y, w, q, B, H, W, C, shortcut, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
