// Kernel 2: N adaptor-free, shortcut-free DepthConvBlocks in one persistent
// launch, forward, B=1, bf16 NHWC; the last block's output is optionally
// multiplied by q_last. Same math per block as csrc/dcb.cu (see
// ops/dcb.py for the rounding points); each block's output is rounded to
// bf16 before the next block reads it.
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
//   100 pixels, at most 1/8 extra products whatever N is.
// - Every product runs on wgmma (m64nNk16, bf16 in, fp32 accumulators) with
//   both operands in shared memory. One producer thread streams the block's
//   weights, packed by ops/dcb_chain.py:pack_block as canonical slabs in the
//   order consumed here, with 1-D bulk copies into two rings under
//   full/empty mbarriers: 8 KB W0 slabs (64 k columns) into their own
//   4-slot ring, and W3 / Wf0 / Wf2 slabs (32 k columns) into a 4-slot ring
//   that reuses the window's bytes once stage A no longer reads them. The
//   consumers keep one slab's products in flight while they await the
//   next. Between blocks it prefetches the
//   next block's first W0 slabs before the grid barrier.
// - Two consumer warpgroups split the work: stage A (dc_0) takes 64 window
//   rows each over 64-channel chunks of h, which go fp32 through the
//   depthwise 3x3 into bf16 hb; stage B takes the tile's 64 pixels x half
//   of the output columns each, with an fp32 accumulator that carries u and
//   then y while the 2C hidden width streams through in 64-channel chunks.
// Left for later: sharing a weight slab across more pixels (128-pixel tiles,
// or a 2-CTA cluster with multicast), the 128-byte swizzle, and overlapping
// the epilogues with the next products.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace chain {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

// Must match ops/dcb_chain.py.
constexpr int TILE = 8, WIN = 10, WIN_ROWS = 128, KC = 64, KF = 64;
constexpr int KS_A = 64, KS_B = 32;    // k columns of a W0 slab, of a ring-B slab
constexpr int SH = KC + 4, RING_A = 4, RING_B = 4, BARRIER_BYTES = 256;
// Two consumer warpgroups and one producer warpgroup, of which one thread
// issues the copies. A whole producer warpgroup (not one warp) lets setmaxnreg
// move its registers to the consumers: ptxas budgets a 288-thread block as
// 384 threads (168 registers each), which spilled the C=384 accumulators.
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
// 128 x 72 + 256 x 216 = 384 x 168: what the producer gives up, the
// consumers take. ptxas still reports a few bytes of spill at C=384 and
// C=320 (none at 128 and 256); no split tried removed them at both.
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
constexpr int HCHUNK = WIN * WIN * SH * 4 > 2 * TILE * TILE * KF * 2
                           ? WIN * WIN * SH * 4 : 2 * TILE * TILE * KF * 2;
constexpr int SLAB_A = KC * KS_A * 2;  // bytes of one W0 slab

// Shared memory: window (ring B in stage B) | hb (uc) | ring A | h chunk
// (two f chunks in stage B) | mbarriers. The same for every N; checked
// against the limit on the CPU through ops/dcb_chain.py:smem_bytes.
__host__ __device__ constexpr int smem_bytes(int C) {
  return WIN_ROWS * C * 2 + TILE * TILE * C * 2 + RING_A * SLAB_A + HCHUNK +
         BARRIER_BYTES;
}

__device__ __forceinline__ float wsilu(float v) {
  return v / (1.0f + __expf(-4.0f * v));    // silu(4v)/4
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// Byte offset of element (r, k) in a canonical tile whose rows hold K
// elements (LBO 128, SBO 16 K).
__device__ __forceinline__ int canon(int r, int k, int K) {
  return (r >> 3) * (16 * K) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// A ring of weight slots with one full and one empty mbarrier each. The
// producer and the consumers each keep their own copy and count the slabs
// they have passed through it, in the same order.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;
  int slot_bytes;
  int slots;
  uint32_t count;
  __device__ int slot() const { return count % slots; }
  __device__ uint32_t phase() const { return (count / slots) & 1; }
};

// Producer: wait for a free slot, then one bulk copy into it.
__device__ __forceinline__ void issue(Ring& r, const bf16* src,
                                      uint32_t bytes) {
  const int s = r.slot();
  hop::mbar_wait(&r.empty[s], r.phase() ^ 1);
  hop::mbar_arrive_expect_tx(&r.full[s], bytes);
  hop::bulk_load(r.base + s * r.slot_bytes, src, bytes, &r.full[s]);
  ++r.count;
}

// Consumer warp: this warp no longer reads slot s.
__device__ __forceinline__ void release(const Ring& r, int s, int lane) {
  __syncwarp();
  if (lane == 0) hop::mbar_arrive(&r.empty[s]);
}

// acc += A x B over `slabs` consecutive slabs of ring r, KS k columns each
// (KS / 16 wgmma k steps). a: the A tile's first byte (canonical, SBO
// sbo_a), advanced KS / 8 core matrices a slab; b_off: the warpgroup's
// first byte within a slot (SBO sbo_b). One slab's products stay in flight
// while the next slab is awaited; a slab is released once its products are
// done.
template <int N, int KS, int R>
__device__ __forceinline__ void ring_mma(float (&acc)[R], Ring& r, int lane,
                                         const unsigned char* a,
                                         uint32_t sbo_a, int b_off,
                                         uint32_t sbo_b, int slabs) {
  int prev = -1;
  for (int i = 0; i < slabs; ++i) {
    const int s = r.slot();
    hop::mbar_wait(&r.full[s], r.phase());
    ++r.count;
    hop::wg_fence();
    hop::fence_regs(acc);
    const unsigned char* ai = a + i * (KS / 8) * 128;
    const unsigned char* bi = r.base + s * r.slot_bytes + b_off;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      hop::Wgmma<N>::mma(acc, hop::desc(ai + kk * 256, 128, sbo_a),
                         hop::desc(bi + kk * 256, 128, sbo_b), 1);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(acc);
    if (prev >= 0) release(r, prev, lane);
    prev = s;
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  release(r, prev, lane);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const bf16* x, bf16* y, bf16* s, const bf16* __restrict__ w,
             const bf16* __restrict__ q, int H, int W, int n, int tiles_y,
             int tiles_x) {
  constexpr int NH = C / 2;             // output columns per warpgroup
  constexpr int NA = (C / KC) * (C / KS_A);  // W0 slabs per tile
  constexpr int SLOT_B = KS_B * C * 2;  // bytes of a ring-B slot
  constexpr size_t BLK = 8 * (size_t)C * C + 17 * C;  // elements per block
  static_assert(C % 64 == 0 && RING_B * SLOT_B == WIN_ROWS * C * 2 &&
                2 * KF * KS_B * 2 <= SLOT_B, "layout");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* win = smem;                          // window / ring B
  unsigned char* hb = smem + WIN_ROWS * C * 2;        // hb, then uc
  unsigned char* ring_a = hb + TILE * TILE * C * 2;
  unsigned char* hch_b = ring_a + RING_A * SLAB_A;    // h chunk / f chunks
  float* hch = reinterpret_cast<float*>(hch_b);
  uint64_t* bars = reinterpret_cast<uint64_t*>(hch_b + HCHUNK);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ra{bars, bars + RING_A, ring_a, SLAB_A, RING_A, 0};
  Ring rb{bars + 2 * RING_A, bars + 2 * RING_A + RING_B, win, SLOT_B, RING_B,
          0};
  uint64_t* winfree = bars + 2 * RING_A + 2 * RING_B;
  if (tid == 0) {
    for (int i = 0; i < RING_A; ++i) {
      hop::mbar_init(&ra.full[i], 1);
      hop::mbar_init(&ra.empty[i], kConsumers / 32);
    }
    for (int i = 0; i < RING_B; ++i) {
      hop::mbar_init(&rb.full[i], 1);
      hop::mbar_init(&rb.empty[i], kConsumers / 32);
    }
    hop::mbar_init(winfree, kConsumers / 32);
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int tiles = tiles_y * tiles_x;

  if (warp >= kConsumers / 32) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const bool issuer = warp == kConsumers / 32 && lane == 0;
    uint32_t ntile = 0;
    int pre = 0;              // W0 slabs of this block's first tile in flight
    for (int j = 0; j < n; ++j) {
      const bf16* wj = w + j * BLK;
      if (issuer) {
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          for (int i = (t == (int)blockIdx.x ? pre : 0); i < NA; ++i)
            issue(ra, wj + (size_t)i * KC * KS_A, SLAB_A);
          hop::mbar_wait(winfree, ntile++ & 1);
          const bf16* p = wj + (size_t)C * C;
          for (int k0 = 0; k0 < C; k0 += KS_B, p += KS_B * C)
            issue(rb, p, KS_B * C * 2);
          for (int f0 = 0; f0 < 2 * C; f0 += KF) {
            for (int k0 = 0; k0 < C; k0 += KS_B, p += 2 * KF * KS_B)
              issue(rb, p, 2 * KF * KS_B * 2);
            for (int k0 = 0; k0 < KF; k0 += KS_B, p += KS_B * C)
              issue(rb, p, KS_B * C * 2);
          }
        }
        pre = 0;
        if (j + 1 < n) {
          pre = NA < RING_A ? NA : RING_A;
          for (int i = 0; i < pre; ++i)
            issue(ra, wj + BLK + (size_t)i * KC * KS_A, SLAB_A);
        }
      }
      __syncwarp();
      if (j + 1 < n) cg::this_grid().sync();
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  for (int j = 0; j < n; ++j) {
    // ops/dcb_chain.py:buffer_plan: the last block writes y
    const bf16* src = j == 0 ? x : ((n - j) % 2 == 0 ? y : s);
    bf16* dst = (n - 1 - j) % 2 == 0 ? y : s;
    const bool last = j == n - 1;
    const bf16* tail = w + j * BLK + 8 * (size_t)C * C;
    const bf16* dw = tail;
    const bf16* b0 = tail + 9 * C;
    const bf16* b2 = b0 + C;
    const bf16* b3 = b2 + C;
    const bf16* bf0 = b3 + C;
    const bf16* bf2 = bf0 + 4 * C;

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int ty0 = (t / tiles_x) * TILE, tx0 = (t % tiles_x) * TILE;

      // ---- window: 10x10 pixels, zero outside the frame ----
      for (int i = tid; i < WIN * WIN * (C / 8); i += kConsumers) {
        const int r = i / (C / 8), kc = i - r * (C / 8);
        const int gy = ty0 - 1 + r / WIN, gx = tx0 - 1 + r % WIN;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        hop::cp_async16(win + canon(r, kc * 8, C),
                        in ? src + ((size_t)gy * W + gx) * C + kc * 8 : src,
                        in);
      }
      hop::cp_async_wait_all();
      hop::fence_proxy_async();
      hop::named_bar(1, kConsumers);

      // ---- stage A: h chunks -> hb ----
      for (int c0 = 0; c0 < C; c0 += KC) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        ring_mma<64, KS_A>(acc, ra, lane, win + wg * 8 * (16 * C), 16 * C, 0,
                           KS_A * 16, C / KS_A);
        if (c0 + KC == C) {        // this tile's window is read for the last time
          __syncwarp();
          if (lane == 0) hop::mbar_arrive(winfree);
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = 64 * wg + 16 * wl + g + 8 * ((i >> 1) & 1);
          const int col = 8 * (i >> 2) + 2 * t4;
          if (row < WIN * WIN) {
            const int gy = ty0 - 1 + row / WIN, gx = tx0 - 1 + row % WIN;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
            float2 v;
            v.x = in ? wsilu(acc[i] + f32(b0[c0 + col])) : 0.f;
            v.y = in ? wsilu(acc[i + 1] + f32(b0[c0 + col + 1])) : 0.f;
            *reinterpret_cast<float2*>(hch + row * SH + col) = v;
          }
        }
        hop::named_bar(1, kConsumers);
        // depthwise 3x3 + b2 on the tile's 64 pixels, 8 channels a thread
        for (int u = tid; u < TILE * TILE * (KC / 8); u += kConsumers) {
          const int p = u / (KC / 8), kg = u % (KC / 8);
          const int oy = p / TILE, ox = p % TILE, c = c0 + kg * 8;
          const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b2 + c));
          float a[8];
          {
            const uint32_t* bw = reinterpret_cast<const uint32_t*>(&bv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack2(bw[e]);
              a[2 * e] = f.x;
              a[2 * e + 1] = f.y;
            }
          }
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int row = (oy + tap / 3) * WIN + ox + tap % 3;
            const float4 h0 = *reinterpret_cast<const float4*>(hch + row * SH + kg * 8);
            const float4 h1 = *reinterpret_cast<const float4*>(hch + row * SH + kg * 8 + 4);
            const uint4 wv = __ldg(reinterpret_cast<const uint4*>(dw + tap * C + c));
            const uint32_t* ww = reinterpret_cast<const uint32_t*>(&wv);
            const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack2(ww[e]);
              a[2 * e] += hv[2 * e] * f.x;
              a[2 * e + 1] += hv[2 * e + 1] * f.y;
            }
          }
          uint4 out;
          out.x = pack2(a[0], a[1]);
          out.y = pack2(a[2], a[3]);
          out.z = pack2(a[4], a[5]);
          out.w = pack2(a[6], a[7]);
          *reinterpret_cast<uint4*>(hb + canon(p, c, C)) = out;
        }
        hop::fence_proxy_async();
        hop::named_bar(1, kConsumers);
      }

      // ---- stage B: u = x + b3 + hb W3 ----
      float yacc[NH / 2];
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) yacc[i] = 0.f;
      ring_mma<NH, KS_B>(yacc, rb, lane, hb, 16 * C,
                         wg * (NH / 8) * (KS_B * 16), KS_B * 16, C / KS_B);
#pragma unroll
      for (int i = 0; i < NH / 2; i += 2) {
        const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
        const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
        const int gy = ty0 + p / TILE, gx = tx0 + p % TILE;
        float2 xv = make_float2(0.f, 0.f);
        if (gy < H && gx < W)
          xv = unpack2(__ldcg(reinterpret_cast<const unsigned int*>(
              src + ((size_t)gy * W + gx) * C + col)));
        yacc[i] += xv.x + f32(b3[col]);
        yacc[i + 1] += xv.y + f32(b3[col + 1]);
      }
      hop::named_bar(1, kConsumers);       // both warpgroups done with hb
      // uc = bf16(u) in hb's place; the accumulator goes on as y
#pragma unroll
      for (int i = 0; i < NH / 2; i += 2) {
        const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
        const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
        *reinterpret_cast<uint32_t*>(hb + canon(p, col, C)) =
            pack2(yacc[i], yacc[i + 1]);
        yacc[i] += f32(bf2[col]);
        yacc[i + 1] += f32(bf2[col + 1]);
      }
      hop::fence_proxy_async();
      hop::named_bar(1, kConsumers);

      // ---- FFN: 2C hidden channels, KF at a time ----
      for (int f0 = 0; f0 < 2 * C; f0 += KF) {
        float fa[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) fa[i] = 0.f;
        ring_mma<64, KS_B>(fa, rb, lane, hb, 16 * C, wg * 8 * (KS_B * 16),
                           KS_B * 16, C / KS_B);
        // columns 0..31 of fa are half a, 32..63 the matching half b
        unsigned char* fch = hch_b + ((f0 / KF) & 1) * (TILE * TILE * KF * 2);
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
          const int hc = 32 * wg + 8 * (i >> 2) + 2 * t4;
          const float v0 = wsilu(fa[i] + f32(bf0[f0 + hc])) +
                           wsilu(fa[i + 16] + f32(bf0[2 * C + f0 + hc]));
          const float v1 = wsilu(fa[i + 1] + f32(bf0[f0 + hc + 1])) +
                           wsilu(fa[i + 17] + f32(bf0[2 * C + f0 + hc + 1]));
          *reinterpret_cast<uint32_t*>(fch + canon(p, hc, KF)) = pack2(v0, v1);
        }
        hop::fence_proxy_async();
        hop::named_bar(1, kConsumers);
        ring_mma<NH, KS_B>(yacc, rb, lane, fch, KF * 16,
                           wg * (NH / 8) * (KS_B * 16), KS_B * 16, KF / KS_B);
      }

      // ---- epilogue: [* q] -> the block's output ----
#pragma unroll
      for (int i = 0; i < NH / 2; i += 2) {
        const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
        const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
        const int gy = ty0 + p / TILE, gx = tx0 + p % TILE;
        if (gy < H && gx < W) {
          float v0 = yacc[i], v1 = yacc[i + 1];
          if (last && q != nullptr) {
            v0 *= f32(q[col]);
            v1 *= f32(q[col + 1]);
          }
          *reinterpret_cast<uint32_t*>(dst + ((size_t)gy * W + gx) * C + col) =
              pack2(v0, v1);
        }
      }
      hop::named_bar(1, kConsumers);       // ring B may take the window again
    }
    if (j + 1 < n) cg::this_grid().sync();
  }
}

template <int C>
int launch(const void* x, void* y, void* s, const void* w, const void* q,
           int H, int W, int n, cudaStream_t stream) {
  if (n <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  int tiles_y = (H + TILE - 1) / TILE, tiles_x = (W + TILE - 1) / TILE;
  const int smem = smem_bytes(C);
  auto kern = chain_kernel<C>;
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
  const int tiles = tiles_y * tiles_x;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  bf16* sp = static_cast<bf16*>(s);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* qp = static_cast<const bf16*>(q);
  void* args[] = {&xp, &yp, &sp, &wp, &qp, &H, &W, &n, &tiles_y, &tiles_x};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace chain

extern "C" int ssgvc_dcb_chain_forward(const void* x, void* y, void* s,
                                       const void* w, const void* q, int H,
                                       int W, int C, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return chain::launch<128>(x, y, s, w, q, H, W, n, st);
    case 256: return chain::launch<256>(x, y, s, w, q, H, W, n, st);
    case 320: return chain::launch<320>(x, y, s, w, q, H, W, n, st);
    case 384: return chain::launch<384>(x, y, s, w, q, H, W, n, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
