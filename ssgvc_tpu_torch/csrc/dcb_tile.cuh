// One DepthConvBlock on one 8x8 output tile of one image, forward, bf16
// NHWC: the per-tile routine of both kernels (csrc/dcb.cu, one block;
// csrc/dcb_chain.cu, N blocks). Same math and rounding points as
// ops/dcb.py:dcb_plain:
// h = wsilu(x W0 + b0) zeroed outside the frame, depthwise 3x3 with zero
// padding in h space, u = x + h W3 + b3, f = wsilu(u Wf0a + bf0a) +
// wsilu(u Wf0b + bf0b), y = u + f Wf2 + bf2 [+ x] [* q], rounded once.
//
// A thread block has 384 threads: two consumer warpgroups and one producer
// warpgroup, of which one thread issues the copies.
// - The tile reads a 10x10 window of its input (one-pixel halo, zero outside
//   the frame) and recomputes dc_0 on its 100 pixels.
// - Every product runs on wgmma (m64nNk16, bf16 in, fp32 accumulators) with
//   both operands in shared memory. The producer streams the block's weights,
//   packed by ops/dcb.py:pack_block as canonical slabs in the order consumed
//   here, with 1-D bulk copies into two rings under full/empty mbarriers:
//   8 KB W0 slabs (64 k columns) into their own 4-slot ring, and W3 / Wf0 /
//   Wf2 slabs (32 k columns) into a 4-slot ring that reuses the window's bytes
//   once stage A no longer reads them. The consumers keep one slab's products
//   in flight while they await the next. Ring A frees as soon as stage A is
//   done, so the producer runs into the next tile's W0 slabs while the
//   consumers finish this tile's FFN.
// - Stage A (dc_0) gives each consumer warpgroup 64 window rows over
//   64-channel chunks of h, which go fp32 through the depthwise 3x3 into
//   bf16 hb; stage B gives each the tile's 64 pixels x half of the output
//   columns, with an fp32 accumulator that carries u and then y while the 2C
//   hidden width streams through in 64-channel chunks.
// - A block of C channels (a multiple of 8, 8 to 512) is computed at CP, C
//   rounded up to a multiple of 64, and at 512 above 384 (C = 368 runs at
//   384, C = 8 at 64, C = 392-448 at 512: there is no CP = 448): per
//   CP one instance for C == CP, where C is the constant CP (every full-
//   profile width but 368), and one (Padded) taking the real C at run
//   time; the tests of which columns are real cost the full widths 2-16%
//   when C is not known to the compiler. ops/dcb.py:pack_block
//   gives the padded channels zero weights and biases, so they stay exactly
//   0 (wsilu(0) = 0) and add nothing; the frame is read and written at its
//   real C, and the window's padded channels are zero-filled.
// - From CP = 128 to 384 the window holds WIN_ROWS rows and ring B 4 slots
//   in its bytes. At CP = 512 that is over the shared-memory limit, so the
//   window holds 104 rows (13 core-matrix groups, its 100 pixels) and ring
//   B 3 slots; stage A's second 64-row wgmma tile then reads its rows
//   104-127 from hb's bytes, and their results, like those of rows 100-103,
//   belong to no pixel and are dropped. At CP = 64 a ring-B slot must hold
//   a 2 KF x KS_B Wf0 slab (8 KiB), twice a CP x KS_B one, and four such
//   slots do not fit in the 16 KiB window: ring B has bytes of its own.

#pragma once

#include "hopper.cuh"
#include "wgmma.cuh"

namespace dcbt {

typedef __nv_bfloat16 bf16;

// Must match ops/dcb.py.
constexpr int TILE = 8, WIN = 10, WIN_ROWS = 128, KC = 64, KF = 64;
constexpr int KS_A = 64, KS_B = 32;    // k columns of a W0 slab, of a ring-B slab
constexpr int SH = KC + 4, RING_A = 4, BARRIER_BYTES = 256;
// A whole producer warpgroup (not one warp) lets setmaxnreg move its
// registers to the consumers: ptxas budgets a 288-thread block as 384
// threads (168 registers each), which spilled the C=384 accumulators.
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
// 128 x 72 + 256 x 216 = 384 x 168: what the producer gives up, the
// consumers take.
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
constexpr int HCHUNK = WIN * WIN * SH * 4 > 2 * TILE * TILE * KF * 2
                           ? WIN * WIN * SH * 4 : 2 * TILE * TILE * KF * 2;
constexpr int SLAB_A = KC * KS_A * 2;  // bytes of one W0 slab

// The plan of a block of C channels (must match ops/dcb.py:
// padded_channels, window_rows, ring_b, slot_b, ring_b_own): the computed
// width, the window rows held in shared memory, the ring-B slots, their
// bytes (the larger of a CP x KS_B slab and a 2 KF x KS_B Wf0 slab), and
// whether ring B needs bytes of its own (CP = 64) rather than the window's.
__host__ __device__ constexpr int padded(int C) {
  return C > 384 ? 512 : (C + KC - 1) / KC * KC;
}
__host__ __device__ constexpr int win_rows(int C) {
  return padded(C) > 384 ? 104 : WIN_ROWS;
}
__host__ __device__ constexpr int ring_b(int C) {
  return padded(C) > 384 ? 3 : 4;
}
__host__ __device__ constexpr int slot_b(int C) {
  return KS_B * padded(C) * 2 > 2 * KF * KS_B * 2 ? KS_B * padded(C) * 2
                                                  : 2 * KF * KS_B * 2;
}
__host__ __device__ constexpr bool ring_b_own(int C) {
  return ring_b(C) * slot_b(C) > win_rows(C) * padded(C) * 2;
}

// Shared memory: window (ring B in stage B) | hb (uc) | ring A | h chunk
// (two f chunks in stage B) | [ring B, at CP = 64] | mbarriers. Checked
// against the limit on the CPU through ops/dcb.py:smem_bytes.
__host__ __device__ constexpr int smem_bytes(int C) {
  return win_rows(C) * padded(C) * 2 + TILE * TILE * padded(C) * 2 +
         RING_A * SLAB_A + HCHUNK +
         (ring_b_own(C) ? ring_b(C) * slot_b(C) : 0) + BARRIER_BYTES;
}

__device__ __forceinline__ float wsilu(float v) {
  return v / (1.0f + __expf(-4.0f * v));    // silu(4v)/4
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// Two consecutive bf16 weights at p (4-byte aligned), as floats.
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

// Two consecutive bf16 activations at p (4-byte aligned), as floats, through
// L2: in a chain, src was written earlier in the same launch.
__device__ __forceinline__ float2 ld2_cg(const bf16* p) {
  return unpack2(__ldcg(reinterpret_cast<const unsigned int*>(p)));
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

// One thread's view of the thread block's shared memory: the buffers, both
// rings and the "window free" mbarrier, which the consumers arrive on once
// stage A has read the window for the last time. CP: the computed width.
template <int CP>
struct Smem {
  static constexpr int RB = ring_b(CP), WR = win_rows(CP);
  static constexpr int SLOT_B = slot_b(CP);    // bytes of a ring-B slot
  static constexpr bool OWN_B = ring_b_own(CP);
  static_assert(CP % KC == 0 && CP == padded(CP), "computed width");
  static_assert(WR % 8 == 0 && WR >= WIN * WIN &&
                (OWN_B || RB * SLOT_B <= WR * CP * 2) &&
                KS_B * CP * 2 <= SLOT_B && 2 * KF * KS_B * 2 <= SLOT_B &&
                RB * 2 + RING_A * 2 + 1 <= BARRIER_BYTES / 8 &&
                smem_bytes(CP) <= 232448, "layout");
  unsigned char* win;      // window / ring B
  unsigned char* hb;       // hb, then uc
  unsigned char* hch_b;    // h chunk (fp32) / two f chunks
  Ring ra, rb;
  uint64_t* winfree;

  __device__ explicit Smem(unsigned char* smem) {
    win = smem;
    hb = smem + WR * CP * 2;
    unsigned char* ring_a = hb + TILE * TILE * CP * 2;
    hch_b = ring_a + RING_A * SLAB_A;
    unsigned char* ring_b_base = OWN_B ? hch_b + HCHUNK : win;
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        hch_b + HCHUNK + (OWN_B ? RB * SLOT_B : 0));
    ra = Ring{bars, bars + RING_A, ring_a, SLAB_A, RING_A, 0};
    rb = Ring{bars + 2 * RING_A, bars + 2 * RING_A + RB, ring_b_base, SLOT_B,
              RB, 0};
    winfree = bars + 2 * RING_A + 2 * RB;
  }

  // One thread, before the thread block's first barrier.
  __device__ void init_barriers() {
    for (int i = 0; i < RING_A; ++i) {
      hop::mbar_init(&ra.full[i], 1);
      hop::mbar_init(&ra.empty[i], kConsumers / 32);
    }
    for (int i = 0; i < RB; ++i) {
      hop::mbar_init(&rb.full[i], 1);
      hop::mbar_init(&rb.empty[i], kConsumers / 32);
    }
    hop::mbar_init(winfree, kConsumers / 32);
    hop::mbar_fence_init();
  }
};

// Producer (one thread): one tile's weight slabs of the block at w, in the
// order consume_tile takes them. The first `skip_a` W0 slabs are already in
// flight; ntile counts the tiles this thread has fed.
template <int CP>
__device__ __forceinline__ void produce_tile(Smem<CP>& s, const bf16* w,
                                             int skip_a, uint32_t& ntile) {
  constexpr int NA = (CP / KC) * (CP / KS_A);  // W0 slabs per tile
  for (int i = skip_a; i < NA; ++i)
    issue(s.ra, w + (size_t)i * KC * KS_A, SLAB_A);
  hop::mbar_wait(s.winfree, ntile++ & 1);
  const bf16* p = w + (size_t)CP * CP;
  for (int k0 = 0; k0 < CP; k0 += KS_B, p += KS_B * CP)
    issue(s.rb, p, KS_B * CP * 2);
  for (int f0 = 0; f0 < 2 * CP; f0 += KF) {
    for (int k0 = 0; k0 < CP; k0 += KS_B, p += 2 * KF * KS_B)
      issue(s.rb, p, 2 * KF * KS_B * 2);
    for (int k0 = 0; k0 < KF; k0 += KS_B, p += KS_B * CP)
      issue(s.rb, p, KS_B * CP * 2);
  }
}

// Consumers (the 256 threads tid of both consumer warpgroups): the block at
// w on the 8x8 tile whose first output pixel is (ty0, tx0), reading src and
// writing dst, a batch stacked as (B H) x W x C: the tile's image holds rows
// [y_lo, y_hi), and every other row is zero padding to this tile, so its
// halo never reads a neighbouring image. src and dst stay the batch's base
// pointers (kernel parameters in csrc/dcb.cu, so no per-image pointer is
// held in registers through the FFN); only the row bounds move. With
// Shortcut the output adds src at the output pixel; q, if not null, then
// multiplies it. Out-of-frame pixels of a ragged tile, and the padded
// channels [C, CP) of a block computed at CP > C, are neither read nor
// written. Padded: C (c_arg) may be below CP; else C is CP.
template <int CP, bool Shortcut, bool Padded>
__device__ __forceinline__ void consume_tile(Smem<CP>& s, const bf16* src,
                                             bf16* dst, const bf16* w,
                                             const bf16* q, int c_arg,
                                             int y_lo, int y_hi, int W,
                                             int ty0, int tx0, int tid) {
  const int C = Padded ? c_arg : CP;
  constexpr int NH = CP / 2;            // output columns per warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* tail = w + 8 * (size_t)CP * CP;
  const bf16* dw = tail;
  const bf16* b0 = tail + 9 * CP;
  const bf16* b2 = b0 + CP;
  const bf16* b3 = b2 + CP;
  const bf16* bf0 = b3 + CP;
  const bf16* bf2 = bf0 + 4 * CP;
  float* hch = reinterpret_cast<float*>(s.hch_b);
  // Whether accumulator element i holds a real output column: its group of
  // 8 columns starts below C (C is a multiple of 8).
  auto real = [&](int i) { return !Padded || wg * NH + 8 * (i >> 2) < C; };

  // ---- window: 10x10 pixels, zero outside the frame ----
  // Not unrolled: the peeled first iterations' indices depend on tid alone,
  // so the compiler hoisted them out of the tile loop and spilled them.
#pragma unroll 1
  for (int i = tid; i < WIN * WIN * (CP / 8); i += kConsumers) {
    const int r = i / (CP / 8), kc = i - r * (CP / 8);
    const int gy = ty0 - 1 + r / WIN, gx = tx0 - 1 + r % WIN;
    const bool in = gy >= y_lo && gy < y_hi && gx >= 0 && gx < W &&
                    (!Padded || kc * 8 < C);
    hop::cp_async16(s.win + canon(r, kc * 8, CP),
                    in ? src + ((size_t)gy * W + gx) * C + kc * 8 : src, in);
  }
  hop::cp_async_wait_all();
  hop::fence_proxy_async();
  hop::named_bar(1, kConsumers);

  // ---- stage A: h chunks -> hb ----
  for (int c0 = 0; c0 < CP; c0 += KC) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    ring_mma<64, KS_A>(acc, s.ra, lane, s.win + wg * 8 * (16 * CP), 16 * CP,
                       0, KS_A * 16, CP / KS_A);
    if (c0 + KC == CP) {       // this tile's window is read for the last time
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(s.winfree);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = 64 * wg + 16 * wl + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t4;
      if (row < WIN * WIN) {
        const int gy = ty0 - 1 + row / WIN, gx = tx0 - 1 + row % WIN;
        const bool in = gy >= y_lo && gy < y_hi && gx >= 0 && gx < W;
        const float2 b = ld2(b0 + c0 + col);
        float2 v;
        v.x = in ? wsilu(acc[i] + b.x) : 0.f;
        v.y = in ? wsilu(acc[i + 1] + b.y) : 0.f;
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
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(dw + tap * CP + c));
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
      *reinterpret_cast<uint4*>(s.hb + canon(p, c, CP)) = out;
    }
    hop::fence_proxy_async();
    hop::named_bar(1, kConsumers);
  }

  // ---- stage B: u = x + b3 + hb W3 ----
  // A thread holds two output pixels of the tile, rows 2 wl and 2 wl + 1
  // of column g: element offsets of their first channel, and whether each
  // lies in the frame.
  const int gx = tx0 + g, gy = ty0 + 2 * wl;
  const size_t px0 = ((size_t)gy * W + gx) * C, px1 = px0 + (size_t)W * C;
  const bool in0 = gx < W && gy < y_hi, in1 = gx < W && gy + 1 < y_hi;
  float yacc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) yacc[i] = 0.f;
  ring_mma<NH, KS_B>(yacc, s.rb, lane, s.hb, 16 * CP,
                     wg * (NH / 8) * (KS_B * 16), KS_B * 16, CP / KS_B);
#pragma unroll
  for (int i = 0; i < NH / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
    const float2 xv = (hi ? in1 : in0) && real(i)
                          ? ld2_cg(src + (hi ? px1 : px0) + col)
                          : make_float2(0.f, 0.f);
    const float2 b = ld2(b3 + col);
    yacc[i] += xv.x + b.x;
    yacc[i + 1] += xv.y + b.y;
  }
  hop::named_bar(1, kConsumers);       // both warpgroups done with hb
  // uc = bf16(u) in hb's place; the accumulator goes on as y
#pragma unroll
  for (int i = 0; i < NH / 2; i += 2) {
    const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
    const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
    *reinterpret_cast<uint32_t*>(s.hb + canon(p, col, CP)) =
        pack2(yacc[i], yacc[i + 1]);
    const float2 b = ld2(bf2 + col);
    yacc[i] += b.x;
    yacc[i + 1] += b.y;
  }
  hop::fence_proxy_async();
  hop::named_bar(1, kConsumers);

  // ---- FFN: 2C hidden channels, KF at a time ----
  for (int f0 = 0; f0 < 2 * CP; f0 += KF) {
    float fa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) fa[i] = 0.f;
    ring_mma<64, KS_B>(fa, s.rb, lane, s.hb, 16 * CP, wg * 8 * (KS_B * 16),
                       KS_B * 16, CP / KS_B);
    // columns 0..31 of fa are half a, 32..63 the matching half b
    unsigned char* fch = s.hch_b + ((f0 / KF) & 1) * (TILE * TILE * KF * 2);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int p = 16 * wl + g + 8 * ((i >> 1) & 1);
      const int hc = 32 * wg + 8 * (i >> 2) + 2 * t4;
      const float2 ba = ld2(bf0 + f0 + hc), bb = ld2(bf0 + 2 * CP + f0 + hc);
      const float v0 = wsilu(fa[i] + ba.x) + wsilu(fa[i + 16] + bb.x);
      const float v1 = wsilu(fa[i + 1] + ba.y) + wsilu(fa[i + 17] + bb.y);
      *reinterpret_cast<uint32_t*>(fch + canon(p, hc, KF)) = pack2(v0, v1);
    }
    hop::fence_proxy_async();
    hop::named_bar(1, kConsumers);
    ring_mma<NH, KS_B>(yacc, s.rb, lane, fch, KF * 16,
                       wg * (NH / 8) * (KS_B * 16), KS_B * 16, KF / KS_B);
  }

  // ---- epilogue: [+ x] [* q] -> the block's output ----
#pragma unroll
  for (int i = 0; i < NH / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int col = wg * NH + 8 * (i >> 2) + 2 * t4;
    if ((hi ? in1 : in0) && real(i)) {
      const size_t at = (hi ? px1 : px0) + col;
      float v0 = yacc[i], v1 = yacc[i + 1];
      if constexpr (Shortcut) {
        const float2 xv = ld2_cg(src + at);
        v0 += xv.x;
        v1 += xv.y;
      }
      if (q != nullptr) {
        const float2 qv = ld2(q + col);
        v0 *= qv.x;
        v1 *= qv.y;
      }
      *reinterpret_cast<uint32_t*>(dst + at) = pack2(v0, v1);
    }
  }
  hop::named_bar(1, kConsumers);       // ring B may take the window again
}

}  // namespace dcbt
