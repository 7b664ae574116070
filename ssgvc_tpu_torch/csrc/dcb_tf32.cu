// The DepthConvBlock forward in float32 on the tensor cores, in 3xTF32: one
// block after its adaptor (with the optional shortcut, + x, and per-channel
// q, * q), or N adaptor-free, shortcut-free blocks in one persistent
// cooperative launch with q on the last output. fp32 NHWC (B, H, W, C), C a
// multiple of 8 computed at CP = C rounded up to 64 (and 512 over 384), at
// least 128 (ops/dcb.py:tf32_width; the models send blocks computed at 64,
// C <= 64, to the SIMT kernel, csrc/dcb_f32.cu, faster there:
// ops/dcb.py:uses_tf32). The math of ops/dcb.py:dcb_plain in fp32.
//
// Replaces, for float32 activations, the TPU kernels _dcb_kernel
// (ssgvc_tpu/ops/pallas_dcb.py:68, through _dcb_fused / pl.pallas_call) and
// _chain_kernel (ssgvc_tpu/ops/pallas_dcb_chain.py:61, through _chain_call).
//
// 3xTF32: each fp32 operand a is split into a_hi = rna_tf32(a) and a_lo =
// rna_tf32(a - a_hi) (round to nearest, ties away, the low 13 bits cleared:
// the hardware ignores them), and every product is a_hi b_lo + a_lo b_hi +
// a_hi b_hi, accumulated in fp32 by wgmma m64nNk8 tf32. hi + lo keeps 22
// bits of a; the dropped a_lo b_lo is ~2^-22 of a b. The weights come split
// (ops/dcb.py:pack_tf32), the activations are split in registers as they
// are loaded (A from registers), so no lo copy of them sits in shared
// memory.
//
// Bound on an H100 SXM: operations. 16 C^2 + 18 C per pixel, three
// products each at 495 TFLOP/s dense TF32, about 165 TFLOP/s of fp32 work
// (a 136x240 frame at C=256: 34.4 GFLOP, 0.21 ms), against 67 TFLOP/s for
// SIMT fp32. The weights are streamed once per 8x8 tile, hi and lo: 64 CP^2
// bytes a tile from L2 (4.2 MB at CP = 256).
//
// Design, simply: a persistent grid of one 256-thread block per SM (two
// warpgroups, no producer) walks the B x 8x8 output tiles; a tile reads its
// 10x10 window (one-pixel halo inside its image, zero outside the frame).
// Each warpgroup streams its own weight slabs with bulk copies into its own
// ring of shared-memory slots (one mbarrier each; its first thread
// re-issues a slot once the warpgroup has consumed it), in the order
// ops/dcb.py:pack_tf32 packs them:
//   stage A, per chunk of KC = 64 h channels: warpgroup g computes h at
//     window rows [64 g, 64 g + 64) (N = 64; rows past 100 are dropped), A
//     straight from the frame (L2) four k16 blocks ahead; wsilu, zeroed
//     outside the frame, to the fp32 h chunk; then all 256 threads run the
//     depthwise 3x3 into g (act, 64 x CP fp32);
//   stage B: u = x + g W3 + b3, warpgroup g its CP/2 columns (N = CP/2, A
//     from act); u replaces g in act;
//   FFN, per chunk of 64 hidden channels: warpgroup g computes its 32 of
//     half a and 32 of half b (N = 64), f = wsilu(a) + wsilu(b) to a
//     double-buffered f chunk (64 x 64 fp32), then d += f Wf2 (N = CP/2);
//   epilogue: y = d + bf2 + u [+ x] [* q] from the accumulators and act to
//     the frame.
// Every wgmma adds its products into the accumulators with truncation, not
// rounding to nearest: each of a sum's 3 K/8 steps may lose up to an ulp of
// the accumulator, always toward zero. So every accumulator starts at 0 and
// holds one product's sum; biases and residuals are added after, in fp32
// (y's accumulators starting at u + bf2 drifted by ~2e-5 over three
// blocks).
// A k16 block's channels are permuted so that a thread loads each A row's
// four channels as one float4: in k8 step s of the block, logical column
// kl holds channel 4 (kl % 4) + 2 s + kl / 4 (ops/dcb.py:tf32_k_order).
// A product keeps one k8 step's three wgmmas in flight while it splits and
// issues the next (the other warpgroup fills the tensor cores too). Sums
// run in a fixed order and the grid's split of the tiles changes no tile's
// arithmetic, so the same inputs give the same output bit for bit, at any
// batch size.
//
// Shared memory (ops/dcb.py:tf32_smem_bytes mirrors smem_bytes below): act
// 64 x CP fp32 (rows XOR-swizzled by 16 floats on odd rows: an A load's
// quarter-warp reads two rows' 64 bytes from distinct banks); the h chunk
// (100 x 68 fp32) or the two f chunks (2 x 64 x 64 fp32), 32 KiB; two rings
// of R slots (slot_bytes: 16 KiB, 12 KiB at CP = 192 and 384, 10 KiB at
// 320), a slab holding SA k8 steps of W0 / Wf0 (64 rows, hi and lo: 4 KiB
// a step) or SB of W3 / Wf2 (CP/2 rows: 32 CP bytes a step); the
// mbarriers. R = 5, 6, 4, 5, 4, 2 at CP = 128 ... 512: at most 229,632
// bytes.
//
// Left for later: a producer warp and deeper wgmma pipelining (one step in
// flight), more pixels per tile (each tile re-streams all the
// weights), splitting the weights in shared memory from one fp32 copy (half
// the L2 bytes), and the narrow widths (CP = 64) on this kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_tf32.cuh"

namespace dcbt {

namespace cg = cooperative_groups;

constexpr int TILE = 8, WIN = 10, NWIN = 100, NPIX = 64;
constexpr int KC = 64;         // h channels per stage-A chunk
constexpr int KF = 64;         // hidden channels per FFN chunk
constexpr int HS = KC + 4;     // fp32 row stride of the h chunk
constexpr int kThreads = 256;  // two warpgroups
constexpr int SMEM_LIMIT = 232448;
constexpr int XBUF = 2 * NPIX * KF * 4;   // >= NWIN * HS * 4
constexpr int BAR_BYTES = 256;
constexpr int MAX_SLOTS = 8;

// A ring slot: whole k8 steps of both slab kinds, as large as shared memory
// lets each warpgroup keep 64-80 KiB in flight (a W3 / Wf2 step is 32 CP
// bytes, a W0 / Wf0 step 4 KiB).
__host__ __device__ constexpr int slot_bytes(int CP) {
  return CP == 192 || CP == 384 ? 12288 : CP == 320 ? 10240 : 16384;
}
__host__ __device__ constexpr int pow2_floor(int v) {
  return v >= 4 ? 4 : v >= 2 ? 2 : 1;
}
// k8 steps per slab: W0 / Wf0 (64 rows), W3 / Wf2 (CP/2 rows)
__host__ __device__ constexpr int sps_a(int CP) {
  return pow2_floor(slot_bytes(CP) / 4096);
}
__host__ __device__ constexpr int sps_b(int CP) {
  return pow2_floor(slot_bytes(CP) / (32 * CP));
}
__host__ __device__ constexpr int slots(int CP) {
  return (SMEM_LIMIT - NPIX * CP * 4 - XBUF - BAR_BYTES) /
                     (2 * slot_bytes(CP)) < MAX_SLOTS
             ? (SMEM_LIMIT - NPIX * CP * 4 - XBUF - BAR_BYTES) /
                   (2 * slot_bytes(CP))
             : MAX_SLOTS;
}
__host__ __device__ constexpr int smem_bytes(int CP) {
  return NPIX * CP * 4 + XBUF + 2 * slots(CP) * slot_bytes(CP) + BAR_BYTES;
}

template <int CP>
struct Plan {
  static constexpr int NH = CP / 2;     // a warpgroup's columns of W3, Wf2
  static constexpr int KS = CP / 8;     // k8 steps over CP
  static constexpr int SA = sps_a(CP), SB = sps_b(CP);
  static constexpr int R = slots(CP);
  static constexpr int SLOT = slot_bytes(CP);
  static constexpr int NA = (CP / KC) * (KS / SA);    // W0 slabs
  static constexpr int NB = KS / SB;                  // W3 slabs
  static constexpr int NF0 = KS / SA;                 // Wf0 slabs a chunk
  static constexpr int NF2 = 8 / SB;                  // Wf2 slabs a chunk
  static constexpr int NFC = 2 * CP / KF;             // FFN chunks
  static constexpr int PER_TILE = NA + NB + NFC * (NF0 + NF2);
  static constexpr size_t W0_BYTES = 8ull * CP * CP;  // 2 CP^2 floats
  static constexpr size_t WG_BYTES = 28ull * CP * CP; // 7 CP^2 floats
  static constexpr size_t BLK_FLOATS = 16ull * CP * CP + 17ull * CP;
  static_assert(smem_bytes(CP) <= SMEM_LIMIT, "shared memory");
  static_assert(R >= 2 && KS % SA == 0 && KS % SB == 0 &&
                    SA * 4096 <= SLOT && SB * 32 * CP <= SLOT, "slabs");
};

__device__ __forceinline__ float wsilu(float v) {   // silu(4v)/4
  return v / (1.0f + expf(-4.0f * v));
}

// v as (hi, lo) tf32: round to nearest, ties away from zero, low 13 bits 0
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void fence_u32(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Element (row, col) of a swizzled fp32 tile with `ld` columns.
__device__ __forceinline__ int sw(int row, int col, int ld) {
  return row * ld + (col ^ ((row & 1) << 4));
}

// One warpgroup's stream of weight slabs through its ring. Every thread of
// the warpgroup counts the slabs it has acquired and released; the first
// thread re-issues a released slot with the slab R further on.
template <int CP>
struct Stream {
  using P = Plan<CP>;
  unsigned char* base;
  uint64_t* full;
  const unsigned char* w;   // block 0's weights
  uint32_t acq, rel, total;
  int my_tiles, g;
  bool leader;

  // slab i of a tile of block weights blk: its first byte and size
  __device__ const unsigned char* src(const unsigned char* blk, int i,
                                      uint32_t& bytes) const {
    constexpr int A_BYTES = 4096 * P::SA, B_BYTES = 32 * CP * P::SB;
    if (i < P::NA) {
      bytes = A_BYTES;
      return blk + (size_t)i * A_BYTES;
    }
    const unsigned char* wg = blk + P::W0_BYTES + g * P::WG_BYTES;
    i -= P::NA;
    if (i < P::NB) {
      bytes = B_BYTES;
      return wg + (size_t)i * B_BYTES;
    }
    i -= P::NB;
    const int chunk = i / (P::NF0 + P::NF2), r = i % (P::NF0 + P::NF2);
    const unsigned char* cb =
        wg + (size_t)P::KS * 32 * CP + (size_t)chunk * 768 * CP;
    if (r < P::NF0) {
      bytes = A_BYTES;
      return cb + (size_t)r * A_BYTES;
    }
    bytes = B_BYTES;
    return cb + 512 * CP + (size_t)(r - P::NF0) * B_BYTES;
  }

  // slab k of this block's whole run into slot k % R (leader only)
  __device__ void issue(uint32_t k) const {
    const uint32_t seq = k / P::PER_TILE;
    const int i = k % P::PER_TILE;
    const int j = seq / my_tiles;
    uint32_t bytes;
    const unsigned char* s =
        src(w + (size_t)j * P::BLK_FLOATS * 4, i, bytes);
    const int slot = k % P::R;
    hop::mbar_arrive_expect_tx(&full[slot], bytes);
    hop::bulk_load(base + slot * P::SLOT, s, bytes, &full[slot]);
  }

  // wait for the next slab; its first byte
  __device__ const unsigned char* acquire() {
    const int slot = acq % P::R;
    hop::mbar_wait(&full[slot], (acq / P::R) & 1);
    ++acq;
    return base + slot * P::SLOT;
  }

  // the warpgroup is done with the oldest slab it holds (its products have
  // completed)
  __device__ void release() {
    hop::named_bar(1 + g, 128);
    if (leader && rel + P::R < total) issue(rel + P::R);
    ++rel;
  }
};

// A rows straight from the frame: the window rows of this thread (null
// outside the frame or past the window), channels below C, through L2.
struct FrameRows {
  const float* r0;
  const float* r1;
  int C, j;
  __device__ void load(int kb, float4 (&v)[2]) const {
    const int col = 16 * kb + 4 * j;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = r0 != nullptr && col < C
               ? __ldcg(reinterpret_cast<const float4*>(r0 + col)) : z;
    v[1] = r1 != nullptr && col < C
               ? __ldcg(reinterpret_cast<const float4*>(r1 + col)) : z;
  }
};

// A rows from a swizzled fp32 tile in shared memory.
struct SmemRows {
  const float* base;
  int ld, row, j;
  __device__ void load(int kb, float4 (&v)[2]) const {
    const int col = 16 * kb + 4 * j;
    v[0] = *reinterpret_cast<const float4*>(base + sw(row, col, ld));
    v[1] = *reinterpret_cast<const float4*>(base + sw(row + 8, col, ld));
  }
};

// acc += A x B^T over nblk k16 blocks: A this warpgroup's 64 rows (src,
// each thread's two rows, P blocks ahead), B the stream's slabs of SPS k8
// steps, each step N rows hi (canonical, LBO 128, SBO 256) then N rows lo.
// One k8 step's three products stay in flight while the next step's are
// issued: a step's A registers (by step parity) are reused two steps on,
// after the wait that retires them, and a slab is released one step after
// its last.
template <int N, int SPS, int P, int CP, class Src>
__device__ __forceinline__ void product(float (&acc)[N / 2],
                                        Stream<CP>& st, const Src& a,
                                        int nblk) {
  static_assert((2 * P) % SPS == 0, "slabs within the unrolled blocks");
  constexpr int STEP = N * 32;          // bytes of one N x 8 tf32 operand
  float4 raw[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) a.load(p, raw[p]);
  uint32_t hi[2][4] = {}, lo[2][4] = {};
  const unsigned char* slab = nullptr;
  bool done = false;                    // a slab's last step was issued
  for (int kb0 = 0; kb0 < nblk; kb0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v0 = raw[p][0], v1 = raw[p][1];
      if (kb0 + p + P < nblk) a.load(kb0 + p + P, raw[p]);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        split(s ? v0.z : v0.x, hi[s][0], lo[s][0]);   // row r, column j
        split(s ? v1.z : v1.x, hi[s][1], lo[s][1]);   // row r + 8
        split(s ? v0.w : v0.y, hi[s][2], lo[s][2]);   // row r, column j + 4
        split(s ? v1.w : v1.y, hi[s][3], lo[s][3]);
        const int t = (2 * p + s) % SPS;
        if (t == 0) slab = st.acquire();
        const unsigned char* b = slab + t * 2 * STEP;
        const uint64_t dh = hop::desc(b, 128, 256);
        const uint64_t dl = hop::desc(b + STEP, 128, 256);
        hop::wg_fence();
        hop::fence_regs(acc);
        hop::Tf32<N>::mma(acc, lo[s], dh);
        hop::Tf32<N>::mma(acc, hi[s], dl);
        hop::Tf32<N>::mma(acc, hi[s], dh);
        hop::wg_commit();
        hop::wg_wait<1>();              // the step before has completed
        hop::fence_regs(acc);
        fence_u32(hi[s ^ 1]);
        fence_u32(lo[s ^ 1]);
        if (done) st.release();
        done = t == SPS - 1;
      }
    }
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  fence_u32(hi[0]);
  fence_u32(lo[0]);
  fence_u32(hi[1]);
  fence_u32(lo[1]);
  st.release();                         // the last slab
}

// One block on one 8x8 tile. src / dst: the batch's base pointers, a stack
// of (B H) rows x W x C; the tile's image holds rows [y_lo, y_hi), its
// first output pixel is (ty0, tx0). tail: the block's taps and biases.
template <int CP>
__device__ void block_tile(float* act, float* xbuf, Stream<CP>& st,
                           const float* src, float* dst,
                           const float* __restrict__ tail,
                           const float* __restrict__ q, bool shortcut,
                           int C, int y_lo, int y_hi, int W, int ty0,
                           int tx0) {
  using P = Plan<CP>;
  const int tid = threadIdx.x, g = tid / 128, w = (tid % 128) / 32;
  const int l = tid % 32, j = l % 4;
  const int ra = 16 * w + l / 4;        // this thread's rows: ra, ra + 8
  const float* taps = tail;
  const float* b0 = taps + 9 * CP;
  const float* b2 = b0 + CP;
  const float* b3 = b2 + CP;
  const float* bf0 = b3 + CP;
  const float* bf2 = bf0 + 4 * CP;

  auto win_in = [&](int r) {
    const int gy = ty0 - 1 + r / WIN, gx = tx0 - 1 + r % WIN;
    return r < NWIN && gy >= y_lo && gy < y_hi && gx >= 0 && gx < W;
  };
  auto win_ptr = [&](int r) -> const float* {
    if (!win_in(r)) return nullptr;
    return src + ((size_t)(ty0 - 1 + r / WIN) * W + (tx0 - 1 + r % WIN)) * C;
  };
  auto out_at = [&](int p) -> long {   // frame offset of pixel p, or -1
    const int gy = ty0 + p / TILE, gx = tx0 + p % TILE;
    return gy < y_hi && gx < W ? ((long)gy * W + gx) * C : -1;
  };

  __syncthreads();                      // the last tile is done with smem

  // ---- stage A: h on the window, KC channels at a time; depthwise -> g --
  const FrameRows xa{win_ptr(64 * g + ra), win_ptr(64 * g + ra + 8), C, j};
  for (int c0 = 0; c0 < CP; c0 += KC) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    product<64, P::SA, 4>(acc, st, xa, CP / 16);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = 64 * g + ra + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * j;
      if (r < NWIN) {
        const bool in = win_in(r);
        const float h0 = in ? wsilu(acc[i] + __ldg(b0 + c0 + col)) : 0.0f;
        const float h1 = in ? wsilu(acc[i + 1] + __ldg(b0 + c0 + col + 1))
                            : 0.0f;
        *reinterpret_cast<float2*>(xbuf + r * HS + col) = make_float2(h0, h1);
      }
    }
    __syncthreads();
    {
      const int ch = tid % KC, pg = tid / KC;
      float t[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] = __ldg(taps + k * CP + c0 + ch);
      const float bias = __ldg(b2 + c0 + ch);
#pragma unroll 4
      for (int i = 0; i < NPIX / 4; ++i) {
        const int p = pg + 4 * i, oy = p / TILE, ox = p % TILE;
        float v = bias;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v += t[k] * xbuf[((oy + k / 3) * WIN + ox + k % 3) * HS + ch];
        act[sw(p, c0 + ch, CP)] = v;
      }
    }
    __syncthreads();
  }

  // ---- stage B: u = x + g W3 + b3; y = u + bf2 in the accumulators ----
  float acc[P::NH / 2];
#pragma unroll
  for (int i = 0; i < P::NH / 2; ++i) acc[i] = 0.0f;
  product<P::NH, P::SB, 2>(acc, st, SmemRows{act, CP, ra, j}, CP / 16);
  __syncthreads();                      // both warpgroups are done with g
#pragma unroll
  for (int i = 0; i < P::NH / 2; i += 2) {
    const int p = ra + 8 * ((i >> 1) & 1);
    const int col = g * P::NH + 8 * (i >> 2) + 2 * j;
    const long at = out_at(p);
    float2 xv = make_float2(0.0f, 0.0f);
    if (at >= 0 && col < C)
      xv = __ldcg(reinterpret_cast<const float2*>(src + at + col));
    const float u0 = acc[i] + __ldg(b3 + col) + xv.x;
    const float u1 = acc[i + 1] + __ldg(b3 + col + 1) + xv.y;
    *reinterpret_cast<float2*>(act + sw(p, col, CP)) = make_float2(u0, u1);
    acc[i] = acc[i + 1] = 0.0f;         // f Wf2 alone: see the note above
  }
  __syncthreads();                      // u is whole

  // ---- FFN: 64 hidden channels at a time ----
  for (int fc = 0; fc < P::NFC; ++fc) {
    float fa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) fa[i] = 0.0f;
    product<64, P::SA, 2>(fa, st, SmemRows{act, CP, ra, j}, CP / 16);
    float* fb = xbuf + (fc & 1) * NPIX * KF;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int p = ra + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + 2 * j;       // of this warpgroup's 32
      const int hid = fc * KF + 32 * g + c;
      const float f0 = wsilu(fa[i] + __ldg(bf0 + hid)) +
                       wsilu(fa[i + 16] + __ldg(bf0 + 2 * CP + hid));
      const float f1 = wsilu(fa[i + 1] + __ldg(bf0 + hid + 1)) +
                       wsilu(fa[i + 17] + __ldg(bf0 + 2 * CP + hid + 1));
      *reinterpret_cast<float2*>(fb + sw(p, 32 * g + c, KF)) =
          make_float2(f0, f1);
    }
    __syncthreads();                    // the f chunk is whole
    product<P::NH, P::SB, 2>(acc, st, SmemRows{fb, KF, ra, j}, KF / 16);
  }

  // ---- epilogue: [+ x] [* q] -> dst ----
#pragma unroll
  for (int i = 0; i < P::NH / 2; i += 2) {
    const int p = ra + 8 * ((i >> 1) & 1);
    const int col = g * P::NH + 8 * (i >> 2) + 2 * j;
    const long at = out_at(p);
    if (at < 0 || col >= C) continue;
    const float2 u = *reinterpret_cast<const float2*>(act + sw(p, col, CP));
    float2 v = make_float2(acc[i] + __ldg(bf2 + col) + u.x,
                           acc[i + 1] + __ldg(bf2 + col + 1) + u.y);
    if (shortcut) {
      const float2 xv = __ldcg(reinterpret_cast<const float2*>(src + at + col));
      v.x += xv.x;
      v.y += xv.y;
    }
    if (q != nullptr) {
      v.x *= __ldg(q + col);
      v.y *= __ldg(q + col + 1);
    }
    *reinterpret_cast<float2*>(dst + at + col) = v;
  }
}

// n blocks; block j reads x (j = 0) or the previous block's output and
// writes y (the last) or s, as ops/dcb_chain.py:buffer_plan; q multiplies
// the last output. With n > 1 the launch is cooperative.
template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
dcb_tf32_kernel(const float* x, float* y, float* s, const float* w,
                const float* __restrict__ q, int C, int H, int W, int n,
                int shortcut, int tiles_x, int tiles, int total) {
  using P = Plan<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);
  float* xbuf = act + NPIX * CP;
  unsigned char* rings = smem + NPIX * CP * 4 + XBUF;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(rings + 2 * P::R * P::SLOT);
  const int g = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * P::R; ++i) hop::mbar_init(&bars[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int my_tiles = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  Stream<CP> st{rings + g * P::R * P::SLOT, bars + g * P::R,
                reinterpret_cast<const unsigned char*>(w), 0u, 0u,
                (uint32_t)n * my_tiles * P::PER_TILE, my_tiles, g,
                threadIdx.x % 128 == 0};
  if (st.leader)
    for (uint32_t k = 0; k < (uint32_t)P::R && k < st.total; ++k) st.issue(k);
  for (int j = 0; j < n; ++j) {
    const float* src = j == 0 ? x : ((n - j) % 2 == 0 ? y : s);
    float* dst = (n - 1 - j) % 2 == 0 ? y : s;
    const float* tail = w + j * P::BLK_FLOATS + 16ull * CP * CP;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / tiles, tt = t - b * tiles, y_lo = b * H;
      block_tile<CP>(act, xbuf, st, src, dst, tail,
                     j == n - 1 ? q : nullptr, shortcut != 0, C, y_lo,
                     y_lo + H, W, y_lo + (tt / tiles_x) * TILE,
                     (tt % tiles_x) * TILE);
    }
    if (j + 1 < n) cg::this_grid().sync();
  }
}

template <int CP>
int launch(const float* x, float* y, float* s, const float* w,
           const float* q, int B, int H, int W, int C, int n, int shortcut,
           cudaStream_t st) {
  auto kern = dcb_tf32_kernel<CP>;
  const int smem = smem_bytes(CP);
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
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int tiles_x = (W + TILE - 1) / TILE;
  int tiles = (H + TILE - 1) / TILE * tiles_x;
  int total = B * tiles;
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  if (n == 1) {
    kern<<<grid, kThreads, smem, st>>>(x, y, s, w, q, C, H, W, n, shortcut,
                                       tiles_x, tiles, total);
  } else {
    void* args[] = {&x, &y, &s, &w, &q, &C, &H, &W, &n, &shortcut,
                    &tiles_x, &tiles, &total};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// ops/dcb.py:tf32_width
inline int padded(int C) {
  return C > 384 ? 512 : C <= 128 ? 128 : (C + 63) / 64 * 64;
}

}  // namespace dcbt

extern "C" int ssgvc_dcb_tf32_forward(const void* x, void* y, void* s,
                                      const void* w, const void* q, int B,
                                      int H, int W, int C, int n,
                                      int shortcut, void* stream) {
  using namespace dcbt;
  if (B <= 0 || H <= 0 || W <= 0 || n <= 0 || C < 8 || C > 512 || C % 8 ||
      (n > 1 && shortcut))
    return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(s);
  const float* wp = static_cast<const float*>(w);
  const float* qp = static_cast<const float*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded(C)) {
    case 128: return launch<128>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
    case 192: return launch<192>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
    case 256: return launch<256>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
    case 320: return launch<320>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
    case 384: return launch<384>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
    case 512: return launch<512>(xp, yp, sp, wp, qp, B, H, W, C, n, shortcut, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one thread block at computed width cp (0 if cp
// is not one): ops/dcb.py:tf32_smem_bytes must agree.
extern "C" int ssgvc_dcb_tf32_smem(int cp) {
  using namespace dcbt;
  return cp >= 128 && cp <= 512 && cp % 64 == 0 && cp != 448
             ? smem_bytes(cp) : 0;
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
