// The DepthConvBlock forward in float32 on the SIMT cores, for the narrow
// blocks (C from 8 to 64; ops/dcb.py:uses_tf32 sends C >= 72 to the 3xTF32
// kernel, csrc/dcb_tf32.cu): one block after its adaptor (with the optional
// shortcut, + x, and per-channel q, * q), or N adaptor-free, shortcut-free
// blocks in one launch with q on the last output. fp32 NHWC (B, H, W, C),
// fp32 weights, every product an fp32 FMA (no TF32: this route exists
// because it is exact fp32). The math of ops/dcb.py:dcb_plain in fp32.
//
// Replaces, for float32 activations, the TPU kernels _dcb_kernel
// (ssgvc_tpu/ops/pallas_dcb.py:68, through _dcb_fused / pl.pallas_call) and
// _chain_kernel (ssgvc_tpu/ops/pallas_dcb_chain.py:61, through _chain_call).
//
// Bound on an H100 SXM: at the sizes this route sees (the RD recipe: B = 8
// images of 1x1 to 8x8 at C = 32, 64) neither bytes nor operations but
// latency: 512 pixels x (16 C^2 + 18 C) is 34 MFLOP, 0.5 us at 67 TFLOP/s
// fp32, while one pass through shared memory and a barrier costs about as
// much. On a 1088x1920 frame at C = 64 (1.07 G fused multiply-adds) it is
// operations: 32 us at 67 TFLOP/s.
//
// What the design does about it:
// - Work units that fit small images (make_plan; ops/dcb.py:f32_plan and
//   f32_units mirror it). An image of H W <= PMAX = 64 pixels is never
//   cut: a unit holds g = 64 / (H W) whole images (up to 64 at 1x1), h is
//   computed at their real pixels only and the depthwise reads zeros past
//   each image's edge (a neighbour table per output). A unit of 32 or more
//   pixels spans a cluster of 2 or 4 CTAs (PCTA = 16 pixels or more each):
//   each computes h at its own pixels and reads its neighbours' h from the
//   other CTAs' shared memory (distributed shared memory, between two
//   cluster barriers), so an 8x8 image runs on 4 SMs with no pixel
//   computed twice. Larger images are cut into 8x8 output tiles, each with
//   its 10x10 window (a one-pixel halo inside its image, zero outside),
//   one CTA each.
// - 256 threads at every C, every product register-tiled: a thread owns 8
//   pixels x 8 output channels (8 x 4 where those tiles fit the block in
//   one pass: small units; 8 x 4 of each of the FFN's halves a and b) and
//   one of KS = ksplit(C) segments of K (8 at C <= 32, else 4); the KS
//   partial sums meet by recursive halving over warp shuffles. KS depends
//   on C alone, so every sum runs in one order whatever B, the plan, the
//   tile shape or the grid, and the same inputs give the same output bit
//   for bit at any batch size. Both operands of a product come from shared
//   memory as float4s: activations channel-major ([k][pixel]), weights
//   [in][out] (a quarter-warp's weight loads: 128 contiguous bytes).
// - The block's weights in shared memory (8 C^2 + 17 C floats, 132.3 KiB at
//   C = 64), brought in by 1-D bulk copies (cp.async.bulk) on five
//   mbarriers, one per group in the order of use: W0 + b0, the taps + b2,
//   W3 + b3, Wf0 + bf0, Wf2 + bf2. Stage A waits for the first only.
// - A chain whose units hold whole images runs all N blocks on its images
//   in shared memory (each CTA's output becomes its next input where it
//   lies), and each weight group of block j + 1 is copied in right after
//   block j's last read of it: a plain (or cluster) launch, no scratch
//   tensor, no grid barrier. Only tile units (images over 64 pixels) take
//   the cooperative path: a grid-wide barrier between blocks, activations
//   ping-ponging between the caller's y and one scratch tensor
//   (ops/dcb_chain.py:buffer_plan).
// - The host's attribute, SM-count and occupancy queries run once per
//   device and C (launch_slots): a launch is one <<<>>> (or
//   cudaLaunchKernelEx with the cluster's size).
//
// Per block on a unit: [x window -> X]; h = wsilu(X W0 + b0), 0 outside the
// image -> H (pixel-major); g = dw3x3(h) + b2 -> G; u = x + g W3 + b3 -> U
// (in H's bytes); f = wsilu(u Wf0a + bf0a) + wsilu(u Wf0b + bf0b) -> F (in
// G's bytes); y = u + f Wf2 + bf2 [+ x] [* q] -> the frame, or X for the
// chain's next block. A persistent grid walks the units (as many thread
// blocks as fit at once), so a single block's weights are read once per
// thread block. wsilu runs on the fast exponential and division.
//
// Measured on an H100 (experiments/simt_probe.py, chip_smoke.py): 8-14 us a
// launch at the RD recipe's shapes, 4-5x faster than the design this one
// replaced (38-62 us: a 64-thread block per 8x4 tile walking every k of
// every product in series, its weights from L2 on each step).
//
// Weights (ops/dcb.py:pack_f32), per block, 8 C^2 + 17 C floats: W0^T
// (C x C, [in][out]), W3^T (C x C), Wf0^T (C x 4C), Wf2^T (2C x C), the
// depthwise taps (9 x C), b0, b2, b3 (C each), bf0 (4C), bf2 (C); 16-byte
// aligned (the bulk copies).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace dcbf {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxC = 64;                 // ops/dcb.py:F32_MAX_CHANNELS
constexpr int PMAX = 64;                  // output pixels of a unit
constexpr int PCTA = 16;                  // least of them a cluster's CTA takes
constexpr int MAX_CS = 4;                 // CTAs a unit of whole images spans
constexpr int TILE_H = 8, TILE_W = 8;     // a tile unit's outputs
constexpr int RP = 8;                     // pixels of a thread's tile
constexpr int LDQ = 104;                  // window pixels a unit holds
constexpr int LDP = 68;                   // row stride of G and F: PMAX + 4
constexpr int kGroups = 5;                // weight groups, one mbarrier each
constexpr int kMaxDevices = 64;

// K segments of every product: a function of C alone (so is the order of
// every sum). 256 threads over a 64-pixel unit's 8x8 tiles at C = 32, 64;
// at C < 32 more segments than fill the block, for shorter serial chains.
__host__ __device__ constexpr int ksplit(int C) { return C <= 32 ? 8 : 4; }

__host__ __device__ constexpr int weight_floats(int C) {
  return 8 * C * C + 17 * C;
}

// Dynamic shared memory (ops/dcb.py:f32_smem_bytes): the weights; X (C x
// LDQ), H then U (C x LDQ), G then F (2C x LDP) floats; the unit's tables
// (slot_px[LDQ], out_slot, out_px [PMAX], out_nbr [PMAX x 9] ints); the
// mbarriers.
__host__ __device__ constexpr int smem_bytes(int C) {
  return (weight_floats(C) + 2 * C * LDQ + 2 * C * LDP) * 4 +
         (LDQ + 11 * PMAX) * 4 + kGroups * 8;
}

// The work units of a (B, H, W) batch (ops/dcb.py:f32_plan), for any N.
// Images of at most PMAX pixels: a unit of g whole images (all of a
// chain's blocks run on it in shared memory), spread over a cluster of cs
// CTAs (cs = 1, 2 or 4: at least PCTA pixels each, for the RD recipe's
// latency-bound launches), CTA r taking the unit's pixels [r p, (r + 1) p)
// in image, row, column order; h crosses between them through distributed
// shared memory. Larger images: tiles with a one-pixel halo, one CTA each.
struct Plan {
  int B, H, W;
  int whole;       // 1: units of g whole images; 0: tiles
  int g;           // images per unit (whole), else 1
  int cs;          // CTAs per unit (a cluster; whole), else 1
  int th, tw;      // outputs per window: the image, or the tile
  int tiles_x;     // tile columns per image (tiles), else 1
  int tiles;       // tiles per image (tiles), else 1
  int units;
  int ww;          // window row stride in slots: W, or TILE_W + 2
  int q;           // window slots per CTA (a multiple of RP, <= LDQ)
  int p;           // outputs per CTA (a multiple of RP, <= PMAX)
};
constexpr int kPlanFields = 14;

__host__ __device__ inline Plan make_plan(int B, int H, int W) {
  Plan pl{};
  pl.B = B;
  pl.H = H;
  pl.W = W;
  if (H * W <= PMAX) {
    pl.whole = 1;
    pl.g = PMAX / (H * W) < B ? PMAX / (H * W) : B;
    const int px = pl.g * H * W;
    pl.cs = px >= MAX_CS * PCTA ? MAX_CS : px >= 2 * PCTA ? 2 : 1;
    pl.th = H;
    pl.tw = W;
    pl.tiles_x = pl.tiles = 1;
    pl.units = (B + pl.g - 1) / pl.g;
    pl.ww = W;
    pl.q = pl.p = ((px + pl.cs - 1) / pl.cs + RP - 1) / RP * RP;
  } else {
    pl.whole = 0;
    pl.g = 1;
    pl.cs = 1;
    pl.th = TILE_H;
    pl.tw = TILE_W;
    pl.tiles_x = (W + pl.tw - 1) / pl.tw;
    pl.tiles = (H + pl.th - 1) / pl.th * pl.tiles_x;
    pl.units = B * pl.tiles;
    pl.ww = pl.tw + 2;
    pl.q = ((pl.th + 2) * pl.ww + RP - 1) / RP * RP;
    pl.p = pl.th * pl.tw;
  }
  return pl;
}

// silu(4v)/4 by the fast exponential and division (2 ulp; 0 below v = -22,
// where 1 + e^-4v overflows): the accurate ones cost 8-9% of a launch
__device__ __forceinline__ float wsilu(float v) {
  return __fdividef(v, 1.0f + __expf(-4.0f * v));
}

// Shared memory, carved from the dynamic allocation.
template <int C>
struct Smem {
  float* w;         // the block's weights, as packed
  float* X;         // C x LDQ: the input window (the chain's next input)
  float* H;         // LDQ x C: h at the window; then u (C x PMAX)
  float* G;         // 2C x LDP: g (C rows); then f (2C rows)
  int* slot_px;     // window slot -> pixel of the (B H W) stack, or -1
  int* out_slot;    // output -> window slot
  int* out_px;      // output -> pixel, or -1 (not stored)
  int* out_nbr;     // output x 3x3 tap -> (CTA rank << 8 | its slot), or -1
  uint64_t* bar;    // kGroups mbarriers

  __device__ explicit Smem(unsigned char* raw) {
    w = reinterpret_cast<float*>(raw);
    X = w + weight_floats(C);
    H = X + C * LDQ;
    G = H + C * LDQ;
    slot_px = reinterpret_cast<int*>(G + 2 * C * LDP);
    out_slot = slot_px + LDQ;
    out_px = out_slot + PMAX;
    out_nbr = out_px + PMAX;
    bar = reinterpret_cast<uint64_t*>(out_nbr + 9 * PMAX);
  }
};

// Weight group g (0..4) of one block: a matrix and its bias, as (offset,
// floats) pairs in the packed layout. Every offset and size is a multiple
// of 4 floats (C a multiple of 8): the bulk copies' 16 bytes.
template <int C>
__device__ __forceinline__ void group_span(int g, int (&off)[2],
                                           int (&len)[2]) {
  constexpr int CC = C * C, T = 8 * CC;   // T: the taps, then the biases
  switch (g) {
    case 0: off[0] = 0;      len[0] = CC;     off[1] = T + 9 * C;  len[1] = C;     break;
    case 1: off[0] = T;      len[0] = 9 * C;  off[1] = T + 10 * C; len[1] = C;     break;
    case 2: off[0] = CC;     len[0] = CC;     off[1] = T + 11 * C; len[1] = C;     break;
    case 3: off[0] = 2 * CC; len[0] = 4 * CC; off[1] = T + 12 * C; len[1] = 4 * C; break;
    default: off[0] = 6 * CC; len[0] = 2 * CC; off[1] = T + 16 * C; len[1] = C;   break;
  }
}

// Issue the bulk copies of group g of the block at `src` (global) into the
// shared weights. One thread.
template <int C>
__device__ void load_group(const Smem<C>& s, const float* src, int g) {
  int off[2], len[2];
  group_span<C>(g, off, len);
  hop::mbar_arrive_expect_tx(&s.bar[g], 4u * (len[0] + len[1]));
  for (int i = 0; i < 2; ++i)
    hop::bulk_load(s.w + off[i], src + off[i], 4u * len[i], &s.bar[g]);
}

// The pixel of the (B H W) stack whose input window slot i of unit u holds
// in CTA `rank` of its cluster, or -1 (h is 0 there).
__device__ __forceinline__ int slot_pixel(const Plan& pl, int u, int rank,
                                          int i) {
  if (pl.whole) {
    const int hw = pl.H * pl.W, b0 = u * pl.g, at = rank * pl.p + i;
    return at < min(pl.g, pl.B - b0) * hw ? b0 * hw + at : -1;
  }
  const int b = u / pl.tiles, tt = u % pl.tiles;
  const int gy = tt / pl.tiles_x * pl.th - 1 + i / pl.ww;
  const int gx = tt % pl.tiles_x * pl.tw - 1 + i % pl.ww;
  return i < (pl.th + 2) * pl.ww && gy >= 0 && gy < pl.H && gx >= 0 &&
                 gx < pl.W
             ? (b * pl.H + gy) * pl.W + gx : -1;
}

// The unit's tables for CTA `rank` of its cluster (then, for tiles, a
// barrier; whole images wait for the one after the input window. The last
// barrier of the unit before comes before they are overwritten).
template <int C>
__device__ void setup_unit(const Smem<C>& s, const Plan& pl, int u,
                           int rank) {
  const int tid = threadIdx.x;
  if (pl.whole) {
    const int hw = pl.H * pl.W, b0 = u * pl.g, first = rank * pl.p;
    const int real = min(pl.g, pl.B - b0) * hw;     // the unit's pixels
    for (int i = tid; i < pl.p; i += kThreads) {
      const int px = slot_pixel(pl, u, rank, i);
      s.slot_px[i] = px;
      s.out_slot[i] = i;
      s.out_px[i] = px;
    }
    for (int i = tid; i < 9 * pl.p; i += kThreads) {
      const int o = i / 9, t = i - 9 * o, at = first + o;
      const int r = at % hw / pl.W + t / 3 - 1, c = at % pl.W + t % 3 - 1;
      const int nb = at + (t / 3 - 1) * pl.W + t % 3 - 1;
      s.out_nbr[i] = at < real && r >= 0 && r < pl.H && c >= 0 && c < pl.W
                         ? (nb / pl.p) << 8 | nb % pl.p : -1;
    }
  } else {
    const int b = u / pl.tiles, tt = u % pl.tiles;
    const int ty0 = tt / pl.tiles_x * pl.th, tx0 = tt % pl.tiles_x * pl.tw;
    for (int i = tid; i < pl.q; i += kThreads)
      s.slot_px[i] = slot_pixel(pl, u, 0, i);
    for (int i = tid; i < pl.p; i += kThreads) {
      const int r = i / pl.tw, c = i % pl.tw;
      const int gy = ty0 + r, gx = tx0 + c;
      s.out_slot[i] = (r + 1) * pl.ww + c + 1;
      s.out_px[i] = gy < pl.H && gx < pl.W ? (b * pl.H + gy) * pl.W + gx : -1;
    }
    for (int i = tid; i < 9 * pl.p; i += kThreads) {
      const int o = i / 9, t = i - 9 * o;
      s.out_nbr[i] = (o / pl.tw + t / 3) * pl.ww + o % pl.tw + t % 3;
    }
  }
}

// Round R of the recursive halving over the K segments (lane bit TPW << R
// tells the partner): each lane keeps the lower or upper half of its live
// elements, adds its partner's copy of them, and moves them to the front.
// Rounds as template steps, so every index is a constant (a loop here was
// not unrolled, and v went to local memory).
template <int E, int LOG, int TPW, int R = 0>
__device__ __forceinline__ void halve(float (&v)[E], int seg) {
  if constexpr (R < LOG) {
    constexpr int half = E >> (R + 1);
    const bool up = seg >> R & 1;
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = up ? v[e] : v[e + half];
      const float keep = up ? v[e + half] : v[e];
      v[e] = keep + __shfl_xor_sync(0xffffffffu, send, TPW << R);
    }
    halve<E, LOG, TPW, R + 1>(v, seg);
  }
}

// The products of a unit: out[p][n] = sum over k < K of A[k LDA + p]
// Wt[k LDW + n], over npix pixels (a multiple of RP) and N columns. A
// thread owns RP = 8 pixels x RN columns: RN = 8 (NB = 1: columns 4 ng + j
// and N/2 + 4 ng + j, so that a quarter-warp's weight loads are 128
// contiguous bytes), RN = 4 (NB = 1: columns 4 ng + j; twice the threads,
// half the serial work each, for small units), or 4 columns of two sums N
// columns apart (NB = 2: the FFN's halves a and b); over one of KS
// segments of K, in order. The lanes of a warp are KS runs of TPW = 32 /
// KS tiles, one run per segment; the segments meet by recursive halving
// over warp shuffles (lane pairs add and swap halves: the same pairwise
// tree for every element, whatever the lane or the tile shape), which
// leaves each lane RP RN NB / KS consecutive elements of its tile.
// epi(n, p, v) gets 4 consecutive pixels p.. of column n: v[nb][i]. All
// threads call it (the shuffles need whole warps).
template <int C, int K, int N, int NB, int RN, int LDA, int LDW, class Epi>
__device__ __forceinline__ void product(const float* A, const float* Wt,
                                        int npix, Epi epi) {
  constexpr int KS = ksplit(C), KN = K / KS, TPW = 32 / KS;
  constexpr int NG = N / RN, E = RP * RN * NB, NW = RN * NB;
  constexpr int SLICE = E / KS, SLOTS = kThreads / KS;
  constexpr int LOG_KS = KS == 8 ? 3 : KS == 4 ? 2 : KS == 2 ? 1 : 0;
  static_assert(1 << LOG_KS == KS, "KS: a power of two up to 8");
  static_assert(K % KS == 0 && N % 8 == 0 && (NW == 8 || NW == 4) &&
                    (NB == 1 || RN == 4), "product shape");
  static_assert(SLICE % (4 * NB) == 0, "a lane's slice: whole 4-pixel runs");
  const int lane = threadIdx.x % 32, seg = lane / TPW;
  int base = 0;                        // the lane's slice after the halving
#pragma unroll
  for (int r = 0; r < LOG_KS; ++r)
    if (seg >> r & 1) base += E >> (r + 1);
  const int ntile = npix / RP * NG;
  for (int t0 = 0; t0 < ntile; t0 += SLOTS) {
    const int t = t0 + threadIdx.x / 32 * TPW + lane % TPW;
    const bool on = t < ntile;
    const int pg = t / NG, ng = t - pg * NG;
    float v[E];                        // v[(j RP + i) NB + nb]
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = 0.0f;
    if (on) {
      const float* a = A + seg * KN * LDA + RP * pg;
      const float* w = Wt + seg * KN * LDW + 4 * ng;
      constexpr int W2 = NB == 1 ? N / 2 : N;   // the second float4's column
#pragma unroll 2
      for (int k = 0; k < KN; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + k * LDA);
        const float4 a1 = *reinterpret_cast<const float4*>(a + k * LDA + 4);
        const float4 w0 = *reinterpret_cast<const float4*>(w + k * LDW);
        const float4 w1 =
            NW == 8 ? *reinterpret_cast<const float4*>(w + k * LDW + W2)
                    : w0;
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int c = 0; c < NW; ++c)   // NB = 1: column c; NB = 2: c % 4, half c / 4
#pragma unroll
          for (int i = 0; i < RP; ++i) {
            const int e = NB == 1 ? c * RP + i : ((c % 4) * RP + i) * 2 + c / 4;
            v[e] = fmaf(av[i], wv[c], v[e]);
          }
      }
    }
    halve<E, LOG_KS, TPW>(v, seg);
    if (on) {
#pragma unroll
      for (int e0 = 0; e0 < SLICE; e0 += 4 * NB) {
        const int g0 = base + e0, col = g0 / (RP * NB), i0 = g0 / NB % RP;
        const int n = RN == 4 || col < 4 ? 4 * ng + col
                                         : N / 2 + 4 * ng + col - 4;
        float vals[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) vals[nb][i] = v[e0 + i * NB + nb];
        epi(n, RP * pg + i0, vals);
      }
    }
  }
}

// Whether a C-column product over npix pixels takes 8 x 4 thread tiles:
// where they fit the thread block in one pass (else 8 x 8 tiles).
template <int C>
__device__ __forceinline__ bool narrow(int npix) {
  return npix / RP * (C / 4) * ksplit(C) <= kThreads;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One block on the current unit. src: the batch's input stack, or null
// when X already holds it (a chain's later block on whole images); dst:
// the output stack, or null to leave y in X for the next block; q: the
// last block's per-channel scale or null. ph: the parity of this block's
// weights; wn: the weights the next step needs, or null (none, or these):
// each group is copied in right after this block's last read of it.
// With pl.cs > 1 the unit spans a cluster: h crosses between its CTAs
// (the depthwise reads a neighbour's H through distributed shared memory),
// between two cluster barriers.
template <int C>
__device__ void run_block(const Smem<C>& s, const Plan& pl, int u, int rank,
                          const float* src, float* dst,
                          const float* __restrict__ q, bool shortcut,
                          uint32_t ph, const float* wn) {
  const int tid = threadIdx.x;
  const auto sync_unit = [&]() {
    if (pl.cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  const bool lead = tid == 0 && wn != nullptr;
  const float* taps = s.w + 8 * C * C;
  const float* b0 = taps + 9 * C;
  const float* b2 = b0 + C;
  const float* b3 = b2 + C;
  const float* bf0 = b3 + C;
  const float* bf2 = bf0 + 4 * C;

  // ---- the input window, channel-major: X[k][slot]; kLoads loads in
  // flight a thread (one at a time waited on L2 once per element) ----
  if (src != nullptr) {
    constexpr int kLoads = 8;
    const int total = pl.q * C;
    for (int i0 = tid; i0 < total; i0 += kThreads * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads, sl = i / C;
        // whole images: no table needed (nor a barrier after it)
        const int px = i >= total ? -1
                       : pl.whole ? slot_pixel(pl, u, rank, sl)
                                  : s.slot_px[sl];
        v[r] = px >= 0 ? __ldcg(src + (size_t)px * C + (i - sl * C)) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int i = i0 + r * kThreads, sl = i / C;
        if (i < total) s.X[(i - sl * C) * LDQ + sl] = v[r];
      }
    }
    __syncthreads();
  }

  // ---- stage A: h = wsilu(x W0 + b0) at the window, 0 outside ----
  hop::mbar_wait(&s.bar[0], ph);
  // h pixel-major (H[slot C + n]): the depthwise's lanes take channels
  const auto epi_h = [&](int n, int p, const float(&v)[1][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s.H[(p + i) * C + n] =
          s.slot_px[p + i] >= 0 ? wsilu(v[0][i] + b0[n]) : 0.0f;
  };
  if (narrow<C>(pl.q))
    product<C, C, C, 1, 4, LDQ, C>(s.X, s.w, pl.q, epi_h);
  else
    product<C, C, C, 1, 8, LDQ, C>(s.X, s.w, pl.q, epi_h);
  sync_unit();                         // every CTA's h is written
  if (lead) load_group<C>(s, wn, 0);

  // ---- depthwise 3x3: g = b2 + sum of taps x h, zeros past the window ----
  hop::mbar_wait(&s.bar[1], ph);
  // the H of each CTA of the cluster (this one's at its own rank)
  const float* hs[MAX_CS] = {s.H, s.H, s.H, s.H};
  if (pl.cs > 1) {
    cg::cluster_group cl = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r)
      if (r < pl.cs) hs[r] = cl.map_shared_rank(s.H, r);
  }
  // a thread takes 4 consecutive outputs of one channel; a warp's lanes
  // take consecutive channels of the same outputs (the neighbour table is
  // read once a warp, h in 128 contiguous bytes)
  for (int i = tid; i < C * pl.p / 4; i += kThreads) {
    const int n = i % C, p = 4 * (i / C);
    float t9[9], g[4];
#pragma unroll
    for (int t = 0; t < 9; ++t) t9[t] = taps[t * C + n];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      float v = b2[n];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int e = s.out_nbr[9 * (p + o) + t], r = e >> 8;
        const float* h = r == 0 ? hs[0] : r == 1 ? hs[1] : r == 2 ? hs[2]
                                                                   : hs[3];
        v = fmaf(t9[t], e >= 0 ? h[(e & 255) * C + n] : 0.0f, v);
      }
      g[o] = v;
    }
    store4(s.G + n * LDP + p, g);
  }
  sync_unit();                         // no CTA reads this one's h again
  if (lead) load_group<C>(s, wn, 1);

  // ---- u = x + (g W3 + b3), into H's bytes (h is dead) ----
  hop::mbar_wait(&s.bar[2], ph);
  const auto epi_u = [&](int n, int p, const float(&v)[1][4]) {
    float u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = s.X[n * LDQ + s.out_slot[p + i]] + (v[0][i] + b3[n]);
    store4(s.H + n * LDQ + p, u);
  };
  if (narrow<C>(pl.p))
    product<C, C, C, 1, 4, LDP, C>(s.G, s.w + C * C, pl.p, epi_u);
  else
    product<C, C, C, 1, 8, LDP, C>(s.G, s.w + C * C, pl.p, epi_u);
  __syncthreads();
  if (lead) load_group<C>(s, wn, 2);

  // ---- f = wsilu(u Wf0a + bf0a) + wsilu(u Wf0b + bf0b), into G's bytes ----
  hop::mbar_wait(&s.bar[3], ph);
  product<C, C, 2 * C, 2, 4, LDQ, 4 * C>(
      s.H, s.w + 2 * C * C, pl.p, [&](int n, int p, const float(&v)[2][4]) {
        float f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f[i] = wsilu(v[0][i] + bf0[n]) + wsilu(v[1][i] + bf0[2 * C + n]);
        store4(s.G + n * LDP + p, f);
      });
  __syncthreads();
  if (lead) load_group<C>(s, wn, 3);

  // ---- y = (f Wf2 + bf2) + u [+ x] [* q] -> the frame, or X ----
  hop::mbar_wait(&s.bar[4], ph);
  const auto epi_y = [&](int n, int p, const float(&v)[1][4]) {
    const float qn = q != nullptr ? __ldg(q + n) : 1.0f;
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t = (v[0][i] + bf2[n]) + s.H[n * LDQ + p + i];
      if (shortcut) t += s.X[n * LDQ + s.out_slot[p + i]];
      if (q != nullptr) t *= qn;
      y[i] = t;
    }
    if (dst == nullptr) {
      store4(s.X + n * LDQ + p, y);     // whole images: slot p is output p
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = s.out_px[p + i];
        if (px >= 0) dst[(size_t)px * C + n] = y[i];
      }
    }
  };
  if (narrow<C>(pl.p))
    product<C, 2 * C, C, 1, 4, LDP, C>(s.G, s.w + 6 * C * C, pl.p, epi_y);
  else
    product<C, 2 * C, C, 1, 8, LDP, C>(s.G, s.w + 6 * C * C, pl.p, epi_y);
  __syncthreads();
  if (lead) load_group<C>(s, wn, 4);
}

// n blocks (weights w, 8 C^2 + 17 C floats each). Whole-image units run all
// n on a unit in shared memory; tile units run block j on every unit, then
// meet at a grid-wide barrier (cooperative launch for n > 1), block j
// reading x (j = 0) or the previous block's output and writing y (the last)
// or s, as ops/dcb_chain.py:buffer_plan.
template <int C>
__global__ void __launch_bounds__(kThreads)
dcb_f32_kernel(const float* x, float* y, float* s,
               const float* __restrict__ w, const float* __restrict__ q,
               Plan pl, int n, int shortcut) {
  extern __shared__ __align__(128) unsigned char raw[];
  const Smem<C> sm(raw);
  constexpr size_t per = weight_floats(C);
  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g) hop::mbar_init(&sm.bar[g], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)                        // W0 first, the rest behind
    for (int g = 0; g < kGroups; ++g) load_group<C>(sm, w, g);
  uint32_t ph = 0;
  if (pl.whole) {
    // a cluster of pl.cs CTAs per unit (a cluster's CTAs are consecutive)
    const int rank = blockIdx.x % pl.cs, clusters = gridDim.x / pl.cs;
    for (int u = blockIdx.x / pl.cs; u < pl.units; u += clusters) {
      const bool more = u + clusters < pl.units;
      setup_unit<C>(sm, pl, u, rank);
      for (int j = 0; j < n; ++j) {
        const int next = j + 1 < n ? j + 1 : more ? 0 : -1;
        const float* wn = next >= 0 && next != j ? w + next * per : nullptr;
        const bool last = j == n - 1;
        run_block<C>(sm, pl, u, rank, j == 0 ? x : nullptr,
                     last ? y : nullptr, last ? q : nullptr, shortcut != 0,
                     ph, wn);
        if (wn != nullptr) ph ^= 1;
      }
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const float* src = j == 0 ? x : ((n - j) % 2 == 0 ? y : s);
      float* dst = (n - 1 - j) % 2 == 0 ? y : s;
      for (int u = blockIdx.x; u < pl.units; u += gridDim.x) {
        const bool last_unit = u + (int)gridDim.x >= pl.units;
        setup_unit<C>(sm, pl, u, 0);
        __syncthreads();
        run_block<C>(sm, pl, u, 0, src, dst, j == n - 1 ? q : nullptr,
                     shortcut != 0, ph,
                     last_unit && j + 1 < n ? w + (j + 1) * per : nullptr);
      }
      if (j + 1 < n) {
        ph ^= 1;
        cg::this_grid().sync();
      }
    }
  }
}

// Thread blocks that fit on the card at once, by device and C / 8 (0: not
// queried yet). Internal linkage: a static inside the template below would
// be one object for every library loaded in the process that holds the
// same instantiation, and another copy of this kernel would then skip its
// own shared-memory attribute.
static std::atomic<int> slots_table[kMaxDevices][kMaxC / 8 + 1];

// The shared-memory attribute, SM count and occupancy for C, queried once
// per device.
template <int C>
cudaError_t launch_slots(int* slots) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& entry = slots_table[dev][C / 8];
  int v = entry.load(std::memory_order_acquire);
  if (v == 0) {
    auto kern = dcb_f32_kernel<C>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(C));
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem_bytes(C));
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    v = sms * per_sm;
    entry.store(v, std::memory_order_release);
  }
  *slots = v;
  return cudaSuccess;
}

template <int C>
int launch(const float* x, float* y, float* s, const float* w,
           const float* q, int B, int H, int W, int n, int shortcut,
           cudaStream_t st) {
  int slots = 0;
  cudaError_t e = launch_slots<C>(&slots);
  if (e != cudaSuccess) return e;
  Plan pl = make_plan(B, H, W);
  const int units = slots / pl.cs;              // clusters that fit at once
  const int grid = (pl.units < units ? pl.units : units) * pl.cs;
  auto kern = dcb_f32_kernel<C>;
  if (pl.cs > 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes(C);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, x, y, s, w, q, pl, n, shortcut);
    if (e != cudaSuccess) return e;
  } else if (n == 1 || pl.whole) {
    kern<<<grid, kThreads, smem_bytes(C), st>>>(x, y, s, w, q, pl, n,
                                                shortcut);
  } else {
    void* args[] = {&x, &y, &s, &w, &q, &pl, &n, &shortcut};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(grid), dim3(kThreads), args,
                                    smem_bytes(C), st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace dcbf

extern "C" int ssgvc_dcb_f32_forward(const void* x, void* y, void* s,
                                     const void* w, const void* q, int B,
                                     int H, int W, int C, int n, int shortcut,
                                     void* stream) {
  using namespace dcbf;
  if (B <= 0 || H <= 0 || W <= 0 || n <= 0 || C < 8 || C > kMaxC || C % 8 ||
      (n > 1 && shortcut))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16) return cudaErrorMisalignedAddress;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(s);
  const float* wp = static_cast<const float*>(w);
  const float* qp = static_cast<const float*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch<8>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 16: return launch<16>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 24: return launch<24>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 32: return launch<32>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 40: return launch<40>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 48: return launch<48>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 56: return launch<56>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
    case 64: return launch<64>(xp, yp, sp, wp, qp, B, H, W, n, shortcut, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one thread block at C (0 if the kernel does not
// take C): ops/dcb.py:f32_smem_bytes must agree.
extern "C" int ssgvc_dcb_f32_smem(int C) {
  using namespace dcbf;
  return C >= 8 && C <= kMaxC && C % 8 == 0 ? smem_bytes(C) : 0;
}

// The unit plan of a (B, H, W) batch as kPlanFields ints in Plan's order
// (ops/dcb.py:f32_plan must agree); returns the field count.
extern "C" int ssgvc_dcb_f32_plan(int B, int H, int W, int* out) {
  using namespace dcbf;
  const Plan pl = make_plan(B, H, W);
  const int f[kPlanFields] = {pl.B, pl.H, pl.W, pl.whole, pl.g, pl.cs, pl.th,
                              pl.tw, pl.tiles_x, pl.tiles, pl.units, pl.ww,
                              pl.q, pl.p};
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  return kPlanFields;
}

// K segments of every product at C (ops/dcb.py:f32_ksplit must agree).
extern "C" int ssgvc_dcb_f32_ksplit(int C) { return dcbf::ksplit(C); }

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
