// W8A8 int8 convolution for sm_90a: the forward of the JAX package's
// QuantConv (ssgvc_tpu/layers/blocks.py:170-240), whose int8 conv is an XLA
// convolution there (lax.conv_general_dilated on int8 operands with int32
// accumulation, :234-238), not a Pallas kernel. PyTorch has no int8
// convolution on CUDA, so the port computes it here.
//
//   xq[p, k]  = clamp(rint(x / s_x), -127, 127)          quantized once
//   acc[p, o] = sum_k xq[p, k] * wq[o, k]                 exact, int32
//   y[p, o]   = (float(acc) * (s_x * s_w[o])) + b[o]      unfused, rounded once
//                                                          to y's dtype
//
// Rows are output pixels (B * Ho * Wo), columns output channels, K = kh *
// kw * Cin in (ky, kx, ci) order with ci fastest. s_x is a device scalar (no
// host sync: mode 1 computes it on the card), s_w and b are fp32 (O,).
// Arithmetic: __fdiv_rn, the clamp and rint's rounding half to even (as
// jnp.round and torch.round; quant_bits), the int32 sum exact in any
// order, then __int2float_rn and the unfused __fmul_rn / __fadd_rn in the
// JAX package's order: every route equals ops/qconv.py:qconv_plain bit for
// bit. Never build this file with --use_fast_math.
//
// Two routes, chosen by shape in ops/qconv.py:qconv_cuda (route_of), each
// counted (ops.qconv.launches_1x1, launches_gemm):
//
// 1x1: kernel 1, stride 1, no padding, Cin % 16 == 0, x 16-byte aligned,
//   and the shared memory of ops/qconv.py:plan_1x1 within the limit (Cin
//   to 2048). These are the DepthConvBlocks' and adaptors' 1x1s, 134 of an
//   int8 P-frame's 140 launches and 95% of the time of the earlier
//   one-route kernel there. y = x W^T, (M x Cin) by (Cin x O): at these shapes the bytes (x read
//   once, y written once; O >= Cin at most sites) bound it, the products
//   taking a few microseconds at 1979 TOP/s. A thread block owns 64 or 128
//   rows and every output column, in consumer warpgroups of 64 rows and a
//   producer warp a ring: two row groups sharing one ring (128 rows, where
//   M gives at least 132 such blocks), or two N groups, each on alternate
//   N tiles from a ring of its own (64 rows, two N tiles or more), or one
//   warpgroup (one N tile). What it does about that kernel's faults:
//   - x quantized once per launch, not once per 64 output channels: the
//     block's consumer threads read its rows once, four 16-channel chunks
//     in flight a thread, and quantize each element once into shared
//     memory in the canonical K-major layout (csrc/hopper.cuh; an int8 core
//     matrix is 8 rows x 16 bytes, so chunk q lands at byte 16 q), Cin
//     zero-padded to KQ, a multiple of KC. O is not split over blocks: that
//     would read and quantize x again. The 64-row blocks give the 68x120
//     frames 128 blocks for 132 SMs; the hyper path's 17x30 and 34x60 have
//     8-32 and are latency-bound.
//   - A pipeline instead of load / sync / product / sync: the weights,
//     packed once per weight version by ops/qconv.py:pack_weight (kept in
//     layers/blocks.py:Conv's cache) as one contiguous BN x KC canonical
//     slot per (N tile, K chunk), stay in L2 (at most 2 MB) and arrive by
//     one 1-D cp.async.bulk a slot into a ring of S slots under full /
//     empty mbarriers, while the warpgroups run wgmma.mma_async m64nBNk32
//     s8 x s8 -> s32 (BN = 32, 64 or 128, ops/qconv.py:tile_n; the s8
//     forms of csrc/wgmma.cuh) into int32 registers, one slot's products in
//     flight while the next is awaited. The plan keeps two blocks an SM
//     where shared memory allows three slots or more, so one block's x
//     loads and quantizing overlap another's products and stores.
//   - Whole rows stored, not 2-byte scatters: each N tile's outputs are
//     rounded, 64 columns at a time, into a staging row per output pixel
//     (8 outputs of padding keep the pair stores on distinct banks), with
//     the columns' s_x s_w and b read from shared memory, where the block
//     put them once; each warp then stores its 16 rows by cp.async.bulk
//     shared -> global, one row segment a copy, and goes on to the next
//     tile's products while the copies drain. A row whose bytes are not a
//     multiple of 16 (O * size) is stored element by element instead.
//   - wgmma instead of mma.sync, with both operands in shared memory.
//   The conversion unit, a quarter of the adds' rate, was the quantizing's
//   limit at Cin >= 512: quant_bits clamps and then rounds by an add, so
//   only the division's reciprocal stays on it.
//
// gemm: every other site (kernel > 1, stride > 1, padding, Cin % 16 != 0,
//   unaligned x). A first kernel quantizes x once into int8 NHWC scratch
//   (16 elements a thread where x is 16-byte aligned); an implicit GEMM then
//   reads the int8 values: 64x64 output tiles of 128 threads (four warps of
//   32x32), mma.sync m16n8k32 s8 on 32-deep K slices, double-buffered by
//   16-byte cp.async (zero-filled outside the frame) when Cin % 16 == 0,
//   else staged element by element; its epilogue stores outputs one by one.
//   An input pixel outside the frame is 0, as the JAX package's int8 zero
//   padding. The weights come as ops/qconv.py:quantize_weight's (O, Kp),
//   Kp = K rounded up to 32 with zero weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------- shared ----

// 16 consecutive input values as raw 16-byte words: 2 for bf16, 4 for fp32.
template <typename T>
struct Raw16;
template <>
struct Raw16<__nv_bfloat16> {
  static constexpr int N = 2;
};
template <>
struct Raw16<float> {
  static constexpr int N = 4;
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p,
                                         uint4 (&r)[Raw16<T>::N]) {
#pragma unroll
  for (int i = 0; i < Raw16<T>::N; ++i)
    r[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

__device__ __forceinline__ void unpack16(const uint4 (&r)[2], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void unpack16(const uint4 (&r)[4], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = __uint_as_float(r[i].x);
    v[4 * i + 1] = __uint_as_float(r[i].y);
    v[4 * i + 2] = __uint_as_float(r[i].z);
    v[4 * i + 3] = __uint_as_float(r[i].w);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clamp(rint(v / s_x), -127, 127) in the low byte of the result. The
// clamp comes first and the rounding after, as the add of 1.5 * 2^23: the
// floats there lie 1 apart, so the add rounds half to even to an integer
// exactly as rintf does, and its low byte is that integer's two's
// complement. Clamping first changes no value (rint and the clamp
// commute on [-127, 127]; NaN clamps to -127 either way, as fmaxf drops
// it), and it spares the conversion unit's rint and float-to-int, a
// quarter of the rate of the adds.
__device__ __forceinline__ uint32_t quant_bits(float v, float sx) {
  const float t = fminf(fmaxf(__fdiv_rn(v, sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

__device__ __forceinline__ int8_t quant(float v, float sx) {
  return static_cast<int8_t>(quant_bits(v, sx) & 0xffu);
}

__device__ __forceinline__ uint4 quant16(const float (&v)[16], float sx) {
  uint32_t pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pk[i] = __byte_perm(__byte_perm(quant_bits(v[4 * i], sx),
                                    quant_bits(v[4 * i + 1], sx), 0x0040),
                        __byte_perm(quant_bits(v[4 * i + 2], sx),
                                    quant_bits(v[4 * i + 3], sx), 0x0040),
                        0x5410);
  return make_uint4(pk[0], pk[1], pk[2], pk[3]);
}

__device__ __forceinline__ float dequant(int acc, float scale, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), b);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- bulk stores shared -> global (per-thread bulk groups) ----
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(hop::smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The sources of this thread's bulk stores may be overwritten.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// ------------------------------------------------------- the 1x1 route ----

// Must match ops/qconv.py (KC, ROWS_WG, STAGE_COLS, MAX_STAGES, SMEM_LIMIT,
// smem_1x1).
constexpr int KC = 64;          // K bytes of a ring slot: two k32 steps
constexpr int ROWS = 64;        // rows of a consumer warpgroup (wgmma M)
constexpr int STAGE_COLS = 64;  // output columns a staging row holds
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

// Staging row bytes: SW outputs and 8 outputs of padding, which keep the
// epilogue's pair stores on distinct banks (bf16) or half-warps (fp32).
__host__ __device__ constexpr int stage_row(int bn, int osz) {
  return ((bn < STAGE_COLS ? bn : STAGE_COLS) + 8) * osz;
}

// rg row groups of 64 and ng N groups: rg * 64 quantized rows, ng rings of
// `stages` slots, a staging block of 64 rows for each of the rg * ng
// consumer warpgroups, scale and bias of every (padded) output column, a
// full and an empty mbarrier a slot.
__host__ __device__ constexpr int smem_1x1(int rg, int ng, int bn, int kq,
                                           int stages, int osz, int o) {
  return rg * ROWS * kq + ng * stages * bn * KC +
         rg * ng * ROWS * stage_row(bn, osz) + 8 * ((o + bn - 1) / bn * bn) +
         ng * stages * 16;
}

// One thread block: BM = 64 RG rows from m0, every output column. Warps
// 0 .. 4 W - 1 (W = RG NG) are the consumer warpgroups: warpgroup i has
// row group i % RG and N group i / RG, which takes the N tiles t with t %
// NG == its N group from ring i / RG. Warp 4 W + g is ring g's producer
// (its lane 0 issues every copy).
template <typename TI, typename TO, int RG, int NG, int BN>
__global__ void __launch_bounds__(RG * NG * 128 + NG * 32,
                                  RG * NG == 2 ? 2 : 3)
    qconv_1x1(const TI* __restrict__ x, const int8_t* __restrict__ wp,
              const float* __restrict__ sw, const float* __restrict__ bias,
              const float* __restrict__ sxp, TO* __restrict__ y, int M, int C,
              int O, int KQ, int S) {
  constexpr int W = RG * NG, BM = RG * ROWS, OSZ = sizeof(TO);
  constexpr int SW = BN < STAGE_COLS ? BN : STAGE_COLS;
  constexpr int RS = stage_row(BN, OSZ), SLOT = BN * KC;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int NC = KQ / KC, NT = (O + BN - 1) / BN, OP = NT * BN;
  unsigned char* A = smem;
  unsigned char* rings = A + BM * KQ;
  unsigned char* stg = rings + NG * S * SLOT;
  float* scl = reinterpret_cast<float*>(stg + W * ROWS * RS);
  float* bia = scl + OP;
  uint64_t* full = reinterpret_cast<uint64_t*>(bia + OP);
  uint64_t* empty = full + NG * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;

  if (tid == 0) {
    for (int s = 0; s < NG * S; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], RG * 4);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= W * 4) {  // producer of ring g: its tiles' slots, in order
    const int g = warp - W * 4;
    if (lane == 0) {
      unsigned char* ring = rings + g * S * SLOT;
      int i = 0;
      for (int t = g; t < NT; t += NG)
        for (int c = 0; c < NC; ++c, ++i) {
          const int s = i % S;
          hop::mbar_wait(&empty[g * S + s], ((i / S) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&full[g * S + s], SLOT);
          hop::bulk_load(ring + s * SLOT,
                         wp + (static_cast<size_t>(t) * NC + c) * SLOT, SLOT,
                         &full[g * S + s]);
        }
    }
    return;
  }

  const float sx = __ldg(sxp);
  // the block's rows of x, read and quantized once by every consumer
  // thread. Chunk q (16 channels) is row 8 (q / 8 CH) + q % 8, channels 16
  // ((q / 8) % CH), and its canonical bytes are 16 q .. 16 q + 15 (row group
  // r / 64 at byte 64 KQ (r / 64)).
  {
    const int CH = KQ / 16, total = BM * CH;
    constexpr int U = 4;
    for (int q0 = tid; q0 < total; q0 += W * 128 * U) {
      uint4 raw[U][Raw16<TI>::N];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + W * 128 * u;
        const int r = (q / (8 * CH)) * 8 + (q & 7), kc = (q >> 3) % CH;
        const int m = m0 + r;
        ok[u] = q < total && m < M && kc * 16 < C;
        if (ok[u]) load_raw(x + static_cast<size_t>(m) * C + kc * 16, raw[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + W * 128 * u;
        if (q < total) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (ok[u]) {
            float f[16];
            unpack16(raw[u], f);
            v = quant16(f, sx);
          }
          *reinterpret_cast<uint4*>(A + 16 * q) = v;
        }
      }
    }
    // s_x s_w[o] and b[o] of every column, zero past O
    for (int o = tid; o < OP; o += W * 128) {
      scl[o] = o < O ? __fmul_rn(sx, __ldg(sw + o)) : 0.f;
      bia[o] = o < O ? __ldg(bias + o) : 0.f;
    }
  }
  hop::fence_proxy_async();
  hop::named_bar(1, W * 128);

  const int wgi = warp >> 2, wl = warp & 3, rg = wgi % RG, ng = wgi / RG;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* Aw = A + rg * ROWS * KQ;
  const unsigned char* ring = rings + ng * S * SLOT;
  uint64_t* rfull = full + ng * S;
  uint64_t* rempty = empty + ng * S;
  unsigned char* st = stg + (wgi * ROWS + wl * 16) * RS;  // this warp's rows
  const int rowbase = m0 + rg * ROWS + wl * 16;            // its first row
  const bool bulk = (O * OSZ) % 16 == 0;
  const uint32_t sbo_a = 8 * KQ;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int count = 0;
  for (int t = ng; t < NT; t += NG) {
    int prev = -1;
    for (int c = 0; c < NC; ++c, ++count) {
      const int s = count % S;
      hop::mbar_wait(&rfull[s], (count / S) & 1);
      hop::wg_fence();
      fence_acc(acc);
      const unsigned char* a = Aw + c * (KC / 16) * 128;
      const unsigned char* b = ring + s * SLOT;
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
        hop::WgmmaS8<BN>::mma(acc, hop::desc(a + kk * 256, 128, sbo_a),
                              hop::desc(b + kk * 256, 128, 8 * KC),
                              (c | kk) != 0);
      hop::wg_commit();
      hop::wg_wait<1>();
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&rempty[prev]);
      }
      prev = s;
    }
    hop::wg_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&rempty[prev]);

    // epilogue, SW columns at a time: accumulator i holds row g + 8 ((i >>
    // 1) & 1) of the warp's 16 and column 8 (i >> 2) + 2 t4 + (i & 1)
#pragma unroll
    for (int hh = 0; hh < BN / SW; ++hh) {
      const int n0 = t * BN + hh * SW, ncols = min(SW, O - n0);
      if (bulk && lane < 16) bulk_wait_read();
      __syncwarp();
#pragma unroll
      for (int j = 0; j < SW / 8; ++j) {
        const int jj = hh * (SW / 8) + j, col = 8 * j + 2 * t4;
        const float2 sc = *reinterpret_cast<const float2*>(scl + n0 + col);
        const float2 bb = *reinterpret_cast<const float2*>(bia + n0 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(reinterpret_cast<TO*>(st + (g + 8 * h) * RS) + col,
                 dequant(acc[4 * jj + 2 * h], sc.x, bb.x),
                 dequant(acc[4 * jj + 2 * h + 1], sc.y, bb.y));
      }
      if (ncols <= 0) continue;
      if (bulk) {
        hop::fence_proxy_async();
        __syncwarp();
        if (lane < 16) {
          const int m = rowbase + lane;
          if (m < M)
            bulk_store(y + static_cast<size_t>(m) * O + n0, st + lane * RS,
                       ncols * OSZ);
          bulk_commit();
        }
      } else {
        __syncwarp();
        for (int r = 0; r < 16; ++r) {
          const int m = rowbase + r;
          if (m >= M) break;
          const TO* src = reinterpret_cast<const TO*>(st + r * RS);
          for (int cc = lane; cc < ncols; cc += 32)
            y[static_cast<size_t>(m) * O + n0 + cc] = src[cc];
        }
        __syncwarp();
      }
    }
  }
  if (bulk && lane < 16) bulk_wait();
}

// Whether each instance's shared-memory limit is raised to SMEM_LIMIT yet:
// once per instance and process (a namespace-scope table, one per library).
bool smem_raised[2][2][5];

template <typename TI, typename TO, int RG, int NG, int BN>
int launch_1x1(const void* x, const void* wp, const void* sw,
               const void* bias, const void* sx, void* y, int M, int C,
               int O, int KQ, int S, int smem, cudaStream_t stream) {
  auto kern = qconv_1x1<TI, TO, RG, NG, BN>;
  bool& raised = smem_raised[sizeof(TI) == 4][sizeof(TO) == 4]
                            [RG == 2 ? 0 : NG == 2 ? 1 : BN / 64 + 2];
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const unsigned grid = static_cast<unsigned>((M + RG * ROWS - 1) /
                                              (RG * ROWS));
  kern<<<grid, RG * NG * 128 + NG * 32, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const float*>(sx), static_cast<TO*>(y), M, C, O, KQ, S);
  return cudaGetLastError();
}

// The instances: 128 rows (two row groups) at BN = 128; 64 rows with two N
// groups at BN = 128 (two N tiles or more); 64 rows, one warpgroup, at BN =
// 128, 64 or 32 (one N tile).
template <typename TI, typename TO>
int dispatch_1x1(const void* x, const void* wp, const void* sw,
                 const void* bias, const void* sx, void* y, int M, int C,
                 int O, int rg, int ng, int bn, int KQ, int S, int smem,
                 cudaStream_t st) {
  if (rg == 2)
    return launch_1x1<TI, TO, 2, 1, 128>(x, wp, sw, bias, sx, y, M, C, O, KQ,
                                         S, smem, st);
  if (ng == 2)
    return launch_1x1<TI, TO, 1, 2, 128>(x, wp, sw, bias, sx, y, M, C, O, KQ,
                                         S, smem, st);
  if (bn == 128)
    return launch_1x1<TI, TO, 1, 1, 128>(x, wp, sw, bias, sx, y, M, C, O, KQ,
                                         S, smem, st);
  if (bn == 64)
    return launch_1x1<TI, TO, 1, 1, 64>(x, wp, sw, bias, sx, y, M, C, O, KQ,
                                        S, smem, st);
  return launch_1x1<TI, TO, 1, 1, 32>(x, wp, sw, bias, sx, y, M, C, O, KQ, S,
                                      smem, st);
}

// ------------------------------------------------------ the gemm route ----

constexpr int GBM = 64;         // output pixels per tile
constexpr int GBN = 64;         // output channels per tile
constexpr int BK = 32;          // K slice: one m16n8k32 step deep
constexpr int LDS = BK + 16;    // bytes per staged row: 48 keeps the
                                // fragment reads of 8 rows on distinct banks
constexpr int GTHREADS = 128;
constexpr int QTHREADS = 256;   // the quantizing pass

struct Shape {
  int B, H, W, C, O, kh, kw, stride, pt, pl, Ho, Wo, K, Kp;
};

// x -> int8 NHWC, each element once. vec: x 16-byte aligned.
template <typename TI>
__global__ void __launch_bounds__(QTHREADS)
    qconv_quantize(const TI* __restrict__ x, int8_t* __restrict__ xq,
                   const float* __restrict__ sxp, long long n, int vec) {
  const float sx = __ldg(sxp);
  const long long step = static_cast<long long>(gridDim.x) * QTHREADS;
  const long long i = static_cast<long long>(blockIdx.x) * QTHREADS +
                      threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n16 = n / 16;
    for (long long c = i; c < n16; c += step) {
      uint4 raw[Raw16<TI>::N];
      load_raw(x + c * 16, raw);
      float f[16];
      unpack16(raw, f);
      reinterpret_cast<uint4*>(xq)[c] = quant16(f, sx);
    }
    tail = n16 * 16;
  }
  for (long long e = tail + i; e < n; e += step)
    xq[e] = quant(to_f(x[e]), sx);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// VEC: Cin % 16 == 0, so each thread's 16 K values lie in one tap and are
// one pixel's contiguous channels: one 16-byte cp.async.
template <typename TO, bool VEC>
__global__ void __launch_bounds__(GTHREADS)
    qconv_gemm(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ sw, const float* __restrict__ bias,
               const float* __restrict__ sxp, TO* __restrict__ y, Shape s) {
  __shared__ __align__(16) int8_t As[2][GBM * LDS];
  __shared__ __align__(16) int8_t Bs[2][GBN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const float sx = __ldg(sxp);
  const int M = s.B * s.Ho * s.Wo;

  // the A row (an output pixel) and the 16-wide half of the K slice this
  // thread stages; the B row (an output channel) likewise
  const int row = tid >> 1, half = (tid & 1) * 16;
  const int am = m0 + row;
  const bool arow = am < M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xb = xq;
  if (arow) {
    const int hw = s.Ho * s.Wo;
    const int b = am / hw, rem = am - b * hw;
    const int oy = rem / s.Wo, ox = rem - oy * s.Wo;
    iy0 = oy * s.stride - s.pt;
    ix0 = ox * s.stride - s.pl;
    xb = xq + static_cast<size_t>(b) * s.H * s.W * s.C;
  }
  const int bn = n0 + row;
  const int8_t* wrow = wq + static_cast<size_t>(bn < s.O ? bn : 0) * s.Kp +
                       half;

  auto stage = [&](int k0, int buf) {
    const int kb = k0 + half;
    int8_t* dst = As[buf] + row * LDS + half;
    if (VEC) {
      const int8_t* src = xq;
      bool valid = false;
      if (arow && kb < s.K) {
        const int tap = kb / s.C, ci = kb - tap * s.C;
        const int ky = tap / s.kw, kx = tap - ky * s.kw;
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
          valid = true;
          src = xb + (static_cast<size_t>(iy) * s.W + ix) * s.C + ci;
        }
      }
      hop::cp_async16(dst, src, valid);
    } else {
      uint32_t pk[4] = {0u, 0u, 0u, 0u};
      if (arow) {
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const int k = kb + j;
          if (k >= s.K) break;
          const int tap = k / s.C, ci = k - tap * s.C;
          const int ky = tap / s.kw, kx = tap - ky * s.kw;
          const int iy = iy0 + ky, ix = ix0 + kx;
          if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
            pk[j >> 2] |=
                static_cast<uint32_t>(static_cast<uint8_t>(
                    xb[(static_cast<size_t>(iy) * s.W + ix) * s.C + ci]))
                << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
    hop::cp_async16(Bs[buf] + row * LDS + half, wrow + k0, bn < s.O);
    cp_async_commit();
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[2][4][4] = {};
  const int nk = s.Kp / BK;

  stage(0, 0);
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    if (it + 1 < nk) {
      stage((it + 1) * BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r0 = As[buf] + (wm + mi * 16 + g) * LDS + t4 * 4;
      const int8_t* r1 = r0 + 8 * LDS;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c0 = Bs[buf] + (wn + ni * 8 + g) * LDS + t4 * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    __syncthreads();
  }

  // epilogue: accumulator (mi, ni, i) holds row g (+8 for i >= 2) and
  // column 2 t4 + (i & 1) of its 16x8 tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm + mi * 16 + g + (i >> 1) * 8;
        const int o = n0 + wn + ni * 8 + t4 * 2 + (i & 1);
        if (m >= M || o >= s.O) continue;
        store(y + static_cast<size_t>(m) * s.O + o,
              dequant(acc[mi][ni][i], __fmul_rn(sx, sw[o]), bias[o]));
      }
}

template <typename TI, typename TO>
int launch_gemm(const void* x, void* xq, const void* wq, const void* sw,
                const void* bias, const void* sx, void* y, const Shape& s,
                bool xvec, cudaStream_t stream) {
  const long long n = static_cast<long long>(s.B) * s.H * s.W * s.C;
  const long long work = xvec ? (n + 15) / 16 : n;
  const unsigned qgrid = static_cast<unsigned>(
      work / QTHREADS + 1 < 132 * 16 ? work / QTHREADS + 1 : 132 * 16);
  qconv_quantize<TI><<<qgrid, QTHREADS, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<int8_t*>(xq),
      static_cast<const float*>(sx), n, xvec ? 1 : 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long M = static_cast<long long>(s.B) * s.Ho * s.Wo;
  const dim3 grid(static_cast<unsigned>((M + GBM - 1) / GBM),
                  static_cast<unsigned>((s.O + GBN - 1) / GBN));
  auto kern = s.C % 16 == 0 ? qconv_gemm<TO, true> : qconv_gemm<TO, false>;
  kern<<<grid, GTHREADS, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const float*>(sx), static_cast<TO*>(y), s);
  return cudaGetLastError();
}

}  // namespace

// The 1x1 route's shared memory for a plan (ops/qconv.py:smem_1x1 mirrors
// it; experiments/qconv_turns.py checks the two agree on the card).
extern "C" int ssgvc_qconv_smem_1x1(int rg, int ng, int bn, int kq,
                                    int stages, int y_f32, int O) {
  return smem_1x1(rg, ng, bn, kq, stages, y_f32 ? 4 : 2, O);
}

// x (M, C) bf16 (x_f32 = 0) or fp32, 16-byte aligned, C % 16 == 0; wp the
// packed weights of ops/qconv.py:pack_weight for BN = bn, KQ = kq; y (M, O)
// bf16 (y_f32 = 0) or fp32; sw, bias (O,) fp32; sx one fp32. rg, ng, bn,
// kq, stages and smem are ops/qconv.py:plan_1x1's.
extern "C" int ssgvc_qconv_1x1(const void* x, int x_f32, const void* wp,
                               const void* sw, const void* bias,
                               const void* sx, void* y, int y_f32, int M,
                               int C, int O, int rg, int ng, int bn, int kq,
                               int stages, int smem, void* stream) {
  const bool inst = (rg == 2 && ng == 1 && bn == 128) ||
                    (rg == 1 && ng == 2 && bn == 128) ||
                    (rg == 1 && ng == 1);
  if (M < 1 || C < 16 || C % 16 || O < 1 || !inst || kq % KC || kq < C ||
      kq >= C + KC || stages < 2 || stages > MAX_STAGES ||
      smem > SMEM_LIMIT ||
      smem != smem_1x1(rg, ng, bn, kq, stages, y_f32 ? 4 : 2, O) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return y_f32 ? dispatch_1x1<float, float>(x, wp, sw, bias, sx, y, M, C, O,
                                              rg, ng, bn, kq, stages, smem,
                                              st)
                 : dispatch_1x1<float, __nv_bfloat16>(
                       x, wp, sw, bias, sx, y, M, C, O, rg, ng, bn, kq,
                       stages, smem, st);
  return y_f32 ? dispatch_1x1<__nv_bfloat16, float>(x, wp, sw, bias, sx, y, M,
                                                    C, O, rg, ng, bn, kq,
                                                    stages, smem, st)
               : dispatch_1x1<__nv_bfloat16, __nv_bfloat16>(
                     x, wp, sw, bias, sx, y, M, C, O, rg, ng, bn, kq, stages,
                     smem, st);
}

// x (B, H, W, C) bf16 (x_f32 = 0) or fp32; xq int8 scratch of x's size,
// 16-byte aligned; y (B, Ho, Wo, O) bf16 (y_f32 = 0) or fp32, Ho = (H + pt
// + pb - kh) / stride + 1, Wo likewise; wq (O, Kp) int8 with Kp = kh * kw *
// C rounded up to 32, 16-byte aligned; sw, bias (O,) fp32; sx one fp32.
extern "C" int ssgvc_qconv_gemm(const void* x, int x_f32, void* xq,
                                const void* wq, const void* sw,
                                const void* bias, const void* sx, void* y,
                                int y_f32, int B, int H, int W, int C, int O,
                                int kh, int kw, int stride, int pt, int pb,
                                int pl, int pr, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1 || kh < 1 || kw < 1 ||
      stride < 1 || pt < 0 || pb < 0 || pl < 0 || pr < 0 ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return cudaErrorInvalidValue;
  Shape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.kh = kh; s.kw = kw;
  s.stride = stride; s.pt = pt; s.pl = pl;
  s.Ho = (H + pt + pb - kh) / stride + 1;
  s.Wo = (W + pl + pr - kw) / stride + 1;
  s.K = kh * kw * C;
  s.Kp = (s.K + BK - 1) / BK * BK;
  if (s.Ho < 1 || s.Wo < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_f32)
    return y_f32 ? launch_gemm<float, float>(x, xq, wq, sw, bias, sx, y, s,
                                             xvec, st)
                 : launch_gemm<float, __nv_bfloat16>(x, xq, wq, sw, bias, sx,
                                                     y, s, xvec, st);
  return y_f32 ? launch_gemm<__nv_bfloat16, float>(x, xq, wq, sw, bias, sx, y,
                                                   s, xvec, st)
               : launch_gemm<__nv_bfloat16, __nv_bfloat16>(
                     x, xq, wq, sw, bias, sx, y, s, xvec, st);
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
