// The DepthConvBlock forward in float32: one block after its adaptor (with
// the optional shortcut, + x, and per-channel q, * q), or N adaptor-free,
// shortcut-free blocks in one persistent launch with q on the last output.
// fp32 NHWC (B, H, W, C), fp32 weights, fp32 sums: the math of
// ops/dcb.py:dcb_plain in fp32, where every rounding point is the identity.
// The fp32 route of the narrow blocks, C up to 64 (ops/dcb.py:uses_tf32):
// wider ones run on the 3xTF32 wgmma kernel, csrc/dcb_tf32.cu (2.3-2.7x
// faster on an H100 at 136x240 from C = 192 up), which computes at a width
// of at least 128: 2-16x the products of C = 64-8. This kernel itself
// takes every C up to 512.
//
// Replaces, for float32 activations, the TPU kernels _dcb_kernel
// (ssgvc_tpu/ops/pallas_dcb.py:68, through _dcb_fused / pl.pallas_call) and
// _chain_kernel (ssgvc_tpu/ops/pallas_dcb_chain.py:61, through _chain_call),
// which compute in the activation dtype (they cast their weights to x's).
//
// Bound on an H100 SXM: operations. 16 C^2 + 18 C per pixel against 8 C
// bytes moved in fp32: a 136x240 frame at C=256 is 34.4 GFLOP, at least
// 0.51 ms at 67 TFLOP/s fp32 (NVIDIA data sheet, outside the tensor cores),
// while its 67 MB of activations take 20 us at 3.35 TB/s.
//
// What the design does about it, simply: every product is SIMT fp32 FMA (no
// TF32, which keeps about three digits) with the operands' reuse held in
// registers, the weights read from L2 four rows ahead of their use
// (rows_dot; one load per row in flight ran 1.5-1.7x slower on the H100).
// A persistent grid walks the B x 8x4-pixel output tiles, each
// tile's one-pixel halo inside its own image (a 10x6 window, zero outside
// the frame), and runs the block in shared memory:
//   stage A: thread n holds output channel n of h = wsilu(x W0 + b0) at the
//     60 window pixels in registers, zeroes it outside the frame, runs the
//     depthwise 3x3 on it in registers and writes g (C x 32) to shared
//     memory; the window is stored channel-major, so each k of the product
//     reads one weight (coalesced over n) and 15 broadcast float4s;
//   stage B: u = x + g W3 + b3 (over the window's bytes), y = u + bf2 (over
//     g's); then the 2C hidden channels in chunks of the block's threads:
//     thread j computes f = wsilu(u Wf0a + bf0a) + wsilu(u Wf0b + bf0b) at
//     the 32 pixels, then thread n adds the chunk's f Wf2 to its y;
//   epilogue: [+ x] [* q], written at the tile's in-frame pixels.
// A thread block has min(256, C rounded up to 32) threads; the grid is as
// many blocks as fit on the card at once (at C = 512, one per SM: 216 KiB
// of shared memory). The chain runs its blocks one after the other with a
// grid-wide barrier between them, ping-ponging between the caller's y and
// one scratch tensor (ops/dcb_chain.py:buffer_plan). Sums run in a fixed
// order and the grid's split of the tiles changes no tile's arithmetic, so
// the same inputs give the same output bit for bit, at any batch size.
// Left for later: wider tiles, weights staged through shared memory.
//
// Weights (ops/dcb.py:pack_f32), per block, 8 C^2 + 17 C floats: W0^T
// (C x C, [in][out]), W3^T (C x C), Wf0^T (C x 4C), Wf2^T (2C x C), the
// depthwise taps (9 x C), b0, b2, b3 (C each), bf0 (4C), bf2 (C).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcbf {

namespace cg = cooperative_groups;

constexpr int TW = 8, TH = 4;                 // output tile: 8 wide, 4 high
constexpr int WW = TW + 2, WH = TH + 2;       // its window
constexpr int NWIN = WW * WH, NPIX = TW * TH;  // 60, 32
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float wsilu(float v) {   // silu(4v)/4
  return v / (1.0f + expf(-4.0f * v));
}

// Floats of shared memory for C channels and T threads: the window (C x 60,
// later u, C x 32), g (C x 32, later y) and one f chunk (T x 32).
__host__ __device__ inline int smem_floats(int C, int T) {
  return C * NWIN + C * NPIX + T * NPIX;
}

__host__ inline int threads_for(int C) {
  const int t = (C + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// acc[c][i] += sum over k < K of rows[k N + i] w[k ld + c off], k in order:
// the product of NW weight columns with K rows of N activations in shared
// memory (broadcast float4 reads). The weights come through L2, so each is
// loaded D rows ahead (K is a multiple of D; the kernel's K are multiples
// of 8): D loads in flight hide L2's latency, which one load per row did
// not.
template <int N, int NW>
__device__ __forceinline__ void rows_dot(float (&acc)[NW][N],
                                         const float* rows,
                                         const float* __restrict__ w,
                                         size_t ld, size_t off, int K) {
  constexpr int D = 4;
  float ring[D][NW];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int c = 0; c < NW; ++c) ring[d][c] = __ldg(w + d * ld + c * off);
  for (int k = 0; k < K; k += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float wk[NW];
      const int kn = k + d + D;
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        wk[c] = ring[d][c];
        ring[d][c] = kn < K ? __ldg(w + kn * ld + c * off) : 0.0f;
      }
      const float4* r4 = reinterpret_cast<const float4*>(rows + (k + d) * N);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 v = r4[i];
#pragma unroll
        for (int c = 0; c < NW; ++c) {
          acc[c][4 * i] += v.x * wk[c];
          acc[c][4 * i + 1] += v.y * wk[c];
          acc[c][4 * i + 2] += v.z * wk[c];
          acc[c][4 * i + 3] += v.w * wk[c];
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* row, const float (&v)[N]) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    r4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// One block on one 8x4 tile. src / dst: the batch's base pointers, a stack
// of (B H) rows x W x C; the tile's image holds rows [y_lo, y_hi), and its
// first output pixel is (ty0, tx0).
__device__ void block_tile(float* sm, const float* src, float* dst,
                           const float* __restrict__ w,
                           const float* __restrict__ q, bool shortcut, int C,
                           int y_lo, int y_hi, int W, int ty0, int tx0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* xs = sm;                      // window, then u
  float* gs = sm + C * NWIN;           // g, then y
  float* fs = gs + C * NPIX;           // f chunk
  const size_t CC = (size_t)C * C;
  const float* w0 = w;
  const float* w3 = w + CC;
  const float* wf0 = w + 2 * CC;
  const float* wf2 = w + 6 * CC;
  const float* taps = w + 8 * CC;
  const float* b0 = taps + 9 * C;
  const float* b2 = b0 + C;
  const float* b3 = b2 + C;
  const float* bf0 = b3 + C;
  const float* bf2 = bf0 + 4 * C;

  // in-frame rows and columns of the window
  uint32_t rowm = 0, colm = 0;
#pragma unroll
  for (int r = 0; r < WH; ++r) {
    const int gy = ty0 - 1 + r;
    rowm |= (uint32_t)(gy >= y_lo && gy < y_hi) << r;
  }
#pragma unroll
  for (int c = 0; c < WW; ++c) {
    const int gx = tx0 - 1 + c;
    colm |= (uint32_t)(gx >= 0 && gx < W) << c;
  }

  // ---- window, channel-major: xs[k][p] ----
  for (int i = tid; i < NWIN * C; i += nt) {
    const int p = i / C, k = i - p * C;
    const int r = p / WW, c = p - r * WW;
    float v = 0.0f;
    if ((rowm >> r & 1) && (colm >> c & 1))
      v = __ldcg(src + ((size_t)(ty0 - 1 + r) * W + (tx0 - 1 + c)) * C + k);
    xs[k * NWIN + p] = v;
  }
  __syncthreads();

  // ---- stage A: h at the window (registers), depthwise -> g ----
  for (int n = tid; n < C; n += nt) {
    float acc1[1][NWIN];
    float(&acc)[NWIN] = acc1[0];
    const float bias = __ldg(b0 + n);
#pragma unroll
    for (int p = 0; p < NWIN; ++p) acc[p] = bias;
    rows_dot(acc1, xs, w0 + n, C, 0, C);
#pragma unroll
    for (int p = 0; p < NWIN; ++p) {
      const bool in = (rowm >> (p / WW) & 1) && (colm >> (p % WW) & 1);
      acc[p] = in ? wsilu(acc[p]) : 0.0f;
    }
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = __ldg(taps + k * C + n);
    float g[NPIX];
    const float gb = __ldg(b2 + n);
#pragma unroll
    for (int p = 0; p < NPIX; ++p) {
      const int oy = p / TW, ox = p % TW;
      float v = gb;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        v += t[k] * acc[(oy + k / 3) * WW + ox + k % 3];
      g[p] = v;
    }
    store_row(gs + n * NPIX, g);
  }
  __syncthreads();

  // ---- stage B: u = x + g W3 + b3 (over the window), y = u + bf2 ----
  for (int n = tid; n < C; n += nt) {
    float u1[1][NPIX];
    float(&u)[NPIX] = u1[0];
    const float bias = __ldg(b3 + n);
#pragma unroll
    for (int p = 0; p < NPIX; ++p) u[p] = bias;
    rows_dot(u1, gs, w3 + n, C, 0, C);
#pragma unroll
    for (int p = 0; p < NPIX; ++p) {
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy < y_hi && gx < W)
        u[p] += __ldcg(src + ((size_t)gy * W + gx) * C + n);
    }
    // the window is dead once every thread is past stage A (above); u goes
    // to its bytes, read by the FFN after the barrier below
    store_row(xs + n * NPIX, u);
  }
  __syncthreads();                     // g is dead: y takes its bytes
  for (int n = tid; n < C; n += nt) {
    const float b = __ldg(bf2 + n);
#pragma unroll
    for (int p = 0; p < NPIX; ++p) gs[n * NPIX + p] = xs[n * NPIX + p] + b;
  }

  // ---- FFN: 2C hidden channels, nt at a time ----
  for (int j0 = 0; j0 < 2 * C; j0 += nt) {
    const int j = j0 + tid;
    if (j < 2 * C) {
      float f[2][NPIX];         // the two halves, a and b
      const float ba = __ldg(bf0 + j), bb = __ldg(bf0 + 2 * C + j);
#pragma unroll
      for (int p = 0; p < NPIX; ++p) {
        f[0][p] = ba;
        f[1][p] = bb;
      }
      rows_dot(f, xs, wf0 + j, 4 * (size_t)C, 2 * (size_t)C, C);
#pragma unroll
      for (int p = 0; p < NPIX; ++p) f[0][p] = wsilu(f[0][p]) + wsilu(f[1][p]);
      store_row(fs + tid * NPIX, f[0]);
    }
    __syncthreads();
    const int nj = 2 * C - j0 < nt ? 2 * C - j0 : nt;
    for (int n = tid; n < C; n += nt) {
      float y1[1][NPIX];
      float(&y)[NPIX] = y1[0];
#pragma unroll
      for (int p = 0; p < NPIX; ++p) y[p] = gs[n * NPIX + p];
      rows_dot(y1, fs, wf2 + (size_t)j0 * C + n, C, 0, nj);
      store_row(gs + n * NPIX, y);
    }
    __syncthreads();
  }

  // ---- epilogue: [+ x] [* q] -> dst ----
  for (int n = tid; n < C; n += nt) {
    const float qn = q != nullptr ? __ldg(q + n) : 1.0f;
#pragma unroll 4
    for (int p = 0; p < NPIX; ++p) {
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy < y_hi && gx < W) {
        const size_t at = ((size_t)gy * W + gx) * C + n;
        float v = gs[n * NPIX + p];
        if (shortcut) v += __ldcg(src + at);
        if (q != nullptr) v *= qn;
        dst[at] = v;
      }
    }
  }
}

// n blocks; block j reads x (j = 0) or the previous block's output and
// writes y (the last) or s, as ops/dcb_chain.py:buffer_plan; q multiplies
// the last output. With n > 1 the launch is cooperative.
__global__ void __launch_bounds__(kMaxThreads)
dcb_f32_kernel(const float* x, float* y, float* s,
               const float* __restrict__ w, const float* __restrict__ q,
               int C, int H, int W, int n, int shortcut, int tiles_x,
               int tiles, int total) {
  extern __shared__ __align__(16) float smem[];
  const size_t blk = 8 * (size_t)C * C + 17 * (size_t)C;
  for (int j = 0; j < n; ++j) {
    const float* src = j == 0 ? x : ((n - j) % 2 == 0 ? y : s);
    float* dst = (n - 1 - j) % 2 == 0 ? y : s;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / tiles, tt = t - b * tiles, y_lo = b * H;
      block_tile(smem, src, dst, w + j * blk, j == n - 1 ? q : nullptr,
                 shortcut != 0, C, y_lo, y_lo + H, W,
                 y_lo + (tt / tiles_x) * TH, (tt % tiles_x) * TW);
    }
    if (j + 1 < n) cg::this_grid().sync();
  }
}

}  // namespace dcbf

extern "C" int ssgvc_dcb_f32_forward(const void* x, void* y, void* s,
                                     const void* w, const void* q, int B,
                                     int H, int W, int C, int n, int shortcut,
                                     void* stream) {
  using namespace dcbf;
  if (B <= 0 || H <= 0 || W <= 0 || n <= 0 || C < 8 || C > 512 || C % 8 ||
      (n > 1 && shortcut))
    return cudaErrorInvalidValue;
  const int nt = threads_for(C);
  const int smem = smem_floats(C, nt) * (int)sizeof(float);
  auto kern = dcb_f32_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, nt, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (W + TW - 1) / TW;
  int tiles = (H + TH - 1) / TH * tiles_x;
  int total = B * tiles;
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(s);
  const float* wp = static_cast<const float*>(w);
  const float* qp = static_cast<const float*>(q);
  if (n == 1) {
    kern<<<grid, nt, smem, st>>>(xp, yp, sp, wp, qp, C, H, W, n, shortcut,
                                 tiles_x, tiles, total);
  } else {
    int tx = tiles_x;
    void* args[] = {&xp, &yp, &sp, &wp, &qp, &C, &H, &W, &n, &shortcut,
                    &tx, &tiles, &total};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(grid), dim3(nt), args, smem, st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
