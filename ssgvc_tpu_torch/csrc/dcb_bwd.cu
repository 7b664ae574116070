// The DepthConvBlock backward's own kernels: the depthwise 3x3 conv forward
// (recompute) and backward, the WSiLU and gated-FFN derivatives, and the
// tap, bias and q reductions. The block's matrix products (the recompute of
// x W0, h W3 and u Wf0, and every 1x1 conv's input and weight gradient) run
// outside them, as ops/dcb_grad.py:block_backward lays out. fp32 SIMT, NHWC
// (B, H, W, C) with C contiguous; any C. The activations that come in or go
// out in the block's dtype (dw_fwd's g, gate_bwd's dy and fr) are bf16 or
// fp32: each such kernel is instantiated for both (T).
//
// The TPU package has no backward kernel: its trainer differentiates the XLA
// conv composition of ssgvc_tpu/layers/blocks.py:DepthConvBlock and never
// reaches the forward Pallas kernel (ssgvc_tpu/ops/pallas_dcb.py:68) in
// training. These kernels give the port's forward kernels (csrc/dcb.cu,
// csrc/dcb_chain.cu) a gradient.
//
// Bound on an H100 SXM: bytes. Each kernel does a few to a few tens of
// operations per element it moves (the depthwise 3x3: 18 per output), far
// under the ~20 fp32 operations per byte at which 67 TFLOP/s and 3.35 TB/s
// meet. What the design does about it: one pass over each tensor, C on the
// fastest thread index so that a warp's loads and stores are contiguous, and
// every per-channel sum over the B*H*W pixels taken in two deterministic
// steps: each thread block sums its PIX pixels in registers into its own row
// of a partials matrix, then grad_reduce sums the rows in a fixed order. No
// floating-point atomics, so the same inputs give the same gradients bit for
// bit. Left for later: wider tiles per block, and fusing the partial sums
// into the matrix products' epilogues.
//
// grad_reduce (d): out[k] = sum over r of part[r][k], fp32, where part has
// one row per PIX pixels and 18 C columns. Bound: bytes, rows x 18 C x 4
// read once (0.6 MB at the training shapes' 128 x 4608), a few us at 3.35
// TB/s; below that, one launch. Its partition is fixed by (rows, K) alone,
// never by the SM count or the grid: a thread block owns a stripe of
// RED_COLS columns (a warp reads 128 contiguous bytes of a row), and of
// each chunk of RED_CHUNK rows each of its RED_WARPS warps sums a fixed
// contiguous run of ceil(min(rows, RED_CHUNK) / RED_WARPS) rows in order,
// RED_UNROLL loads in flight; the warps' sums are added in shared memory
// in warp order. More rows than RED_CHUNK: each chunk's sum goes to a
// scratch row, and the same kernel sums the scratch rows (a second pass).
// ops/dcb_grad.py:grad_reduce_order does the same additions on the CPU.
// Left for later: fewer partial rows at their source (more pixels per
// thread block in gate_bwd and dw_bwd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dcbg {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int PIX = 8;   // pixels per thread block; must match ops/dcb_grad.py

__device__ __forceinline__ float sigmoid4(float v) {
  return 1.0f / (1.0f + __expf(-4.0f * v));
}

__device__ __forceinline__ float wsilu(float v) {     // silu(4v)/4
  return v * sigmoid4(v);
}

__device__ __forceinline__ float wsilu_grad(float v) {
  const float s = sigmoid4(v);
  return s + 4.0f * v * s * (1.0f - s);
}

// An activation in the block's dtype, to and from fp32 (round to nearest).
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// (a) g = dw3x3(wsilu(a0)) + b2, zero padding in h = wsilu(a0) space per
// image (taps (9, C): taps[3 i + j] multiplies h at (y + i - 1, x + j - 1)),
// rounded to T. One thread per element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const float* __restrict__ a0, const float* __restrict__ taps,
              const float* __restrict__ b2, T* __restrict__ g, int H,
              int W, int C, long total) {
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int c = e % C;
    const long p = e / C;
    const int x = p % W, y = (p / W) % H;
    const long img = p - (long)y * W - x;      // first pixel of the image
    float acc = b2[c];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int yy = y + i - 1;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int xx = x + j - 1;
        if (xx < 0 || xx >= W) continue;
        acc += taps[(3 * i + j) * C + c] *
               wsilu(a0[(img + (long)yy * W + xx) * C + c]);
      }
    }
    g[e] = from_f<T>(acc);
  }
}

// (b) From df (M, 2C) and p = u Wf0^T + bf0 (M, 4C): dp for both 2C halves
// through wsilu', and fr = round(wsilu(p_a) + wsilu(p_b)) (M, 2C), the FFN's
// hidden activation that the Wf2 gradient needs, in T. From dy (M, C), in
// T: with q, dyq = dy * q (M, C). Partials of thread block k, row k of part
// (row stride ld): [0, 4C) sum of dp, [4C, 5C) sum of dy (* q), [5C, 6C)
// with q the sum of dy * resid (the q gradient's per-pixel part), else 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_bwd_kernel(const float* __restrict__ df, const float* __restrict__ p,
                const T* __restrict__ dy, const float* __restrict__ q,
                const float* __restrict__ resid, float* __restrict__ dp,
                T* __restrict__ fr, float* __restrict__ dyq,
                float* __restrict__ part, int ld, int C, long M) {
  const long p0 = blockIdx.x * (long)PIX;
  const long p1 = p0 + PIX < M ? p0 + PIX : M;
  float* row = part + blockIdx.x * (long)ld;
  for (int k = threadIdx.x; k < 2 * C; k += blockDim.x) {
    float sa = 0.0f, sb = 0.0f;
    for (long m = p0; m < p1; ++m) {
      const float pa = p[m * 4 * C + k], pb = p[m * 4 * C + 2 * C + k];
      const float d = df[m * 2 * C + k];
      const float da = d * wsilu_grad(pa), db = d * wsilu_grad(pb);
      dp[m * 4 * C + k] = da;
      dp[m * 4 * C + 2 * C + k] = db;
      fr[m * 2 * C + k] = from_f<T>(wsilu(pa) + wsilu(pb));
      sa += da;
      sb += db;
    }
    row[k] = sa;
    row[2 * C + k] = sb;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.0f, s2 = 0.0f;
    const float qc = q ? q[c] : 1.0f;
    for (long m = p0; m < p1; ++m) {
      const float d = to_f(dy[m * C + c]);
      if (q) {
        dyq[m * C + c] = d * qc;
        s2 += d * resid[m * C + c];
      }
      s1 += d * qc;
    }
    row[4 * C + c] = s1;
    row[5 * C + c] = s2;
  }
}

// (c) From dg (M, C), the gradient of g: dh = dw3x3^T(dg), the correlation
// with the flipped taps, zero beyond each image's edge, and da0 = dh *
// wsilu'(a0). Partials of thread block k, row k of part: [0, 9C) the tap
// gradient sum dg(y, x) h(y + i - 1, x + j - 1) at 3 i + j, with h =
// wsilu(a0) recomputed at each neighbour (not stored by (a)), [9C, 10C) sum
// of dg (b2), [10C, 11C) sum of da0 (b0), [11C, 12C) sum of du (b3).
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ dg, const float* __restrict__ a0,
              const float* __restrict__ taps, const float* __restrict__ du,
              float* __restrict__ da0,
              float* __restrict__ part, int ld, int H, int W, int C, long M) {
  const long p0 = blockIdx.x * (long)PIX;
  const long p1 = p0 + PIX < M ? p0 + PIX : M;
  float* row = part + blockIdx.x * (long)ld;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = taps[k * C + c];
    float dt[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    float s2 = 0.0f, s0 = 0.0f, s3 = 0.0f;
    for (long m = p0; m < p1; ++m) {
      const int x = m % W, y = (m / W) % H;
      const long img = m - (long)y * W - x;
      const float dgc = dg[m * C + c];
      float dh = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // g at (y - i + 1, x - j + 1) read h here through tap 3 i + j;
          // h at (y + i - 1, x + j - 1) fed g here through the same tap
          const int gy = y - i + 1, gx = x - j + 1;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            dh += t[3 * i + j] * dg[(img + (long)gy * W + gx) * C + c];
          const int hy = y + i - 1, hx = x + j - 1;
          if (hy >= 0 && hy < H && hx >= 0 && hx < W)
            dt[3 * i + j] +=
                dgc * wsilu(a0[(img + (long)hy * W + hx) * C + c]);
        }
      }
      const float d = dh * wsilu_grad(a0[m * C + c]);
      da0[m * C + c] = d;
      s2 += dgc;
      s0 += d;
      s3 += du[m * C + c];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) row[k * C + c] = dt[k];
    row[9 * C + c] = s2;
    row[10 * C + c] = s0;
    row[11 * C + c] = s3;
  }
}

// (d) one pass of grad_reduce: out[chunk][k] = the sum of rows [chunk
// RED_CHUNK, (chunk + 1) RED_CHUNK) of part, in the fixed order above;
// blockIdx.x the column stripe, blockIdx.y the chunk.
constexpr int RED_COLS = 32, RED_WARPS = 8, RED_UNROLL = 8;
constexpr int RED_CHUNK = 1024;  // must match ops/dcb_grad.py

__global__ void __launch_bounds__(RED_COLS * RED_WARPS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
              int rows, int K) {
  __shared__ float sums[RED_WARPS][RED_COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x * RED_COLS + lane;
  const int run = ((rows < RED_CHUNK ? rows : RED_CHUNK) + RED_WARPS - 1) /
                  RED_WARPS;
  const int c0 = blockIdx.y * RED_CHUNK;
  const int c1 = c0 + RED_CHUNK < rows ? c0 + RED_CHUNK : rows;
  const int r0 = c0 + warp * run;
  const int r1 = r0 + run < c1 ? r0 + run : c1;
  float s = 0.0f;
  if (k < K) {
    const float* p = part + k;
    int r = r0;
    for (; r + RED_UNROLL <= r1; r += RED_UNROLL) {
      float v[RED_UNROLL];
#pragma unroll
      for (int u = 0; u < RED_UNROLL; ++u) v[u] = p[(long)(r + u) * K];
#pragma unroll
      for (int u = 0; u < RED_UNROLL; ++u) s += v[u];
    }
    for (; r < r1; ++r) s += p[(long)r * K];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < K) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) t += sums[w][lane];
    out[(long)blockIdx.y * K + k] = t;
  }
}

inline int blocks_for(long n) {
  const long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

inline int pixel_blocks(long M) { return (int)((M + PIX - 1) / PIX); }

}  // namespace dcbg

using namespace dcbg;

template <typename T>
void dw_fwd_launch(const void* a0, const void* taps, const void* b2, void* g,
                   int H, int W, int C, long total, cudaStream_t stream) {
  dw_fwd_kernel<T><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const float*>(a0), static_cast<const float*>(taps),
      static_cast<const float*>(b2), static_cast<T*>(g), H, W, C, total);
}

template <typename T>
void gate_bwd_launch(const void* df, const void* p, const void* dy,
                     const void* q, const void* resid, void* dp, void* fr,
                     void* dyq, void* part, int ld, int C, long M,
                     cudaStream_t stream) {
  gate_bwd_kernel<T><<<pixel_blocks(M), kThreads, 0, stream>>>(
      static_cast<const float*>(df), static_cast<const float*>(p),
      static_cast<const T*>(dy), static_cast<const float*>(q),
      static_cast<const float*>(resid), static_cast<float*>(dp),
      static_cast<T*>(fr), static_cast<float*>(dyq),
      static_cast<float*>(part), ld, C, M);
}

// f32: g in fp32 (else bf16).
extern "C" int ssgvc_dw_fwd(const void* a0, const void* taps, const void* b2,
                            void* g, int B, int H, int W, int C, int f32,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long total = (long)B * H * W * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    dw_fwd_launch<float>(a0, taps, b2, g, H, W, C, total, st);
  else
    dw_fwd_launch<bf16>(a0, taps, b2, g, H, W, C, total, st);
  return cudaGetLastError();
}

// f32: dy and fr in fp32 (else bf16).
extern "C" int ssgvc_gate_bwd(const void* df, const void* p, const void* dy,
                              const void* q, const void* resid, void* dp,
                              void* fr, void* dyq, void* part, int ld, int C,
                              long M, int f32, void* stream) {
  if (C <= 0 || M <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    gate_bwd_launch<float>(df, p, dy, q, resid, dp, fr, dyq, part, ld, C, M,
                           st);
  else
    gate_bwd_launch<bf16>(df, p, dy, q, resid, dp, fr, dyq, part, ld, C, M,
                          st);
  return cudaGetLastError();
}

extern "C" int ssgvc_dw_bwd(const void* dg, const void* a0, const void* taps,
                            const void* du, void* da0, void* part, int ld,
                            int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long M = (long)B * H * W;
  dw_bwd_kernel<<<pixel_blocks(M), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dg), static_cast<const float*>(a0),
      static_cast<const float*>(taps), static_cast<const float*>(du),
      static_cast<float*>(da0),
      static_cast<float*>(part), ld, H, W, C, M);
  return cudaGetLastError();
}

// scratch: ceil(rows / RED_CHUNK) x K floats when rows > RED_CHUNK (else
// unused); rows at most RED_CHUNK^2.
extern "C" int ssgvc_grad_reduce(const void* part, void* out, void* scratch,
                                 int rows, int K, void* stream) {
  if (rows <= 0 || K <= 0 || rows > RED_CHUNK * RED_CHUNK)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stripes = (K + RED_COLS - 1) / RED_COLS;
  const int chunks = (rows + RED_CHUNK - 1) / RED_CHUNK;
  const float* src = static_cast<const float*>(part);
  if (chunks > 1) {
    reduce_kernel<<<dim3(stripes, chunks), RED_COLS * RED_WARPS, 0, st>>>(
        src, static_cast<float*>(scratch), rows, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = static_cast<const float*>(scratch);
    rows = chunks;
  }
  reduce_kernel<<<dim3(stripes, 1), RED_COLS * RED_WARPS, 0, st>>>(
      src, static_cast<float*>(out), rows, K);
  return cudaGetLastError();
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
