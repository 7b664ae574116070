// W8A8 int8 convolution for sm_90a: the forward of the JAX package's
// QuantConv (ssgvc_tpu/layers/blocks.py:170-240), whose int8 conv is an XLA
// convolution there (lax.conv_general_dilated on int8 operands with int32
// accumulation, :234-238), not a Pallas kernel. PyTorch has no int8
// convolution on CUDA, so the port computes it here.
//
//   xq[p, k]  = clamp(rint(x / s_x), -127, 127)          quantized on load
//   acc[p, o] = sum_k xq[p, k] * wq[o, k]                 exact, int32
//   y[p, o]   = (float(acc) * (s_x * s_w[o])) + b[o]      unfused, rounded once
//                                                          to y's dtype
//
// An implicit GEMM on NHWC: rows are output pixels (B * Ho * Wo), columns
// output channels, K = kh * kw * Cin in (ky, kx, ci) order with ci fastest.
// The weights come packed by ops/qconv.py:quantize_weight as (O, Kp) int8,
// K contiguous, Kp = K rounded up to 32 with zero weights. s_x is a device
// scalar (no host sync: mode 1 computes it on the card), s_w and b are fp32
// (O,). Padding is explicit on each side (top, bottom, left, right), and an
// input pixel outside the frame quantizes to 0, as the JAX package's int8
// zero padding does.
//
// What bounds it: on the model's 1x1 sites the int8 products would take a
// few microseconds at the tensor cores' 1979 TOP/s, so the bytes (x read,
// y written) bound the work. This first kernel is simple: 64x64 output tiles
// of 128 threads (four warps of 32x32), mma.sync m16n8k32 s8 products on
// 32-deep K slices staged through shared memory, and every tile quantizes
// the x it reads, so x is read and quantized once per 64 output channels.
// wgmma on s8 operands with TMA staging, and quantizing once, are later work.
//
// Arithmetic: __fdiv_rn and rintf (round half to even, as jnp.round and
// torch.round), the int32 sum is exact in any order, then __int2float_rn and
// the unfused __fmul_rn / __fadd_rn in the JAX package's order: the kernel
// equals ops/qconv.py:qconv_plain bit for bit. Never build this file with
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output pixels per tile
constexpr int BN = 64;        // output channels per tile
constexpr int BK = 32;        // K slice: one m16n8k32 step deep
constexpr int LDS = BK + 16;  // bytes per staged row: 48 keeps the fragment
                              // reads of 8 rows on distinct banks
constexpr int THREADS = 128;

struct Shape {
  int B, H, W, C, O, kh, kw, stride, pt, pl, Ho, Wo, K, Kp;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 consecutive channels as floats; p 16-byte aligned.
__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t quant(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC: Cin % 16 == 0 and x 16-byte aligned, so each thread's 16 K values lie
// in one tap and are one pixel's contiguous channels.
template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const TI* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 const float* __restrict__ sxp, TO* __restrict__ y, Shape s) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float sx = *sxp;
  const int M = s.B * s.Ho * s.Wo;

  // the A row (an output pixel) and the 16-wide half of the K slice this
  // thread stages; the B row (an output channel) likewise
  const int row = tid >> 1, half = (tid & 1) * 16;
  const int am = m0 + row;
  const bool arow = am < M;
  int iy0 = 0, ix0 = 0;
  const TI* xb = x;
  if (arow) {
    const int hw = s.Ho * s.Wo;
    const int b = am / hw, rem = am - b * hw;
    const int oy = rem / s.Wo, ox = rem - oy * s.Wo;
    iy0 = oy * s.stride - s.pt;
    ix0 = ox * s.stride - s.pl;
    xb = x + static_cast<size_t>(b) * s.H * s.W * s.C;
  }
  const int bn = n0 + row;
  const int8_t* wrow = wq + static_cast<size_t>(bn) * s.Kp + half;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < s.Kp; k0 += BK) {
    uint32_t pk[4] = {0u, 0u, 0u, 0u};
    const int kb = k0 + half;
    if (VEC) {
      if (arow && kb < s.K) {
        const int tap = kb / s.C, ci = kb - tap * s.C;
        const int ky = tap / s.kw, kx = tap - ky * s.kw;
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
          float v[16];
          load16(xb + (static_cast<size_t>(iy) * s.W + ix) * s.C + ci, v);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            pk[j >> 2] |= quant(v[j], sx) << (8 * (j & 3));
        }
      }
    } else if (arow) {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int k = kb + j;
        if (k >= s.K) break;
        const int tap = k / s.C, ci = k - tap * s.C;
        const int ky = tap / s.kw, kx = tap - ky * s.kw;
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          pk[j >> 2] |= quant(to_f(xb[(static_cast<size_t>(iy) * s.W + ix) *
                                          s.C + ci]), sx)
                        << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(As + row * LDS + half) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
    uint4 wv = make_uint4(0u, 0u, 0u, 0u);
    if (bn < s.O) wv = *reinterpret_cast<const uint4*>(wrow + k0);
    *reinterpret_cast<uint4*>(Bs + row * LDS + half) = wv;
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r0 = As + (wm + mi * 16 + g) * LDS + t4 * 4;
      const int8_t* r1 = r0 + 8 * LDS;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c0 = Bs + (wn + ni * 8 + g) * LDS + t4 * 4;
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
        const float v = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[mi][ni][i]), __fmul_rn(sx, sw[o])),
            bias[o]);
        store(y + static_cast<size_t>(m) * s.O + o, v);
      }
}

template <typename TI, typename TO>
int launch(const void* x, const void* wq, const void* sw, const void* bias,
           const void* sx, void* y, const Shape& s, bool vec,
           cudaStream_t stream) {
  const long long M = static_cast<long long>(s.B) * s.Ho * s.Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((s.O + BN - 1) / BN));
  auto kern = vec ? qconv_kernel<TI, TO, true> : qconv_kernel<TI, TO, false>;
  kern<<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const float*>(sx), static_cast<TO*>(y), s);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) bf16 (x_f32 = 0) or fp32; y (B, Ho, Wo, O) bf16 (y_f32 =
// 0) or fp32, Ho = (H + pt + pb - kh) / stride + 1, Wo likewise; wq (O, Kp)
// int8 with Kp = kh * kw * C rounded up to 32; sw, bias (O,) fp32; sx one
// fp32. vec takes the 16-channel loads (C % 16 == 0, x 16-byte aligned).
extern "C" int ssgvc_qconv_forward(const void* x, int x_f32, const void* wq,
                                   const void* sw, const void* bias,
                                   const void* sx, void* y, int y_f32, int B,
                                   int H, int W, int C, int O, int kh, int kw,
                                   int stride, int pt, int pb, int pl, int pr,
                                   int vec, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || O < 1 || kh < 1 || kw < 1 ||
      stride < 1 || pt < 0 || pb < 0 || pl < 0 || pr < 0)
    return cudaErrorInvalidValue;
  if (vec && C % 16) return cudaErrorInvalidValue;
  Shape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.kh = kh; s.kw = kw;
  s.stride = stride; s.pt = pt; s.pl = pl;
  s.Ho = (H + pt + pb - kh) / stride + 1;
  s.Wo = (W + pl + pr - kw) / stride + 1;
  s.K = kh * kw * C;
  s.Kp = (s.K + BK - 1) / BK * BK;
  if (s.Ho < 1 || s.Wo < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_f32)
    return y_f32 ? launch<float, float>(x, wq, sw, bias, sx, y, s, v, st)
                 : launch<float, __nv_bfloat16>(x, wq, sw, bias, sx, y, s, v,
                                                st);
  return y_f32 ? launch<__nv_bfloat16, float>(x, wq, sw, bias, sx, y, s, v, st)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, wq, sw, bias, sx, y,
                                                      s, v, st);
}

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
