// DepthConvBlock tile routine shared by csrc/dcb.cu (one block) and
// csrc/dcb_chain.cu (N chained blocks). NHWC bf16 activations, B=1.
//
// Per block (see ssgvc_tpu_torch/ops/dcb.py for the rounding points):
//   h = wsilu(x W0 + b0), zero outside the frame; h = dw3x3(h) + b2
//   u = x + h W3 + b3; f = wsilu(u Wf0a + bf0a) + wsilu(u Wf0b + bf0b)
//   y = u + f Wf2 + bf2 [+ x] [* q]
//
// One thread block owns a th x tw output tile. Shared memory holds the tile's
// input with a halo of n pixels on each side (`cur`, bf16), so n blocks run
// back to back without leaving the SM; each block's live region shrinks by
// one pixel per side. Neither (tile, C) fp32 nor (tile, 4C) is ever resident:
//   stage A streams KC h-channels at a time: dc_0 over the block's input
//           region -> fp32 chunk (`hch`), masked to 0 outside the frame in
//           both rows and columns, -> depthwise 3x3 -> bf16 `hb`;
//   stage B walks MB-pixel sub-tiles of the output region: the C-wide fp32
//           accumulator starts at x + b3, takes hb W3 (u), is stored once as
//           bf16 (`uc`, the Wf0 operand), takes bf2, then streams the 2C
//           hidden width KF channels at a time (f chunk `fch`, bf16) into
//           the same accumulator. A non-final block writes its bf16 output
//           back into `cur` in place (stage B is pointwise per pixel).
// Products run on tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate); A operands come from shared memory, B (weights, [out][in]
// layout, L2 resident) straight from global memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 64;       // h channels per stage-A chunk (8 warps x n8)
constexpr int SH = KC + 4;   // fp32 row stride of hch
constexpr int MG = 12;       // m16 row tiles per stage-A pass of a warp
constexpr int KF = 64;       // hidden channels per FFN chunk (8 warps x n8)
constexpr int SF = KF + 8;   // bf16 row stride of fch
constexpr int MB = 64;       // pixels per stage-B sub-tile

// Must equal ssgvc_tpu_torch/ops/dcb.py:smem_bytes.
__host__ __device__ inline long smem_bytes(int C, int n, int th, int tw) {
  const long sc = C + 8;
  const long p_in = (long)(th + 2 * n) * (tw + 2 * n);
  const long p_out = (long)(th + 2 * n - 2) * (tw + 2 * n - 2);
  const long work_a = p_in * SH * 4;
  const long work_b = MB * sc * 2 + MB * SF * 2;
  return p_in * sc * 2 + p_out * sc * 2 + (work_a > work_b ? work_a : work_b);
}

typedef __nv_bfloat16 bf16;

// One block's weights, packed by ops/dcb.py:pack_params.
struct Weights {
  const bf16 *w0, *w3, *wf0, *wf2, *dw, *b0, *b2, *b3, *bf0, *bf2;
};

template <int C>
__device__ __forceinline__ Weights block_weights(const bf16* base, int j) {
  Weights w;
  const bf16* p = base + (size_t)j * (8 * C * C + 17 * C);
  w.w0 = p;
  w.w3 = p + C * C;
  w.wf0 = p + 2 * C * C;
  w.wf2 = p + 6 * C * C;
  w.dw = p + 8 * C * C;
  w.b0 = w.dw + 9 * C;
  w.b2 = w.b0 + C;
  w.b3 = w.b2 + C;
  w.bf0 = w.b3 + C;
  w.bf2 = w.bf0 + 4 * C;
  return w;
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float wsilu(float v) {
  return v / (1.0f + __expf(-4.0f * v));    // silu(4v)/4
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

extern __shared__ __align__(16) unsigned char dcb_smem[];

// Runs n blocks on this thread block's output tile. x, y: (H, W, C);
// wts: n packed blocks; q: (C) or null, applied to the last block's output;
// shortcut adds the tile input to the last block's output (n == 1 only).
template <int C>
__device__ void run_tile(const bf16* __restrict__ x, bf16* __restrict__ y,
                         const bf16* __restrict__ wts,
                         const bf16* __restrict__ q, int H, int W, int n,
                         int th, int tw, bool shortcut) {
  constexpr int SC = C + 8;       // bf16 row stride of cur / hb / uc
  constexpr int NTW = C / 64;     // n8 tiles per warp across C outputs
  static_assert(C % 64 == 0 && KC == 8 * kWarps, "C in 64s, KC = 8 warps x n8");
  const int R0h = th + 2 * n, R0w = tw + 2 * n;
  const int p_in0 = R0h * R0w;
  const int p_out0 = (R0h - 2) * (R0w - 2);
  bf16* cur = reinterpret_cast<bf16*>(dcb_smem);
  bf16* hb = cur + (size_t)p_in0 * SC;
  float* hch = reinterpret_cast<float*>(hb + (size_t)p_out0 * SC);
  bf16* uc = reinterpret_cast<bf16*>(hch);       // aliases hch (stage B)
  bf16* fch = uc + MB * SC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int y0 = blockIdx.y * th - n, x0 = blockIdx.x * tw - n;
  const int nbase = warp * (C / 8);

  // region 0 -> cur, zero outside the frame (16-byte vectors)
  constexpr int V = C / 8;
  for (int i = tid; i < p_in0 * V; i += kThreads) {
    const int p = i / V, v = i - p * V;
    const int gy = y0 + p / R0w, gx = x0 + p % R0w;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(x + ((size_t)gy * W + gx) * C + v * 8);
    *reinterpret_cast<uint4*>(cur + (size_t)p * SC + v * 8) = val;
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const Weights wj = block_weights<C>(wts, j);
    const int hin = R0h - 2 * j, win = R0w - 2 * j;   // input region at (j, j)
    const int hout = hin - 2, wout = win - 2;         // output at (j+1, j+1)
    const int pin = hin * win, pout = hout * wout;
    const bool last = (j == n - 1);

    // ---------------- stage A: h chunks -> hb ----------------
    // Each warp owns 8 of the chunk's KC h channels over all of the
    // region's rows, MG row tiles per pass, so one load of a W0 fragment
    // from L2 feeds up to MG products.
    const int mtiles = (pin + 15) / 16;
    for (int c0 = 0; c0 < C; c0 += KC) {
      const int col0 = warp * 8 + 2 * t;            // chunk column of e = 0
      const bf16* wr = wj.w0 + (size_t)(c0 + warp * 8 + g) * C + 2 * t;
      const float bias0 = f32(wj.b0[c0 + col0]);
      const float bias1 = f32(wj.b0[c0 + col0 + 1]);
      for (int m0 = 0; m0 < mtiles; m0 += MG) {
        const int mcount = min(MG, mtiles - m0);
        int off[MG][2];                              // cur offsets of rows g, g+8
        float acc[MG][4];
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = min((m0 + i) * 16 + g + 8 * hf, pin - 1);
            off[i][hf] = ((j + r / win) * R0w + j + r % win) * SC + 2 * t;
          }
        }
#pragma unroll 4
        for (int k0 = 0; k0 < C; k0 += 16) {
          const uint32_t b0 = ldg32(wr + k0), b1 = ldg32(wr + k0 + 8);
#pragma unroll
          for (int i = 0; i < MG; ++i) {
            if (i < mcount) {
              const uint32_t a[4] = {
                  lds32(cur + off[i][0] + k0), lds32(cur + off[i][1] + k0),
                  lds32(cur + off[i][0] + k0 + 8),
                  lds32(cur + off[i][1] + k0 + 8)};
              mma(acc[i], a, b0, b1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MG; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (m0 + i) * 16 + g + 8 * (e >> 1);
            if (i < mcount && row < pin) {
              const int gy = y0 + j + row / win, gx = x0 + j + row % win;
              const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
              const float v = acc[i][e] + ((e & 1) ? bias1 : bias0);
              hch[row * SH + col0 + (e & 1)] = in ? wsilu(v) : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < pout * KC; i += kThreads) {
        const int p = i / KC, k = i - p * KC;
        const int r = p / wout, cc = p - r * wout;
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc += hch[((r + dy) * win + cc + dx) * SH + k] *
                   f32(wj.dw[(dy * 3 + dx) * C + c0 + k]);
        acc += f32(wj.b2[c0 + k]);
        hb[(size_t)p * SC + c0 + k] = __float2bfloat16_rn(acc);
      }
      __syncthreads();
    }

    // ---------------- stage B: MB-pixel sub-tiles ----------------
    for (int s0 = 0; s0 < pout; s0 += MB) {
      int crow[4][2];   // cur row of each accumulator row (clamped pixel)
      int orow[4][2];   // output-region pixel (unclamped)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = s0 + mt * 16 + g + 8 * hf;
          const int pc = min(p, pout - 1);
          crow[mt][hf] = (j + 1 + pc / wout) * R0w + j + 1 + pc % wout;
          orow[mt][hf] = p;
        }

      float acc[4][NTW][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nbase + nt * 8 + 2 * t + (e & 1);
            acc[mt][nt][e] = f32(cur[(size_t)crow[mt][e >> 1] * SC + col]) +
                             f32(wj.b3[col]);
          }

      // u = x + b3 + hb W3
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* pa = hb + (size_t)min(orow[mt][0], pout - 1) * SC + k0 + 2 * t;
          const bf16* pb = hb + (size_t)min(orow[mt][1], pout - 1) * SC + k0 + 2 * t;
          a[mt][0] = lds32(pa);
          a[mt][1] = lds32(pb);
          a[mt][2] = lds32(pa + 8);
          a[mt][3] = lds32(pb + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const bf16* wp = wj.w3 + (size_t)(nbase + nt * 8 + g) * C + k0 + 2 * t;
          const uint32_t b0 = ldg32(wp), b1 = ldg32(wp + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
        }
      }

      // uc = bf16(u); the accumulator continues as y = u + bf2 + f Wf2
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int col = nbase + nt * 8 + 2 * t;
          const int m = mt * 16 + g;
          *reinterpret_cast<uint32_t*>(uc + m * SC + col) =
              pack2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<uint32_t*>(uc + (m + 8) * SC + col) =
              pack2(acc[mt][nt][2], acc[mt][nt][3]);
          const float c0v = f32(wj.bf2[col]), c1v = f32(wj.bf2[col + 1]);
          acc[mt][nt][0] += c0v;
          acc[mt][nt][1] += c1v;
          acc[mt][nt][2] += c0v;
          acc[mt][nt][3] += c1v;
        }
      __syncthreads();

      for (int f0 = 0; f0 < 2 * C; f0 += KF) {
        float fa[4][4], fb[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) fa[mt][e] = fb[mt][e] = 0.f;
        const bf16* wa = wj.wf0 + (size_t)(f0 + warp * 8 + g) * C + 2 * t;
        const bf16* wb = wa + (size_t)2 * C * C;
        for (int k0 = 0; k0 < C; k0 += 16) {
          const uint32_t ba0 = ldg32(wa + k0), ba1 = ldg32(wa + k0 + 8);
          const uint32_t bb0 = ldg32(wb + k0), bb1 = ldg32(wb + k0 + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const bf16* pa = uc + (mt * 16 + g) * SC + k0 + 2 * t;
            const uint32_t a[4] = {lds32(pa), lds32(pa + 8 * SC),
                                   lds32(pa + 8), lds32(pa + 8 * SC + 8)};
            mma(fa[mt], a, ba0, ba1);
            mma(fb[mt], a, bb0, bb1);
          }
        }
        {
          const int col = warp * 8 + 2 * t;
          const float ba_0 = f32(wj.bf0[f0 + col]), ba_1 = f32(wj.bf0[f0 + col + 1]);
          const float bb_0 = f32(wj.bf0[2 * C + f0 + col]);
          const float bb_1 = f32(wj.bf0[2 * C + f0 + col + 1]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int m = mt * 16 + g;
            *reinterpret_cast<uint32_t*>(fch + m * SF + col) =
                pack2(wsilu(fa[mt][0] + ba_0) + wsilu(fb[mt][0] + bb_0),
                      wsilu(fa[mt][1] + ba_1) + wsilu(fb[mt][1] + bb_1));
            *reinterpret_cast<uint32_t*>(fch + (m + 8) * SF + col) =
                pack2(wsilu(fa[mt][2] + ba_0) + wsilu(fb[mt][2] + bb_0),
                      wsilu(fa[mt][3] + ba_1) + wsilu(fb[mt][3] + bb_1));
          }
        }
        __syncthreads();
#pragma unroll
        for (int k0 = 0; k0 < KF; k0 += 16) {
          uint32_t a[4][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const bf16* pa = fch + (mt * 16 + g) * SF + k0 + 2 * t;
            a[mt][0] = lds32(pa);
            a[mt][1] = lds32(pa + 8 * SF);
            a[mt][2] = lds32(pa + 8);
            a[mt][3] = lds32(pa + 8 * SF + 8);
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const bf16* wp = wj.wf2 + (size_t)(nbase + nt * 8 + g) * (2 * C) + f0 + k0 + 2 * t;
            const uint32_t b0 = ldg32(wp), b1 = ldg32(wp + 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
          }
        }
        __syncthreads();
      }

      // epilogue: [+x] [*q] -> global (last block) or back into cur
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = orow[mt][hf];
          if (p >= pout) continue;
          const int r = p / wout, cc = p - r * wout;
          const int gy = blockIdx.y * th + r, gx = blockIdx.x * tw + cc;
          if (last && (gy >= H || gx >= W)) continue;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const int col = nbase + nt * 8 + 2 * t;
            float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
            const bf16* xr = cur + (size_t)crow[mt][hf] * SC + col;
            if (shortcut) {
              v0 += f32(xr[0]);
              v1 += f32(xr[1]);
            }
            if (last && q != nullptr) {
              v0 *= f32(q[col]);
              v1 *= f32(q[col + 1]);
            }
            if (last)
              *reinterpret_cast<uint32_t*>(y + ((size_t)gy * W + gx) * C + col) = pack2(v0, v1);
            else
              *reinterpret_cast<uint32_t*>(cur + (size_t)crow[mt][hf] * SC + col) = pack2(v0, v1);
          }
        }
      __syncthreads();
    }
  }
}

}  // namespace dcb

extern "C" const char* ssgvc_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
