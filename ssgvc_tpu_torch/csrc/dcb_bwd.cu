// The DepthConvBlock backward's own kernels: the depthwise 3x3 conv forward
// (recompute) and backward, the WSiLU and gated-FFN derivatives, and the
// tap, bias and q reductions. The block's matrix products (the recompute of
// x W0, h W3 and u Wf0, and every 1x1 conv's input and weight gradient) run
// outside them, as ops/dcb_grad.py:block_backward lays out. fp32 SIMT, NHWC
// (B, H, W, C) with C contiguous. The activations that come in or go out in
// the block's dtype (dw_fwd's g, gate_bwd's dy and fr) are bf16 or fp32:
// each such kernel is instantiated for both (T).
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
// meet. At the training shapes (B = 4, 2x2 to 16x16 pixels) one launch
// moves 0.1-15 MB, a few us at 3.35 TB/s, so latency matters as much as
// bytes. Every per-channel sum over the B*H*W pixels is taken in two
// deterministic steps: each tile's sum in a fixed order into its own row of
// a partials matrix, then grad_reduce sums the rows in a fixed order. No
// floating-point atomics, so the same inputs give the same gradients bit for
// bit.
//
// The partials' partition (gate_bwd and dw_bwd; ops/dcb_grad.py:bwd_tiles
// chooses th x tw from the shape alone and passes them): tiles of th x tw
// pixels of one image, th = min(TILE, H), tw = min(TILE, W), the last tile
// row and column cut off at the image's edge; one partials row per tile, in
// (image, tile row, tile column) order. A thread block owns one tile's
// SLICE channels (grid: tiles x ceil(C / SLICE)) and writes those channels'
// columns of the tile's row. dw_fwd runs on the same tiles but writes no
// partials, and its thread blocks own DW_SLICE channels. All three need C %
// 8 == 0 and 16-byte aligned operands (16-byte loads and copies of 4
// channels).
//
// grad_reduce (d): out[k] = sum over r of part[r][k], fp32, where part has
// one row per tile and 18 C columns. Bound: bytes, rows x 18 C x 4 read
// once; below that, one launch. Its partition is fixed by (rows, K) alone,
// never by the SM count or the grid: a thread block owns a stripe of
// RED_COLS columns (a warp reads 128 contiguous bytes of a row), and of
// each chunk of RED_CHUNK rows each of its RED_WARPS warps sums a fixed
// contiguous run of ceil(min(rows, RED_CHUNK) / RED_WARPS) rows in order,
// RED_UNROLL loads in flight; the warps' sums are added in shared memory
// in warp order. More rows than RED_CHUNK: each chunk's sum goes to a
// scratch row, and the same kernel sums the scratch rows (a second pass).
// ops/dcb_grad.py:grad_reduce_order does the same additions on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace dcbg {

using hop::cp_async16;
using hop::cp_async_wait_all;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// The partials' tiles; must match ops/dcb_grad.py
constexpr int TILE = 8;     // at most TILE x TILE pixels of one image
constexpr int SLICE = 32;   // channels of one thread block
constexpr int HALO = TILE + 2;
constexpr int GROUPS = SLICE / 4;         // gate_bwd: 4-channel groups
constexpr int LANES = kThreads / GROUPS;  // gate_bwd: pixel lanes
static_assert(kThreads / SLICE == TILE, "dw_bwd: one warp per tile row");
static_assert(2 * LANES >= TILE * TILE, "gate_bwd: two pixels a lane");

__device__ __forceinline__ float sigmoid4(float v) {
  return 1.0f / (1.0f + __expf(-4.0f * v));
}

__device__ __forceinline__ float wsilu(float v) {     // silu(4v)/4
  return v * sigmoid4(v);
}

// wsilu(v) and wsilu'(v) from one exponential.
__device__ __forceinline__ void wsilu_both(float v, float& f, float& d) {
  const float s = sigmoid4(v);
  f = v * s;
  d = s + 4.0f * v * s * (1.0f - s);
}

// Four consecutive channels: 16 bytes of fp32, 8 of bf16 (stored rounded
// to nearest).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void operator+=(float4& a, float4 b) { a = a + b; }
__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Tile t of the partition: its image and first pixel.
struct Tile {
  int b, y0, x0;
};
__device__ __forceinline__ Tile tile_of(int t, int th, int tw, int tiles_y,
                                        int tiles_x) {
  const int tx = t % tiles_x, r = t / tiles_x;
  return Tile{r / tiles_y, (r % tiles_y) * th, tx * tw};
}

// (a) g = dw3x3(wsilu(a0)) + b2, zero padding in h = wsilu(a0) space per
// image (taps (9, C): taps[3 i + j] multiplies h at (y + i - 1, x + j - 1)),
// rounded to T. Replaces the wsilu and dc_2 lines of
// ssgvc_tpu/layers/blocks.py:DepthConvBlock (:491-498) in the recompute.
//
// A thread block owns one tile of the partition (th x tw pixels of one
// image) and DW_SLICE channels; a thread owns 4 of those channels of one
// pixel of the TILE x TILE grid throughout. It copies its channels of a
// cell or two of the tile's window (the tile and a one-pixel halo, on a
// fixed HALO x HALO grid) into shared memory (16-byte cp.async,
// zero-filled beyond the image: wsilu(0) = 0, so the zeros are the
// padding), then turns what it copied into h in place: one exponential per
// staged value in the image, at most (th + 2)(tw + 2) a channel (100 at
// 8x8, not 9 an output). After one barrier it computes its pixel, where
// the tile has it: its 9 taps and b2 in registers (16-byte loads), h read
// from shared memory 16 bytes at a time, g stored 16 bytes (fp32) or 8
// (bf16). The index math is per tile and pixel, in 32 bits, on the fixed
// grids (no division by a run-time value; the entry takes at most 2^31 - 1
// pixels). Each output's sum: b2, then one fma per tap in (i, j) row-major
// order. A halo tap adds t * 0, which leaves the sum's value as it is, so
// g is that of a sum over the in-image taps alone, in the same order.
//
// Why these shapes (experiments/dw_fwd_turns.py, in turns on an H100): at
// the training shapes (B = 4, 2x2 to 16x16) and the RD recipe's (B = 8,
// 1x1 to 8x8) a launch lasts a few microseconds, a round trip to memory
// and a block's serial work after the launch itself. 32-channel blocks of
// 256 threads put a small frame on few SMs (4x8x8x128: 16 blocks) and
// gave each thread two pixels and four cells; 8-channel blocks of 128
// threads spread the same work over 4x the SMs, one pixel and at most two
// cells a thread, and took a sixth to a quarter less time at 8x8.
__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(__fmaf_rn(a.x, b.x, c.x), __fmaf_rn(a.y, b.y, c.y),
                     __fmaf_rn(a.z, b.z, c.z), __fmaf_rn(a.w, b.w, c.w));
}

// dw_fwd's channel slice: it writes no partials, so its thread blocks need
// not own SLICE channels; a narrow slice spreads a small frame's tiles over
// more SMs (see above)
constexpr int DW_SLICE = 8;
static_assert(8 % DW_SLICE == 0, "dw_fwd: C % 8 == 0 fills every slice");
constexpr int DW_GROUPS = DW_SLICE / 4;
constexpr int DW_THREADS = TILE * TILE * DW_GROUPS;  // one pixel a thread
constexpr int DW_COPIES = (HALO * HALO + TILE * TILE - 1) / (TILE * TILE);

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_fwd_kernel(const float* __restrict__ a0, const float* __restrict__ taps,
              const float* __restrict__ b2, T* __restrict__ g, int H, int W,
              int C, int th, int tw, int tiles_y, int tiles_x) {
  // a0, then h, on a fixed HALO x HALO grid of cells: cell (r, s) holds
  // row y0 - 1 + r, column x0 - 1 + s, DW_SLICE channels
  __shared__ __align__(16) float sh[HALO * HALO * DW_SLICE];
  // this thread's 4 channels: it stages, turns into h and computes them
  // (no other thread reads them)
  const int grp = threadIdx.x % DW_GROUPS, lane = threadIdx.x / DW_GROUPS;
  const int c = blockIdx.y * DW_SLICE + 4 * grp;
  const Tile t = tile_of(blockIdx.x, th, tw, tiles_y, tiles_x);
  const int img = t.b * H * W;                  // the image's first pixel

  // stage the window's cells lane + j TILE^2 (j < DW_COPIES), 4 channels
  // each: in the image copied, beyond it zero-filled
  int cell[DW_COPIES];                          // shared-memory offsets
  bool inside[DW_COPIES];
#pragma unroll
  for (int j = 0; j < DW_COPIES; ++j) {
    const int pix = lane + j * TILE * TILE;
    const int r = pix / HALO, s = pix % HALO;
    const int yy = t.y0 - 1 + r, xx = t.x0 - 1 + s;
    const bool want = r < th + 2 && s < tw + 2;
    inside[j] = want && yy >= 0 && yy < H && xx >= 0 && xx < W;
    cell[j] = pix * DW_SLICE + 4 * grp;
    if (want)
      cp_async16(sh + cell[j],
                 inside[j] ? a0 + (size_t)(img + yy * W + xx) * C + c : a0,
                 inside[j]);
  }
  // while the copies fly: this thread's taps and b2
  float4 tp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tp[k] = load4(taps + k * C + c);
  const float4 bias = load4(b2 + c);
  cp_async_wait_all();
  // h = wsilu(a0) for the cells this thread copied (visible to it after its
  // own wait; a zero-filled cell is already h), then one barrier
#pragma unroll
  for (int j = 0; j < DW_COPIES; ++j) {
    if (!inside[j]) continue;
    float4* v = reinterpret_cast<float4*>(sh + cell[j]);
    const float4 a = *v;
    *v = make_float4(wsilu(a.x), wsilu(a.y), wsilu(a.z), wsilu(a.w));
  }
  __syncthreads();

  // pixel lane of the TILE x TILE grid, where the tile (th x tw, cut off
  // at the image's edge) has it; it sits at cell (py + 1, px + 1), so its
  // window starts at cell (py, px)
  const int py = lane / TILE, px = lane % TILE;
  const int y = t.y0 + py, x = t.x0 + px;
  if (py >= th || px >= tw || y >= H || x >= W) return;
  const float* hs = sh + (py * HALO + px) * DW_SLICE + 4 * grp;
  float4 acc = bias;
#pragma unroll
  for (int ti = 0; ti < 3; ++ti) {
#pragma unroll
    for (int tj = 0; tj < 3; ++tj)
      acc = fma4(tp[3 * ti + tj],
                 *reinterpret_cast<const float4*>(
                     hs + (ti * HALO + tj) * DW_SLICE),
                 acc);
  }
  store4(g + (size_t)(img + y * W + x) * C + c, acc);
}

// (b) From df (M, 2C) and p = u Wf0^T + bf0 (M, 4C): dp for both 2C halves
// through wsilu', and fr = round(wsilu(p_a) + wsilu(p_b)) (M, 2C), the FFN's
// hidden activation that the Wf2 gradient needs, in T. From dy (M, C), in
// T: with q, dyq = dy * q (M, C). Partials of tile t, row t of part (row
// stride ld): [0, 4C) sum of dp, [4C, 5C) sum of dy (* q), [5C, 6C) with q
// the sum of dy * resid (the q gradient's per-pixel part), else 0.
//
// A thread owns 4 channels (GROUPS a slice) of the tile's pixels lane,
// lane + LANES: one pass over every column, 16-byte loads and stores (8 for
// bf16), one exponential per element for wsilu and wsilu'. Its 24 sums go
// to shared memory, and each column's LANES sums are added in lane order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_bwd_kernel(const float* __restrict__ df, const float* __restrict__ p,
                const T* __restrict__ dy, const float* __restrict__ q,
                const float* __restrict__ resid, float* __restrict__ dp,
                T* __restrict__ fr, float* __restrict__ dyq,
                float* __restrict__ part, int ld, int H, int W, int C,
                int th, int tw, int tiles_y, int tiles_x) {
  // [sum s][channel of the group][lane][group]: s = dp at c, C + c,
  // 2C + c, 3C + c, then dy (* q), dy * resid
  __shared__ float red[6][4][LANES][GROUPS];
  const int grp = threadIdx.x % GROUPS, lane = threadIdx.x / GROUPS;
  const int c0 = blockIdx.y * SLICE, c = c0 + 4 * grp;
  const Tile t = tile_of(blockIdx.x, th, tw, tiles_y, tiles_x);
  float4 acc[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c < C) {
    const float4 qv = q ? load4(q + c) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
#pragma unroll
    for (int u = 0; u < 2; ++u) {       // both pixels' loads in flight
      const int i = lane + u * LANES;
      const int y = t.y0 + i / tw, x = t.x0 + i % tw;
      if (i >= th * tw || y >= H || x >= W) continue;
      const long m = ((long)t.b * H + y) * W + x;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long k = m * 4 * C + half * C + c;    // p_a; p_b is 2C on
        const long kf = m * 2 * C + half * C + c;   // df and fr
        const float4 pa = load4(p + k), pb = load4(p + k + 2 * C);
        const float4 d = load4(df + kf);
        float4 fa, ga, fb, gb;
        wsilu_both(pa.x, fa.x, ga.x);
        wsilu_both(pa.y, fa.y, ga.y);
        wsilu_both(pa.z, fa.z, ga.z);
        wsilu_both(pa.w, fa.w, ga.w);
        wsilu_both(pb.x, fb.x, gb.x);
        wsilu_both(pb.y, fb.y, gb.y);
        wsilu_both(pb.z, fb.z, gb.z);
        wsilu_both(pb.w, fb.w, gb.w);
        const float4 da = d * ga, db = d * gb;
        store4(dp + k, da);
        store4(dp + k + 2 * C, db);
        store4(fr + kf, fa + fb);
        acc[half] += da;
        acc[2 + half] += db;
      }
      const float4 d = load4(dy + m * C + c);
      if (q) {
        const float4 dq = d * qv;
        store4(dyq + m * C + c, dq);
        acc[4] += dq;
        acc[5] += d * load4(resid + m * C + c);
      } else {
        acc[4] += d;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 6; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[s][j][lane][grp] = get(acc[s], j);
  }
  __syncthreads();
  float* row = part + (long)blockIdx.x * ld;
  for (int o = threadIdx.x; o < 6 * SLICE; o += kThreads) {
    const int s = o / SLICE, cc = o % SLICE;
    if (c0 + cc >= C) continue;
    const float* v = &red[s][cc % 4][0][cc / 4];
    float sum = 0.0f;
    for (int l = 0; l < LANES; ++l) sum += v[l * GROUPS];
    row[s * C + c0 + cc] = sum;
  }
}

// (c) From dg (M, C), the gradient of g: dh = dw3x3^T(dg), the correlation
// with the flipped taps, zero beyond each image's edge, and da0 = dh *
// wsilu'(a0). Partials of tile t, row t of part: [0, 9C) the tap gradient
// sum dg(y, x) h(y + i - 1, x + j - 1) at 3 i + j, with h = wsilu(a0),
// [9C, 10C) sum of dg (b2), [10C, 11C) sum of da0 (b0), [11C, 12C) sum of
// du (b3).
//
// The thread block copies dg and a0 over its tile and a one-pixel halo into
// shared memory (16-byte cp.async, zero-filled beyond the image: dg is 0
// there and wsilu(0) = 0, so the zeros are the padding), then turns a0 into
// h once per element (wsilu' kept in registers at the tile's own pixels).
// Warp r owns tile row r, a thread one channel: it walks the row with 3x3
// windows of dg and h in registers (three new values of each a pixel), its
// 9 tap and 3 bias sums in registers; the rows' sums are added in row order
// in shared memory.
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ dg, const float* __restrict__ a0,
              const float* __restrict__ taps, const float* __restrict__ du,
              float* __restrict__ da0, float* __restrict__ part, int ld,
              int H, int W, int C, int th, int tw, int tiles_y,
              int tiles_x) {
  __shared__ __align__(16) float sg[HALO * HALO * SLICE];  // dg, then sums
  __shared__ __align__(16) float sh[HALO * HALO * SLICE];  // a0, then h
  const int lc = threadIdx.x % SLICE, r = threadIdx.x / SLICE;
  const int c0 = blockIdx.y * SLICE, c = c0 + lc;
  const int cs = C - c0 < SLICE ? C - c0 : SLICE;
  const Tile t = tile_of(blockIdx.x, th, tw, tiles_y, tiles_x);
  const long img = (long)t.b * H * W;
  const int y = t.y0 + r;
  const bool mine = r < th && y < H && lc < cs;   // this thread's row

  // stage rows y0 - 1 .. y0 + th, columns x0 - 1 .. x0 + tw
  const int hw = tw + 2, n = (th + 2) * hw * GROUPS;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int q4 = i % GROUPS, pix = i / GROUPS;
    const int sr = pix / hw, scol = pix % hw;
    const int yy = t.y0 - 1 + sr, xx = t.x0 - 1 + scol;
    const bool valid = yy >= 0 && yy < H && xx >= 0 && xx < W && 4 * q4 < cs;
    const long src = valid ? (img + (long)yy * W + xx) * C + c0 + 4 * q4 : 0;
    const int dst = (sr * HALO + scol) * SLICE + 4 * q4;
    cp_async16(sg + dst, dg + src, valid);
    cp_async16(sh + dst, a0 + src, valid);
  }
  // while the copies fly: the taps and du at this thread's pixels
  float tp[9], dus[TILE];
#pragma unroll
  for (int k = 0; k < 9; ++k) tp[k] = lc < cs ? taps[k * C + c] : 0.0f;
#pragma unroll
  for (int x = 0; x < TILE; ++x)
    dus[x] = mine && x < tw && t.x0 + x < W
                 ? du[(img + (long)y * W + t.x0 + x) * C + c]
                 : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  // h = wsilu(a0), each staged element once: warp r its own row (r + 1 in
  // shared memory), warp 0 also the top halo row, warp th - 1 the bottom
  float dsl[TILE] = {};
  if (r < th) {
    float* hr = sh + (r + 1) * HALO * SLICE + lc;
#pragma unroll
    for (int x = 0; x < HALO; ++x) {
      if (x >= tw + 2) break;
      float f, d;
      wsilu_both(hr[x * SLICE], f, d);
      hr[x * SLICE] = f;
      if (x >= 1 && x <= TILE) dsl[x - 1] = d;
    }
    for (int edge = 0; edge < 2; ++edge) {
      const int sr = edge == 0 ? 0 : th + 1;
      if (r != (edge == 0 ? 0 : th - 1)) continue;
      float* he = sh + sr * HALO * SLICE + lc;
      for (int x = 0; x < tw + 2; ++x) he[x * SLICE] = wsilu(he[x * SLICE]);
    }
  }
  __syncthreads();

  float dt[9], s2 = 0.0f, s0 = 0.0f, s3 = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) dt[k] = 0.0f;
  if (mine) {
    // windows [i][j]: shared-memory row r + i, column x + j (pixel x of
    // the tile sits at column x + 1)
    const float* G = sg + r * HALO * SLICE + lc;
    const float* Hs = sh + r * HALO * SLICE + lc;
    float gw[3][3], hv[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        gw[i][j] = G[(i * HALO + j) * SLICE];
        hv[i][j] = Hs[(i * HALO + j) * SLICE];
      }
    }
#pragma unroll
    for (int x = 0; x < TILE; ++x) {
      if (x >= tw) break;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        gw[i][2] = G[(i * HALO + x + 2) * SLICE];
        hv[i][2] = Hs[(i * HALO + x + 2) * SLICE];
      }
      const float dgc = gw[1][1];
      float dh = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // g at (y - i + 1, x - j + 1) read h here through tap 3 i + j;
          // h at (y + i - 1, x + j - 1) fed g here through the same tap
          dh += tp[3 * i + j] * gw[2 - i][2 - j];
          dt[3 * i + j] += dgc * hv[i][j];
        }
      }
      if (t.x0 + x < W) {
        const float d = dh * dsl[x];
        da0[(img + (long)y * W + t.x0 + x) * C + c] = d;
        s2 += dgc;
        s0 += d;
        s3 += dus[x];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        gw[i][0] = gw[i][1];
        gw[i][1] = gw[i][2];
        hv[i][0] = hv[i][1];
        hv[i][1] = hv[i][2];
      }
    }
  }
  __syncthreads();                  // every window read: sg holds the sums
  float* red = sg;                  // [12][TILE rows][SLICE]
#pragma unroll
  for (int k = 0; k < 9; ++k) red[(k * TILE + r) * SLICE + lc] = dt[k];
  red[(9 * TILE + r) * SLICE + lc] = s2;
  red[(10 * TILE + r) * SLICE + lc] = s0;
  red[(11 * TILE + r) * SLICE + lc] = s3;
  __syncthreads();
  float* row = part + (long)blockIdx.x * ld;
  for (int o = threadIdx.x; o < 12 * SLICE; o += kThreads) {
    const int k = o / SLICE, cc = o % SLICE;
    if (cc >= cs) continue;
    const float* v = red + k * TILE * SLICE + cc;
    float sum = 0.0f;
#pragma unroll
    for (int rr = 0; rr < TILE; ++rr) sum += v[rr * SLICE];
    row[k * C + c0 + cc] = sum;
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

// The tile grid of dw_fwd, gate_bwd and dw_bwd (tiles x channel slices), or
// false for a shape or tile they do not take.
inline bool tile_grid(int B, int H, int W, int C, int th, int tw,
                      int* tiles_y, int* tiles_x, dim3* grid) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0) return false;
  if (th < 1 || th > TILE || th > H || tw < 1 || tw > TILE || tw > W)
    return false;
  *tiles_y = (H + th - 1) / th;
  *tiles_x = (W + tw - 1) / tw;
  const long tiles = (long)B * *tiles_y * *tiles_x;
  if (tiles > 0x7fffffffL) return false;
  *grid = dim3((unsigned)tiles, (C + SLICE - 1) / SLICE);
  return true;
}

}  // namespace dcbg

using namespace dcbg;

template <typename T>
void dw_fwd_launch(const void* a0, const void* taps, const void* b2, void* g,
                   int H, int W, int C, int th, int tw, int tiles_y,
                   int tiles_x, dim3 grid, cudaStream_t stream) {
  dw_fwd_kernel<T><<<grid, DW_THREADS, 0, stream>>>(
      static_cast<const float*>(a0), static_cast<const float*>(taps),
      static_cast<const float*>(b2), static_cast<T*>(g), H, W, C, th, tw,
      tiles_y, tiles_x);
}

template <typename T>
void gate_bwd_launch(const void* df, const void* p, const void* dy,
                     const void* q, const void* resid, void* dp, void* fr,
                     void* dyq, void* part, int ld, int H, int W, int C,
                     int th, int tw, int tiles_y, int tiles_x, dim3 grid,
                     cudaStream_t stream) {
  gate_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(df), static_cast<const float*>(p),
      static_cast<const T*>(dy), static_cast<const float*>(q),
      static_cast<const float*>(resid), static_cast<float*>(dp),
      static_cast<T*>(fr), static_cast<float*>(dyq),
      static_cast<float*>(part), ld, H, W, C, th, tw, tiles_y, tiles_x);
}

// f32: g in fp32 (else bf16). th x tw: the partition's tile.
extern "C" int ssgvc_dw_fwd(const void* a0, const void* taps, const void* b2,
                            void* g, int B, int H, int W, int C, int th,
                            int tw, int f32, void* stream) {
  int tiles_y, tiles_x;
  dim3 grid;
  if (!tile_grid(B, H, W, C, th, tw, &tiles_y, &tiles_x, &grid) ||
      (long)B * H * W > 0x7fffffffL)
    return cudaErrorInvalidValue;
  grid.y = (C + DW_SLICE - 1) / DW_SLICE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    dw_fwd_launch<float>(a0, taps, b2, g, H, W, C, th, tw, tiles_y, tiles_x,
                         grid, st);
  else
    dw_fwd_launch<bf16>(a0, taps, b2, g, H, W, C, th, tw, tiles_y, tiles_x,
                        grid, st);
  return cudaGetLastError();
}

// f32: dy and fr in fp32 (else bf16). th x tw: the partition's tile.
extern "C" int ssgvc_gate_bwd(const void* df, const void* p, const void* dy,
                              const void* q, const void* resid, void* dp,
                              void* fr, void* dyq, void* part, int ld, int B,
                              int H, int W, int C, int th, int tw, int f32,
                              void* stream) {
  int tiles_y, tiles_x;
  dim3 grid;
  if (!tile_grid(B, H, W, C, th, tw, &tiles_y, &tiles_x, &grid))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    gate_bwd_launch<float>(df, p, dy, q, resid, dp, fr, dyq, part, ld, H, W,
                           C, th, tw, tiles_y, tiles_x, grid, st);
  else
    gate_bwd_launch<bf16>(df, p, dy, q, resid, dp, fr, dyq, part, ld, H, W,
                          C, th, tw, tiles_y, tiles_x, grid, st);
  return cudaGetLastError();
}

extern "C" int ssgvc_dw_bwd(const void* dg, const void* a0, const void* taps,
                            const void* du, void* da0, void* part, int ld,
                            int B, int H, int W, int C, int th, int tw,
                            void* stream) {
  int tiles_y, tiles_x;
  dim3 grid;
  if (!tile_grid(B, H, W, C, th, tw, &tiles_y, &tiles_x, &grid))
    return cudaErrorInvalidValue;
  dw_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dg), static_cast<const float*>(a0),
      static_cast<const float*>(taps), static_cast<const float*>(du),
      static_cast<float*>(da0), static_cast<float*>(part), ld, H, W, C, th,
      tw, tiles_y, tiles_x);
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
