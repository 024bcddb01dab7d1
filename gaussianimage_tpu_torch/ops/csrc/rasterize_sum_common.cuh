// Device code shared by the accumulated-summation rasterizer kernels K1
// (rasterize_sum_fwd.cu), K2 and K3 (rasterize_sum_bwd.cu): the tile and
// chunk geometry, the staging of a chunk of the instance stream in shared
// memory, the quadratic form, gate and weight of one (instance, pixel)
// pair, and the forward walk of a tile's window. All three kernels evaluate
// a pair through these functions, so they make bit-identical gate decisions
// and weights, and K1 and K3 compute the same image bit for bit.
//
// Two stream layouts (`Stream`), a template parameter kBlocks of the
// staging, the geometry and the walk: the flat stream, rows feat[gids[s]]
// and windows [starts[t], starts[t+1]); and the aligned stream, [NB, 16, 64]
// transposed blocks written by K11a (stream_blocks.cu) and windows
// [starts[t], starts[t] + counts[t]) with starts[t] a multiple of 64, so
// chunk ci of tile t is block starts[t] / 64 + ci. The chunk boundaries
// relative to a window's start are the same in both, and so is every
// pair's arithmetic: on the same instances the two give the same image and
// the same gradient rows bit for bit.
//
// Arithmetic: the JAX kernel's expression, rounded op by op (__fmul_rn,
// __fadd_rn: no FMA contraction) and expf, not __expf, so q and w are
// bit-equal to the plain PyTorch versions'. That matters at the q <= q_cut
// gate, where one ulp of q decides whether exp(-4.5) ~ 0.011 is added.

#pragma once

#include <cuda_runtime.h>

namespace gsum {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;                     // 8
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 4
constexpr int kBK = 64;                                   // instances per chunk
constexpr int kFW = 16;                                   // floats per feature row
constexpr int kC = 4;                                     // rgb + alpha

// One chunk of at most kBK instances, as per-instance columns: tile-local
// center, conic (a, 2b, c), premultiplied color matrix (o*r, o*g, o*b, o).
struct Chunk {
  float gx[kBK], gy[kBK], a[kBK], b2[kBK], c[kBK];
  float cm[kC][kBK];
};

// The stream a kernel walks. Flat: feat [n_rows, 16], gids [I], starts
// [T+1]; counts and blocks unused. Aligned: blocks [NB, 16, 64], starts
// [T+1] (multiples of 64) and counts [T]; feat and gids unused.
struct Stream {
  const float* feat;
  int n_rows;
  const int* gids;
  const float* blocks;
  const int* starts;
  const int* counts;
};

// Slot base + k's feature f is r[f * step]: a row feat[gids[s]] (step 1;
// out-of-range ids read the zero sentinel row n_rows-1), or lane k of the
// aligned stream's block base / 64 (step 64; base is a chunk's first slot,
// a multiple of 64 there).
template <bool kBlocks>
__device__ __forceinline__ const float* slot_features(const Stream& st, int base, int k,
                                                      int& step) {
  if (kBlocks) {
    step = kBK;
    return st.blocks + static_cast<size_t>(base / kBK) * (kFW * kBK) + k;
  }
  step = 1;
  int g = st.gids[base + k];
  if (g < 0 || g >= st.n_rows) g = st.n_rows - 1;
  return st.feat + static_cast<size_t>(g) * kFW;
}

// Threads 0..n-1 stage stream slots base..base+n-1. The caller
// synchronises before the chunk is read.
template <bool kBlocks>
__device__ __forceinline__ void stage_chunk(Chunk& s, const Stream& st, int base, int n,
                                            float tx0, float ty0) {
  const int k = threadIdx.x;
  if (k < n) {
    int step;
    const float* r = slot_features<kBlocks>(st, base, k, step);
    s.gx[k] = __fsub_rn(r[0], tx0);
    s.gy[k] = __fsub_rn(r[step], ty0);
    s.a[k] = r[2 * step];
    s.b2[k] = __fmul_rn(2.0f, r[3 * step]);
    s.c[k] = r[4 * step];
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) s.cm[ch][k] = r[(5 + ch) * step];
  }
}

// q = max(a dx^2 + 2b dx dy + c dy^2, 0) from the per-column terms
// adxdx = (a dx) dx and b2dx = (2b) dx, in the plain version's order.
__device__ __forceinline__ float quad_form(float adxdx, float b2dx, float c,
                                           float dy) {
  const float q = __fadd_rn(__fadd_rn(adxdx, __fmul_rn(b2dx, dy)),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return fmaxf(q, 0.0f);
}

// The pair's weight exp(-q/2), called only where q <= q_cut.
__device__ __forceinline__ float pair_weight(float q) {
  return expf(__fmul_rn(-0.5f, q));
}

// The block's tile and the thread's 4 pixels. Thread (warp w, lane l) owns
// column l of the contiguous rows 4w..4w+3, so stores are coalesced along x
// and a small Gaussian touches few warps.
struct TileGeom {
  int start, end;               // the tile's window of the stream
  float tx0, ty0;               // the tile's origin, pixels
  float X;                      // the thread's tile-local column
  float Y[kRowsPerThread];      // its tile-local rows
  bool inside[kRowsPerThread];  // pixel within H x W
  size_t pix[kRowsPerThread];   // py * W + px
};

template <bool kBlocks>
__device__ __forceinline__ TileGeom tile_geom(const Stream& st, int H, int W, int tiles_x) {
  TileGeom g;
  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  g.tx0 = static_cast<float>(tx * kTile);
  g.ty0 = static_cast<float>(ty * kTile);
  g.start = st.starts[t];
  g.end = kBlocks ? g.start + st.counts[t] : st.starts[t + 1];
  const int lx = threadIdx.x % kTile;
  const int warp = threadIdx.x / kTile;
  const int px = tx * kTile + lx;
  g.X = static_cast<float>(lx);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ly = warp * kRowsPerThread + j;
    const int py = ty * kTile + ly;
    g.Y[j] = static_cast<float>(ly);
    g.inside[j] = px < W && py < H;
    g.pix[j] = g.inside[j] ? static_cast<size_t>(py) * W + px : 0;
  }
  return g;
}

// The forward walk: acc[j] = sum over the tile's window, in stream order,
// of (o*r, o*g, o*b, o) * w at the thread's pixel j. Every thread of the
// block must call it (it stages chunks and synchronises).
template <bool kBlocks>
__device__ __forceinline__ void tile_forward(Chunk& s, const Stream& st, const TileGeom& tg,
                                             float q_cut,
                                             float (&acc)[kRowsPerThread][kC]) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) acc[j][ch] = 0.0f;
  for (int base = tg.start; base < tg.end; base += kBK) {
    const int n = min(kBK, tg.end - base);
    stage_chunk<kBlocks>(s, st, base, n, tg.tx0, tg.ty0);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float dx = __fsub_rn(tg.X, s.gx[k]);
      const float adxdx = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
      const float b2dx = __fmul_rn(s.b2[k], dx);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float q = quad_form(adxdx, b2dx, s.c[k], __fsub_rn(tg.Y[j], s.gy[k]));
        if (q <= q_cut) {
          const float w = pair_weight(q);
#pragma unroll
          for (int ch = 0; ch < kC; ++ch)
            acc[j][ch] = __fadd_rn(acc[j][ch], __fmul_rn(s.cm[ch][k], w));
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace gsum
