// Device code shared by the alpha-blend kernels K8 and K9
// (rasterize_blend.cu): the tile geometry for 16- and 32-pixel tiles, the
// staging of a chunk of depth-ordered rows in shared memory, and the alpha
// terms of one (instance, pixel) pair, the JAX kernel's _alpha_terms
// (gaussianimage_tpu/ops/rasterize_blend.py:110). Both kernels evaluate a
// pair through pair_alpha, so K9 walks back over exactly the alphas K8
// composited. The stream is flat or aligned (kBlocks), as in
// rasterize_sum_common.cuh, whose Stream and slot_features it shares.
//
// Arithmetic: the quadratic form and weight of rasterize_sum_common.cuh
// (rounded op by op, full-precision expf), with the tile origin subtracted
// from the center first, as the JAX kernel does.

#pragma once

#include <cuda_runtime.h>

#include "rasterize_sum_common.cuh"

namespace gblend {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // 8
constexpr int kBK = 64;                // stream slots per chunk
constexpr int kFW = 16;                // floats per feature row

// One chunk of at most kBK depth-ordered rows, as per-slot columns:
// tile-local center, conic (a, 2b, c), raw color, opacity.
struct Chunk {
  float gx[kBK], gy[kBK], a[kBK], b2[kBK], c[kBK];
  float col[3][kBK];
  float op[kBK];
};

using gsum::Stream;

// Threads 0..n-1 stage stream slots base..base+n-1 (gsum::slot_features:
// rows feat[gids[s]], or the aligned stream's blocks). The caller
// synchronises before the chunk is read.
template <bool kBlocks>
__device__ __forceinline__ void stage_chunk(Chunk& s, const Stream& st, int base, int n,
                                            float tx0, float ty0) {
  const int k = threadIdx.x;
  if (k < n) {
    int step;
    const float* r = gsum::slot_features<kBlocks>(st, base, k, step);
    s.gx[k] = __fsub_rn(r[0], tx0);
    s.gy[k] = __fsub_rn(r[step], ty0);
    s.a[k] = r[2 * step];
    s.b2[k] = __fmul_rn(2.0f, r[3 * step]);
    s.c[k] = r[4 * step];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s.col[ch][k] = r[(5 + ch) * step];
    s.op[k] = r[8 * step];
  }
}

// The block's tile and the thread's kPPT pixels: thread i owns column
// i % TILE of the contiguous rows (i / TILE) * kPPT ..., so stores are
// coalesced along x (for TILE = 32 the layout of rasterize_sum_common.cuh).
template <int TILE>
struct TileGeom {
  static constexpr int kPPT = TILE * TILE / kThreads;  // 4 or 1
  int start, end;          // the tile's window of the stream
  float tx0, ty0;          // the tile's origin, pixels
  float X;                 // the thread's tile-local column
  float Y[kPPT];           // its tile-local rows
  bool inside[kPPT];       // pixel within H x W
  size_t pix[kPPT];        // py * W + px
};

template <int TILE, bool kBlocks>
__device__ __forceinline__ TileGeom<TILE> tile_geom(const Stream& st, int H, int W,
                                                    int tiles_x) {
  constexpr int kPPT = TileGeom<TILE>::kPPT;
  static_assert(kPPT >= 1 && kPPT * kThreads == TILE * TILE, "tile");
  TileGeom<TILE> g;
  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  g.tx0 = static_cast<float>(tx * TILE);
  g.ty0 = static_cast<float>(ty * TILE);
  g.start = st.starts[t];
  g.end = kBlocks ? g.start + st.counts[t] : st.starts[t + 1];
  const int lx = threadIdx.x % TILE;
  const int grp = threadIdx.x / TILE;
  const int px = tx * TILE + lx;
  g.X = static_cast<float>(lx);
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int ly = grp * kPPT + j;
    const int py = ty * TILE + ly;
    g.Y[j] = static_cast<float>(ly);
    g.inside[j] = px < W && py < H;
    g.pix[j] = g.inside[j] ? static_cast<size_t>(py) * W + px : 0;
  }
  return g;
}

// One pair's terms. The slot is live (only live slots are staged); `on`
// is raw >= alpha_min, and where it is false the pair's alpha is 0 and it
// adds nothing to either kernel's sums.
struct PairAlpha {
  float q, w, raw, alpha;
  bool on;
};

__device__ __forceinline__ PairAlpha pair_alpha(float adxdx, float b2dx, float c,
                                                float dy, float op, float alpha_clip,
                                                float alpha_min) {
  PairAlpha p;
  p.q = gsum::quad_form(adxdx, b2dx, c, dy);
  p.w = gsum::pair_weight(p.q);
  p.raw = __fmul_rn(op, p.w);
  p.on = p.raw >= alpha_min;
  p.alpha = p.on ? fminf(p.raw, alpha_clip) : 0.0f;
  return p;
}

}  // namespace gblend
