// Device code shared by the alpha-blend kernels K8 and K9
// (rasterize_blend.cu): the layout of a tile's pixels over a cluster of
// CTAs and their warps, the per-slot cull, the staging of a chunk of
// depth-ordered rows in shared memory, and the alpha terms of one
// (instance, pixel) pair, the JAX kernel's _alpha_terms
// (gaussianimage_tpu/ops/rasterize_blend.py:110). Both kernels evaluate a
// pair through pair_alpha behind the same cull, so K9 walks back over
// exactly the alphas K8 composited. The stream is flat or aligned
// (kBlocks), as in rasterize_sum_common.cuh, whose Stream, load_slot
// and slot_cull it shares (and rasterize_blend.cu its warp_sum8).
//
// Layout. A 32-pixel tile is a cluster of 4 CTAs of 256 threads; CTA r
// owns rows 8r..8r+7. A 16-pixel tile is one CTA. Each thread owns one
// pixel, and each warp an 8 x 4 patch of them, so a small Gaussian
// touches few warps.
//
// The cull (blend_cull, mirrored op for op by rasterize_blend.py's
// blend_cull_plain). Per slot, once at staging: q_cut = 2 log(o /
// alpha_min) + kQMargin, and the tile-local pixel rectangle that holds
// every pixel whose computed q can reach q_cut (gsum::slot_cull, whose
// derivation rasterize_sum_common.cuh gives). A pair with q > q_cut has
// o exp(-q/2) < alpha_min, and so does a pair outside the rectangle; such
// a pair has alpha 0 and changes no sum, so skipping it leaves every
// pixel's sequence of operations as it was.
//
// Arithmetic: the quadratic form of rasterize_sum_common.cuh (rounded op
// by op, full-precision expf), with the tile origin subtracted from the
// center first, as the JAX kernel does. The gate compares the unclamped
// form with q_cut, so a NaN form fails it as the plain version's NaN does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "rasterize_sum_common.cuh"

namespace gblend {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // 8
constexpr int kBK = 64;                // stream slots per chunk
constexpr int kFW = 16;                // floats per feature row
constexpr int kPatchW = 8;             // a warp's patch: 8 columns x 4 rows
constexpr int kPatchH = 4;
constexpr float kQMargin = 0.01f;      // q_cut = 2 log(o / alpha_min) + this

// The tile over its CTAs: kCluster CTAs of kRows rows each, warp w of a
// CTA on the patch (w % kPatchesX, w / kPatchesX).
template <int TILE>
struct Layout {
  static constexpr int kCluster = TILE == 32 ? 4 : 1;
  static constexpr int kRows = kThreads / TILE;        // 8 or 16
  static constexpr int kPatchesX = TILE / kPatchW;     // 4 or 2
  static_assert(kCluster * kRows == TILE, "one pixel per thread");
  static_assert(kPatchesX * (kRows / kPatchH) == kWarps, "one patch per warp");
};

// One chunk of at most kBK depth-ordered rows, as per-slot columns:
// tile-local center, conic (a, 2b, c), raw color, opacity, the gate q_cut
// and the warps of this CTA whose patch meets the slot's rectangle.
struct Chunk {
  float gx[kBK], gy[kBK], a[kBK], b2[kBK], c[kBK];
  float col[3][kBK];
  float op[kBK];
  float qc[kBK];
  unsigned hit[kBK];  // bit w: warp w's patch
};

using gsum::SlotCull;
using gsum::SlotRow;
using gsum::Stream;

// A slot's cull (see the head of this file): its gate q_cut and the
// tile-local pixel rectangle it can reach.
__device__ __forceinline__ SlotCull blend_cull(float gx, float gy, float a, float b,
                                               float c, float op, float alpha_min,
                                               int tile) {
  const float qc = alpha_min > 0.0f
      ? __fadd_rn(__fmul_rn(2.0f, logf(__fdiv_rn(op, alpha_min))), kQMargin)
      : INFINITY;
  return gsum::slot_cull(gx, gy, a, b, c, qc, tile);
}

// The thread's tile, CTA rank, warp patch and pixel.
struct Pixel {
  int start, end;    // the tile's window of the stream
  float tx0, ty0;    // the tile's origin, pixels
  int tile, rank;    // tile index, CTA rank in the tile's cluster
  int warp, lane;
  float X, Y;        // the tile-local pixel
  bool inside;       // within H x W
  size_t pix;        // py * W + px
};

template <int TILE, bool kBlocks>
__device__ __forceinline__ Pixel pixel_of(const Stream& st, int H, int W, int tiles_x) {
  using L = Layout<TILE>;
  Pixel p;
  p.tile = blockIdx.x / L::kCluster;
  p.rank = blockIdx.x % L::kCluster;
  const int tx = p.tile % tiles_x;
  const int ty = p.tile / tiles_x;
  p.tx0 = static_cast<float>(tx * TILE);
  p.ty0 = static_cast<float>(ty * TILE);
  p.start = st.starts[p.tile];
  p.end = kBlocks ? p.start + st.counts[p.tile] : st.starts[p.tile + 1];
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  const int lx = kPatchW * (p.warp % L::kPatchesX) + p.lane % kPatchW;
  const int ly = p.rank * L::kRows + kPatchH * (p.warp / L::kPatchesX) + p.lane / kPatchW;
  p.X = static_cast<float>(lx);
  p.Y = static_cast<float>(ly);
  const int px = tx * TILE + lx;
  const int py = ty * TILE + ly;
  p.inside = px < W && py < H;
  p.pix = p.inside ? static_cast<size_t>(py) * W + px : 0;
  return p;
}

// Thread k < kBK stages slot k of the chunk (its row `v`, where k < n) with
// its cull against the patches of CTA `rank`; slots n..kBK-1 hit no warp.
// The caller synchronises before the chunk is read.
template <int TILE>
__device__ __forceinline__ void stage_slot(Chunk& s, const SlotRow& v, int n, float tx0,
                                           float ty0, int rank, float alpha_min) {
  using L = Layout<TILE>;
  const int k = threadIdx.x;
  if (k >= kBK) return;
  unsigned hit = 0;
  if (k < n) {
    const float gx = __fsub_rn(v.x, tx0);
    const float gy = __fsub_rn(v.y, ty0);
    s.gx[k] = gx;
    s.gy[k] = gy;
    s.a[k] = v.a;
    s.b2[k] = __fmul_rn(2.0f, v.b);
    s.c[k] = v.c;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s.col[ch][k] = v.f[ch];
    s.op[k] = v.f[3];
    const SlotCull cl = blend_cull(gx, gy, v.a, v.b, v.c, v.f[3], alpha_min, TILE);
    s.qc[k] = cl.qc;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int px0 = kPatchW * (w % L::kPatchesX);
      const int py0 = rank * L::kRows + kPatchH * (w / L::kPatchesX);
      if (cl.x0 <= px0 + kPatchW - 1 && cl.x1 >= px0 && cl.y0 <= py0 + kPatchH - 1
          && cl.y1 >= py0)
        hit |= 1u << w;
    }
  }
  s.hit[k] = hit;
}

// The warp's slots of the staged chunk: bit k set where slot k's
// rectangle meets the warp's patch.
__device__ __forceinline__ unsigned long long warp_slots(const Chunk& s, int warp,
                                                         int lane) {
  const unsigned lo = __ballot_sync(0xffffffffu, (s.hit[lane] >> warp) & 1u);
  const unsigned hi = __ballot_sync(0xffffffffu, (s.hit[lane + 32] >> warp) & 1u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// One pair's terms, behind the gate. `on` is q <= q_cut and raw >=
// alpha_min; where it is false the pair's alpha is 0 and it adds nothing
// to either kernel's sums, and the other fields are not set.
struct PairAlpha {
  float q, w, raw, alpha;
  bool on;
};

__device__ __forceinline__ PairAlpha pair_alpha(const Chunk& s, int k, float dx, float dy,
                                                float alpha_clip, float alpha_min) {
  PairAlpha p;
  // the form of gsum::quad_form, before its clamp at 0
  const float adxdx = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
  const float qr = __fadd_rn(__fadd_rn(adxdx, __fmul_rn(__fmul_rn(s.b2[k], dx), dy)),
                             __fmul_rn(__fmul_rn(s.c[k], dy), dy));
  p.on = qr <= s.qc[k];
  if (p.on) {
    p.q = fmaxf(qr, 0.0f);
    p.w = gsum::pair_weight(p.q);
    p.raw = __fmul_rn(s.op[k], p.w);
    p.on = p.raw >= alpha_min;
    p.alpha = fminf(p.raw, alpha_clip);
  }
  return p;
}

}  // namespace gblend
