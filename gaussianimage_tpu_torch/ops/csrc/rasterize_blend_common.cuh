// Device code shared by the alpha-blend kernels K8 and K9
// (rasterize_blend.cu): the layout of a tile's pixels over a cluster of
// CTAs and their warps, the per-slot cull, the staging of a chunk of
// depth-ordered rows in shared memory, and the alpha terms of one
// (instance, pixel) pair, the JAX kernel's _alpha_terms
// (gaussianimage_tpu/ops/rasterize_blend.py:110). Both kernels evaluate a
// pair through pair_alpha behind the same cull, so K9 walks back over
// exactly the alphas K8 composited. The stream is flat or aligned
// (kBlocks), as in rasterize_sum_common.cuh, whose Stream and
// slot_features it shares.
//
// Layout. A 32-pixel tile is a cluster of 4 CTAs of 256 threads; CTA r
// owns rows 8r..8r+7. A 16-pixel tile is one CTA. Each thread owns one
// pixel, and each warp an 8 x 4 patch of them, so a small Gaussian
// touches few warps.
//
// The cull (slot_cull, mirrored op for op by rasterize_blend.py's
// blend_cull_plain). Per slot, once at staging: q_cut = 2 log(o /
// alpha_min) + kQMargin, and the tile-local pixel rectangle that holds
// every pixel whose computed q can reach q_cut. A pair with q > q_cut has
// o exp(-q/2) < alpha_min, and so does a pair outside the rectangle; such
// a pair has alpha 0 and changes no sum, so skipping it leaves every
// pixel's sequence of operations as it was. The rectangle bounds the
// ellipse a dx^2 + 2b dx dy + c dy^2 <= Q, half extents sqrt(Q c / det)
// and sqrt(Q a / det) with det = ac - b^2, for Q = q_cut / (1 - 2e-6
// kappa), kappa = ac / det: the float32 form rounds each of its three
// terms and two sums, which moves q by at most 24 u kappa F (u = 2^-24)
// at a point where the exact form is F, so Q covers every pixel whose
// computed q is <= q_cut. The half extents are then padded by a relative
// 1e-3 and one pixel. The rectangle is computed in double (the products
// of two floats are exact there). A row with a NaN (center, conic) or
// q_cut that is NaN or negative takes no pixel (its pairs compare false
// at the gate, as in the plain version); a row that is not positive
// definite (det <= 0 or a <= 0), holds an infinity or has kappa above
// 2.5e5 takes the whole tile.
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

using gsum::Stream;

// The tile-local pixel rectangle [x0, x1] x [y0, y1] (empty: x0 > x1) a
// slot can reach, and its q_cut (see the head of this file).
struct SlotCull {
  float qc;
  int x0, x1, y0, y1;
};

__device__ __forceinline__ SlotCull slot_cull(float gx, float gy, float a, float b,
                                              float c, float op, float alpha_min,
                                              int tile) {
  SlotCull r;
  r.qc = alpha_min > 0.0f
      ? __fadd_rn(__fmul_rn(2.0f, logf(__fdiv_rn(op, alpha_min))), kQMargin)
      : INFINITY;
  r.x0 = r.y0 = tile;  // empty
  r.x1 = r.y1 = -1;
  const double X = gx, Y = gy, A = a, B = b, C = c, Q = r.qc;
  if (isnan(X) || isnan(Y) || isnan(A) || isnan(B) || isnan(C) || !(Q >= 0.0))
    return r;
  r.x0 = r.y0 = 0;  // the whole tile
  r.x1 = r.y1 = tile - 1;
  if (isinf(X) || isinf(Y) || isinf(A) || isinf(B) || isinf(C) || isinf(Q)) return r;
  // rounded op by op (no contraction), as blend_cull_plain computes it
  const double AC = __dmul_rn(A, C);
  const double det = __dsub_rn(AC, __dmul_rn(B, B));
  if (!(det > 0.0 && A > 0.0)) return r;
  const double e = __dmul_rn(2e-6, __ddiv_rn(AC, det));
  if (!(e < 0.5)) return r;
  const double Qp = __ddiv_rn(Q, __dsub_rn(1.0, e));
  const double rx =
      __dadd_rn(__dmul_rn(__dsqrt_rn(__ddiv_rn(__dmul_rn(Qp, C), det)), 1.001), 1.0);
  const double ry =
      __dadd_rn(__dmul_rn(__dsqrt_rn(__ddiv_rn(__dmul_rn(Qp, A), det)), 1.001), 1.0);
  const double lx = ceil(__dsub_rn(X, rx)), hx = floor(__dadd_rn(X, rx));
  const double ly = ceil(__dsub_rn(Y, ry)), hy = floor(__dadd_rn(Y, ry));
  r.x0 = lx > tile - 1 ? tile : (lx < 0.0 ? 0 : static_cast<int>(lx));
  r.x1 = hx < 0.0 ? -1 : (hx > tile - 1 ? tile - 1 : static_cast<int>(hx));
  r.y0 = ly > tile - 1 ? tile : (ly < 0.0 ? 0 : static_cast<int>(ly));
  r.y1 = hy < 0.0 ? -1 : (hy > tile - 1 ? tile - 1 : static_cast<int>(hy));
  return r;
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

// A slot's feature row in registers: center, conic (a, b, c), raw color,
// opacity.
struct SlotRow {
  float x, y, a, b, c, col[3], op;
};

// Slot base + k's row (gsum::slot_features: feat[gids[s]], or the aligned
// stream's blocks). The kernels load a chunk's rows while the warps walk
// the chunk before it, so the loads' latency hides behind the walk.
template <bool kBlocks>
__device__ __forceinline__ SlotRow load_slot(const Stream& st, int base, int k) {
  int step;
  const float* r = gsum::slot_features<kBlocks>(st, base, k, step);
  SlotRow v;
  v.x = r[0];
  v.y = r[step];
  v.a = r[2 * step];
  v.b = r[3 * step];
  v.c = r[4 * step];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) v.col[ch] = r[(5 + ch) * step];
  v.op = r[8 * step];
  return v;
}

// On the flat stream, ask for the ids of slots base..base+n-1 to be
// brought into L1 a chunk before load_slot reads them, so that the row
// loads wait on no id.
template <bool kBlocks>
__device__ __forceinline__ void prefetch_ids(const Stream& st, int base, int n) {
  if (!kBlocks && static_cast<int>(threadIdx.x) < n)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(st.gids + base + threadIdx.x));
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
    for (int ch = 0; ch < 3; ++ch) s.col[ch][k] = v.col[ch];
    s.op[k] = v.op;
    const SlotCull cl = slot_cull(gx, gy, v.a, v.b, v.c, v.op, alpha_min, TILE);
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
