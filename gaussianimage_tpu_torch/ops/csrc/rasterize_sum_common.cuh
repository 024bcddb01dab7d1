// Device code shared by the accumulated-summation rasterizer kernels K1
// (rasterize_sum_fwd.cu), K2 and K3 (rasterize_sum_bwd.cu): the tile and
// chunk geometry, the staging of a chunk of the instance stream in shared
// memory, the quadratic form, gate and weight of one (instance, pixel)
// pair, and the forward walk of a tile's window. All three kernels evaluate
// a pair through these functions, so they make bit-identical gate decisions
// and weights, and K1 and K3 compute the same image bit for bit. Also
// shared with the alpha-blend kernels K8 / K9 (rasterize_blend_common.cuh):
// a slot's row loaded into registers (load_slot), the per-slot cull
// rectangle (slot_cull) and the eight-term warp reduction (warp_sum8).
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
// The gate takes max(form, 0) as the JAX kernel's jnp.maximum does: a
// negative form (a near-degenerate or indefinite conic) counts as q = 0,
// and a NaN form stays NaN and fails q <= q_cut.
//
// The cull (slot_cull, mirrored op for op by rasterize_sum.py's
// slot_cull_plain). Per staged slot, the tile-local pixel rectangle that
// holds every pixel whose computed form can reach a gate qc: K3 takes qc
// = q_cut, K8 / K9 qc = 2 log(o / alpha_min) + kQMargin. A pair outside
// it fails the gate, so skipping it leaves every pixel's sum as it was.
// The rectangle bounds the ellipse a dx^2 + 2b dx dy + c dy^2 <= Q, half
// extents sqrt(Q c / det) and sqrt(Q a / det) with det = ac - b^2, for Q
// = qc / (1 - 2e-6 kappa), kappa = ac / det: the float32 form rounds each
// of its three terms and two sums, which moves q by at most 24 u kappa F
// (u = 2^-24) at a point where the exact form is F, so Q covers every
// pixel whose computed form is <= qc (a form that rounds below 0 needs
// kappa > 1 / (24 u) ~ 7e5, above the whole-tile limit below). The half
// extents are then padded by a relative 1e-3 and one pixel. The rectangle
// is computed in double (the products of two floats are exact there). A
// row with a NaN (center, conic) or a qc that is NaN or negative takes no
// pixel (its pairs compare false at the gate, as in the plain versions); a
// row that is not positive definite (det <= 0 or a <= 0), holds an
// infinity or has kappa above 2.5e5 takes the whole tile.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
// adxdx = (a dx) dx and b2dx = (2b) dx, in the plain version's order. A
// NaN form stays NaN (fmaxf would return 0 and let the pair in with w = 1).
__device__ __forceinline__ float quad_form(float adxdx, float b2dx, float c,
                                           float dy) {
  const float q = __fadd_rn(__fadd_rn(adxdx, __fmul_rn(b2dx, dy)),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return q < 0.0f ? 0.0f : q;
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

// A slot's feature row in registers: center, conic (a, b, c) and the four
// features after them (K1-K3: o*r, o*g, o*b, o; K8 / K9: r, g, b, o).
struct SlotRow {
  float x, y, a, b, c, f[4];
};

// Slot base + k's row (slot_features: feat[gids[s]], or the aligned
// stream's blocks). A kernel loads a chunk's rows while its warps walk the
// chunk before it, so the loads' latency hides behind the walk.
template <bool kBlocks>
__device__ __forceinline__ SlotRow load_slot(const Stream& st, int base, int k) {
  int step;
  const float* r = slot_features<kBlocks>(st, base, k, step);
  SlotRow v;
  v.x = r[0];
  v.y = r[step];
  v.a = r[2 * step];
  v.b = r[3 * step];
  v.c = r[4 * step];
#pragma unroll
  for (int i = 0; i < 4; ++i) v.f[i] = r[(5 + i) * step];
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

// The tile-local pixel rectangle [x0, x1] x [y0, y1] (empty: x0 > x1 or
// y0 > y1) a slot can reach under the gate qc (see the head of this file).
struct SlotCull {
  float qc;
  int x0, x1, y0, y1;
};

__device__ __forceinline__ SlotCull slot_cull(float gx, float gy, float a, float b,
                                              float c, float qc, int tile) {
  SlotCull r;
  r.qc = qc;
  r.x0 = r.y0 = tile;  // empty
  r.x1 = r.y1 = -1;
  const double X = gx, Y = gy, A = a, B = b, C = c, Q = qc;
  if (isnan(X) || isnan(Y) || isnan(A) || isnan(B) || isnan(C) || !(Q >= 0.0))
    return r;
  r.x0 = r.y0 = 0;  // the whole tile
  r.x1 = r.y1 = tile - 1;
  if (isinf(X) || isinf(Y) || isinf(A) || isinf(B) || isinf(C) || isinf(Q)) return r;
  // rounded op by op (no contraction), as slot_cull_plain computes it
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

// Eight per-lane values v[0..7] summed over the warp with 9 shuffles,
// where eight trees take 40: at each butterfly step a lane keeps the half
// of its values that its lane bit selects and adds its partner's copy of
// that half. Returns term (lane bits 4, 3, 2) of the eight, summed over
// all 32 lanes (the four lanes of a group hold the same sum); the order of
// the additions is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_sum8(const float* v, int lane, int& term) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (h16 ? v[i + 4] : v[i])
            + __shfl_xor_sync(0xffffffffu, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (h8 ? w4[i + 2] : w4[i])
            + __shfl_xor_sync(0xffffffffu, h8 ? w4[i] : w4[i + 2], 8);
  float w1 = (h4 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, h4 ? w2[0] : w2[1], 4);
  w1 += __shfl_xor_sync(0xffffffffu, w1, 2);
  w1 += __shfl_xor_sync(0xffffffffu, w1, 1);
  term = (h16 ? 4 : 0) + (h8 ? 2 : 0) + (h4 ? 1 : 0);
  return w1;
}

}  // namespace gsum
