// K2 and K3: the backward of the accumulated-summation rasterizer, and the
// fused render + L2 + backward of the training step, for Hopper (sm_90a).
//
// K2 `rasterize_sum_bwd` replaces gaussianimage_tpu/ops/rasterize_sum.py::
// _bwd_kernel (with _bwd_chunk_store); K3 `rasterize_sum_l2` replaces
// ::_fused_l2_kernel. Both fuse the stream gather of
// ops/stream_common.py::gather_stream, and read and write [C, H, W] images
// directly where the TPU kernels take tiled [T, 4, 1024] blocks
// (stream_common.tile_cotangent). The `_aligned` entry points walk the
// aligned stream (rasterize_sum_common.cuh's kBlocks: K11a's [NB, 16, 64]
// blocks) and write their gradients as [NB, 16, 64] blocks, the TPU
// kernels' `aligned` branch.
//
// Function. Per 32x32 tile t, over its window [starts[t], starts[t+1]) of
// the tile-sorted stream, with rows feat[gids[s]] = (x, y, a, b, c, o*r,
// o*g, o*b, o, pad..) and the pair weight w = exp(-q/2) gated at q <= q_cut
// (rasterize_sum_common.cuh, as K1):
//   K3 forward: img = sum_s cm_s w_s (K1's sum, in K1's order, so it is
//     bit-equal to K1's image); imgc = clip(img, 0, 1) and
//     gmask = 0 < img < 1 (or imgc = img and no mask under no_clamp);
//     diff = imgc - gt on in-image pixels; sse[t] = sum diff^2;
//     G = gscale * diff * gmask for rgb (gscale = 2 / (3HW)), 0 for alpha.
//   K2: G is the caller's cotangent [4, H, W]; alpha's is live.
//   Backward (shared): per instance, dw = sum_c cm_c G_c and
//     dq = -w dw / 2 on every gated pixel, then
//       cx = sum dq dx, cy = sum dq dy,
//       da = sum dq dx^2, db = 2 sum dq dx dy, dc = sum dq dy^2,
//       dgx = -2 a cx - 2 b cy, dgy = -2 b cx - 2 c cy,
//       dcm_c = sum w G_c,
//     written as the row [dgx, dgy, da, db, dc, dcm0..3, 0 x 7] of
//     dgfeat[slot] (flat), or down lane slot % 64 of gradient block
//     slot / 64 (aligned: each chunk's whole block, its dead lanes zero). The moments are summed directly over the pixel offsets
//     dx, dy, not recombined from tile-local pixel moments as the TPU kernel
//     does (da = mxx - 2 gx mx + gx^2 m0): the direct sum has no
//     cancellation and takes one reduction fewer.
//
// A slot belongs to exactly one tile's window, so blocks write disjoint
// rows of dgfeat, and the TPU kernel's masked += over the neighbour's
// window has no counterpart here. Rows of slots past the last window are
// not written. On the aligned stream each gradient block belongs to one
// tile, so its whole-block stores are disjoint too; blocks past the last
// window are not written.
//
// Bound on the H100: FP32 issue slots and MUFU ex2, as for K1. K3 does K1's
// work (q and the gate, ~9 slots, and 13 + 1 ex2 more per gated pair), then
// a second walk that recomputes q and, per gated pair, w (ex2), dw, dq,
// the five moments and four dcm sums (~26 slots). K2 is the second walk
// alone. Only the gated pairs need this: the pairs of a window that fail
// the gate (88% on the 10k fit's stream, 95% at 40k) need no work beyond
// a cull per slot. Device bytes are a few MB: the rows, the stream, one or
// two [C, H, W] images and the [I, 16] gradient rows.
//
// K2's design: one block per tile, 256 threads, each owning 4 pixels of
// one column; warp w owns the contiguous rows 4w..4w+3 (TileGeom, shared
// with K1). The chunk of 64 instances is staged in shared memory as in K1
// (one broadcast read per instance), and every thread evaluates every
// pair of the window. Per instance each warp with a gated pixel
// (__any_sync) sums its nine partials by shuffles in a fixed tree; lane 0
// parks them in shared memory; after the chunk, thread k adds the 8
// warps' partials of instance k in warp order and writes its row.
//
// K3's design. A window of the fit's stream is shallow (67 slots on the
// mean tile at 10k points, at most 3 chunks; 177 and 7 at 40k), so one
// block of 256 threads per tile, and the time went to the all-pairs walk
// (8-21x more pairs than pass the gate) and to the nine 5-level shuffle
// trees per slot and warp. Here:
// - Each thread owns 4 pixels, one in each 8 x 4 patch of its warp's
//   16 x 8 block: warp w the block at (16 (w % 2), 8 (w / 2)), pixel j in
//   patch (j % 2, j / 2) of it, lane l at (l % 8, l / 8) of the patch.
//   The cull tests patches (fewest pairs) and the reduction runs per
//   warp (fewest visits); on the H100, 2 pixels a thread ran as fast and 1
//   (1024 threads, a warp per patch) slower (PERF.md §6).
// - Staging a chunk computes each slot's cull rectangle for q <= q_cut
//   (slot_cull) and from it a mask of the tile's 32 patches (bit 4w + j).
//   Each warp ballots the slots whose mask meets its 4 patches and walks
//   only those, in stream order, and per slot only its patches in the
//   mask: warp-uniform branches, in both walks.
// - Threads 0-63 load the next chunk's rows into registers during the
//   walk; the backward walks the chunks last to first, so the chunk the
//   forward staged last is walked again without staging.
// - The backward sums a slot's eight live terms over the warp in one
//   reduce-scatter butterfly (warp_sum8: 9 shuffles, where eight trees
//   take 40; alpha's cotangent is 0 in K3, so its dcm term is 0 and is
//   not summed), then over the warps that met the slot in warp order.
// The image is K1's bit for bit: the cull skips only pairs that fail the
// gate, and each pixel adds its pairs in stream order. No atomics, in
// shared or global memory: the result is deterministic.

#include <cuda_runtime.h>

#include "rasterize_sum_common.cuh"

namespace {

using namespace gsum;

constexpr int kMoments = 9;  // cx, cy, sum dq dx^2, dq dx dy, dq dy^2, dcm0..3

struct BwdShared {
  Chunk s;
  float part[kWarps][kMoments][kBK];  // per-warp partial sums per instance
};

// Sum over the warp in a fixed tree; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The backward walk over the tile's window with the cotangent G in
// registers; writes one gradient row per slot of the window (flat) or one
// gradient block per chunk (aligned).
template <bool kBlocks>
__device__ __forceinline__ void tile_backward(BwdShared& sh, const Stream& st,
                                              const TileGeom& tg,
                                              const float (&G)[kRowsPerThread][kC],
                                              float q_cut, float* __restrict__ dgfeat) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = tg.start; base < tg.end; base += kBK) {
    const int n = min(kBK, tg.end - base);
    stage_chunk<kBlocks>(sh.s, st, base, n, tg.tx0, tg.ty0);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float dx = __fsub_rn(tg.X, sh.s.gx[k]);
      const float adxdx = __fmul_rn(__fmul_rn(sh.s.a[k], dx), dx);
      const float b2dx = __fmul_rn(sh.s.b2[k], dx);
      float m[kMoments];
#pragma unroll
      for (int v = 0; v < kMoments; ++v) m[v] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (!tg.inside[j]) continue;
        const float dy = __fsub_rn(tg.Y[j], sh.s.gy[k]);
        const float q = quad_form(adxdx, b2dx, sh.s.c[k], dy);
        if (q <= q_cut) {
          const float w = pair_weight(q);
          float dw = 0.0f;
#pragma unroll
          for (int ch = 0; ch < kC; ++ch) dw += sh.s.cm[ch][k] * G[j][ch];
          const float dq = -0.5f * w * dw;
          const float dqdx = dq * dx;
          const float dqdy = dq * dy;
          m[0] += dqdx;
          m[1] += dqdy;
          m[2] += dqdx * dx;
          m[3] += dqdx * dy;
          m[4] += dqdy * dy;
#pragma unroll
          for (int ch = 0; ch < kC; ++ch) m[5 + ch] += w * G[j][ch];
          any = true;
        }
      }
      // warp-uniform branch: a warp with no gated pixel keeps zeros
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int v = 0; v < kMoments; ++v) m[v] = warp_sum(m[v]);
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < kMoments; ++v) sh.part[warp][v][k] = m[v];
      }
    }
    __syncthreads();
    const int k = threadIdx.x;
    float row[kFW];  // the slot's gradient row; a dead lane's stays zero
#pragma unroll
    for (int f = 0; f < kFW; ++f) row[f] = 0.0f;
    if (k < n) {
      float r[kMoments];
#pragma unroll
      for (int v = 0; v < kMoments; ++v) {
        float acc = sh.part[0][v][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += sh.part[w][v][k];
        r[v] = acc;
      }
      const float a = sh.s.a[k];
      const float b = 0.5f * sh.s.b2[k];  // exact: b2 = 2b
      const float c = sh.s.c[k];
      const float cx = r[0], cy = r[1];
      row[0] = -2.0f * a * cx - 2.0f * b * cy;
      row[1] = -2.0f * b * cx - 2.0f * c * cy;
      row[2] = r[2];
      row[3] = 2.0f * r[3];
#pragma unroll
      for (int v = 4; v < kMoments; ++v) row[v] = r[v];
    }
    if (kBlocks) {
      if (k < kBK) {
        float* out = dgfeat + static_cast<size_t>(base / kBK) * (kFW * kBK) + k;
#pragma unroll
        for (int f = 0; f < kFW; ++f) out[f * kBK] = row[f];
      }
    } else if (k < n) {
      float4* out = reinterpret_cast<float4*>(dgfeat + static_cast<size_t>(base + k) * kFW);
#pragma unroll
      for (int f = 0; f < kFW / 4; ++f)
        out[f] = make_float4(row[4 * f], row[4 * f + 1], row[4 * f + 2], row[4 * f + 3]);
    }
    __syncthreads();
  }
}

template <bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_sum_bwd_kernel(Stream st, const float* __restrict__ g,
                         float* __restrict__ dgfeat, int H, int W,
                         int tiles_x, float q_cut) {
  __shared__ BwdShared sh;
  const TileGeom tg = tile_geom<kBlocks>(st, H, W, tiles_x);
  if (tg.start >= tg.end) return;
  const size_t plane = static_cast<size_t>(H) * W;
  float G[kRowsPerThread][kC];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
      G[j][ch] = tg.inside[j] ? g[ch * plane + tg.pix[j]] : 0.0f;
  tile_backward<kBlocks>(sh, st, tg, G, q_cut, dgfeat);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int kPatchW = 8;  // a patch: 8 columns x 4 rows, one pixel a lane
constexpr int kPatchH = 4;
constexpr int kTerms = 8;   // cx, cy, sum dq dx^2, dq dx dy, dq dy^2, dcm0..2

// A staged chunk: per-slot columns as in Chunk, and the slot's patch mask
// (bit 4w + j: patch j of warp w meets the slot's cull rectangle).
struct L2Chunk {
  float gx[kBK], gy[kBK], a[kBK], b2[kBK], c[kBK];
  float cm[kC][kBK];
  unsigned hit[kBK];
};

struct L2Shared {
  L2Chunk s;
  float part[kWarps][kTerms][kBK];  // per-warp sums per slot
  float sum[kTerms][kBK];           // the tile's sums per slot
  unsigned long long live[kWarps];  // slots with a part from the warp
  float red[kWarps];                // per-warp partial SSE
};

// The thread's pixels: j = jx + 2 jy at tile-local (X[jx], Y[jy]).
struct L2Pixels {
  int start, end;  // the tile's window of the stream
  float tx0, ty0;  // the tile's origin, pixels
  int x0, y0;      // the tile's origin, integer
  int warp, lane;
  float X[2], Y[2];
  bool inside[kRowsPerThread];
};

template <bool kBlocks>
__device__ __forceinline__ L2Pixels l2_pixels(const Stream& st, int H, int W, int tiles_x) {
  L2Pixels p;
  const int t = blockIdx.x;
  p.x0 = (t % tiles_x) * kTile;
  p.y0 = (t / tiles_x) * kTile;
  p.tx0 = static_cast<float>(p.x0);
  p.ty0 = static_cast<float>(p.y0);
  p.start = st.starts[t];
  p.end = kBlocks ? p.start + st.counts[t] : st.starts[t + 1];
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  int lx[2], ly[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lx[i] = 2 * kPatchW * (p.warp % 2) + kPatchW * i + p.lane % kPatchW;
    ly[i] = 2 * kPatchH * (p.warp / 2) + kPatchH * i + p.lane / kPatchW;
    p.X[i] = static_cast<float>(lx[i]);
    p.Y[i] = static_cast<float>(ly[i]);
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    p.inside[j] = p.x0 + lx[j & 1] < W && p.y0 + ly[j >> 1] < H;
  return p;
}

// Thread k < kBK stages slot k of the chunk (its row `v`, where k < n)
// with its patch mask; slots n..kBK-1 meet no patch. The caller
// synchronises before the chunk is read.
__device__ __forceinline__ void stage_l2(L2Chunk& s, const SlotRow& v, int n, float tx0,
                                         float ty0, float q_cut) {
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
    for (int ch = 0; ch < kC; ++ch) s.cm[ch][k] = v.f[ch];
    const SlotCull cl = slot_cull(gx, gy, v.a, v.b, v.c, q_cut, kTile);
    if (cl.x0 <= cl.x1 && cl.y0 <= cl.y1) {
      // the patch columns (0..3) and rows (0..7) the rectangle meets
      const unsigned cols = (2u << (cl.x1 / kPatchW)) - (1u << (cl.x0 / kPatchW));
      const unsigned rows = (2u << (cl.y1 / kPatchH)) - (1u << (cl.y0 / kPatchH));
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned cb = (cols >> (2 * (w % 2))) & 3u;
        const unsigned rb = (rows >> (2 * (w / 2))) & 3u;
        hit |= (((rb & 1u) ? cb : 0u) | ((rb & 2u) ? cb << 2 : 0u)) << (4 * w);
      }
    }
  }
  s.hit[k] = hit;
}

// The warp's slots of the staged chunk: bit k set where slot k's mask
// meets one of the warp's patches.
__device__ __forceinline__ unsigned long long l2_slots(const L2Chunk& s, int warp,
                                                       int lane) {
  const unsigned lo = __ballot_sync(0xffffffffu, (s.hit[lane] >> (4 * warp)) & 0xFu);
  const unsigned hi = __ballot_sync(0xffffffffu, (s.hit[lane + 32] >> (4 * warp)) & 0xFu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The forward walk over a staged chunk: acc[j] += cm w on the warp's
// slots, in stream order (K1's sum, pair for pair).
__device__ __forceinline__ void l2_forward(const L2Chunk& s, const L2Pixels& p, float q_cut,
                                           float (&acc)[kRowsPerThread][kC]) {
  unsigned long long m = l2_slots(s, p.warp, p.lane);
  while (m) {
    const int k = __ffsll(static_cast<long long>(m)) - 1;
    m &= m - 1;
    const unsigned nib = (s.hit[k] >> (4 * p.warp)) & 0xFu;
    float adxdx[2], b2dx[2], dy[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float dx = __fsub_rn(p.X[i], s.gx[k]);
      adxdx[i] = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
      b2dx[i] = __fmul_rn(s.b2[k], dx);
      dy[i] = __fsub_rn(p.Y[i], s.gy[k]);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (!((nib >> j) & 1u)) continue;  // warp-uniform
      const float q = quad_form(adxdx[j & 1], b2dx[j & 1], s.c[k], dy[j >> 1]);
      if (q <= q_cut) {
        const float w = pair_weight(q);
#pragma unroll
        for (int ch = 0; ch < kC; ++ch)
          acc[j][ch] = __fadd_rn(acc[j][ch], __fmul_rn(s.cm[ch][k], w));
      }
    }
  }
}

// The backward walk over a staged chunk, then its gradient rows: per
// slot the warp's eight terms (one butterfly), the tile's sums over the
// warps in warp order, and one row (flat) or the chunk's block (aligned)
// written by threads 0-63. G is the rgb cotangent; alpha's is 0.
template <bool kBlocks>
__device__ __forceinline__ void l2_backward(L2Shared& sh, const L2Pixels& p,
                                            const float (&G)[kRowsPerThread][3],
                                            float q_cut, int base, int n,
                                            float* __restrict__ dgfeat) {
  const L2Chunk& s = sh.s;
  unsigned long long m = l2_slots(s, p.warp, p.lane);
  unsigned long long live = 0;
  while (m) {
    const int k = __ffsll(static_cast<long long>(m)) - 1;
    m &= m - 1;
    const unsigned nib = (s.hit[k] >> (4 * p.warp)) & 0xFu;
    float dx[2], adxdx[2], b2dx[2], dy[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dx[i] = __fsub_rn(p.X[i], s.gx[k]);
      adxdx[i] = __fmul_rn(__fmul_rn(s.a[k], dx[i]), dx[i]);
      b2dx[i] = __fmul_rn(s.b2[k], dx[i]);
      dy[i] = __fsub_rn(p.Y[i], s.gy[k]);
    }
    float v[kTerms];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) v[t] = 0.0f;
    bool on = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (!((nib >> j) & 1u)) continue;  // warp-uniform
      if (!p.inside[j]) continue;
      const float q = quad_form(adxdx[j & 1], b2dx[j & 1], s.c[k], dy[j >> 1]);
      if (q <= q_cut) {
        const float w = pair_weight(q);
        // alpha's term cm3 * 0 keeps a non-finite opacity's NaN, as the
        // plain version's sum over the four channels does
        const float dw = s.cm[0][k] * G[j][0] + s.cm[1][k] * G[j][1]
                         + s.cm[2][k] * G[j][2] + s.cm[3][k] * 0.0f;
        const float dq = -0.5f * w * dw;
        const float dqdx = dq * dx[j & 1];
        const float dqdy = dq * dy[j >> 1];
        v[0] += dqdx;
        v[1] += dqdy;
        v[2] += dqdx * dx[j & 1];
        v[3] += dqdx * dy[j >> 1];
        v[4] += dqdy * dy[j >> 1];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) v[5 + ch] += w * G[j][ch];
        on = true;
      }
    }
    // warp-uniform: a slot with no gated pixel in the warp adds nothing
    if (__any_sync(0xffffffffu, on)) {
      int t;
      const float tot = warp_sum8(v, p.lane, t);
      if ((p.lane & 3) == 0) sh.part[p.warp][t][k] = tot;
      live |= 1ull << k;
    }
  }
  if (p.lane == 0) sh.live[p.warp] = live;
  __syncthreads();
  for (int i = threadIdx.x; i < kTerms * kBK; i += kThreads) {
    const int t = i / kBK, k = i % kBK;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if ((sh.live[w] >> k) & 1ull) a += sh.part[w][t][k];
    sh.sum[t][k] = a;
  }
  __syncthreads();
  // thread k writes slot k's row; it is also the thread that stages slot
  // k of the next chunk, so its reads of this chunk come first
  const int k = threadIdx.x;
  if (k >= kBK) return;
  float row[kFW];  // the slot's gradient row; a dead lane's stays zero
#pragma unroll
  for (int f = 0; f < kFW; ++f) row[f] = 0.0f;
  if (k < n) {
    const float a = s.a[k];
    const float b = 0.5f * s.b2[k];  // exact: b2 = 2b
    const float c = s.c[k];
    const float cx = sh.sum[0][k], cy = sh.sum[1][k];
    row[0] = -2.0f * a * cx - 2.0f * b * cy;
    row[1] = -2.0f * b * cx - 2.0f * c * cy;
    row[2] = sh.sum[2][k];
    row[3] = 2.0f * sh.sum[3][k];
#pragma unroll
    for (int t = 4; t < kTerms; ++t) row[t] = sh.sum[t][k];
    // row[8], alpha's dcm, is 0
  }
  if (kBlocks) {
    float* out = dgfeat + static_cast<size_t>(base / kBK) * (kFW * kBK) + k;
#pragma unroll
    for (int f = 0; f < kFW; ++f) out[f * kBK] = row[f];
  } else if (k < n) {
    float4* out = reinterpret_cast<float4*>(dgfeat + static_cast<size_t>(base + k) * kFW);
#pragma unroll
    for (int f = 0; f < kFW / 4; ++f)
      out[f] = make_float4(row[4 * f], row[4 * f + 1], row[4 * f + 2], row[4 * f + 3]);
  }
}

template <bool kBlocks>
__global__ void __launch_bounds__(kThreads, 3)
rasterize_sum_l2_kernel(Stream st, const float* __restrict__ gt,
                        float* __restrict__ sse, float* __restrict__ dgfeat,
                        int H, int W, int tiles_x, float q_cut, float gscale,
                        int clamp) {
  __shared__ L2Shared sh;
  const L2Pixels p = l2_pixels<kBlocks>(st, H, W, tiles_x);
  const int len = p.end - p.start;
  const int nch = len > 0 ? (len + kBK - 1) / kBK : 0;
  const int k_own = threadIdx.x;  // the slot this thread loads and stages
  SlotRow row;                    // its row in the next chunk to stage

  // forward: K1's sums, chunk by chunk in stream order
  float acc[kRowsPerThread][kC];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) acc[j][ch] = 0.0f;
  if (k_own < min(kBK, len)) row = load_slot<kBlocks>(st, p.start, k_own);
  prefetch_ids<kBlocks>(st, p.start + kBK, len - kBK);
  for (int ci = 0; ci < nch; ++ci) {
    const int base = p.start + ci * kBK;
    stage_l2(sh.s, row, min(kBK, p.end - base), p.tx0, p.ty0, q_cut);
    __syncthreads();
    // the next chunk's rows (or, after the last, the backward's first
    // chunk to stage) and the ids of the one after load during the walk
    if (ci + 1 < nch) {
      if (k_own < min(kBK, p.end - base - kBK)) row = load_slot<kBlocks>(st, base + kBK, k_own);
      prefetch_ids<kBlocks>(st, base + 2 * kBK, p.end - base - 2 * kBK);
    } else if (nch > 1 && k_own < kBK) {
      row = load_slot<kBlocks>(st, base - kBK, k_own);
    }
    l2_forward(sh.s, p, q_cut, acc);
    if (ci + 1 < nch) __syncthreads();  // every warp is done with the chunk
  }

  // clip, masked L2 and its cotangent, per pixel; the tile's SSE
  const size_t plane = static_cast<size_t>(H) * W;
  float G[kRowsPerThread][3];
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const size_t pix = p.inside[j]
        ? static_cast<size_t>(p.y0 + static_cast<int>(p.Y[j >> 1])) * W + p.x0
              + static_cast<int>(p.X[j & 1])
        : 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float img = acc[j][ch];
      const float imgc = clamp ? fminf(fmaxf(img, 0.0f), 1.0f) : img;
      const bool live = !clamp || (img > 0.0f && img < 1.0f);
      const float diff = p.inside[j] ? __fsub_rn(imgc, gt[ch * plane + pix]) : 0.0f;
      e = __fadd_rn(e, __fmul_rn(diff, diff));
      G[j][ch] = __fmul_rn(gscale, live ? diff : 0.0f);
    }
  }
  e = warp_sum(e);
  if (p.lane == 0) sh.red[p.warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = sh.red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += sh.red[w];
    sse[blockIdx.x] = total;
  }

  // backward: the chunks last to first; the last is still staged
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int base = p.start + ci * kBK;
    if (ci < nch - 1) {
      stage_l2(sh.s, row, kBK, p.tx0, p.ty0, q_cut);  // only the last chunk is partial
      __syncthreads();
      if (ci > 0 && k_own < kBK) row = load_slot<kBlocks>(st, base - kBK, k_own);
      if (ci > 1) prefetch_ids<kBlocks>(st, base - 2 * kBK, kBK);
    }
    l2_backward<kBlocks>(sh, p, G, q_cut, base, min(kBK, p.end - base), dgfeat);
  }
}

int check_args(int n_tiles, int n_rows) {
  return (n_tiles <= 0 || n_rows <= 0) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// K2. feat [n_rows, 16] f32, gids [I] i32, starts [>= tiles_x*tiles_y + 1]
// i32, g [4, H, W] f32 cotangent, dgfeat [I, 16] f32 (rows of slots past
// the last window are left as they are); all device pointers. Launches on
// `stream` and returns the launch's cudaError_t (0 = success); it does not
// synchronise.
extern "C" int rasterize_sum_bwd(const float* feat, int n_rows,
                                 const int* gids, const int* starts,
                                 const float* g, float* dgfeat, int H, int W,
                                 int tiles_x, int tiles_y, float q_cut,
                                 cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (int rc = check_args(n_tiles, n_rows)) return rc;
  const Stream st{feat, n_rows, gids, nullptr, starts, nullptr};
  rasterize_sum_bwd_kernel<false><<<n_tiles, kThreads, 0, stream>>>(st, g, dgfeat, H, W,
                                                                    tiles_x, q_cut);
  return static_cast<int>(cudaGetLastError());
}

// K3. As K2, with gt [3, H, W] f32 in place of the cotangent, and
// sse [tiles_x * tiles_y] f32 the per-tile sum of squared errors.
// gscale = 2 / (3 H W); clamp != 0 clips the render to [0, 1].
extern "C" int rasterize_sum_l2(const float* feat, int n_rows,
                                const int* gids, const int* starts,
                                const float* gt, float* sse, float* dgfeat,
                                int H, int W, int tiles_x, int tiles_y,
                                float q_cut, float gscale, int clamp,
                                cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (int rc = check_args(n_tiles, n_rows)) return rc;
  const Stream st{feat, n_rows, gids, nullptr, starts, nullptr};
  rasterize_sum_l2_kernel<false><<<n_tiles, kThreads, 0, stream>>>(
      st, gt, sse, dgfeat, H, W, tiles_x, q_cut, gscale, clamp);
  return static_cast<int>(cudaGetLastError());
}

// K2 on the aligned stream: blocks [NB, 16, 64] f32 (K11a's), starts
// [>= tiles_x*tiles_y + 1] i32 (multiples of 64), counts
// [>= tiles_x*tiles_y] i32, g [4, H, W] f32, dgb [NB, 16, 64] f32 (each
// chunk of a window written whole, dead lanes zero; blocks past the last
// window are left as they are). As rasterize_sum_bwd otherwise.
extern "C" int rasterize_sum_bwd_aligned(const float* blocks, const int* starts,
                                         const int* counts, const float* g, float* dgb,
                                         int H, int W, int tiles_x, int tiles_y,
                                         float q_cut, cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Stream st{nullptr, 0, nullptr, blocks, starts, counts};
  rasterize_sum_bwd_kernel<true><<<n_tiles, kThreads, 0, stream>>>(st, g, dgb, H, W,
                                                                   tiles_x, q_cut);
  return static_cast<int>(cudaGetLastError());
}

// K3 on the aligned stream: as rasterize_sum_bwd_aligned, with gt [3, H, W]
// f32 in place of the cotangent and sse as in rasterize_sum_l2.
extern "C" int rasterize_sum_l2_aligned(const float* blocks, const int* starts,
                                        const int* counts, const float* gt, float* sse,
                                        float* dgb, int H, int W, int tiles_x, int tiles_y,
                                        float q_cut, float gscale, int clamp,
                                        cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Stream st{nullptr, 0, nullptr, blocks, starts, counts};
  rasterize_sum_l2_kernel<true><<<n_tiles, kThreads, 0, stream>>>(
      st, gt, sse, dgb, H, W, tiles_x, q_cut, gscale, clamp);
  return static_cast<int>(cudaGetLastError());
}
