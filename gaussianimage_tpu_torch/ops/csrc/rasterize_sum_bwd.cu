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
// Function. Per tile t of TILE x TILE pixels (TILE = 32, or 16, the
// sharded fit's default), over its window [starts[t], starts[t+1]) of
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
// Design, K2 and K3 alike. A window of the fit's stream is shallow (67
// slots on the mean tile at 10k points, at most 3 chunks; 177 and 7 at
// 40k), so one CTA per tile (256 threads at 32 pixels, 64 at 16:
// Geo<TILE>), on the layout, staging and cull of rasterize_sum_common.cuh
// (shared with K1). A walk of every pair
// spends most of its time on pairs that fail the gate (8-21x more than
// pass) and, per (slot, warp), on one 5-level shuffle tree per term.
// Here:
// - Each thread owns 4 pixels, one in each 8 x 4 patch of its warp's
//   16 x 8 block. The cull tests patches (fewest pairs) and the reduction
//   runs per warp (fewest visits); on the H100, 2 pixels a thread ran as
//   fast and 1 (1024 threads, a warp per patch) slower (PERF.md §6).
// - Staging a chunk computes each slot's cull rectangle for q <= q_cut
//   (slot_cull) as a mask of the tile's 32 patches; each warp walks only
//   the slots whose mask meets its patches, in stream order, and per slot
//   only its patches in the mask: warp-uniform branches.
// - Threads 0-63 load the next chunk's rows into registers during the
//   walk. K2 walks the chunks in stream order; K3 walks them forward, then
//   backward from the last (still staged) to the first.
// - The backward sums a slot's terms over the warp without atomics, in a
//   fixed order: the first eight (cx, cy, the three moments, dcm0..2) in
//   one reduce-scatter butterfly (warp_sum8: 9 shuffles, where eight trees
//   take 40), and K2's ninth, alpha's dcm3, in one 5-shuffle tree (K3's
//   alpha cotangent is 0, so its dcm3 is 0 and is not summed); then the
//   warps that met the slot, in warp order.
// K3's image is K1's bit for bit: the cull skips only pairs that fail the
// gate, and each pixel adds its pairs in stream order. No atomics, in
// shared or global memory: the results are deterministic.

#include <cuda_runtime.h>

#include "rasterize_sum_common.cuh"

namespace {

using namespace gsum;

// Sum over the warp in a fixed tree; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The backward walk's shared memory for kTerms terms a slot: the staged
// chunk, the per-warp sums per slot, the tile's sums per slot and the
// slots each warp has a part of.
template <int TILE, int kTerms>
struct BackShared {
  Slots s;
  float part[Geo<TILE>::kWarps][kTerms][kBK];
  float sum[kTerms][kBK];
  unsigned long long live[Geo<TILE>::kWarps];
};

// The backward walk over a staged chunk, then its gradient rows: per slot
// the warp's terms (cx, cy, sum dq dx^2, dq dx dy, dq dy^2, dcm0..dcm[kCG-1];
// one butterfly for the first eight, one tree for K2's dcm3), the tile's
// sums over the warps in warp order, and one row (flat) or the chunk's
// block (aligned) written by threads 0-63. G is the cotangent of the
// thread's pixels: kCG = 4 channels (K2), or rgb only (kCG = 3, K3, whose
// alpha cotangent is 0).
template <int TILE, bool kBlocks, int kCG>
__device__ __forceinline__ void backward_slots(BackShared<TILE, 5 + kCG>& sh, const Pixels& p,
                                               const float (&G)[kPixels][kCG], float q_cut,
                                               int base, int n, float* __restrict__ dgfeat) {
  using L = Geo<TILE>;
  constexpr int kTerms = 5 + kCG;
  static_assert(kTerms == 8 || kTerms == 9, "rgb or rgb + alpha cotangent");
  const Slots& s = sh.s;
  unsigned long long m = warp_slots(s, p.warp, p.lane);
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
    for (int j = 0; j < kPixels; ++j) {
      if (!((nib >> j) & 1u)) continue;  // warp-uniform
      if (!p.inside[j]) continue;
      const float q = quad_form(adxdx[j & 1], b2dx[j & 1], s.c[k], dy[j >> 1]);
      if (q <= q_cut) {
        const float w = pair_weight(q);
        // with no alpha cotangent, alpha's term cm3 * 0 keeps a non-finite
        // opacity's NaN, as the plain version's sum over the four channels
        // does
        const float g3 = kCG == 4 ? G[j][kCG - 1] : 0.0f;
        const float dw = s.cm[0][k] * G[j][0] + s.cm[1][k] * G[j][1]
                         + s.cm[2][k] * G[j][2] + s.cm[3][k] * g3;
        const float dq = -0.5f * w * dw;
        const float dqdx = dq * dx[j & 1];
        const float dqdy = dq * dy[j >> 1];
        v[0] += dqdx;
        v[1] += dqdy;
        v[2] += dqdx * dx[j & 1];
        v[3] += dqdx * dy[j >> 1];
        v[4] += dqdy * dy[j >> 1];
#pragma unroll
        for (int ch = 0; ch < kCG; ++ch) v[5 + ch] += w * G[j][ch];
        on = true;
      }
    }
    // warp-uniform: a slot with no gated pixel in the warp adds nothing
    if (__any_sync(0xffffffffu, on)) {
      int t;
      const float tot = warp_sum8(v, p.lane, t);
      if ((p.lane & 3) == 0) sh.part[p.warp][t][k] = tot;
      if constexpr (kTerms > 8) {
        const float t8 = warp_sum(v[8]);
        if (p.lane == 0) sh.part[p.warp][8][k] = t8;
      }
      live |= 1ull << k;
    }
  }
  if (p.lane == 0) sh.live[p.warp] = live;
  __syncthreads();
  for (int i = threadIdx.x; i < kTerms * kBK; i += L::kThreads) {
    const int t = i / kBK, k = i % kBK;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < L::kWarps; ++w)
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
    // K3: row[8], alpha's dcm, is 0
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

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(Geo<TILE>::kThreads, Geo<TILE>::kMinBlocks)
rasterize_sum_bwd_kernel(Stream st, const float* __restrict__ g,
                         float* __restrict__ dgfeat, int H, int W,
                         int tiles_x, float q_cut) {
  __shared__ BackShared<TILE, 5 + kC> sh;
  const Pixels p = pixels_of<TILE, kBlocks>(st, H, W, tiles_x);
  const int len = p.end - p.start;
  if (len <= 0) return;
  const int nch = (len + kBK - 1) / kBK;
  const int k_own = threadIdx.x;  // the slot this thread loads and stages
  SlotRow row;                    // its row in the next chunk to stage
  if (k_own < min(kBK, len)) row = load_slot<kBlocks>(st, p.start, k_own);
  prefetch_ids<kBlocks>(st, p.start + kBK, len - kBK);
  // the cotangent of the thread's pixels, all four channels
  const size_t plane = static_cast<size_t>(H) * W;
  float G[kPixels][kC];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const size_t pix = pixel_index(p, j, W);
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) G[j][ch] = p.inside[j] ? g[ch * plane + pix] : 0.0f;
  }
  // the chunks in stream order; the next chunk's rows load during the walk
  for (int ci = 0; ci < nch; ++ci) {
    const int base = p.start + ci * kBK;
    const int n = min(kBK, p.end - base);
    stage_slots<TILE>(sh.s, row, n, p.tx0, p.ty0, q_cut);
    __syncthreads();
    if (ci + 1 < nch) {
      if (k_own < min(kBK, p.end - base - kBK)) row = load_slot<kBlocks>(st, base + kBK, k_own);
      prefetch_ids<kBlocks>(st, base + 2 * kBK, p.end - base - 2 * kBK);
    }
    backward_slots<TILE, kBlocks, kC>(sh, p, G, q_cut, base, n, dgfeat);
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(Geo<TILE>::kThreads, Geo<TILE>::kMinBlocks)
rasterize_sum_l2_kernel(Stream st, const float* __restrict__ gt,
                        float* __restrict__ sse, float* __restrict__ dgfeat,
                        int H, int W, int tiles_x, float q_cut, float gscale,
                        int clamp) {
  using L = Geo<TILE>;
  __shared__ BackShared<TILE, 5 + 3> sh;
  __shared__ float red[L::kWarps];  // per-warp partial SSE
  const Pixels p = pixels_of<TILE, kBlocks>(st, H, W, tiles_x);
  const int len = p.end - p.start;
  const int nch = len > 0 ? (len + kBK - 1) / kBK : 0;
  const int k_own = threadIdx.x;  // the slot this thread loads and stages
  SlotRow row;                    // its row in the next chunk to stage

  // forward: K1's sums, chunk by chunk in stream order; then `row` holds
  // the backward's first chunk to stage
  float acc[kPixels][kC];
  walk_forward<TILE, kBlocks, true>(sh.s, st, p, q_cut, acc, row);

  // clip, masked L2 and its cotangent, per pixel; the tile's SSE
  const size_t plane = static_cast<size_t>(H) * W;
  float G[kPixels][3];
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const size_t pix = pixel_index(p, j, W);
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
  if (p.lane == 0) red[p.warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = red[0];
#pragma unroll
    for (int w = 1; w < L::kWarps; ++w) total += red[w];
    sse[blockIdx.x] = total;
  }

  // backward: the chunks last to first; the last is still staged
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int base = p.start + ci * kBK;
    if (ci < nch - 1) {
      stage_slots<TILE>(sh.s, row, kBK, p.tx0, p.ty0, q_cut);  // only the last chunk is partial
      __syncthreads();
      if (ci > 0 && k_own < kBK) row = load_slot<kBlocks>(st, base - kBK, k_own);
      if (ci > 1) prefetch_ids<kBlocks>(st, base - 2 * kBK, kBK);
    }
    backward_slots<TILE, kBlocks, 3>(sh, p, G, q_cut, base, min(kBK, p.end - base), dgfeat);
  }
}

// The launches at tile_px 32 or 16 (anything else: cudaErrorInvalidValue).
template <bool kBlocks>
int launch_bwd(const Stream& st, const float* g, float* dgfeat, int H, int W, int tiles_x,
               int tiles_y, int tile_px, float q_cut, cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32)
    rasterize_sum_bwd_kernel<32, kBlocks><<<n_tiles, Geo<32>::kThreads, 0, stream>>>(
        st, g, dgfeat, H, W, tiles_x, q_cut);
  else if (tile_px == 16)
    rasterize_sum_bwd_kernel<16, kBlocks><<<n_tiles, Geo<16>::kThreads, 0, stream>>>(
        st, g, dgfeat, H, W, tiles_x, q_cut);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlocks>
int launch_l2(const Stream& st, const float* gt, float* sse, float* dgfeat, int H, int W,
              int tiles_x, int tiles_y, int tile_px, float q_cut, float gscale, int clamp,
              cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32)
    rasterize_sum_l2_kernel<32, kBlocks><<<n_tiles, Geo<32>::kThreads, 0, stream>>>(
        st, gt, sse, dgfeat, H, W, tiles_x, q_cut, gscale, clamp);
  else if (tile_px == 16)
    rasterize_sum_l2_kernel<16, kBlocks><<<n_tiles, Geo<16>::kThreads, 0, stream>>>(
        st, gt, sse, dgfeat, H, W, tiles_x, q_cut, gscale, clamp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. feat [n_rows, 16] f32, gids [I] i32, starts [>= tiles_x*tiles_y + 1]
// i32, g [4, H, W] f32 cotangent, dgfeat [I, 16] f32 (rows of slots past
// the last window are left as they are); all device pointers; tile_px 32
// or 16. Launches on `stream` and returns the launch's cudaError_t (0 =
// success); it does not synchronise.
extern "C" int rasterize_sum_bwd(const float* feat, int n_rows,
                                 const int* gids, const int* starts,
                                 const float* g, float* dgfeat, int H, int W,
                                 int tiles_x, int tiles_y, int tile_px, float q_cut,
                                 cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<false>(Stream{feat, n_rows, gids, nullptr, starts, nullptr}, g, dgfeat,
                           H, W, tiles_x, tiles_y, tile_px, q_cut, stream);
}

// K3. As K2, with gt [3, H, W] f32 in place of the cotangent, and
// sse [tiles_x * tiles_y] f32 the per-tile sum of squared errors.
// gscale = 2 / (3 H W); clamp != 0 clips the render to [0, 1].
extern "C" int rasterize_sum_l2(const float* feat, int n_rows,
                                const int* gids, const int* starts,
                                const float* gt, float* sse, float* dgfeat,
                                int H, int W, int tiles_x, int tiles_y, int tile_px,
                                float q_cut, float gscale, int clamp,
                                cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_l2<false>(Stream{feat, n_rows, gids, nullptr, starts, nullptr}, gt, sse,
                          dgfeat, H, W, tiles_x, tiles_y, tile_px, q_cut, gscale, clamp,
                          stream);
}

// K2 on the aligned stream: blocks [NB, 16, 64] f32 (K11a's), starts
// [>= tiles_x*tiles_y + 1] i32 (multiples of 64), counts
// [>= tiles_x*tiles_y] i32, g [4, H, W] f32, dgb [NB, 16, 64] f32 (each
// chunk of a window written whole, dead lanes zero; blocks past the last
// window are left as they are). As rasterize_sum_bwd otherwise.
extern "C" int rasterize_sum_bwd_aligned(const float* blocks, const int* starts,
                                         const int* counts, const float* g, float* dgb,
                                         int H, int W, int tiles_x, int tiles_y,
                                         int tile_px, float q_cut, cudaStream_t stream) {
  return launch_bwd<true>(Stream{nullptr, 0, nullptr, blocks, starts, counts}, g, dgb, H,
                          W, tiles_x, tiles_y, tile_px, q_cut, stream);
}

// K3 on the aligned stream: as rasterize_sum_bwd_aligned, with gt [3, H, W]
// f32 in place of the cotangent and sse as in rasterize_sum_l2.
extern "C" int rasterize_sum_l2_aligned(const float* blocks, const int* starts,
                                        const int* counts, const float* gt, float* sse,
                                        float* dgb, int H, int W, int tiles_x, int tiles_y,
                                        int tile_px, float q_cut, float gscale, int clamp,
                                        cudaStream_t stream) {
  return launch_l2<true>(Stream{nullptr, 0, nullptr, blocks, starts, counts}, gt, sse, dgb,
                         H, W, tiles_x, tiles_y, tile_px, q_cut, gscale, clamp, stream);
}
