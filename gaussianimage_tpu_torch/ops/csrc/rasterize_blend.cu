// K8 and K9: the depth-sorted alpha-blend rasterizer of the 3DGS baseline
// and its backward, for Hopper (sm_90a).
//
// K8 `rasterize_blend_fwd` replaces gaussianimage_tpu/ops/
// rasterize_blend.py::_blend_fwd_kernel; K9 `rasterize_blend_bwd` replaces
// ::_blend_bwd_kernel. Both fuse the stream gather of
// ops/stream_common.py::gather_stream, and read and write [C, H, W] images
// directly where the TPU kernels take tiled [T, 8, P] blocks. The
// `_aligned` entry points walk the aligned stream (kBlocks: K11a's
// [NB, 16, 64] blocks, windows [starts[t], starts[t] + counts[t])) and K9
// writes its gradients as [NB, 16, 64] blocks, the TPU kernels' `aligned`
// branch.
//
// Function. Per tile t (16 or 32 pixels a side), over its window
// [starts[t], starts[t+1]) of the stream, whose rows feat[gids[s]] =
// (x, y, a, b, c, r, g, b, o, pad..) are in depth order, in chunks of 64
// slots, with alpha = min(o w, clip) where raw = o w >= alpha_min, else 0,
// w = exp(-q/2) (rasterize_blend_common.cuh):
//   K8, per pixel and slot in order: acc += rgb * (alpha * exp(logT)),
//     logT += log1p(-alpha). After each chunk the tile stops when the max
//     of logT over all its pixels (those past H x W included) is <=
//     log_stop, or its window ends (the JAX kernel's per-tile, per-chunk
//     rule). Writes rgb, T_fin = exp(logT) and logT into planes 0-4 of
//     out [5, H, W], and the chunks consumed into nch_used[t].
//   K9, over exactly those chunks, back to front, and per chunk its slots
//     back to front, per pixel: suf += log1p(-alpha) (the suffix sum, this
//     slot included), T_k = exp(logT_fin - suf), vis = alpha T_k;
//     dalpha = (G.rgb) T_k - (S + G_T T_fin) / (1 - alpha) where
//     alpha_min <= raw <= clip (else 0), with S the suffix sum of
//     (G.rgb) vis over the later slots; then dop = dalpha w,
//     dq = -w (dalpha o) / 2 where q > 0, and per slot the sums over the
//     tile's pixels: dgx = -2a sum(dq dx) - 2b sum(dq dy), dgy likewise,
//     da = sum dq dx^2, db = 2 sum dq dx dy, dc = sum dq dy^2,
//     drgb = sum G vis, do = sum dalpha w. The transmittance is never
//     divided back to front (that underflows float32 near e^-87): it comes
//     from logT_fin less a suffix sum, as in the JAX kernel.
//
// A slot belongs to one tile's window, so K9's clusters write disjoint
// rows of dgfeat; rows of slots in no consumed chunk are left as they are
// (the caller zeroes them). On the aligned stream K9 writes each consumed
// chunk's whole gradient block, its dead lanes zero; each block belongs to
// one tile, so the stores are disjoint, and blocks of chunks past
// nch_used are left as they are.
//
// Bound on the H100: FP32 issue slots and MUFU, per (slot, pixel) pair of
// the consumed chunks: the quadratic form and its compare with the row's
// threshold q <= 2 log(o / alpha_min) (~9 slots) for every pair; for the
// pairs within it, exp and the alpha gate (~8 slots, 1 MUFU ex2), then
// log1p, exp(logT) and the three accumulations (~19 slots, 2 MUFU) in K8,
// or log1p, two exps, dalpha and the nine sums (~60 slots, 3 MUFU) in K9.
// Device bytes are a few MB: the rows, the stream, the [5, H, W] output
// and, in K9, the [4, H, W] cotangent and the [I, 16] rows. (The bound
// counts every pair of the consumed chunks, as the earlier design
// evaluated them; the cull below evaluates fewer.)
//
// Design. A 3DGS stream is deep in a few tiles (thousands of slots) and
// empty in many, so the time was one SM walking a deep tile. Here:
// - A 32-pixel tile is a thread-block cluster of 4 CTAs of 256 threads,
//   CTA r on rows 8r..8r+7; a 16-pixel tile is one CTA. One pixel per
//   thread, each warp an 8 x 4 patch (rasterize_blend_common.cuh's
//   Layout), so a deep tile spreads over 4 SMs and 32 warps.
// - Each CTA stages every chunk's 64 rows in its own shared memory, and
//   with each row its cull (blend_cull): q_cut and the pixel rectangle the
//   row can reach, tested against the CTA's 8 patches. Threads 0-63 load
//   the next chunk's rows into registers while the warps walk the current
//   one (and, on the flat stream, prefetch the ids of the chunk after), so
//   a chunk's staging waits on no global load. Each warp ballots
//   the slots whose rectangle meets its patch and walks only those set
//   bits, in ascending order (K8) or descending (K9); per pair it computes
//   q first and the exponential only where q <= q_cut.
// - K8's early stop: after each chunk each warp reduces its 32 logT to one
//   max by shuffles and publishes it in shared memory (two buffers, by
//   chunk parity); after a cluster barrier lane l of every warp reads the
//   max of warp l % 8 of CTA l / 8 through distributed shared memory, and
//   the warp takes the max over its lanes. The max is exact, so the 4
//   CTAs take the same decision; rank 0 writes nch_used.
// - K9 sums each slot's nine terms over the warp by shuffles in a fixed
//   order (only warps whose mask holds the slot and where a lane is on):
//   eight of them in one reduce-scatter butterfly (9 shuffles, where a
//   tree per term takes 40: with one pixel a thread the shuffles bounded
//   the walk) and the ninth in a tree; then over the CTA's warps in warp
//   order, then over the cluster's CTAs in rank order through distributed
//   shared memory: CTA r writes the rows of slots 16r..16r+15. No
//   atomics: the result is deterministic.
// - Every CTA of a cluster takes the same branches around its barriers
//   (the window, the chunk count and the early-stop max are the same for
//   all four), and a last barrier keeps each CTA's shared memory alive
//   until the others have read it.
//
// Arithmetic: K8 rounds op by op (__fmul_rn, __fadd_rn) with full-precision
// expf and log1pf, as torch computes its plain version on the card, so the
// two agree bit for bit and take the same early-stop decisions. The cull
// skips only pairs whose alpha is 0 (see rasterize_blend_common.cuh), and
// each pixel's operations run in the same order, so K8's output does not
// depend on the cull or on the pixel map. K9 is held to its plain version
// to a tolerance (its per-slot sums are reduced in another order).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rasterize_blend_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gblend;
using gsum::load_slot;
using gsum::prefetch_ids;
using gsum::warp_sum8;

constexpr int kTerms = 9;  // sum dq dx, dq dy, dq dx^2, dq dx dy, dq dy^2, G vis x3, dalpha w

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the warp in a fixed butterfly; every lane holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A barrier over the tile's CTAs: the cluster's, or the block's when the
// tile is one CTA. It orders shared-memory writes before it against reads
// after it, within the CTA and, in a cluster, across its CTAs.
template <int kCluster>
__device__ __forceinline__ void tile_sync() {
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// CTA `r`'s copy of the shared variable `v` (this CTA's own when the tile
// is one CTA).
template <int kCluster, typename T>
__device__ __forceinline__ T* rank_ptr(T* v, int r) {
  if constexpr (kCluster > 1) {
    return cg::this_cluster().map_shared_rank(v, r);
  } else {
    return v;
  }
}

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_blend_fwd_kernel(Stream st, float* __restrict__ out, int* __restrict__ nch_used,
                           int H, int W, int tiles_x, float alpha_clip, float alpha_min,
                           float log_stop) {
  constexpr int kCluster = Layout<TILE>::kCluster;
  __shared__ Chunk s;
  __shared__ float wmax[2][kWarps];  // each warp's max of logT, by chunk parity
  const Pixel px = pixel_of<TILE, kBlocks>(st, H, W, tiles_x);
  float logT = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
  const int nch = (px.end - px.start + kBK - 1) / kBK;
  const int k_own = threadIdx.x;  // the slot this thread loads and stages
  SlotRow row;                    // its row in the next chunk to stage
  if (k_own < min(kBK, px.end - px.start)) row = load_slot<kBlocks>(st, px.start, k_own);
  prefetch_ids<kBlocks>(st, px.start + kBK, px.end - px.start - kBK);
  float tile_max = 0.0f;  // max of logT over the tile, before the first chunk
  int ci = 0;
  for (; ci < nch && tile_max > log_stop; ++ci) {
    const int base = px.start + ci * kBK;
    const int n = min(kBK, px.end - base);
    stage_slot<TILE>(s, row, n, px.tx0, px.ty0, px.rank, alpha_min);
    __syncthreads();
    // the next chunk's rows and the ids of the one after load during the walk
    if (k_own < min(kBK, px.end - base - kBK))
      row = load_slot<kBlocks>(st, base + kBK, k_own);
    prefetch_ids<kBlocks>(st, base + 2 * kBK, px.end - base - 2 * kBK);
    unsigned long long m = warp_slots(s, px.warp, px.lane);
    while (m) {
      const int k = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      const PairAlpha p = pair_alpha(s, k, __fsub_rn(px.X, s.gx[k]),
                                     __fsub_rn(px.Y, s.gy[k]), alpha_clip, alpha_min);
      if (p.on) {
        const float vis = __fmul_rn(p.alpha, expf(logT));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          acc[ch] = __fadd_rn(acc[ch], __fmul_rn(s.col[ch][k], vis));
        logT = __fadd_rn(logT, log1pf(-p.alpha));
      }
    }
    const float m_w = warp_max(logT);
    if (px.lane == 0) wmax[ci & 1][px.warp] = m_w;
    tile_sync<kCluster>();  // also: every warp is done with the staged chunk
    // lane l reads warp l % 8 of CTA l / 8 (the tile has kCluster x 8
    // warps), then the max over the lanes: exact, the same in every thread
    const int l = px.lane % (kCluster * kWarps);
    tile_max = warp_max(*rank_ptr<kCluster>(&wmax[ci & 1][l % kWarps], l / kWarps));
  }

  if (px.inside) {
    const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch * plane + px.pix] = acc[ch];
    out[3 * plane + px.pix] = expf(logT);
    out[4 * plane + px.pix] = logT;
  }
  if (px.rank == 0 && threadIdx.x == 0) nch_used[px.tile] = ci;
  if constexpr (kCluster > 1) tile_sync<kCluster>();  // the others read wmax
}

struct BwdShared {
  Chunk s;
  float part[kWarps][kTerms][kBK];     // per-warp sums per slot
  unsigned long long live[kWarps];     // slots with a part from the warp
  float cta[2][kTerms][kBK];           // this CTA's sums per slot, by chunk parity
};

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_blend_bwd_kernel(Stream st, const float* __restrict__ logt,
                           const int* __restrict__ nch_used, const float* __restrict__ g,
                           float* __restrict__ dgfeat, int H, int W, int tiles_x,
                           float alpha_clip, float alpha_min) {
  constexpr int kCluster = Layout<TILE>::kCluster;
  constexpr int kSlotsPerRank = kBK / kCluster;  // rows each CTA writes
  __shared__ BwdShared sh;
  const Pixel px = pixel_of<TILE, kBlocks>(st, H, W, tiles_x);
  const int nch = nch_used[px.tile];  // the same in every CTA of the tile
  if (nch <= 0) return;
  const size_t plane = static_cast<size_t>(H) * W;

  // the pixel's cotangent, log T_fin and T_fin; the running suffix sums
  float G[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) G[ch] = px.inside ? g[ch * plane + px.pix] : 0.0f;
  const float lTf = px.inside ? logt[px.pix] : 0.0f;
  const float Tf = expf(lTf);
  float suf = 0.0f, S = 0.0f;

  const int k_own = threadIdx.x;  // the slot this thread loads and stages
  SlotRow row;                    // its row in the next chunk to stage
  {
    const int last = px.start + (nch - 1) * kBK;
    if (k_own < min(kBK, px.end - last)) row = load_slot<kBlocks>(st, last, k_own);
    if (nch > 1) prefetch_ids<kBlocks>(st, last - kBK, kBK);
  }
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int base = px.start + ci * kBK;
    const int n = min(kBK, px.end - base);
    const int par = ci & 1;
    stage_slot<TILE>(sh.s, row, n, px.tx0, px.ty0, px.rank, alpha_min);
    __syncthreads();
    // the previous chunk's rows (whole: only the last chunk is partial) and
    // the ids of the one before load during the walk
    if (ci > 0 && k_own < kBK) row = load_slot<kBlocks>(st, base - kBK, k_own);
    if (ci > 1) prefetch_ids<kBlocks>(st, base - 2 * kBK, kBK);
    const Chunk& s = sh.s;
    unsigned long long m = warp_slots(s, px.warp, px.lane);
    unsigned long long live = 0;
    while (m) {
      const int k = 63 - __clzll(static_cast<long long>(m));
      m &= ~(1ull << k);
      const float dx = __fsub_rn(px.X, s.gx[k]);
      const float dy = __fsub_rn(px.Y, s.gy[k]);
      float v[kTerms];
#pragma unroll
      for (int t = 0; t < kTerms; ++t) v[t] = 0.0f;
      bool on = false;
      if (px.inside) {
        const PairAlpha p = pair_alpha(s, k, dx, dy, alpha_clip, alpha_min);
        if (p.on) {
          on = true;
          const float l1m = log1pf(-p.alpha);
          suf += l1m;
          const float T_k = expf(lTf - suf);
          const float vis = p.alpha * T_k;
          const float gdotc = s.col[0][k] * G[0] + s.col[1][k] * G[1] + s.col[2][k] * G[2];
          const float dalpha = p.raw <= alpha_clip
              ? gdotc * T_k - (S + G[3] * Tf) * expf(-l1m)
              : 0.0f;
          S += gdotc * vis;
          const float dw = dalpha * s.op[k];
          const float dq = p.q > 0.0f ? -0.5f * p.w * dw : 0.0f;
          const float dqdx = dq * dx;
          const float dqdy = dq * dy;
          v[0] = dqdx;
          v[1] = dqdy;
          v[2] = dqdx * dx;
          v[3] = dqdx * dy;
          v[4] = dqdy * dy;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) v[5 + ch] = G[ch] * vis;
          v[8] = dalpha * p.w;
        }
      }
      // warp-uniform: a slot with no live pair in the warp adds nothing
      if (__any_sync(0xffffffffu, on)) {
        int t;
        const float v8 = warp_sum8(v, px.lane, t);
        const float dw = warp_sum(v[8]);
        if ((px.lane & 3) == 0) sh.part[px.warp][t][k] = v8;
        if (px.lane == 0) sh.part[px.warp][8][k] = dw;
        live |= 1ull << k;
      }
    }
    if (px.lane == 0) sh.live[px.warp] = live;
    __syncthreads();
    // the CTA's sums per slot, over its warps in warp order
    {
      const int k = threadIdx.x % kBK;
      for (int t = threadIdx.x / kBK; t < kTerms; t += kThreads / kBK) {
        float a = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if ((sh.live[w] >> k) & 1ull) a += sh.part[w][t][k];
        sh.cta[par][t][k] = a;
      }
    }
    // CTA r writes the rows of slots r * kSlotsPerRank ...; read the
    // slot's conic now, before the barrier lets the next chunk be staged
    const int kr = px.rank * kSlotsPerRank + threadIdx.x;
    const bool writer = threadIdx.x < kSlotsPerRank;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    if (writer && kr < n) {
      a = s.a[kr];
      b = 0.5f * s.b2[kr];  // exact: b2 = 2b
      c = s.c[kr];
    }
    tile_sync<kCluster>();
    if (writer) {
      float row[kFW];  // the slot's gradient row; a dead lane's stays zero
#pragma unroll
      for (int f = 0; f < kFW; ++f) row[f] = 0.0f;
      if (kr < n) {
        float r[kTerms];
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          float acc = *rank_ptr<kCluster>(&sh.cta[par][t][kr], 0);
#pragma unroll
          for (int q = 1; q < kCluster; ++q)
            acc += *rank_ptr<kCluster>(&sh.cta[par][t][kr], q);
          r[t] = acc;
        }
        row[0] = -2.0f * a * r[0] - 2.0f * b * r[1];
        row[1] = -2.0f * b * r[0] - 2.0f * c * r[1];
        row[2] = r[2];
        row[3] = 2.0f * r[3];
#pragma unroll
        for (int t = 4; t < kTerms; ++t) row[t] = r[t];
      }
      if (kBlocks) {
        float* o = dgfeat + static_cast<size_t>(base / kBK) * (kFW * kBK) + kr;
#pragma unroll
        for (int f = 0; f < kFW; ++f) o[f * kBK] = row[f];
      } else if (kr < n) {
        float4* o = reinterpret_cast<float4*>(dgfeat + static_cast<size_t>(base + kr) * kFW);
#pragma unroll
        for (int f = 0; f < kFW / 4; ++f)
          o[f] = make_float4(row[4 * f], row[4 * f + 1], row[4 * f + 2], row[4 * f + 3]);
      }
    }
  }
  if constexpr (kCluster > 1) tile_sync<kCluster>();  // the others read cta
}

// Launch `kernel` on one cluster of Layout<TILE>::kCluster CTAs per tile
// (one CTA when the tile is 16 pixels); returns the launch's cudaError_t.
template <int TILE, typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), int n_tiles, cudaStream_t stream,
                 Args... args) {
  constexpr int kCluster = Layout<TILE>::kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlocks>
int launch_fwd(const Stream& st, float* out, int* nch_used, int H, int W, int tiles_x,
               int tiles_y, int tile_px, float alpha_clip, float alpha_min, float log_stop,
               cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0 || (tile_px != 16 && tile_px != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32)
    return launch_tiles<32>(rasterize_blend_fwd_kernel<32, kBlocks>, n_tiles, stream, st,
                            out, nch_used, H, W, tiles_x, alpha_clip, alpha_min, log_stop);
  return launch_tiles<16>(rasterize_blend_fwd_kernel<16, kBlocks>, n_tiles, stream, st,
                          out, nch_used, H, W, tiles_x, alpha_clip, alpha_min, log_stop);
}

template <bool kBlocks>
int launch_bwd(const Stream& st, const float* logt, const int* nch_used, const float* g,
               float* dgfeat, int H, int W, int tiles_x, int tiles_y, int tile_px,
               float alpha_clip, float alpha_min, cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0 || (tile_px != 16 && tile_px != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32)
    return launch_tiles<32>(rasterize_blend_bwd_kernel<32, kBlocks>, n_tiles, stream, st,
                            logt, nch_used, g, dgfeat, H, W, tiles_x, alpha_clip,
                            alpha_min);
  return launch_tiles<16>(rasterize_blend_bwd_kernel<16, kBlocks>, n_tiles, stream, st,
                          logt, nch_used, g, dgfeat, H, W, tiles_x, alpha_clip, alpha_min);
}

}  // namespace

// K8. feat [n_rows, 16] f32 depth-ordered rows, gids [I] i32, starts
// [>= tiles_x*tiles_y + 1] i32, out [5, H, W] f32 (rgb, T_fin, log T_fin),
// nch_used [tiles_x*tiles_y] i32; all device pointers. tile_px is 16 or
// 32; log_stop = log(early_stop_T), or -inf for no early stop. Launches
// on `stream` and returns the launch's cudaError_t (0 = success); it does
// not synchronise.
extern "C" int rasterize_blend_fwd(const float* feat, int n_rows, const int* gids,
                                   const int* starts, float* out, int* nch_used, int H,
                                   int W, int tiles_x, int tiles_y, int tile_px,
                                   float alpha_clip, float alpha_min, float log_stop,
                                   cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<false>(Stream{feat, n_rows, gids, nullptr, starts, nullptr}, out,
                           nch_used, H, W, tiles_x, tiles_y, tile_px, alpha_clip,
                           alpha_min, log_stop, stream);
}

// K9. As K8's inputs, with logt [H, W] f32 (K8's plane 4) and nch_used
// [tiles_x*tiles_y] i32 from K8, g [4, H, W] f32 the cotangent of (rgb,
// T_fin), and dgfeat [I, 16] f32 (rows of slots in no consumed chunk are
// left as they are).
extern "C" int rasterize_blend_bwd(const float* feat, int n_rows, const int* gids,
                                   const int* starts, const float* logt,
                                   const int* nch_used, const float* g, float* dgfeat,
                                   int H, int W, int tiles_x, int tiles_y, int tile_px,
                                   float alpha_clip, float alpha_min,
                                   cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<false>(Stream{feat, n_rows, gids, nullptr, starts, nullptr}, logt,
                           nch_used, g, dgfeat, H, W, tiles_x, tiles_y, tile_px,
                           alpha_clip, alpha_min, stream);
}

// K8 on the aligned stream: blocks [NB, 16, 64] f32 (K11a's, depth-ordered
// rows), starts [>= tiles_x*tiles_y + 1] i32 (multiples of 64), counts
// [>= tiles_x*tiles_y] i32; otherwise as rasterize_blend_fwd.
extern "C" int rasterize_blend_fwd_aligned(const float* blocks, const int* starts,
                                           const int* counts, float* out, int* nch_used,
                                           int H, int W, int tiles_x, int tiles_y,
                                           int tile_px, float alpha_clip, float alpha_min,
                                           float log_stop, cudaStream_t stream) {
  return launch_fwd<true>(Stream{nullptr, 0, nullptr, blocks, starts, counts}, out,
                          nch_used, H, W, tiles_x, tiles_y, tile_px, alpha_clip,
                          alpha_min, log_stop, stream);
}

// K9 on the aligned stream: as rasterize_blend_bwd with the aligned
// stream's blocks, starts and counts, and dgb [NB, 16, 64] f32 in place of
// dgfeat (blocks of chunks past nch_used are left as they are).
extern "C" int rasterize_blend_bwd_aligned(const float* blocks, const int* starts,
                                           const int* counts, const float* logt,
                                           const int* nch_used, const float* g, float* dgb,
                                           int H, int W, int tiles_x, int tiles_y,
                                           int tile_px, float alpha_clip, float alpha_min,
                                           cudaStream_t stream) {
  return launch_bwd<true>(Stream{nullptr, 0, nullptr, blocks, starts, counts}, logt,
                          nch_used, g, dgb, H, W, tiles_x, tiles_y, tile_px, alpha_clip,
                          alpha_min, stream);
}
