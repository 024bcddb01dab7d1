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
// A slot belongs to one tile's window, so K9's blocks write disjoint rows
// of dgfeat; rows of slots in no consumed chunk are left as they are (the
// caller zeroes them). On the aligned stream K9 writes each consumed
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
// and, in K9, the [4, H, W] cotangent and the [I, 16] rows.
//
// Design: one block per tile, 256 threads, each owning 4 pixels (32-pixel
// tiles) or 1 (16-pixel tiles) of one column. Each chunk's 64 rows are
// staged in shared memory (broadcast reads); the transmittance, color sums
// and cotangent stay in registers. A pair with raw < alpha_min is skipped:
// its alpha is 0 and it changes no sum. K8's early stop is a block-wide
// max of logT per chunk (shuffles, then shared memory). K9 sums each
// slot's nine terms over the warp by shuffles in a fixed tree, lane 0
// parks them in shared memory, and after the chunk thread k adds the 8
// warps' partials of slot k in warp order and writes its row: no atomics,
// the result is deterministic.
//
// Arithmetic: K8 rounds op by op (__fmul_rn, __fadd_rn) with full-precision
// expf and log1pf, as torch computes its plain version on the card, so the
// two agree bit for bit and take the same early-stop decisions. K9 is held
// to its plain version to a tolerance (its per-slot sums are reduced in
// another order).

#include <cuda_runtime.h>
#include <math.h>

#include "rasterize_blend_common.cuh"

namespace {

using namespace gblend;

constexpr int kTerms = 9;  // sum dq dx, dq dy, dq dx^2, dq dx dy, dq dy^2, G vis x3, dalpha w

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the warp in a fixed tree; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_blend_fwd_kernel(Stream st, float* __restrict__ out, int* __restrict__ nch_used,
                           int H, int W, int tiles_x, float alpha_clip, float alpha_min,
                           float log_stop) {
  constexpr int kPPT = TileGeom<TILE>::kPPT;
  __shared__ Chunk s;
  __shared__ float red[kWarps];
  const TileGeom<TILE> tg = tile_geom<TILE, kBlocks>(st, H, W, tiles_x);
  float logT[kPPT], acc[kPPT][3];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    logT[j] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) acc[j][ch] = 0.0f;
  }
  const int nch = (tg.end - tg.start + kBK - 1) / kBK;
  float tile_max = 0.0f;  // max of logT over the tile, before the first chunk
  int ci = 0;
  for (; ci < nch && tile_max > log_stop; ++ci) {
    const int base = tg.start + ci * kBK;
    const int n = min(kBK, tg.end - base);
    stage_chunk<kBlocks>(s, st, base, n, tg.tx0, tg.ty0);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float dx = __fsub_rn(tg.X, s.gx[k]);
      const float adxdx = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
      const float b2dx = __fmul_rn(s.b2[k], dx);
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        const PairAlpha p = pair_alpha(adxdx, b2dx, s.c[k], __fsub_rn(tg.Y[j], s.gy[k]),
                                       s.op[k], alpha_clip, alpha_min);
        if (p.on) {
          const float vis = __fmul_rn(p.alpha, expf(logT[j]));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            acc[j][ch] = __fadd_rn(acc[j][ch], __fmul_rn(s.col[ch][k], vis));
          logT[j] = __fadd_rn(logT[j], log1pf(-p.alpha));
        }
      }
    }
    float m = logT[0];
#pragma unroll
    for (int j = 1; j < kPPT; ++j) m = fmaxf(m, logT[j]);
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    tile_max = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tile_max = fmaxf(tile_max, red[w]);
    __syncthreads();  // the next chunk overwrites s and red
  }

  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    if (tg.inside[j]) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[ch * plane + tg.pix[j]] = acc[j][ch];
      out[3 * plane + tg.pix[j]] = expf(logT[j]);
      out[4 * plane + tg.pix[j]] = logT[j];
    }
  }
  if (threadIdx.x == 0) nch_used[blockIdx.x] = ci;
}

struct BwdShared {
  Chunk s;
  float part[kWarps][kTerms][kBK];  // per-warp partial sums per slot
};

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_blend_bwd_kernel(Stream st, const float* __restrict__ logt,
                           const int* __restrict__ nch_used, const float* __restrict__ g,
                           float* __restrict__ dgfeat, int H, int W, int tiles_x,
                           float alpha_clip, float alpha_min) {
  constexpr int kPPT = TileGeom<TILE>::kPPT;
  __shared__ BwdShared sh;
  const TileGeom<TILE> tg = tile_geom<TILE, kBlocks>(st, H, W, tiles_x);
  const int nch = nch_used[blockIdx.x];
  if (nch <= 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane = static_cast<size_t>(H) * W;

  // per pixel: the cotangent, log T_fin and T_fin; the running suffix sums
  float G[kPPT][4], lTf[kPPT], Tf[kPPT], suf[kPPT], S[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      G[j][ch] = tg.inside[j] ? g[ch * plane + tg.pix[j]] : 0.0f;
    lTf[j] = tg.inside[j] ? logt[tg.pix[j]] : 0.0f;
    Tf[j] = expf(lTf[j]);
    suf[j] = 0.0f;
    S[j] = 0.0f;
  }

  for (int ci = nch - 1; ci >= 0; --ci) {
    const int base = tg.start + ci * kBK;
    const int n = min(kBK, tg.end - base);
    stage_chunk<kBlocks>(sh.s, st, base, n, tg.tx0, tg.ty0);
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {
      const Chunk& s = sh.s;
      const float dx = __fsub_rn(tg.X, s.gx[k]);
      const float adxdx = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
      const float b2dx = __fmul_rn(s.b2[k], dx);
      float m[kTerms];
#pragma unroll
      for (int v = 0; v < kTerms; ++v) m[v] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        if (!tg.inside[j]) continue;
        const float dy = __fsub_rn(tg.Y[j], s.gy[k]);
        const PairAlpha p = pair_alpha(adxdx, b2dx, s.c[k], dy, s.op[k], alpha_clip,
                                       alpha_min);
        if (!p.on) continue;
        const float l1m = log1pf(-p.alpha);
        suf[j] += l1m;
        const float T_k = expf(lTf[j] - suf[j]);
        const float vis = p.alpha * T_k;
        const float gdotc = s.col[0][k] * G[j][0] + s.col[1][k] * G[j][1]
                            + s.col[2][k] * G[j][2];
        const float dalpha = p.raw <= alpha_clip
            ? gdotc * T_k - (S[j] + G[j][3] * Tf[j]) * expf(-l1m)
            : 0.0f;
        S[j] += gdotc * vis;
        const float dw = dalpha * s.op[k];
        const float dq = p.q > 0.0f ? -0.5f * p.w * dw : 0.0f;
        const float dqdx = dq * dx;
        const float dqdy = dq * dy;
        m[0] += dqdx;
        m[1] += dqdy;
        m[2] += dqdx * dx;
        m[3] += dqdx * dy;
        m[4] += dqdy * dy;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) m[5 + ch] += G[j][ch] * vis;
        m[8] += dalpha * p.w;
        any = true;
      }
      // warp-uniform branch: a warp with no live pair keeps zeros
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int v = 0; v < kTerms; ++v) m[v] = warp_sum(m[v]);
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < kTerms; ++v) sh.part[warp][v][k] = m[v];
      }
    }
    __syncthreads();
    const int k = threadIdx.x;
    float row[kFW];  // the slot's gradient row; a dead lane's stays zero
#pragma unroll
    for (int f = 0; f < kFW; ++f) row[f] = 0.0f;
    if (k < n) {
      float r[kTerms];
#pragma unroll
      for (int v = 0; v < kTerms; ++v) {
        float acc = sh.part[0][v][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += sh.part[w][v][k];
        r[v] = acc;
      }
      const float a = sh.s.a[k];
      const float b = 0.5f * sh.s.b2[k];  // exact: b2 = 2b
      const float c = sh.s.c[k];
      row[0] = -2.0f * a * r[0] - 2.0f * b * r[1];
      row[1] = -2.0f * b * r[0] - 2.0f * c * r[1];
      row[2] = r[2];
      row[3] = 2.0f * r[3];
#pragma unroll
      for (int v = 4; v < kTerms; ++v) row[v] = r[v];
    }
    if (kBlocks) {
      if (k < kBK) {
        float* o = dgfeat + static_cast<size_t>(base / kBK) * (kFW * kBK) + k;
#pragma unroll
        for (int f = 0; f < kFW; ++f) o[f * kBK] = row[f];
      }
    } else if (k < n) {
      float4* o = reinterpret_cast<float4*>(dgfeat + static_cast<size_t>(base + k) * kFW);
#pragma unroll
      for (int f = 0; f < kFW / 4; ++f)
        o[f] = make_float4(row[4 * f], row[4 * f + 1], row[4 * f + 2], row[4 * f + 3]);
    }
    __syncthreads();  // the next chunk overwrites the staged rows and partials
  }
}

template <bool kBlocks>
int launch_fwd(const Stream& st, float* out, int* nch_used, int H, int W, int tiles_x,
               int tiles_y, int tile_px, float alpha_clip, float alpha_min, float log_stop,
               cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0 || (tile_px != 16 && tile_px != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32) {
    rasterize_blend_fwd_kernel<32, kBlocks><<<n_tiles, kThreads, 0, stream>>>(
        st, out, nch_used, H, W, tiles_x, alpha_clip, alpha_min, log_stop);
  } else {
    rasterize_blend_fwd_kernel<16, kBlocks><<<n_tiles, kThreads, 0, stream>>>(
        st, out, nch_used, H, W, tiles_x, alpha_clip, alpha_min, log_stop);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlocks>
int launch_bwd(const Stream& st, const float* logt, const int* nch_used, const float* g,
               float* dgfeat, int H, int W, int tiles_x, int tiles_y, int tile_px,
               float alpha_clip, float alpha_min, cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0 || (tile_px != 16 && tile_px != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32) {
    rasterize_blend_bwd_kernel<32, kBlocks><<<n_tiles, kThreads, 0, stream>>>(
        st, logt, nch_used, g, dgfeat, H, W, tiles_x, alpha_clip, alpha_min);
  } else {
    rasterize_blend_bwd_kernel<16, kBlocks><<<n_tiles, kThreads, 0, stream>>>(
        st, logt, nch_used, g, dgfeat, H, W, tiles_x, alpha_clip, alpha_min);
  }
  return static_cast<int>(cudaGetLastError());
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
