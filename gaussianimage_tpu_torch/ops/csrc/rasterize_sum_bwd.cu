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
// work (~9 slots per pair and 13 + 1 ex2 more per gated pair), then a second
// walk that recomputes q (~9 per pair) and, per gated pair, w (ex2), dw, dq,
// the five moments and four dcm sums (~26 slots). K2 is the second walk
// alone. Device bytes are a few MB: the rows, the stream, one or two
// [C, H, W] images and the [I, 16] gradient rows.
//
// Design: one block per tile, 256 threads, each owning 4 pixels of one
// column; warp w owns the contiguous rows 4w..4w+3 (TileGeom, shared with
// K1), so a small Gaussian touches few warps and a warp with no gated pixel for an instance skips
// its reduction (__any_sync). The chunk of 64 instances is staged in shared
// memory as in K1 (one broadcast read per instance), and the image
// accumulators and G stay in registers between the two walks. Per instance
// each warp sums its nine partials by shuffles in a fixed tree; lane 0
// parks them in shared memory; after the chunk, thread k adds the 8 warps'
// partials of instance k in warp order and writes its row. No atomics, in
// shared or global memory: the result is deterministic.

#include <cuda_runtime.h>

#include "rasterize_sum_common.cuh"

namespace {

using namespace gsum;

constexpr int kMoments = 9;  // cx, cy, sum dq dx^2, dq dx dy, dq dy^2, dcm0..3

struct BwdShared {
  Chunk s;
  float part[kWarps][kMoments][kBK];  // per-warp partial sums per instance
  float red[kWarps];                  // per-warp partial SSE
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

template <bool kBlocks>
__global__ void __launch_bounds__(kThreads)
rasterize_sum_l2_kernel(Stream st, const float* __restrict__ gt,
                        float* __restrict__ sse, float* __restrict__ dgfeat,
                        int H, int W, int tiles_x, float q_cut, float gscale,
                        int clamp) {
  __shared__ BwdShared sh;
  const TileGeom tg = tile_geom<kBlocks>(st, H, W, tiles_x);

  // forward: K1's walk (tile_forward), so img is bit-equal to K1's image
  float acc[kRowsPerThread][kC];
  tile_forward<kBlocks>(sh.s, st, tg, q_cut, acc);

  // clip, masked L2 and its cotangent, per pixel; the tile's SSE
  const size_t plane = static_cast<size_t>(H) * W;
  float G[kRowsPerThread][kC];
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float img = acc[j][ch];
      const float imgc = clamp ? fminf(fmaxf(img, 0.0f), 1.0f) : img;
      const bool live = !clamp || (img > 0.0f && img < 1.0f);
      const float diff = tg.inside[j] ? __fsub_rn(imgc, gt[ch * plane + tg.pix[j]]) : 0.0f;
      e = __fadd_rn(e, __fmul_rn(diff, diff));
      G[j][ch] = __fmul_rn(gscale, live ? diff : 0.0f);
    }
    G[j][3] = 0.0f;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  e = warp_sum(e);
  if (lane == 0) sh.red[warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = sh.red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += sh.red[w];
    sse[blockIdx.x] = total;
  }

  tile_backward<kBlocks>(sh, st, tg, G, q_cut, dgfeat);
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
