// K1: forward accumulated-summation rasterizer for Hopper (sm_90a).
//
// Replaces gaussianimage_tpu/ops/rasterize_sum.py::_fwd_kernel (with
// _tile_acc and _chunk_geom), and fuses the stream gather of
// ops/stream_common.py::gather_stream into it.
//
// Function: for every image tile of 32x32 pixels, walk the tile's window
// [starts[t], starts[t+1]) of the tile-sorted instance stream. Each
// instance is a row feat[gids[s]] = (x, y, a, b, c, o*r, o*g, o*b, o, pad..)
// of 16 floats. For each pixel of the tile, on tile-local offsets
//   q = max(a dx^2 + 2 b dx dy + c dy^2, 0),
//   w = exp(-q/2) if q <= q_cut else 0,
//   acc[4] += (o*r, o*g, o*b, o) * w,
// and write acc once into the [4, H, W] channel-major image, masking the
// pixels past H x W on the ragged edge.
//
// Bound on the H100: FP32 and MUFU work, about I_live * 1024 (instance,
// pixel) pairs with one exp and ~20 float operations each. The bytes are a
// few MB (the feature rows, the stream, the 4 x H x W output).
//
// Design: one thread block per tile, 256 threads, each owning 4 pixels of
// one column (rows ly, ly+8, ly+16, ly+24), so stores are coalesced along x.
// The block stages each chunk of BK instances' rows in shared memory (every
// thread then reads the same word: a broadcast, no bank conflicts) and each
// thread keeps its 4 x 4 accumulators in registers. Instances are summed in
// stream order: deterministic, no atomics.
//
// Arithmetic: the JAX kernel's expression, rounded op by op (__fmul_rn,
// __fadd_rn: no FMA contraction) and expf, not __expf, so q and w are
// bit-equal to the plain PyTorch version's. That matters at the q <= q_cut
// gate, where one ulp of q decides whether exp(-4.5) ~ 0.011 is added.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 4
constexpr int kRowStride = kThreads / kTile;              // 8
constexpr int kBK = 64;                                   // instances per chunk
constexpr int kFW = 16;                                   // floats per feature row

__global__ void __launch_bounds__(kThreads)
rasterize_sum_fwd_kernel(const float* __restrict__ feat, int n_rows,
                         const int* __restrict__ gids,
                         const int* __restrict__ starts,
                         float* __restrict__ out, int H, int W, int tiles_x,
                         float q_cut) {
  // per-instance columns: tile-local center, conic (a, 2b, c), color matrix
  __shared__ float s_gx[kBK], s_gy[kBK], s_a[kBK], s_b2[kBK], s_c[kBK];
  __shared__ float s_cm[4][kBK];

  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const float tx0 = static_cast<float>(tx * kTile);
  const float ty0 = static_cast<float>(ty * kTile);
  const int start = starts[t];
  const int end = starts[t + 1];

  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const float X = static_cast<float>(lx);
  float Y[kRowsPerThread];
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    Y[j] = static_cast<float>(ly + j * kRowStride);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[j][ch] = 0.0f;
  }

  for (int base = start; base < end; base += kBK) {
    const int n = min(kBK, end - base);
    if (threadIdx.x < n) {
      int g = gids[base + threadIdx.x];
      if (g < 0 || g >= n_rows) g = n_rows - 1;  // the zero sentinel row
      const float* r = feat + static_cast<size_t>(g) * kFW;
      const int k = threadIdx.x;
      s_gx[k] = __fsub_rn(r[0], tx0);
      s_gy[k] = __fsub_rn(r[1], ty0);
      s_a[k] = r[2];
      s_b2[k] = __fmul_rn(2.0f, r[3]);
      s_c[k] = r[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) s_cm[ch][k] = r[5 + ch];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float gx = s_gx[k], gy = s_gy[k];
      const float a = s_a[k], b2 = s_b2[k], c = s_c[k];
      const float dx = __fsub_rn(X, gx);
      const float adxdx = __fmul_rn(__fmul_rn(a, dx), dx);
      const float b2dx = __fmul_rn(b2, dx);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float dy = __fsub_rn(Y[j], gy);
        float q = __fadd_rn(__fadd_rn(adxdx, __fmul_rn(b2dx, dy)),
                            __fmul_rn(__fmul_rn(c, dy), dy));
        q = fmaxf(q, 0.0f);
        if (q <= q_cut) {
          const float w = expf(__fmul_rn(-0.5f, q));
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
            acc[j][ch] = __fadd_rn(acc[j][ch], __fmul_rn(s_cm[ch][k], w));
        }
      }
    }
    __syncthreads();
  }

  const int px = tx * kTile + lx;
  if (px >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int py = ty * kTile + ly + j * kRowStride;
    if (py < H) {
      const size_t o = static_cast<size_t>(py) * W + px;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) out[ch * plane + o] = acc[j][ch];
    }
  }
}

}  // namespace

// feat [n_rows, 16] f32, gids [I] i32, starts [>= tiles_x*tiles_y + 1] i32,
// out [4, H, W] f32; all device pointers. Launches on `stream` and returns
// the launch's cudaError_t (0 = success); it does not synchronise.
extern "C" int rasterize_sum_fwd(const float* feat, int n_rows,
                                 const int* gids, const int* starts,
                                 float* out, int H, int W, int tiles_x,
                                 int tiles_y, float q_cut,
                                 cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rasterize_sum_fwd_kernel<<<n_tiles, kThreads, 0, stream>>>(
      feat, n_rows, gids, starts, out, H, W, tiles_x, q_cut);
  return static_cast<int>(cudaGetLastError());
}
