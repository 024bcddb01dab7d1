// K1: forward accumulated-summation rasterizer for Hopper (sm_90a).
//
// Replaces gaussianimage_tpu/ops/rasterize_sum.py::_fwd_kernel (with
// _tile_acc and _chunk_geom), and fuses the stream gather of
// ops/stream_common.py::gather_stream into it. `rasterize_sum_fwd` walks the
// flat stream; `rasterize_sum_fwd_aligned` the aligned one, reading the
// [NB, 16, 64] blocks K11a wrote (the TPU kernel's `aligned` branch).
//
// Function: for every image tile of TILE x TILE pixels (TILE = 32, or 16,
// the sharded fit's default), walk the tile's window
// of the tile-sorted instance stream ([starts[t], starts[t+1]) flat,
// [starts[t], starts[t] + counts[t]) aligned). Each instance is a row
// feat[gids[s]] = (x, y, a, b, c, o*r, o*g, o*b, o, pad..) of 16 floats, or
// the same 16 features down lane s % 64 of block s / 64. For each pixel of the tile, on tile-local offsets
//   q = max(a dx^2 + 2 b dx dy + c dy^2, 0),
//   w = exp(-q/2) if q <= q_cut else 0,
//   acc[4] += (o*r, o*g, o*b, o) * w,
// and write acc once into the [4, H, W] channel-major image, masking the
// pixels past H x W on the ragged edge.
//
// Bound on the H100: FP32 issue slots and MUFU ex2. Each pair that passes
// the gate takes q and the gate (~9 slots), -q/2, expf (one ex2) and four
// multiply-adds; on the flower@10k fit's stream 3.19M of the windows'
// 26.21M (instance, pixel) pairs pass (12%). The bytes are a few MB (the
// feature rows, the stream, the 4 x H x W output).
//
// Design: 88% of a window's pairs fail the gate on the fit stream, so K1
// walks only the pairs that can pass, on the layout, staging and walk of
// rasterize_sum_common.cuh that it shares with K3 (Pixels, walk_forward).
// One CTA of 256 threads per 32-pixel tile (a window holds 67 slots on
// the mean tile at 10k points, at most 3 chunks; 177 and 7 at 40k: too
// shallow to split a tile over a cluster), or of 64 threads per 16-pixel
// tile (Geo<16>: two warps, four times the CTAs); each warp owns a 16 x 8
// block of four 8 x 4 patches, one pixel of each per thread.
// Staging a chunk gives each slot its cull rectangle at q_cut as a mask of
// the tile's patches, and each warp walks only the slots that meet its
// patches, and per slot only those patches, with the next chunk's rows
// loading into registers meanwhile. The thread's 4 x 4 accumulators stay
// in registers and each pixel adds its gated pairs in stream order, so the
// image is the all-pairs walk's bit for bit (the cull drops only pairs
// that fail the gate), deterministic, with no atomics. A warp's store of
// one channel of one of its pixels writes 32 contiguous bytes per patch
// row.
//
// Arithmetic: the pair's q, gate and weight come from
// rasterize_sum_common.cuh, shared with K3 (which must reproduce K1's
// image bit for bit) and K2, rounded op by op so they are bit-equal to the
// plain PyTorch version's.

#include <cuda_runtime.h>

#include "rasterize_sum_common.cuh"

namespace {

using namespace gsum;

template <int TILE, bool kBlocks>
__global__ void __launch_bounds__(Geo<TILE>::kThreads)
rasterize_sum_fwd_kernel(Stream st, float* __restrict__ out, int H, int W, int tiles_x,
                         float q_cut) {
  __shared__ Slots s;
  const Pixels p = pixels_of<TILE, kBlocks>(st, H, W, tiles_x);
  float acc[kPixels][kC];
  SlotRow row;
  walk_forward<TILE, kBlocks, false>(s, st, p, q_cut, acc, row);

  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    if (p.inside[j]) {
      const size_t pix = pixel_index(p, j, W);
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) out[ch * plane + pix] = acc[j][ch];
    }
  }
}

template <int TILE, bool kBlocks>
int launch_fwd(const Stream& st, float* out, int H, int W, int tiles_x, int n_tiles,
               float q_cut, cudaStream_t stream) {
  rasterize_sum_fwd_kernel<TILE, kBlocks><<<n_tiles, Geo<TILE>::kThreads, 0, stream>>>(
      st, out, H, W, tiles_x, q_cut);
  return static_cast<int>(cudaGetLastError());
}

// The launch at tile_px 32 or 16 (anything else: cudaErrorInvalidValue).
template <bool kBlocks>
int launch_fwd_tile(const Stream& st, float* out, int H, int W, int tiles_x, int tiles_y,
                    int tile_px, float q_cut, cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_px == 32)
    return launch_fwd<32, kBlocks>(st, out, H, W, tiles_x, n_tiles, q_cut, stream);
  if (tile_px == 16)
    return launch_fwd<16, kBlocks>(st, out, H, W, tiles_x, n_tiles, q_cut, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// feat [n_rows, 16] f32, gids [I] i32, starts [>= tiles_x*tiles_y + 1] i32,
// out [4, H, W] f32; all device pointers; tile_px 32 or 16. Launches on
// `stream` and returns the launch's cudaError_t (0 = success); it does not
// synchronise.
extern "C" int rasterize_sum_fwd(const float* feat, int n_rows,
                                 const int* gids, const int* starts,
                                 float* out, int H, int W, int tiles_x,
                                 int tiles_y, int tile_px, float q_cut,
                                 cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_tile<false>(Stream{feat, n_rows, gids, nullptr, starts, nullptr}, out,
                                H, W, tiles_x, tiles_y, tile_px, q_cut, stream);
}

// The aligned stream: blocks [NB, 16, 64] f32 (K11a's), starts
// [>= tiles_x*tiles_y + 1] i32 (multiples of 64), counts
// [>= tiles_x*tiles_y] i32; otherwise as rasterize_sum_fwd.
extern "C" int rasterize_sum_fwd_aligned(const float* blocks, const int* starts,
                                         const int* counts, float* out, int H, int W,
                                         int tiles_x, int tiles_y, int tile_px,
                                         float q_cut, cudaStream_t stream) {
  return launch_fwd_tile<true>(Stream{nullptr, 0, nullptr, blocks, starts, counts}, out, H,
                               W, tiles_x, tiles_y, tile_px, q_cut, stream);
}
