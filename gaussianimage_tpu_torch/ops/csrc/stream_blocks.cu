// K11a and K11b: the aligned instance stream's relayout kernels, for Hopper
// (sm_90a).
//
// K11a `stream_blockize` replaces gaussianimage_tpu/ops/stream_common.py::
// blockize_stream (its Pallas kernel `kern`), and fuses the feat[gids]
// gather of ::gather_stream_blocks into it. K11b `stream_unblockize`
// replaces ::unblockize_stream, which feeds ::scatter_block_grads.
//
// Function. The aligned stream holds NB blocks of kBK = 64 slots; slot
// s = b * 64 + k of block b, lane k.
//   K11a: blocks[b][f][k] = feat[gids[b * 64 + k]][f] for the 16 features
//     f, with ids outside [0, n_rows) reading the sentinel row n_rows - 1
//     (as the rasterizers' slot_features does);
//   K11b: rows[b * 64 + k][f] = dgb[b][f][k].
// A pure copy: both are bit-equal to their plain versions.
//
// Bound on the H100: bytes. K11a reads a 4-byte id and a 64-byte row and
// writes 64 bytes per slot; K11b reads and writes 64 bytes per slot. No
// arithmetic beyond the addresses.
//
// K11a's design: one block of 256 threads per stream block. The 64 x 16
// floats go through shared memory padded to [16][65] so the transpose has
// no bank conflicts on its column side. The row side moves as float4:
// thread i loads quarter i % 4 of slot i / 4's row (the rows are 64 bytes,
// 16-byte aligned), so four threads read one row's 64 bytes together. The
// block side moves as floats, thread i at element r * 256 + i of the
// block's 1024 for r = 0..3: a warp writes 128 contiguous bytes of one
// feature's 256-byte line.
//
// K11b's design: every access 16 bytes wide, no shared memory, no
// barrier. Thread i of the grid takes stream block i / 64, features
// 4 fq .. 4 fq + 3 (fq = (i / 16) % 4) and lanes 4 kq .. 4 kq + 3 (kq =
// i % 16): it loads four float4s, one per feature, transposes the 4 x 4
// in registers and stores four float4s, one per slot. A warp's loads
// cover 512 contiguous bytes (two features' 256-byte lines), and each of
// its stores fills whole 32-byte sectors (two adjacent quarters of 16
// rows). Four loads are in flight per thread, and a block of 256 threads
// moves four stream blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;          // slots per block
constexpr int kFW = 16;          // floats per feature row
constexpr int kThreads = 256;    // K11a: kBK * kFW / 4, one float4 per thread
constexpr int kPad = kBK + 1;    // shared row stride: no bank conflicts

__global__ void __launch_bounds__(kThreads)
stream_blockize_kernel(const float* __restrict__ feat, int n_rows,
                       const int* __restrict__ gids, float* __restrict__ blocks) {
  __shared__ float tile[kFW][kPad];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int k = i >> 2;        // the slot's lane
  const int q = (i & 3) * 4;   // the quarter's first feature
  int g = gids[static_cast<size_t>(b) * kBK + k];
  if (g < 0 || g >= n_rows) g = n_rows - 1;
  const float4 v = *reinterpret_cast<const float4*>(feat + static_cast<size_t>(g) * kFW + q);
  tile[q + 0][k] = v.x;
  tile[q + 1][k] = v.y;
  tile[q + 2][k] = v.z;
  tile[q + 3][k] = v.w;
  __syncthreads();
  float* out = blocks + static_cast<size_t>(b) * (kFW * kBK);
#pragma unroll
  for (int r = 0; r < kFW * kBK / kThreads; ++r) {
    const int e = r * kThreads + i;  // element f * 64 + lane of the block
    out[e] = tile[e / kBK][e % kBK];
  }
}

__global__ void __launch_bounds__(kThreads)
stream_unblockize_kernel(const float4* __restrict__ dgb, float4* __restrict__ rows,
                         int n_threads) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  constexpr int kQuads = kBK / 4;  // float4s per feature line of a block
  const int fq = (i / kQuads) % 4;
  const int kq = i % kQuads;
  // block b = i / 64 is kFW * kQuads = 256 float4s in both layouts:
  // [feature][lane quad] in, [slot][feature quarter] out
  const size_t b = static_cast<size_t>(i / (4 * kQuads)) * (kFW * kQuads);
  const float4* in = dgb + b + (4 * fq) * kQuads + kq;
  const float4 f0 = in[0], f1 = in[kQuads], f2 = in[2 * kQuads], f3 = in[3 * kQuads];
  float4* out = rows + b + (4 * kq) * 4 + fq;
  out[0] = make_float4(f0.x, f1.x, f2.x, f3.x);
  out[4] = make_float4(f0.y, f1.y, f2.y, f3.y);
  out[8] = make_float4(f0.z, f1.z, f2.z, f3.z);
  out[12] = make_float4(f0.w, f1.w, f2.w, f3.w);
}

}  // namespace

// K11a. feat [n_rows, 16] f32 (16-byte aligned), gids [n_blocks * 64]
// i32, blocks [n_blocks, 16, 64] f32; all device pointers. Launches on
// `stream` and returns the launch's cudaError_t (0 = success); it does not
// synchronise.
extern "C" int stream_blockize(const float* feat, int n_rows, const int* gids,
                               float* blocks, int n_blocks, cudaStream_t stream) {
  if (n_blocks <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stream_blockize_kernel<<<n_blocks, kThreads, 0, stream>>>(feat, n_rows, gids, blocks);
  return static_cast<int>(cudaGetLastError());
}

// K11b. dgb [n_blocks, 16, 64] f32, rows [n_blocks * 64, 16] f32, both
// 16-byte aligned; device pointers. As K11a for the stream and the return
// value.
extern "C" int stream_unblockize(const float* dgb, float* rows, int n_blocks,
                                 cudaStream_t stream) {
  if (n_blocks <= 0 || n_blocks > (1 << 30) / kBK) return static_cast<int>(cudaErrorInvalidValue);
  const int n_threads = n_blocks * kBK;  // 16 floats a thread
  stream_unblockize_kernel<<<(n_threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(dgb), reinterpret_cast<float4*>(rows), n_threads);
  return static_cast<int>(cudaGetLastError());
}
