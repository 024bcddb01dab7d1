// K4-K7: the fused splat prep for Hopper (sm_90a), one pass from a
// Gaussian's parameters to its packed feature row, its binning keys and its
// counts.
//
// K5 splat_prep_raw replaces gaussianimage_tpu/ops/splat_prep.py::_raw_kernel
// (:249): the serving render's front from raw parameters,
//   means = tanh(_xyz), L = _cholesky + bound, Sigma = L L^T.
// K4 splat_prep_decode replaces ::_decode_kernel (:157): the codec decode's
// front from code arrays,
//   means = tanh(f16 xyz codes), L = code * scale + beta + bound,
//   colors = the combined residual-VQ codebook at idx0 * 8 + idx1
// (the JAX kernel's one-hot HIGHEST matmul is an exact gather).
// K7 splat_prep_decode_batch replaces ::_batch_decode_kernel (:195): K4 over
// B frames of n Gaussians stacked into B*n rows on one canvas of B frames
// stacked vertically. Row r is of frame f = r / n (integer division: the
// same answer as the JAX kernel's comparison ladder), reads frame f's
// scale, beta and combined codebook (embed[f * 64 + idx0 * 8 + idx1]), maps
// its y with the frame's height and then adds f * H, and clips its tile
// rows to its frame's band [f * rows, f * rows + rows - 1].
// K6b splat_prep_rs_raw replaces ::_rs_raw_kernel (:471): the RS serving
// render's front from raw parameters,
//   means = tanh(_xyz), s = |_scaling + bound|, theta = sigmoid(_rotation)
//   * 2 pi (torch's CUDA sigmoid, torch_sigmoid), Sigma = rs_cov(s, theta).
// K6a splat_prep_rs_decode replaces ::_rs_decode_kernel (:434): the RS
// decode's front from code arrays,
//   means = tanh(f16 xyz codes), s = |code * scale + beta + bound|,
//   theta = code * scale + beta (the codec quantizes the activated angle,
//   so no sigmoid), colors from the combined codebook as in K4.
// All five then run splat_prep_common.cuh's head and tail (project_head,
// then pack_bin for K5 and K7, pack_bin_staged for K4, K6a and K6b): pixel
// mapping, conic with the 1e-6 det floor, 3-sigma radius, the exact
// q <= q_cut axis extents, the [N+1, 16] feature row, M packed keys
// (tile << id_bits) | row with dead slots at INT32_MAX, and the
// (trunc, live) counts.
//
// Bound on the H100: bytes. At N = 10,000 and M = 9 a launch reads 28-32 B
// and writes 64 + 4M + 8 B per row, about 1.4 MB (0.4 us at 3.35 TB/s),
// against about 2M FP32 slots (0.06 us); K7 at B frames moves B times that.
// K6a/K6b add sincosf (and K6b expf) to a row: about 2.4M slots, still
// under the byte time. Launch latency and one round of loads dominate.
// K7's per-frame tables (2 * 3 B + 64 * 3 B floats) are read through the
// cache.
//
// Design. K5 and K7: the simple one, one thread per row r in [0, N] in
// CTAs of 256: coalesced row reads, float4 stores of the feature row
// (splat_prep_common.cuh's pack_bin), and slot-major keys [M, N+1] so that
// neighbouring threads write neighbouring keys. K4, K6a and K6b as K10
// (splat_prep3d.cu): CTAs of kStagedRows = 64 rows, so that 10,001 rows
// cover every SM; their row inputs staged in shared memory with 16-byte
// loads over each array's span (RowStage; the one- and three-float widths
// of K6b's rotation and colors, K6a's rotation codes, read back a value at
// a time), every load issued before any store; K4's and K6a's quantizer
// tables and combined codebook there too, so that the color is a
// shared-memory read; and the rows out through pack_bin_staged. The
// staged fronts take row inputs that start on 16 bytes (the wrappers
// check). rs_cov reduces the angle once for its cosine and sine
// (sincosf), and every front bins with the exact reciprocal of its
// power-of-two tile side. No atomics; the counts go out per row and the
// caller sums them, so a run is deterministic.

#include <cuda_runtime.h>

#include "splat_prep_common.cuh"

namespace {

using namespace sprep;

__global__ void __launch_bounds__(kThreads)
splat_prep_raw_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ chol,
                      const float* __restrict__ colors, float b0, float b1,
                      float b2, Geom g, float* __restrict__ feat,
                      int* __restrict__ keys, int* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= g.n_rows) return;
  const bool valid = r < g.N;
  const int i = valid ? r : 0;  // the sentinel row reads row 0, unused
  const float mx = tanhf(xyz[2 * i]);
  const float my = tanhf(xyz[2 * i + 1]);
  const float l11 = __fadd_rn(chol[3 * i], b0);
  const float l21 = __fadd_rn(chol[3 * i + 1], b1);
  const float l22 = __fadd_rn(chol[3 * i + 2], b2);
  project_pack_bin<false>(
      r, valid, mx, my, __fmul_rn(l11, l11), __fmul_rn(l11, l21),
      __fadd_rn(__fmul_rn(l21, l21), __fmul_rn(l22, l22)), colors[3 * i],
      colors[3 * i + 1], colors[3 * i + 2], g, Band{}, feat, keys, stats);
}

// K4: rows staged as K10's are (RowStage), with the combined codebook,
// scale and beta in shared memory, then the staged tail.
__global__ void __launch_bounds__(kStagedRows)
splat_prep_decode_kernel(const float* __restrict__ xyz,
                         const int* __restrict__ codes,
                         const int* __restrict__ idx,
                         const float* __restrict__ scale,
                         const float* __restrict__ beta,
                         const float* __restrict__ embed, float b0, float b1,
                         float b2, Geom g, float* __restrict__ feat,
                         int* __restrict__ keys, int* __restrict__ stats) {
  using Mean = RowStage<float, 2>;
  using Code = RowStage<int, 3>;
  using Idx = RowStage<int, 2>;
  constexpr int kTable = 64 * 3;  // the combined codebook's floats
  constexpr int kPer = (kTable + kStagedRows - 1) / kStagedRows;
  __shared__ __align__(16) float s_xyz[Mean::kSize];
  __shared__ __align__(16) int s_codes[Code::kSize];
  __shared__ __align__(16) int s_idx[Idx::kSize];
  __shared__ float s_embed[kTable];
  __shared__ float s_sb[6];  // scale, then beta
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  {
    Mean m;
    Code c;
    Idx x;
    float e[kPer];
    m.load(xyz, r0, rows, t);
    c.load(codes, r0, rows, t);
    x.load(idx, r0, rows, t);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (t + k * kStagedRows < kTable)
        e[k] = __ldg(embed + t + k * kStagedRows);
    const float sb =
        t < 3 ? __ldg(scale + t) : t < 6 ? __ldg(beta + t - 3) : 0.0f;
    m.store(s_xyz, t);
    c.store(s_codes, t);
    x.store(s_idx, t);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (t + k * kStagedRows < kTable) s_embed[t + k * kStagedRows] = e[k];
    if (t < 6) s_sb[t] = sb;
  }
  __syncthreads();
  // every thread runs to the end (pack_bin_staged is warp-collective);
  // rows past N read zeros and store nothing but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  float mean[2];
  int code[3], ix[2];
  Mean::read(s_xyz, t, mean);
  Code::read(s_codes, t, code);
  Idx::read(s_idx, t, ix);
  const float mx = tanhf(mean[0]);
  const float my = tanhf(mean[1]);
  // dequantize as the generic path does: code * scale + beta, then + bound
  const float l11 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[0], s_sb[0]), s_sb[3]), b0);
  const float l21 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[1], s_sb[1]), s_sb[4]), b1);
  const float l22 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[2], s_sb[2]), s_sb[5]), b2);
  // the combined codebook holds every sum embed0[a] + embed1[b] at a*8 + b;
  // indices outside it read entry 0 rather than past the table
  int comb = ix[0] * 8 + ix[1];
  if (comb < 0 || comb >= 64) comb = 0;
  const float* col = s_embed + 3 * comb;
  const Splat sp = project_head<false>(
      mx, my, __fmul_rn(l11, l11), __fmul_rn(l11, l21),
      __fadd_rn(__fmul_rn(l21, l21), __fmul_rn(l22, l22)), g, Band{});
  pack_bin_staged(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                  s_feat[t / 32], feat, keys, stats);
}

// K7: g.N = B * n_per rows, g.H the frame's height, g.tiles_y the canvas's
// tile rows (B * rows_pf). scale and beta are [B, 3], embed [B * 64, 3].
__global__ void __launch_bounds__(kThreads)
splat_prep_decode_batch_kernel(const float* __restrict__ xyz,
                               const int* __restrict__ codes,
                               const int* __restrict__ idx,
                               const float* __restrict__ scale,
                               const float* __restrict__ beta,
                               const float* __restrict__ embed, float b0,
                               float b1, float b2, int n_per, int rows_pf,
                               Geom g, float* __restrict__ feat,
                               int* __restrict__ keys,
                               int* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= g.n_rows) return;
  const bool valid = r < g.N;
  const int i = valid ? r : 0;  // the sentinel row reads row 0 of frame 0
  const int f = i / n_per;
  const float mx = tanhf(xyz[2 * i]);
  const float my = tanhf(xyz[2 * i + 1]);
  const float* sc = scale + 3 * f;
  const float* be = beta + 3 * f;
  const float l11 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)codes[3 * i], sc[0]), be[0]), b0);
  const float l21 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)codes[3 * i + 1], sc[1]), be[1]), b1);
  const float l22 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)codes[3 * i + 2], sc[2]), be[2]), b2);
  int comb = idx[2 * i] * 8 + idx[2 * i + 1];
  if (comb < 0 || comb >= 64) comb = 0;
  const float* col = embed + 3 * (f * 64 + comb);
  // the frame's offset and band, as the JAX kernel forms them in f32 (exact
  // for these small whole numbers)
  const float ff = (float)f;
  const float lo = __fmul_rn(ff, (float)rows_pf);
  const Band band{__fmul_rn(ff, (float)g.H), lo,
                  __fadd_rn(lo, (float)(rows_pf - 1))};
  project_pack_bin<true>(
      r, valid, mx, my, __fmul_rn(l11, l11), __fmul_rn(l11, l21),
      __fadd_rn(__fmul_rn(l21, l21), __fmul_rn(l22, l22)), col[0], col[1],
      col[2], g, band, feat, keys, stats);
}

// K6b: rows staged as K4's are (RowStage), then the staged tail.
// scaling [N, 2] before the bound, rotation [N, 1] before the sigmoid.
__global__ void __launch_bounds__(kStagedRows)
splat_prep_rs_raw_kernel(const float* __restrict__ xyz,
                         const float* __restrict__ scaling,
                         const float* __restrict__ rotation,
                         const float* __restrict__ colors, float b0, float b1,
                         Geom g, float* __restrict__ feat,
                         int* __restrict__ keys, int* __restrict__ stats) {
  using Pair = RowStage<float, 2>;
  using Rot = RowStage<float, 1>;
  using Col = RowStage<float, 3>;
  __shared__ __align__(16) float s_xyz[Pair::kSize];
  __shared__ __align__(16) float s_scaling[Pair::kSize];
  __shared__ __align__(16) float s_rot[Rot::kSize];
  __shared__ __align__(16) float s_col[Col::kSize];
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  {
    Pair m, sc;
    Rot a;
    Col c;
    m.load(xyz, r0, rows, t);
    sc.load(scaling, r0, rows, t);
    a.load(rotation, r0, rows, t);
    c.load(colors, r0, rows, t);
    m.store(s_xyz, t);
    sc.store(s_scaling, t);
    a.store(s_rot, t);
    c.store(s_col, t);
  }
  __syncthreads();
  // every thread runs to the end (pack_bin_staged is warp-collective);
  // rows past N read zeros and store nothing but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  float mean[2], scl[2], rot[1], col[3];
  Pair::read(s_xyz, t, mean);
  Pair::read(s_scaling, t, scl);
  Rot::read(s_rot, t, rot);
  Col::read(s_col, t, col);
  const float mx = tanhf(mean[0]);
  const float my = tanhf(mean[1]);
  const float sx = fabsf(__fadd_rn(scl[0], b0));
  const float sy = fabsf(__fadd_rn(scl[1], b1));
  const float theta = __fmul_rn(torch_sigmoid(rot[0]), kTwoPi);
  float s11, s12, s22;
  rs_cov(sx, sy, theta, s11, s12, s22);
  const Splat sp = project_head<false>(mx, my, s11, s12, s22, g, Band{});
  pack_bin_staged(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                  s_feat[t / 32], feat, keys, stats);
}

// K6a: rows staged as K4's, the quantizer tables and the combined codebook
// in shared memory, then the staged tail. scodes [N, 2], rcodes [N, 1];
// s_scale, s_beta [2]; r_scale, r_beta [1]; dequantized as the generic
// path does: code * scale + beta.
__global__ void __launch_bounds__(kStagedRows)
splat_prep_rs_decode_kernel(const float* __restrict__ xyz,
                            const int* __restrict__ scodes,
                            const int* __restrict__ rcodes,
                            const int* __restrict__ idx,
                            const float* __restrict__ s_scale,
                            const float* __restrict__ s_beta,
                            const float* __restrict__ r_scale,
                            const float* __restrict__ r_beta,
                            const float* __restrict__ embed, float b0,
                            float b1, Geom g, float* __restrict__ feat,
                            int* __restrict__ keys, int* __restrict__ stats) {
  using Mean = RowStage<float, 2>;
  using Pair = RowStage<int, 2>;
  using RCode = RowStage<int, 1>;
  constexpr int kTable = 64 * 3;  // the combined codebook's floats
  constexpr int kPer = (kTable + kStagedRows - 1) / kStagedRows;
  __shared__ __align__(16) float s_xyz[Mean::kSize];
  __shared__ __align__(16) int s_scodes[Pair::kSize];
  __shared__ __align__(16) int s_rcodes[RCode::kSize];
  __shared__ __align__(16) int s_idx[Pair::kSize];
  __shared__ float s_embed[kTable];
  __shared__ float s_q[6];  // s_scale, s_beta, r_scale, r_beta
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  {
    Mean m;
    Pair sc, x;
    RCode rc;
    float e[kPer];
    m.load(xyz, r0, rows, t);
    sc.load(scodes, r0, rows, t);
    rc.load(rcodes, r0, rows, t);
    x.load(idx, r0, rows, t);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (t + k * kStagedRows < kTable)
        e[k] = __ldg(embed + t + k * kStagedRows);
    const float q = t < 2   ? __ldg(s_scale + t)
                    : t < 4 ? __ldg(s_beta + t - 2)
                    : t == 4 ? __ldg(r_scale)
                    : t == 5 ? __ldg(r_beta)
                             : 0.0f;
    m.store(s_xyz, t);
    sc.store(s_scodes, t);
    rc.store(s_rcodes, t);
    x.store(s_idx, t);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (t + k * kStagedRows < kTable) s_embed[t + k * kStagedRows] = e[k];
    if (t < 6) s_q[t] = q;
  }
  __syncthreads();
  // every thread runs to the end (pack_bin_staged is warp-collective);
  // rows past N read zeros and store nothing but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  float mean[2];
  int scode[2], rcode[1], ix[2];
  Mean::read(s_xyz, t, mean);
  Pair::read(s_scodes, t, scode);
  RCode::read(s_rcodes, t, rcode);
  Pair::read(s_idx, t, ix);
  const float mx = tanhf(mean[0]);
  const float my = tanhf(mean[1]);
  const float sx = fabsf(__fadd_rn(
      __fadd_rn(__fmul_rn((float)scode[0], s_q[0]), s_q[2]), b0));
  const float sy = fabsf(__fadd_rn(
      __fadd_rn(__fmul_rn((float)scode[1], s_q[1]), s_q[3]), b1));
  const float theta = __fadd_rn(__fmul_rn((float)rcode[0], s_q[4]), s_q[5]);
  float s11, s12, s22;
  rs_cov(sx, sy, theta, s11, s12, s22);
  // indices outside the combined codebook read entry 0, as in K4
  int comb = ix[0] * 8 + ix[1];
  if (comb < 0 || comb >= 64) comb = 0;
  const float* col = s_embed + 3 * comb;
  const Splat sp = project_head<false>(mx, my, s11, s12, s22, g, Band{});
  pack_bin_staged(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                  s_feat[t / 32], feat, keys, stats);
}

Geom make_geom(int N, int H, int W, int tile_px, int tiles_x, int tiles_y,
               int M, int id_bits, float q_cut) {
  Geom g;
  g.N = N;
  g.n_rows = N + 1;
  g.H = H;
  g.W = W;
  g.tile_px = tile_px;
  g.tiles_x = tiles_x;
  g.tiles_y = tiles_y;
  g.M = M;
  g.id_bits = id_bits;
  g.q_cut = q_cut;
  g.inv_tile = 1.0f / (float)tile_px;
  return g;
}

int blocks_for(int n_rows) { return (n_rows + kThreads - 1) / kThreads; }

int staged_blocks_for(int n_rows) {
  return (n_rows + kStagedRows - 1) / kStagedRows;
}

}  // namespace

// K5. xyz [N, 2], chol [N, 3], colors [N, 3] f32; feat [N+1, 16] f32,
// keys [M, N+1] i32, stats [2, N+1] i32; all device pointers. Launches on
// `stream` and returns the launch's cudaError_t (0 = success;
// cudaErrorInvalidValue for N < 1, M < 1 or a tile_px that is not a power
// of two, in every launcher below too).
extern "C" int splat_prep_raw(const float* xyz, const float* chol,
                              const float* colors, int N, int H, int W,
                              int tile_px, int tiles_x, int tiles_y, int M,
                              int id_bits, float q_cut, float b0, float b1,
                              float b2, float* feat, int* keys, int* stats,
                              cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(N, H, W, tile_px, tiles_x, tiles_y, M, id_bits, q_cut);
  splat_prep_raw_kernel<<<blocks_for(g.n_rows), kThreads, 0, stream>>>(
      xyz, chol, colors, b0, b1, b2, g, feat, keys, stats);
  return static_cast<int>(cudaGetLastError());
}

// K4. xyz [N, 2] f32 (the f16 codes, widened), codes [N, 3] i32,
// idx [N, 2] i32 (these three and feat 16-byte aligned), scale [3],
// beta [3], embed [64, 3] f32; outputs as K5's.
extern "C" int splat_prep_decode(const float* xyz, const int* codes,
                                 const int* idx, const float* scale,
                                 const float* beta, const float* embed, int N,
                                 int H, int W, int tile_px, int tiles_x,
                                 int tiles_y, int M, int id_bits, float q_cut,
                                 float b0, float b1, float b2, float* feat,
                                 int* keys, int* stats, cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(N, H, W, tile_px, tiles_x, tiles_y, M, id_bits, q_cut);
  splat_prep_decode_kernel<<<staged_blocks_for(g.n_rows), kStagedRows, 0,
                             stream>>>(
      xyz, codes, idx, scale, beta, embed, b0, b1, b2, g, feat, keys, stats);
  return static_cast<int>(cudaGetLastError());
}

// K7. N = B * n_per rows: xyz [N, 2] f32, codes [N, 3] i32, idx [N, 2] i32,
// scale [B, 3], beta [B, 3], embed [B * 64, 3] f32; H the frame's height,
// tiles_y the canvas's tile rows (a multiple of B); outputs as K5's.
extern "C" int splat_prep_decode_batch(
    const float* xyz, const int* codes, const int* idx, const float* scale,
    const float* beta, const float* embed, int N, int n_per, int H, int W,
    int tile_px, int tiles_x, int tiles_y, int M, int id_bits, float q_cut,
    float b0, float b1, float b2, float* feat, int* keys, int* stats,
    cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px) || n_per < 1 || N % n_per != 0 ||
      tiles_y % (N / n_per) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_pf = tiles_y / (N / n_per);
  const Geom g = make_geom(N, H, W, tile_px, tiles_x, tiles_y, M, id_bits, q_cut);
  splat_prep_decode_batch_kernel<<<blocks_for(g.n_rows), kThreads, 0,
                                   stream>>>(xyz, codes, idx, scale, beta,
                                             embed, b0, b1, b2, n_per,
                                             rows_pf, g, feat, keys, stats);
  return static_cast<int>(cudaGetLastError());
}

// K6b. xyz [N, 2], scaling [N, 2], rotation [N, 1], colors [N, 3] f32
// (these four and feat 16-byte aligned); the bound (b0, b1); outputs as
// K5's.
extern "C" int splat_prep_rs_raw(const float* xyz, const float* scaling,
                                 const float* rotation, const float* colors,
                                 int N, int H, int W, int tile_px, int tiles_x,
                                 int tiles_y, int M, int id_bits, float q_cut,
                                 float b0, float b1, float* feat, int* keys,
                                 int* stats, cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(N, H, W, tile_px, tiles_x, tiles_y, M, id_bits, q_cut);
  splat_prep_rs_raw_kernel<<<staged_blocks_for(g.n_rows), kStagedRows, 0,
                             stream>>>(xyz, scaling, rotation, colors, b0,
                                       b1, g, feat, keys, stats);
  return static_cast<int>(cudaGetLastError());
}

// K6a. xyz [N, 2] f32 (the f16 codes, widened), scodes [N, 2], rcodes
// [N, 1] and idx [N, 2] i32 (these four and feat 16-byte aligned),
// s_scale, s_beta [2], r_scale, r_beta [1], embed [64, 3] f32; the bound
// (b0, b1); outputs as K5's.
extern "C" int splat_prep_rs_decode(
    const float* xyz, const int* scodes, const int* rcodes, const int* idx,
    const float* s_scale, const float* s_beta, const float* r_scale,
    const float* r_beta, const float* embed, int N, int H, int W, int tile_px,
    int tiles_x, int tiles_y, int M, int id_bits, float q_cut, float b0,
    float b1, float* feat, int* keys, int* stats, cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(N, H, W, tile_px, tiles_x, tiles_y, M, id_bits, q_cut);
  splat_prep_rs_decode_kernel<<<staged_blocks_for(g.n_rows), kStagedRows, 0,
                                stream>>>(
      xyz, scodes, rcodes, idx, s_scale, s_beta, r_scale, r_beta, embed, b0,
      b1, g, feat, keys, stats);
  return static_cast<int>(cudaGetLastError());
}
