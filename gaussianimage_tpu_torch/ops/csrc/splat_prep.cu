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
// then pack_bin_staged): pixel mapping, conic with the 1e-6 det floor,
// 3-sigma radius, the exact q <= q_cut axis extents, the [N+1, 16] feature
// row, M packed keys (tile << id_bits) | row with dead slots at INT32_MAX,
// and the (trunc, live) counts.
//
// Bound on the H100: bytes. At N = 10,000 and M = 9 a launch reads 28-32 B
// and writes 64 + 4M + 8 B per row, about 1.4 MB (0.4 us at 3.35 TB/s),
// against about 2M FP32 slots (0.06 us); K7 at B frames moves B times that.
// K6a/K6b add sincosf (and K6b expf) to a row: about 2.4M slots, still
// under the byte time. The time is latency: 10,001 rows are fewer than a
// warp for each of the card's schedulers, so a launch takes about a load's
// round trip plus one row's instruction stream.
//
// Design, one for all five fronts, as K10's (splat_prep3d.cu): CTAs of
// kStagedRows = 64 rows, so that 10,001 rows cover every SM (157 CTAs;
// CTAs of 256 rows would leave 92 of the 132 idle). Each CTA brings its
// rows' inputs to shared memory with 16-byte loads over each array's span
// (RowStage; the one- and three-float widths, K5's Cholesky factors and
// colors, K6b's rotation and colors, K6a's rotation codes, read back a
// value at a time, conflict-free at strides 1 and 3), every load issued
// before any store; the quantizer tables and combined codebooks of K4, K6a
// and K7 go to shared memory beside them, so that a row's color is a
// shared-memory read. K7's 64 rows span at most two frames where a frame
// holds 64 rows or more, and it stages both frames' tables; its small-frame
// variant (test scenes) reads them through the cache. The rows leave
// through pack_bin_staged: a warp's 32 feature rows as 2 KB of consecutive
// float4s, so that each warp store is contiguous. The fronts take row inputs that start on 16 bytes (the wrappers check).
// rs_cov reduces the angle once for its cosine and sine (sincosf), and every
// front bins with the exact reciprocal of its power-of-two tile side. No
// atomics; the counts go out per row and the caller sums them, so a run is
// deterministic.

#include <cuda_runtime.h>

#include "splat_prep_common.cuh"

namespace {

using namespace sprep;

// K5: rows staged as K4's are (RowStage), then the staged tail. chol
// [N, 3] before the bound.
__global__ void __launch_bounds__(kStagedRows)
splat_prep_raw_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ chol,
                      const float* __restrict__ colors, float b0, float b1,
                      float b2, Geom g, float* __restrict__ feat,
                      int* __restrict__ keys, int* __restrict__ stats) {
  using Mean = RowStage<float, 2>;
  using Tri = RowStage<float, 3>;
  __shared__ __align__(16) float s_xyz[Mean::kSize];
  __shared__ __align__(16) float s_chol[Tri::kSize];
  __shared__ __align__(16) float s_col[Tri::kSize];
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  {
    Mean m;
    Tri l, c;
    m.load(xyz, r0, rows, t);
    l.load(chol, r0, rows, t);
    c.load(colors, r0, rows, t);
    m.store(s_xyz, t);
    l.store(s_chol, t);
    c.store(s_col, t);
  }
  __syncthreads();
  // every thread runs to the end (pack_bin_staged is warp-collective);
  // rows past N read zeros and store nothing but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  float mean[2], ch[3], col[3];
  Mean::read(s_xyz, t, mean);
  Tri::read(s_chol, t, ch);
  Tri::read(s_col, t, col);
  const float mx = tanhf(mean[0]);
  const float my = tanhf(mean[1]);
  const float l11 = __fadd_rn(ch[0], b0);
  const float l21 = __fadd_rn(ch[1], b1);
  const float l22 = __fadd_rn(ch[2], b2);
  const Splat sp = project_head<false>(
      mx, my, __fmul_rn(l11, l11), __fmul_rn(l11, l21),
      __fadd_rn(__fmul_rn(l21, l21), __fmul_rn(l22, l22)), g, Band{});
  pack_bin_staged<false>(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                         Band{}, s_feat[t / 32], feat, keys, stats);
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
  pack_bin_staged<false>(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                         Band{}, s_feat[t / 32], feat, keys, stats);
}

// K7: K4 over frames. g.N = B * n_per rows, g.H the frame's height,
// g.tiles_y the canvas's tile rows (B * rows_pf). scale and beta are
// [B, 3], embed [B * 64, 3]. Rows staged as K4's; row r is of frame
// r / n_per, the sentinel and rows past N of the last frame (their outputs
// do not read it). kTables (n_per >= kStagedRows): the CTA's rows span the
// frames f_lo and f_hi <= f_lo + 1, whose scale and beta and combined
// codebooks it stages in shared memory (slot f - f_lo); else each row
// reads its frame's through the cache. Each row then bins under its
// frame's band.
template <bool kTables>
__global__ void __launch_bounds__(kStagedRows)
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
  using Mean = RowStage<float, 2>;
  using Code = RowStage<int, 3>;
  using Idx = RowStage<int, 2>;
  constexpr int kTable = 64 * 3;  // a combined codebook's floats
  constexpr int kPer = kTable / kStagedRows;  // 3 a frame
  constexpr int kSlots = kTables ? 2 : 1;
  static_assert(kTable % kStagedRows == 0, "a codebook in whole rounds");
  __shared__ __align__(16) float s_xyz[Mean::kSize];
  __shared__ __align__(16) int s_codes[Code::kSize];
  __shared__ __align__(16) int s_idx[Idx::kSize];
  __shared__ float s_embed[kSlots][kTable];
  __shared__ float s_sb[kSlots][6];  // scale, then beta
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  const int f_lo = min(r0, g.N - 1) / n_per;
  const bool two = min(r0 + kStagedRows - 1, g.N - 1) >= (f_lo + 1) * n_per;
  {
    Mean m;
    Code c;
    Idx x;
    [[maybe_unused]] float e[kSlots][kPer], sb = 0.0f;
    m.load(xyz, r0, rows, t);
    c.load(codes, r0, rows, t);
    x.load(idx, r0, rows, t);
    if constexpr (kTables) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          e[s][k] = s == 0 || two
                        ? __ldg(embed + kTable * (f_lo + s) + t +
                                k * kStagedRows)
                        : 0.0f;
      // thread t < 12: value t % 6 of slot t / 6
      const int f = f_lo + (t >= 6);
      const int j = t % 6;
      if (t < 6 || (t < 12 && two))
        sb = __ldg(j < 3 ? scale + 3 * f + j : beta + 3 * f + (j - 3));
    }
    m.store(s_xyz, t);
    c.store(s_codes, t);
    x.store(s_idx, t);
    if constexpr (kTables) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          s_embed[s][t + k * kStagedRows] = e[s][k];
      if (t < 12) s_sb[t / 6][t % 6] = sb;
    }
  }
  __syncthreads();
  // every thread runs to the end (pack_bin_staged is warp-collective);
  // rows past N read zeros and store nothing but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  const int rr = min(r, g.N - 1);
  const int f = kTables ? f_lo + (rr >= (f_lo + 1) * n_per) : rr / n_per;
  float mean[2];
  int code[3], ix[2];
  Mean::read(s_xyz, t, mean);
  Code::read(s_codes, t, code);
  Idx::read(s_idx, t, ix);
  // indices outside the combined codebook read entry 0, as in K4
  int comb = ix[0] * 8 + ix[1];
  if (comb < 0 || comb >= 64) comb = 0;
  float sc[3], be[3], col[3];
  if constexpr (kTables) {
    const int slot = f - f_lo;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sc[i] = s_sb[slot][i];
      be[i] = s_sb[slot][3 + i];
      col[i] = s_embed[slot][3 * comb + i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sc[i] = __ldg(scale + 3 * f + i);
      be[i] = __ldg(beta + 3 * f + i);
      col[i] = __ldg(embed + kTable * f + 3 * comb + i);
    }
  }
  const float mx = tanhf(mean[0]);
  const float my = tanhf(mean[1]);
  const float l11 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[0], sc[0]), be[0]), b0);
  const float l21 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[1], sc[1]), be[1]), b1);
  const float l22 = __fadd_rn(
      __fadd_rn(__fmul_rn((float)code[2], sc[2]), be[2]), b2);
  // the frame's offset and band, as the JAX kernel forms them in f32 (exact
  // for these small whole numbers)
  const float ff = (float)f;
  const float lo = __fmul_rn(ff, (float)rows_pf);
  const Band band{__fmul_rn(ff, (float)g.H), lo,
                  __fadd_rn(lo, (float)(rows_pf - 1))};
  const Splat sp = project_head<true>(
      mx, my, __fmul_rn(l11, l11), __fmul_rn(l11, l21),
      __fadd_rn(__fmul_rn(l21, l21), __fmul_rn(l22, l22)), g, band);
  pack_bin_staged<true>(r, valid, sp, col[0], col[1], col[2], 1.0f, g, band,
                        s_feat[t / 32], feat, keys, stats);
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
  pack_bin_staged<false>(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                         Band{}, s_feat[t / 32], feat, keys, stats);
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
  pack_bin_staged<false>(r, valid, sp, col[0], col[1], col[2], 1.0f, g,
                         Band{}, s_feat[t / 32], feat, keys, stats);
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

int staged_blocks_for(int n_rows) {
  return (n_rows + kStagedRows - 1) / kStagedRows;
}

}  // namespace

// K5. xyz [N, 2], chol [N, 3], colors [N, 3] f32 (these three and feat
// 16-byte aligned); feat [N+1, 16] f32,
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
  splat_prep_raw_kernel<<<staged_blocks_for(g.n_rows), kStagedRows, 0,
                          stream>>>(xyz, chol, colors, b0, b1, b2, g, feat,
                                    keys, stats);
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

// K7. N = B * n_per rows: xyz [N, 2] f32, codes [N, 3] i32, idx [N, 2] i32
// (these three and feat 16-byte aligned), scale [B, 3], beta [B, 3],
// embed [B * 64, 3] f32; H the frame's height,
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
  // frames of 64 rows or more: a CTA's rows span at most two
  auto kernel = n_per >= kStagedRows ? splat_prep_decode_batch_kernel<true>
                                     : splat_prep_decode_batch_kernel<false>;
  kernel<<<staged_blocks_for(g.n_rows), kStagedRows, 0, stream>>>(
      xyz, codes, idx, scale, beta, embed, b0, b1, b2, n_per, rows_pf, g,
      feat, keys, stats);
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
