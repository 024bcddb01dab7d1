// Device code shared by the fused splat-prep kernels K4-K7 (splat_prep.cu)
// and K10 (splat_prep3d.cu): the conic and radius of a 2D covariance
// (conic_radius); the sum path's head, from a mean in NDC and a covariance
// to the pixel center, conic and binning extents (project_head); and the
// tail every front ends with, the packed feature row with its colors and
// opacity, the binning keys and the counts of one Gaussian: its arithmetic
// (feat_row, bin_row, write_bins) and its store, pack_bin_staged (a warp's
// rows through shared memory); and RowStage, which brings a CTA's input
// rows to shared memory. Every front, K4-K7 and K10, stages its rows and
// ends with that tail.
// Counterpart of gaussianimage_tpu/ops/splat_prep.py _project_pack_bin
// (:61) and _pack_bin (:110), which replicate core/covariance.py,
// rasterize_sum._axis_radii and tiles._expand_instances; and the RS model's
// covariance (_rs_cov, :421) and angle activation.
//
// Arithmetic: the JAX expression, rounded op by op (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction, no fast math), with floorf and
// ceilf. The plain PyTorch versions (ops/splat_prep.py) and the port's
// generic path (core/covariance.py, ops/tiles.py) compute the same
// expressions one operator at a time, so all three agree bit for bit; one
// ulp of an extent would move a tile edge and flip a key.

#pragma once

#include <cuda_runtime.h>

namespace sprep {

constexpr int kFW = 16;                // floats per packed feature row
constexpr int kIntMax = 0x7fffffff;    // dead key slot
constexpr float kTwoPi = 6.28318530717958647692f;  // float(2 pi), as torch
                                                    // and JAX round it

// torch.sigmoid of a float32 tensor on CUDA: 1 / (1 + exp(-x)) in float,
// with expf and an IEEE division (ATen/native/cuda/
// UnarySpecialOpsKernel.cu, sigmoid_kernel_cuda), so that the RS angle
// sigmoid(r) * 2 pi agrees bit for bit with the plain version and the
// generic path on the card.
__device__ __forceinline__ float torch_sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The RS covariance Sigma = R(theta) diag(sx, sy)^2 R(theta)^T, as
// core/covariance.py's cov2d_from_scale_rot computes it: full-precision
// cosine and sine, each product left to right, no contraction. sincosf
// reduces the angle once for both and gives cosf's and sinf's values bit
// for bit (torch.cos / torch.sin on the card, which the plain versions
// call; chip_smoke.py holds K6a and K6b to them bit for bit).
__device__ __forceinline__ void rs_cov(float sx, float sy, float theta,
                                       float& s11, float& s12, float& s22) {
  float s, c;
  sincosf(theta, &s, &c);
  const float sx2 = __fmul_rn(sx, sx);
  const float sy2 = __fmul_rn(sy, sy);
  const float cc = __fmul_rn(c, c);
  const float ss = __fmul_rn(s, s);
  s11 = __fadd_rn(__fmul_rn(cc, sx2), __fmul_rn(ss, sy2));
  s12 = __fmul_rn(__fmul_rn(c, s), __fsub_rn(sx2, sy2));
  s22 = __fadd_rn(__fmul_rn(ss, sx2), __fmul_rn(cc, sy2));
}

// Static geometry of one prep launch. n_rows = N + 1: row N is the zero
// sentinel row the stream's dead slots read. H is the height the pixel
// mapping uses, tiles_y the tile rows of the whole canvas: the same image
// for K4 and K5, one frame and B frames stacked vertically for K7.
struct Geom {
  int N, n_rows, H, W, tile_px, tiles_x, tiles_y, M, id_bits;
  float q_cut, inv_tile;  // inv_tile = 1 / tile_px, exact (geom_ok)
};

// The launchers' test of a geometry: rows, key slots, and a power-of-two
// tile side, whose reciprocal is exact, so that bin_row's x * inv_tile is
// the float x / tile_px (both round the same exact quotient).
inline bool geom_ok(int N, int M, int tile_px) {
  return N >= 1 && M >= 1 && tile_px >= 1 && (tile_px & (tile_px - 1)) == 0;
}

// A row's place on K7's tall canvas: y_off shifts its pixel y into its
// frame, and its tile rows are clipped to the band [lo, hi] of that frame
// (tiles._expand_instances' band). The inside test stays against the whole
// canvas, as in the JAX kernel.
struct Band {
  float y_off, lo, hi;
};

// The conic (the 1e-6 det floor) and the 3-sigma radius of a 2D covariance:
// core/covariance.py's conic_from_cov2d and radius_from_cov2d, shared by
// the sum path's head (project_head) and the 3DGS front (K10).
__device__ __forceinline__ void conic_radius(float s11, float s12, float s22,
                                             float& ca, float& cb, float& cc,
                                             float& radii) {
  const float det = __fsub_rn(__fmul_rn(s11, s22), __fmul_rn(s12, s12));
  const float inv_det = __fdiv_rn(1.0f, fmaxf(det, 1e-6f));
  ca = __fmul_rn(s22, inv_det);
  cb = __fmul_rn(-s12, inv_det);
  cc = __fmul_rn(s11, inv_det);
  // radius_from_cov2d: ceil(3 * sqrt(lambda_max))
  const float mid = __fmul_rn(0.5f, __fadd_rn(s11, s22));
  const float disc =
      __fsqrt_rn(fmaxf(__fsub_rn(__fmul_rn(mid, mid), det), 0.0f));
  radii =
      ceilf(__fmul_rn(3.0f, __fsqrt_rn(fmaxf(__fadd_rn(mid, disc), 1e-12f))));
}

// One sum-path row after its pixel mapping and covariance: the pixel
// center, the conic and the binning half-extents.
struct Splat {
  float x, y, ca, cb, cc, rx, ry;
};

// The head of K4-K7 (JAX _project_pack_bin up to its _pack_bin call): the
// pixel mapping, then K7's frame offset under kBand; the conic and radius;
// the exact q <= q_cut axis extents, capped by the radius (_axis_radii).
template <bool kBand>
__device__ __forceinline__ Splat project_head(float mx, float my, float s11,
                                              float s12, float s22,
                                              const Geom& g, Band band) {
  Splat o;
  // pixel mapping: 0.5 * ((m + 1) * W - 1), then K7's frame offset
  o.x = __fmul_rn(
      0.5f, __fsub_rn(__fmul_rn(__fadd_rn(mx, 1.0f), (float)g.W), 1.0f));
  o.y = __fmul_rn(
      0.5f, __fsub_rn(__fmul_rn(__fadd_rn(my, 1.0f), (float)g.H), 1.0f));
  if (kBand) o.y = __fadd_rn(o.y, band.y_off);
  float radii;
  conic_radius(s11, s12, s22, o.ca, o.cb, o.cc, radii);
  const float cdet =
      fmaxf(__fsub_rn(__fmul_rn(o.ca, o.cc), __fmul_rn(o.cb, o.cb)), 1e-12f);
  const float rx =
      __fsqrt_rn(__fdiv_rn(__fmul_rn(g.q_cut, fmaxf(o.cc, 0.0f)), cdet));
  const float ry =
      __fsqrt_rn(__fdiv_rn(__fmul_rn(g.q_cut, fmaxf(o.ca, 0.0f)), cdet));
  const bool live = radii > 0.0f;
  o.rx = live ? fminf(rx, radii) : 0.0f;
  o.ry = live ? fminf(ry, radii) : 0.0f;
  return o;
}

// The tail of every front (JAX _pack_bin), in three parts. feat_row: row
// r's 16 floats (x, y, conic, the three colors, the opacity, zero pad; a
// zero row for rows r >= N, valid == false). bin_row: the tiles of the bbox
// of half-extents rx, ry. write_bins: its M keys keys[j * n_rows + r]
// (slot-major, as the JAX kernel lays them out; dead slots at INT32_MAX)
// and its counts stats[r] = trunc, stats[n_rows + r] = live instances.
// kBand (K7 only) clips the tile rows to [band.lo, band.hi]; without it
// `band` is not read.
__device__ __forceinline__ void feat_row(bool valid, const Splat& s, float c0,
                                         float c1, float c2, float opac,
                                         float4 (&v)[4]) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v[0] = valid ? make_float4(s.x, s.y, s.ca, s.cb) : zero;
  v[1] = valid ? make_float4(s.cc, c0, c1, c2) : zero;
  v[2] = valid ? make_float4(opac, 0.0f, 0.0f, 0.0f) : zero;
  v[3] = zero;
}

// A row's tiles: the first tile column and row of its bbox, the bbox's
// width in tiles, its live slots min(area, M) and the slots cut, area - M.
struct Bins {
  int x0, y0, span_w, n_live, trunc;
};

template <bool kBand>
__device__ __forceinline__ Bins bin_row(bool valid, const Splat& s,
                                        const Geom& g, Band band) {
  const float x = s.x, y = s.y, rx = s.rx, ry = s.ry;
  const float it = g.inv_tile;  // x * it == x / tile_px (geom_ok)
  const float hx = (float)(g.tiles_x - 1);
  const float ly = kBand ? band.lo : 0.0f;
  const float hy = kBand ? band.hi : (float)(g.tiles_y - 1);
  const float x0 = fminf(fmaxf(floorf(__fmul_rn(__fsub_rn(x, rx), it)), 0.0f), hx);
  const float x1 = fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(x, rx), it)), 0.0f), hx);
  const float y0 = fminf(fmaxf(floorf(__fmul_rn(__fsub_rn(y, ry), it)), ly), hy);
  const float y1 = fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(y, ry), it)), ly), hy);
  const bool inside = valid && rx > 0.0f && ry > 0.0f &&
                      __fadd_rn(x, rx) >= 0.0f &&
                      __fsub_rn(x, rx) < (float)(g.tiles_x * g.tile_px) &&
                      __fadd_rn(y, ry) >= 0.0f &&
                      __fsub_rn(y, ry) < (float)(g.tiles_y * g.tile_px);
  // the spans are small whole numbers: float and int arithmetic agree
  Bins b;
  b.x0 = (int)x0;
  b.y0 = (int)y0;
  b.span_w = inside ? (int)x1 - b.x0 + 1 : 1;
  const int area = inside ? b.span_w * ((int)y1 - b.y0 + 1) : 0;
  b.n_live = area < g.M ? area : g.M;
  b.trunc = area > g.M ? area - g.M : 0;
  return b;
}

// Slot j is the tile (y0 + j / span_w, x0 + j % span_w): counted along the
// row (jx) and down (tile_row), the same integers without a division.
__device__ __forceinline__ void write_bins(int r, const Bins& b, const Geom& g,
                                           int* __restrict__ keys,
                                           int* __restrict__ stats) {
  int jx = 0;
  int tile_row = b.y0 * g.tiles_x + b.x0;
  for (int j = 0; j < g.M; ++j) {
    keys[static_cast<size_t>(j) * g.n_rows + r] =
        j < b.n_live ? ((tile_row + jx) << g.id_bits) | r : kIntMax;
    if (++jx == b.span_w) {
      jx = 0;
      tile_row += g.tiles_x;
    }
  }
  stats[r] = b.trunc;
  stats[g.n_rows + r] = b.n_live;
}

// Rows (and threads) of a CTA of every front (K10: rows, two threads a row):
// 10,001 rows make 157 CTAs, more than the card's 132 SMs.
constexpr int kStagedRows = 64;

// The tail through shared memory, for the 32 lanes of a warp together, on
// rows r - lane .. r - lane + 31 (lane = r % 32): every lane of the warp
// calls it, rows r >= n_rows included, whose stores are masked. The rows
// go to `stage` (the warp's 128 float4s) as lane l's part k at 4 l + (k ^
// ((l >> 1) & 3)), then out as 2 KB of consecutive float4s, lane l storing
// float4s l, l + 32, l + 64 and l + 96 of the span: 512 contiguous bytes a
// warp store. The swizzle keeps both sides free of bank conflicts (each
// quarter-warp meets 8 distinct 16-byte bank groups). Each row bins under
// its own `band` (kBand, K7: its frame's); the others pass Band{}.
template <bool kBand>
__device__ __forceinline__ void pack_bin_staged(
    int r, bool valid, const Splat& s, float c0, float c1, float c2,
    float opac, const Geom& g, Band band, float4* __restrict__ stage,
    float* __restrict__ feat, int* __restrict__ keys,
    int* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  float4 v[4];
  feat_row(valid, s, c0, c1, c2, opac, v);
#pragma unroll
  for (int k = 0; k < 4; ++k) stage[4 * lane + (k ^ ((lane >> 1) & 3))] = v[k];
  __syncwarp();
  const int r0 = r - lane;
  float4* out = reinterpret_cast<float4*>(feat) + static_cast<size_t>(r0) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = lane + 32 * k;  // row q / 4 of the warp's, part q % 4
    const int row = q >> 2;
    if (r0 + row < g.n_rows)
      out[q] = stage[4 * row + ((q & 3) ^ ((row >> 1) & 3))];
  }
  if (r < g.n_rows)
    write_bins(r, bin_row<kBand>(valid, s, g, band), g, keys, stats);
}

// 8- and 16-byte vectors of a 4-byte type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V2 = float2;
  using V4 = float4;
};
template <>
struct Vec<int> {
  using V2 = int2;
  using V4 = int4;
};

// A CTA's rows [r0, r0 + kStagedRows) of a row-major [N, kW] array of
// 4-byte values, brought to shared memory (kSize values, 16-byte aligned)
// in two steps, so that a kernel issues every stage's loads before it
// stores any. load reads the rows' contiguous span as 16-byte vectors,
// consecutive threads on consecutive vectors (the span starts on a 16-byte
// boundary when src does: r0 is a multiple of 4); in a CTA short of rows it
// reads the ragged end a value at a time, and rows past N as zero. store
// puts vector q where it lands in row t's kPitch values. read gives thread
// t its row in registers, in the widest access that keeps a warp's reads on
// distinct banks: 16-byte vectors when kW is a multiple of 4, one 8-byte
// vector when kW = 2, else one value at a time (kW odd). The pitch is kW,
// or kW + 4 where kW / 4 is even (48: a row of 13 vectors), so that eight
// threads' 16-byte reads meet eight bank groups.
template <typename T, int kW>
struct RowStage {
  static_assert(kW % 2 == 1 || kW == 2 || kW % 4 == 0, "a staged row width");
  using V2 = typename Vec<T>::V2;
  using V4 = typename Vec<T>::V4;
  static constexpr bool kVecRows = kW % 4 == 0;
  static constexpr int kPitch = kVecRows && (kW / 4) % 2 == 0 ? kW + 4 : kW;
  static constexpr int kSize = kStagedRows * kPitch;
  static constexpr int kVecs = kStagedRows * kW / 4;  // of a whole CTA
  static constexpr int kIters = (kVecs + kStagedRows - 1) / kStagedRows;
  V4 v[kIters];

  // rows = min(kStagedRows, N - r0), at most 0 in a CTA of the sentinel
  // row alone; i in [0, kStagedRows), the thread's place in the group that
  // stages the array
  __device__ __forceinline__ void load(const T* __restrict__ src, int r0,
                                       int rows, int i) {
    const T* base = src + static_cast<size_t>(r0) * kW;
    const V4* vec = reinterpret_cast<const V4*>(base);
    if (rows == kStagedRows) {
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int q = i + k * kStagedRows;
        if (kVecs % kStagedRows == 0 || q < kVecs) v[k] = __ldg(vec + q);
      }
      return;
    }
    const int n = rows > 0 ? rows * kW : 0;
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int q = i + k * kStagedRows;
      if (4 * q + 4 <= n) {
        v[k] = __ldg(vec + q);
      } else {
        T a[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          a[c] = 4 * q + c < n ? base[4 * q + c] : T(0);
        v[k].x = a[0];
        v[k].y = a[1];
        v[k].z = a[2];
        v[k].w = a[3];
      }
    }
  }

  __device__ __forceinline__ void store(T* s, int i) const {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int q = i + k * kStagedRows;
      if (kVecs % kStagedRows == 0 || q < kVecs) {
        const int at = kPitch == kW
                           ? 4 * q
                           : q / (kW / 4) * kPitch + 4 * (q % (kW / 4));
        *reinterpret_cast<V4*>(s + at) = v[k];
      }
    }
  }

  static __device__ __forceinline__ void read(const T* s, int t,
                                              T (&out)[kW]) {
    const T* row = s + t * kPitch;
    if constexpr (kVecRows) {
#pragma unroll
      for (int i = 0; i < kW / 4; ++i) {
        const V4 x = reinterpret_cast<const V4*>(row)[i];
        out[4 * i] = x.x;
        out[4 * i + 1] = x.y;
        out[4 * i + 2] = x.z;
        out[4 * i + 3] = x.w;
      }
    } else if constexpr (kW == 2) {
      const V2 x = *reinterpret_cast<const V2*>(row);
      out[0] = x.x;
      out[1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) out[i] = row[i];
    }
  }
};

}  // namespace sprep
