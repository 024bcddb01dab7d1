// Device code shared by the fused splat-prep kernels K4-K7 (splat_prep.cu)
// and K10 (splat_prep3d.cu): the conic and radius of a 2D covariance
// (conic_radius); the sum path's head, from a mean in NDC and a covariance
// to the pixel center, conic and binning extents (project_head); and the
// tail every front ends with, the packed feature row with its colors and
// opacity, the binning keys and the counts of one Gaussian (pack_bin).
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
constexpr int kThreads = 256;
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
// cosf and sinf, each product left to right, no contraction.
__device__ __forceinline__ void rs_cov(float sx, float sy, float theta,
                                       float& s11, float& s12, float& s22) {
  const float c = cosf(theta);
  const float s = sinf(theta);
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
  float q_cut;
};

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

// The tail of every front (JAX _pack_bin): row r's outputs feat[r] (16
// floats: x, y, conic, the three colors, the opacity, zero pad), its M keys
// keys[j * n_rows + r] (slot-major, as the JAX kernel lays them out) from
// the bbox half-extents rx, ry, and its counts stats[r] = trunc,
// stats[n_rows + r] = live instances. Rows r >= N (valid == false) write a
// zero row, dead keys and zero counts. kBand (K7 only) clips the tile rows
// to [band.lo, band.hi]; without it `band` is not read.
template <bool kBand>
__device__ __forceinline__ void pack_bin(
    int r, bool valid, const Splat& s, float c0, float c1, float c2,
    float opac, const Geom& g, Band band, float* __restrict__ feat,
    int* __restrict__ keys, int* __restrict__ stats) {
  const float x = s.x, y = s.y, rx = s.rx, ry = s.ry;
  // ---- the feature row -------------------------------------------------
  float4* row = reinterpret_cast<float4*>(feat + static_cast<size_t>(r) * kFW);
  if (valid) {
    row[0] = make_float4(x, y, s.ca, s.cb);
    row[1] = make_float4(s.cc, c0, c1, c2);
    row[2] = make_float4(opac, 0.0f, 0.0f, 0.0f);
  } else {
    row[0] = row[1] = row[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // ---- binning keys (_expand_instances + the packed key) ---------------
  const float tp = (float)g.tile_px;
  const float hx = (float)(g.tiles_x - 1);
  const float ly = kBand ? band.lo : 0.0f;
  const float hy = kBand ? band.hi : (float)(g.tiles_y - 1);
  const float x0 = fminf(fmaxf(floorf(__fdiv_rn(__fsub_rn(x, rx), tp)), 0.0f), hx);
  const float x1 = fminf(fmaxf(floorf(__fdiv_rn(__fadd_rn(x, rx), tp)), 0.0f), hx);
  const float y0 = fminf(fmaxf(floorf(__fdiv_rn(__fsub_rn(y, ry), tp)), ly), hy);
  const float y1 = fminf(fmaxf(floorf(__fdiv_rn(__fadd_rn(y, ry), tp)), ly), hy);
  const bool inside = valid && rx > 0.0f && ry > 0.0f &&
                      __fadd_rn(x, rx) >= 0.0f &&
                      __fsub_rn(x, rx) < (float)(g.tiles_x * g.tile_px) &&
                      __fadd_rn(y, ry) >= 0.0f &&
                      __fsub_rn(y, ry) < (float)(g.tiles_y * g.tile_px);
  // the spans are small whole numbers: float and int arithmetic agree
  const int span_w = inside ? (int)x1 - (int)x0 + 1 : 1;
  const int area = inside ? span_w * ((int)y1 - (int)y0 + 1) : 0;
  const int n_live = area < g.M ? area : g.M;
  for (int j = 0; j < g.M; ++j) {
    int key = kIntMax;
    if (j < n_live) {
      const int jy = j / span_w;
      const int tile = ((int)y0 + jy) * g.tiles_x + ((int)x0 + (j - jy * span_w));
      key = (tile << g.id_bits) | r;
    }
    keys[static_cast<size_t>(j) * g.n_rows + r] = key;
  }
  stats[r] = area > g.M ? area - g.M : 0;
  stats[g.n_rows + r] = n_live;
}

// K4-K7: the head, then the tail with opacity 1 (the Cholesky and RS
// models' fixed opacity).
template <bool kBand>
__device__ __forceinline__ void project_pack_bin(
    int r, bool valid, float mx, float my, float s11, float s12, float s22,
    float c0, float c1, float c2, const Geom& g, Band band,
    float* __restrict__ feat, int* __restrict__ keys,
    int* __restrict__ stats) {
  pack_bin<kBand>(r, valid, project_head<kBand>(mx, my, s11, s12, s22, g, band),
                  c0, c1, c2, 1.0f, g, band, feat, keys, stats);
}

}  // namespace sprep
