// K10: the fused 3DGS splat prep for Hopper (sm_90a), one pass from a 3D
// Gaussian's raw parameters to its blend feature row, its binning keys and
// its counts.
//
// K10 splat_prep_blend3d replaces
// gaussianimage_tpu/ops/splat_prep3d.py::_blend3d_prep_kernel (:89), with
// its SH evaluation _sh_eval (:45): the 3DGS serving render's front, over
// rows already in depth order,
//   q = quat / max(|q|, 1e-30), R(q), Sigma3D = (R S)(R S)^T, S = diag(exp s);
//   t = W x + t_view, tz = max(t2, clip_near), (px, py) = f t01 / tz + c;
//   cov2d = J W Sigma W^T J^T + 0.3 I, the conic and the 3-sigma radius
//   (zero behind the near plane) through splat_prep_common.cuh's
//   conic_radius;
//   rgb = max(SH(degree, normalised x - origin) + 0.5, 0), or sigmoid of the
//   DC row at degree 0; opacity = sigmoid(logit) (torch_sigmoid);
// then splat_prep_common.cuh's tail with the isotropic bbox rx = ry =
// radius (the blend kernel has no q_cut gate): the feature row (x, y, conic,
// rgb, opacity), M packed keys (tile << id_bits) | row with dead slots at
// INT32_MAX, and the (trunc, live) counts. The row index is the rank in
// depth order, so each tile's window comes out depth-sorted.
//
// Arithmetic: the JAX kernel's expression in its term order, each product,
// sum and quotient rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction), with expf, floorf and ceilf,
// so the plain version (ops/splat_prep3d.py) agrees bit for bit on the
// card. The SH constants are the JAX package's doubles rounded to float, as
// a Python float meets a float32 array there and a float32 tensor here.
//
// The camera (20 floats: the view rotation and translation, fx, fy, cx, cy,
// the SH origin, clip_near) is passed by value. sh_degree is a template
// parameter over 0-4: K = (degree + 1)^2 coefficients per channel, read
// basis-major from a [N, 3K] row.
//
// Bound on the H100: bytes. At sh_degree 3 and M = 12 a row reads 236 B
// (xyz, scales, quaternion, opacity, 48 coefficients) and writes 64 + 4M + 8
// = 120 B: 3.56 MB over 10,001 rows, 1.06 us at 3.35 TB/s, against ~640
// FP32 issue slots a row (0.19 us). The time is latency: 10,001 rows are
// fewer than one warp for each of the card's 528 schedulers, so a launch
// takes about a load's round trip plus the instruction stream of one row
// (16 IEEE divisions with their slow-path branches, four expf, the SH)
// issued by a lone warp.
//
// Design: a CTA of kThreads3d = 128 threads on kStagedRows = 64 rows, so
// that 10,001 rows make 157 CTAs and every SM works (256-thread CTAs of
// one row a thread left 92 of the 132 idle), and each row's work is split
// between two warp groups (see the kernel): the colors run beside the
// projection instead of after it. Each group brings its inputs' rows to
// shared memory with splat_prep_common.cuh's RowStage (every load issued
// before any is used, 16-byte vectors over the rows' contiguous span; each
// thread then reads its row without bank conflicts), where one thread a
// row read a 192-byte SH row a float at a time, 32 lines a warp load. The
// rows leave through pack_bin_staged: 2 KB of contiguous feature rows a
// warp. No atomics; the counts go out per row and the caller sums them.
// The JAX kernel's [1, blk] lane layout and its 512-row block cap fit the
// TPU's vector lanes and VMEM; neither carries over.

#include <cuda_runtime.h>

#include "splat_prep_common.cuh"

namespace {

using namespace sprep;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a0 * b0 + a1 * b1 + a2 * b2, left to right
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// The view: rotation W (row major) and translation, the intrinsics, the SH
// origin (the camera's translation) and the near plane.
struct Cam {
  float w00, w01, w02, w10, w11, w12, w20, w21, w22;
  float tv0, tv1, tv2, fx, fy, cx, cy, ox, oy, oz, clip_near;
};

// core/sh.py's constants, scalars (a constexpr array is not usable in
// device code)
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC2_0 = static_cast<float>(1.0925484305920792);
constexpr float kC2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_2 = static_cast<float>(0.31539156525252005);
constexpr float kC2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_4 = static_cast<float>(0.5462742152960396);
constexpr float kC3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kC3_1 = static_cast<float>(2.890611442640554);
constexpr float kC3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_3 = static_cast<float>(0.3731763325901154);
constexpr float kC3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_5 = static_cast<float>(1.445305721320277);
constexpr float kC3_6 = static_cast<float>(-0.5900435899266435);
constexpr float kC4_0 = static_cast<float>(2.5033429417967046);
constexpr float kC4_1 = static_cast<float>(-1.7701307697799304);
constexpr float kC4_2 = static_cast<float>(0.9461746957575601);
constexpr float kC4_3 = static_cast<float>(-0.6690465435572892);
constexpr float kC4_4 = static_cast<float>(0.10578554691520431);
constexpr float kC4_5 = static_cast<float>(-0.6690465435572892);
constexpr float kC4_6 = static_cast<float>(0.47308734787878004);
constexpr float kC4_7 = static_cast<float>(-1.7701307697799304);
constexpr float kC4_8 = static_cast<float>(0.6258357354491761);

// The SH basis factors f[b] at the unit direction (x, y, z), b >= 1, so
// that _sh_eval's term b is f[b] * cf(b): each factor is the expression's
// left part, rounded as Python evaluates it (C * x * y * cf = ((C x) y) cf).
template <int kDeg>
__device__ __forceinline__ void sh_factors(float x, float y, float z,
                                           float* f) {
  if constexpr (kDeg >= 1) {
    f[1] = mul(kC1, y);  // subtracted
    f[2] = mul(kC1, z);
    f[3] = mul(kC1, x);  // subtracted
  }
  if constexpr (kDeg >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    f[4] = mul(kC2_0, xy);
    f[5] = mul(kC2_1, yz);
    f[6] = mul(kC2_2, sub(sub(mul(2.0f, zz), xx), yy));
    f[7] = mul(kC2_3, xz);
    f[8] = mul(kC2_4, sub(xx, yy));
    if constexpr (kDeg >= 3) {
      f[9] = mul(mul(kC3_0, y), sub(mul(3.0f, xx), yy));
      f[10] = mul(mul(kC3_1, xy), z);
      f[11] = mul(mul(kC3_2, y), sub(sub(mul(4.0f, zz), xx), yy));
      f[12] = mul(mul(kC3_3, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      f[13] = mul(mul(kC3_4, x), sub(sub(mul(4.0f, zz), xx), yy));
      f[14] = mul(mul(kC3_5, z), sub(xx, yy));
      f[15] = mul(mul(kC3_6, x), sub(xx, mul(3.0f, yy)));
    }
    if constexpr (kDeg >= 4) {
      f[16] = mul(mul(kC4_0, xy), sub(xx, yy));
      f[17] = mul(mul(kC4_1, yz), sub(mul(3.0f, xx), yy));
      f[18] = mul(mul(kC4_2, xy), sub(mul(7.0f, zz), 1.0f));
      f[19] = mul(mul(kC4_3, yz), sub(mul(7.0f, zz), 3.0f));
      f[20] = mul(kC4_4, add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f));
      f[21] = mul(mul(kC4_5, xz), sub(mul(7.0f, zz), 3.0f));
      f[22] = mul(mul(kC4_6, sub(xx, yy)), sub(mul(7.0f, zz), 1.0f));
      f[23] = mul(mul(kC4_7, xz), sub(xx, mul(3.0f, yy)));
      f[24] = mul(kC4_8, sub(mul(xx, sub(xx, mul(3.0f, yy))),
                              mul(yy, sub(mul(3.0f, xx), yy))));
    }
  }
}

// One channel of _sh_eval: C0 cf(0), then the terms in order (degree 1's
// first and third subtracted), with cf(b) = cf[3 b].
template <int kDeg>
__device__ __forceinline__ float sh_channel(const float* f, const float* cf) {
  constexpr int K = (kDeg + 1) * (kDeg + 1);
  float res = mul(kC0, cf[0]);
  if constexpr (kDeg >= 1) {
    res = sub(res, mul(f[1], cf[3]));
    res = add(res, mul(f[2], cf[6]));
    res = sub(res, mul(f[3], cf[9]));
  }
#pragma unroll
  for (int b = 4; b < K; ++b) res = add(res, mul(f[b], cf[3 * b]));
  return res;
}

// One row's projection (camera3d.project_gaussians): the normalised
// quaternion's rotation, Sigma3D, the view transform and perspective,
// cov2d = J W Sigma W^T J^T + 0.3 I, its conic and 3-sigma radius (zero
// behind the near plane); x3, y3, z3 the mean, scl the log scales.
__device__ __forceinline__ Splat project3d(float x3, float y3, float z3,
                                           const float (&scl)[3],
                                           const float (&qt)[4],
                                           const Cam& cam) {
  // quat -> rotation, normalised (camera3d.quat_to_rotmat)
  float w = qt[0], qx = qt[1], qy = qt[2], qz = qt[3];
  const float qn = fmaxf(
      __fsqrt_rn(add(add(add(mul(w, w), mul(qx, qx)), mul(qy, qy)),
                     mul(qz, qz))),
      1e-30f);
  w = dvd(w, qn);
  qx = dvd(qx, qn);
  qy = dvd(qy, qn);
  qz = dvd(qz, qn);
  const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  const float r01 = mul(2.0f, sub(mul(qx, qy), mul(w, qz)));
  const float r02 = mul(2.0f, add(mul(qx, qz), mul(w, qy)));
  const float r10 = mul(2.0f, add(mul(qx, qy), mul(w, qz)));
  const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  const float r12 = mul(2.0f, sub(mul(qy, qz), mul(w, qx)));
  const float r20 = mul(2.0f, sub(mul(qx, qz), mul(w, qy)));
  const float r21 = mul(2.0f, add(mul(qy, qz), mul(w, qx)));
  const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));

  // Sigma3D = (R S)(R S)^T
  const float s0 = expf(scl[0]);
  const float s1 = expf(scl[1]);
  const float s2 = expf(scl[2]);
  const float m00 = mul(r00, s0), m01 = mul(r01, s1), m02 = mul(r02, s2);
  const float m10 = mul(r10, s0), m11 = mul(r11, s1), m12 = mul(r12, s2);
  const float m20 = mul(r20, s0), m21 = mul(r21, s1), m22 = mul(r22, s2);
  const float c00 = dot3(m00, m00, m01, m01, m02, m02);
  const float c01 = dot3(m00, m10, m01, m11, m02, m12);
  const float c02 = dot3(m00, m20, m01, m21, m02, m22);
  const float c11 = dot3(m10, m10, m11, m11, m12, m12);
  const float c12 = dot3(m10, m20, m11, m21, m12, m22);
  const float c22 = dot3(m20, m20, m21, m21, m22, m22);

  // the camera transform and the perspective
  const float t0 = add(dot3(x3, cam.w00, y3, cam.w01, z3, cam.w02), cam.tv0);
  const float t1 = add(dot3(x3, cam.w10, y3, cam.w11, z3, cam.w12), cam.tv1);
  const float t2 = add(dot3(x3, cam.w20, y3, cam.w21, z3, cam.w22), cam.tv2);
  const float tz = fmaxf(t2, cam.clip_near);
  const bool in_front = t2 > cam.clip_near;
  Splat s;
  s.x = add(dvd(mul(cam.fx, t0), tz), cam.cx);
  s.y = add(dvd(mul(cam.fy, t1), tz), cam.cy);

  // cov2d = J W Sigma W^T J^T + 0.3 I, in the JAX kernel's term order
  const float tzz = mul(tz, tz);
  const float j00 = dvd(cam.fx, tz);
  const float j02 = dvd(mul(-cam.fx, t0), tzz);
  const float j11 = dvd(cam.fy, tz);
  const float j12 = dvd(mul(-cam.fy, t1), tzz);
  const float jw00 = add(mul(j00, cam.w00), mul(j02, cam.w20));
  const float jw01 = add(mul(j00, cam.w01), mul(j02, cam.w21));
  const float jw02 = add(mul(j00, cam.w02), mul(j02, cam.w22));
  const float jw10 = add(mul(j11, cam.w10), mul(j12, cam.w20));
  const float jw11 = add(mul(j11, cam.w11), mul(j12, cam.w21));
  const float jw12 = add(mul(j11, cam.w12), mul(j12, cam.w22));
  const float u0 = dot3(c00, jw00, c01, jw01, c02, jw02);
  const float u1 = dot3(c01, jw00, c11, jw01, c12, jw02);
  const float u2 = dot3(c02, jw00, c12, jw01, c22, jw02);
  const float v0 = dot3(c00, jw10, c01, jw11, c02, jw12);
  const float v1 = dot3(c01, jw10, c11, jw11, c12, jw12);
  const float v2 = dot3(c02, jw10, c12, jw11, c22, jw12);
  const float low_pass = static_cast<float>(0.3);
  const float s11 = add(dot3(jw00, u0, jw01, u1, jw02, u2), low_pass);
  const float s12 = dot3(jw10, u0, jw11, u1, jw12, u2);
  const float s22 = add(dot3(jw10, v0, jw11, v1, jw12, v2), low_pass);
  float radii;
  conic_radius(s11, s12, s22, s.ca, s.cb, s.cc, radii);
  s.rx = s.ry = in_front ? radii : 0.0f;
  return s;
}

// One row's colors and opacity: SH at the view direction + 0.5 clamped at
// 0, or sigmoid of the DC row at degree 0; sigmoid of the opacity logit.
template <int kDeg>
__device__ __forceinline__ float4 colors3d(float x3, float y3, float z3,
                                           const float* cf, float logit,
                                           const Cam& cam) {
  float rgb[3];
  if constexpr (kDeg > 0) {
    const float vx = sub(x3, cam.ox), vy = sub(y3, cam.oy),
                vz = sub(z3, cam.oz);
    const float vn = fmaxf(
        __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz))), 1e-30f);
    constexpr int K = (kDeg + 1) * (kDeg + 1);
    float f[K];
    sh_factors<kDeg>(dvd(vx, vn), dvd(vy, vn), dvd(vz, vn), f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = fmaxf(add(sh_channel<kDeg>(f, cf + c), 0.5f), 0.0f);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = torch_sigmoid(cf[c]);
  }
  return make_float4(rgb[0], rgb[1], rgb[2], torch_sigmoid(logit));
}

// Two groups of kStagedRows threads, warp-uniform, on the CTA's rows:
// group 0 (warps 0-1) stages xyz, scaling and the quaternion and projects
// each row; group 1 (warps 2-3) stages the opacity and the SH coefficients
// and computes each row's colors and opacity, which it hands over in
// shared memory; group 0 then stores the rows through the staged tail.
constexpr int kThreads3d = 2 * kStagedRows;

template <int kDeg>
__global__ void __launch_bounds__(kThreads3d)
splat_prep_blend3d_kernel(const float* __restrict__ xyz,
                          const float* __restrict__ scaling,
                          const float* __restrict__ quat,
                          const float* __restrict__ opac,
                          const float* __restrict__ coeffs, Cam cam, Geom g,
                          float* __restrict__ feat, int* __restrict__ keys,
                          int* __restrict__ stats) {
  constexpr int K = (kDeg + 1) * (kDeg + 1);
  using Vec3 = RowStage<float, 3>;
  using Quat = RowStage<float, 4>;
  using Opac = RowStage<float, 1>;
  using Coef = RowStage<float, 3 * K>;
  __shared__ __align__(16) float s_xyz[Vec3::kSize];
  __shared__ __align__(16) float s_scl[Vec3::kSize];
  __shared__ __align__(16) float s_quat[Quat::kSize];
  __shared__ __align__(16) float s_opac[Opac::kSize];
  __shared__ __align__(16) float s_cf[Coef::kSize];
  __shared__ float4 s_col[kStagedRows];  // rgb, opacity
  __shared__ float4 s_feat[kStagedRows / 32][128];
  const int t = threadIdx.x % kStagedRows;  // the row in the CTA
  const bool colors = threadIdx.x >= kStagedRows;
  const int r0 = blockIdx.x * kStagedRows;
  const int rows = min(kStagedRows, g.N - r0);
  if (colors) {
    Opac o;
    Coef c;
    o.load(opac, r0, rows, t);
    c.load(coeffs, r0, rows, t);
    o.store(s_opac, t);
    c.store(s_cf, t);
  } else {
    Vec3 a, b;
    Quat q;
    a.load(xyz, r0, rows, t);
    b.load(scaling, r0, rows, t);
    q.load(quat, r0, rows, t);
    a.store(s_xyz, t);
    b.store(s_scl, t);
    q.store(s_quat, t);
  }
  __syncthreads();
  // rows past N read zeros; group 0 runs to the end (pack_bin_staged is
  // warp-collective) and stores nothing for them but the sentinel's zeros
  const int r = r0 + t;
  const bool valid = r < g.N;
  float pos[3];
  Vec3::read(s_xyz, t, pos);
  Splat s;
  if (colors) {
    float cf[3 * K], op[1];
    Coef::read(s_cf, t, cf);
    Opac::read(s_opac, t, op);
    s_col[t] = colors3d<kDeg>(pos[0], pos[1], pos[2], cf, op[0], cam);
  } else {
    float scl[3], qt[4];
    Vec3::read(s_scl, t, scl);
    Quat::read(s_quat, t, qt);
    s = project3d(pos[0], pos[1], pos[2], scl, qt, cam);
  }
  __syncthreads();
  if (colors) return;
  const float4 col = s_col[t];
  pack_bin_staged<false>(r, valid, s, col.x, col.y, col.z, col.w, g,
                         Band{}, s_feat[t / 32], feat, keys, stats);
}

}  // namespace

// K10. xyz [N, 3], scaling [N, 3] (log scales), quat [N, 4], opac [N, 1]
// (logits), coeffs [N, 3K] f32 basis-major, all in depth order and 16-byte
// aligned; the camera's 20 floats; feat [N+1, 16] f32 (16-byte aligned),
// keys [M, N+1] i32, stats [2, N+1] i32; all device pointers. Launches on
// `stream` and returns the launch's cudaError_t (0 = success;
// cudaErrorInvalidValue for a degree outside 0-4 or a tile_px that is not a
// power of two).
extern "C" int splat_prep_blend3d(
    const float* xyz, const float* scaling, const float* quat,
    const float* opac, const float* coeffs, int N, int H, int W, int tile_px,
    int tiles_x, int tiles_y, int M, int id_bits, int sh_degree, float w00,
    float w01, float w02, float w10, float w11, float w12, float w20,
    float w21, float w22, float tv0, float tv1, float tv2, float fx, float fy,
    float cx, float cy, float ox, float oy, float oz, float clip_near,
    float* feat, int* keys, int* stats, cudaStream_t stream) {
  if (!geom_ok(N, M, tile_px)) return static_cast<int>(cudaErrorInvalidValue);
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
  g.q_cut = 0.0f;  // the sum path's gate: unused here
  g.inv_tile = 1.0f / (float)tile_px;
  const Cam cam{w00, w01, w02, w10, w11, w12, w20, w21, w22, tv0,
                tv1, tv2, fx,  fy,  cx,  cy,  ox,  oy,  oz,  clip_near};
  const int blocks = (g.n_rows + kStagedRows - 1) / kStagedRows;
#define K10_LAUNCH(D)                                                     \
  splat_prep_blend3d_kernel<D><<<blocks, kThreads3d, 0, stream>>>(        \
      xyz, scaling, quat, opac, coeffs, cam, g, feat, keys, stats)
  switch (sh_degree) {
    case 0: K10_LAUNCH(0); break;
    case 1: K10_LAUNCH(1); break;
    case 2: K10_LAUNCH(2); break;
    case 3: K10_LAUNCH(3); break;
    case 4: K10_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K10_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
