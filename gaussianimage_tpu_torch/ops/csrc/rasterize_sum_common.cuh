// Device code shared by the accumulated-summation rasterizer kernels K1
// (rasterize_sum_fwd.cu), K2 and K3 (rasterize_sum_bwd.cu): the layout of
// a tile's pixels over a CTA's warps, the staging of a chunk of the
// instance stream in shared memory with each slot's cull, the quadratic
// form, gate and weight of one (instance, pixel) pair, and the forward walk
// of a tile's window. All three kernels stage and walk through these
// functions, so they visit the same pairs and make bit-identical gate
// decisions and weights, and K1 and K3 compute the same image bit for bit.
// Also shared with the alpha-blend kernels K8 / K9
// (rasterize_blend_common.cuh): a slot's row loaded into registers
// (load_slot), the per-slot cull rectangle (slot_cull) and the eight-term
// warp reduction (warp_sum8).
//
// Layout (Pixels, Geo<TILE>). The tile side TILE is 32 or 16, a template
// parameter of the layout, the staging and the walk. One CTA of TILE^2 / 4
// threads a tile (256 at 32, 64 at 16): TILE / 16 columns of warps, each
// warp w the 16 x 8 block at (16 (w % kWarpsX), 8 (w / kWarpsX)), four
// 8 x 4 patches; each of its threads owns one pixel of each patch j = jx +
// 2 jy, lane l at (l % 8, l / 8) of the patch. So a 32-pixel tile is 8
// warps in a 2 x 4 grid and a 16-pixel tile 2 warps in a column, with the
// same patch, warp block and per-thread work. The cull tests patches (the
// fewest pairs), and a warp reduces per slot once for its four patches
// (the fewest visits). A warp's store of one pixel index writes one
// 32-byte sector per patch row.
//
// The walk (stage_slots, warp_slots, forward_slots, walk_forward). Threads
// 0-63 stage a chunk of at most 64 slots from registers, each with its cull
// rectangle at q_cut (slot_cull) as a mask of the tile's patches (bit 4w +
// j: 32 bits at 32 pixels, 8 at 16), and load the next chunk's rows while
// the warps walk this
// one. Each warp ballots the slots whose mask meets its patches and walks
// only those, in stream order, and per slot only its patches in the mask:
// warp-uniform branches. A pair outside the rectangle fails the gate, so
// each pixel adds the same pairs in the same order as a walk of every pair.
//
// Two stream layouts (`Stream`), a template parameter kBlocks of the
// staging, the geometry and the walk: the flat stream, rows feat[gids[s]]
// and windows [starts[t], starts[t+1]); and the aligned stream, [NB, 16, 64]
// transposed blocks written by K11a (stream_blocks.cu) and windows
// [starts[t], starts[t] + counts[t]) with starts[t] a multiple of 64, so
// chunk ci of tile t is block starts[t] / 64 + ci. The chunk boundaries
// relative to a window's start are the same in both, and so is every
// pair's arithmetic: on the same instances the two give the same image and
// the same gradient rows bit for bit.
//
// Arithmetic: the JAX kernel's expression, rounded op by op (__fmul_rn,
// __fadd_rn: no FMA contraction) and expf, not __expf, so q and w are
// bit-equal to the plain PyTorch versions'. That matters at the q <= q_cut
// gate, where one ulp of q decides whether exp(-4.5) ~ 0.011 is added.
// The gate takes max(form, 0) as the JAX kernel's jnp.maximum does: a
// negative form (a near-degenerate or indefinite conic) counts as q = 0,
// and a NaN form stays NaN and fails q <= q_cut.
//
// The cull (slot_cull, mirrored op for op by rasterize_sum.py's
// slot_cull_plain). Per staged slot, the tile-local pixel rectangle that
// holds every pixel whose computed form can reach a gate qc: K1-K3 take qc
// = q_cut, K8 / K9 qc = 2 log(o / alpha_min) + kQMargin. A pair outside
// it fails the gate, so skipping it leaves every pixel's sum as it was.
// The rectangle bounds the ellipse a dx^2 + 2b dx dy + c dy^2 <= Q, half
// extents sqrt(Q c / det) and sqrt(Q a / det) with det = ac - b^2, for Q
// = qc / (1 - 2e-6 kappa), kappa = ac / det: the float32 form rounds each
// of its three terms and two sums, which moves q by at most 24 u kappa F
// (u = 2^-24) at a point where the exact form is F, so Q covers every
// pixel whose computed form is <= qc (a form that rounds below 0 needs
// kappa > 1 / (24 u) ~ 7e5, above the whole-tile limit below). The half
// extents are then padded by a relative 1e-3 and one pixel. The rectangle
// is computed in double (the products of two floats are exact there). A
// row with a NaN (center, conic) or a qc that is NaN or negative takes no
// pixel (its pairs compare false at the gate, as in the plain versions); a
// row that is not positive definite (det <= 0 or a <= 0), holds an
// infinity or has kappa above 2.5e5 takes the whole tile.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gsum {

constexpr int kPixels = 4;                          // a thread's, one per patch
constexpr int kBK = 64;                             // instances per chunk
constexpr int kFW = 16;                             // floats per feature row
constexpr int kC = 4;                               // rgb + alpha
constexpr int kPatchW = 8;  // a patch: 8 columns x 4 rows, one pixel a lane
constexpr int kPatchH = 4;

// A tile of TILE x TILE pixels over its CTA: kWarps warps of 16 x 8 pixel
// blocks, kWarpsX of them across the tile, four pixels a thread.
template <int TILE>
struct Geo {
  static_assert(TILE == 16 || TILE == 32, "K1-K3 are built for 16 and 32");
  static constexpr int kTile = TILE;
  static constexpr int kWarpsX = TILE / (2 * kPatchW);                  // 2 or 1
  static constexpr int kWarps = kWarpsX * TILE / (2 * kPatchH);         // 8 or 2
  static constexpr int kThreads = 32 * kWarps;                          // 256 or 64
  // K2 / K3's CTAs a SM (__launch_bounds__): 768 threads either way, which
  // caps a thread at 85 registers
  static constexpr int kMinBlocks = 768 / kThreads;                     // 3 or 12
  static_assert(kThreads * kPixels == TILE * TILE, "four pixels a thread");
  static_assert(kThreads >= kBK, "threads 0-63 stage a chunk");
  static_assert(4 * kWarps <= 32, "a slot's patch mask fits 32 bits");
};

// The stream a kernel walks. Flat: feat [n_rows, 16], gids [I], starts
// [T+1]; counts and blocks unused. Aligned: blocks [NB, 16, 64], starts
// [T+1] (multiples of 64) and counts [T]; feat and gids unused.
struct Stream {
  const float* feat;
  int n_rows;
  const int* gids;
  const float* blocks;
  const int* starts;
  const int* counts;
};

// Slot base + k's feature f is r[f * step]: a row feat[gids[s]] (step 1;
// out-of-range ids read the zero sentinel row n_rows-1), or lane k of the
// aligned stream's block base / 64 (step 64; base is a chunk's first slot,
// a multiple of 64 there).
template <bool kBlocks>
__device__ __forceinline__ const float* slot_features(const Stream& st, int base, int k,
                                                      int& step) {
  if (kBlocks) {
    step = kBK;
    return st.blocks + static_cast<size_t>(base / kBK) * (kFW * kBK) + k;
  }
  step = 1;
  int g = st.gids[base + k];
  if (g < 0 || g >= st.n_rows) g = st.n_rows - 1;
  return st.feat + static_cast<size_t>(g) * kFW;
}

// q = max(a dx^2 + 2b dx dy + c dy^2, 0) from the per-column terms
// adxdx = (a dx) dx and b2dx = (2b) dx, in the plain version's order. A
// NaN form stays NaN (fmaxf would return 0 and let the pair in with w = 1).
__device__ __forceinline__ float quad_form(float adxdx, float b2dx, float c,
                                           float dy) {
  const float q = __fadd_rn(__fadd_rn(adxdx, __fmul_rn(b2dx, dy)),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return q < 0.0f ? 0.0f : q;
}

// The pair's weight exp(-q/2), called only where q <= q_cut.
__device__ __forceinline__ float pair_weight(float q) {
  return expf(__fmul_rn(-0.5f, q));
}

// A slot's feature row in registers: center, conic (a, b, c) and the four
// features after them (K1-K3: o*r, o*g, o*b, o; K8 / K9: r, g, b, o).
struct SlotRow {
  float x, y, a, b, c, f[4];
};

// Slot base + k's row (slot_features: feat[gids[s]], or the aligned
// stream's blocks). A kernel loads a chunk's rows while its warps walk the
// chunk before it, so the loads' latency hides behind the walk.
template <bool kBlocks>
__device__ __forceinline__ SlotRow load_slot(const Stream& st, int base, int k) {
  int step;
  const float* r = slot_features<kBlocks>(st, base, k, step);
  SlotRow v;
  v.x = r[0];
  v.y = r[step];
  v.a = r[2 * step];
  v.b = r[3 * step];
  v.c = r[4 * step];
#pragma unroll
  for (int i = 0; i < 4; ++i) v.f[i] = r[(5 + i) * step];
  return v;
}

// On the flat stream, ask for the ids of slots base..base+n-1 to be
// brought into L1 a chunk before load_slot reads them, so that the row
// loads wait on no id.
template <bool kBlocks>
__device__ __forceinline__ void prefetch_ids(const Stream& st, int base, int n) {
  if (!kBlocks && static_cast<int>(threadIdx.x) < n)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(st.gids + base + threadIdx.x));
}

// The tile-local pixel rectangle [x0, x1] x [y0, y1] (empty: x0 > x1 or
// y0 > y1) a slot can reach under the gate qc (see the head of this file).
struct SlotCull {
  float qc;
  int x0, x1, y0, y1;
};

__device__ __forceinline__ SlotCull slot_cull(float gx, float gy, float a, float b,
                                              float c, float qc, int tile) {
  SlotCull r;
  r.qc = qc;
  r.x0 = r.y0 = tile;  // empty
  r.x1 = r.y1 = -1;
  const double X = gx, Y = gy, A = a, B = b, C = c, Q = qc;
  if (isnan(X) || isnan(Y) || isnan(A) || isnan(B) || isnan(C) || !(Q >= 0.0))
    return r;
  r.x0 = r.y0 = 0;  // the whole tile
  r.x1 = r.y1 = tile - 1;
  if (isinf(X) || isinf(Y) || isinf(A) || isinf(B) || isinf(C) || isinf(Q)) return r;
  // rounded op by op (no contraction), as slot_cull_plain computes it
  const double AC = __dmul_rn(A, C);
  const double det = __dsub_rn(AC, __dmul_rn(B, B));
  if (!(det > 0.0 && A > 0.0)) return r;
  const double e = __dmul_rn(2e-6, __ddiv_rn(AC, det));
  if (!(e < 0.5)) return r;
  const double Qp = __ddiv_rn(Q, __dsub_rn(1.0, e));
  const double rx =
      __dadd_rn(__dmul_rn(__dsqrt_rn(__ddiv_rn(__dmul_rn(Qp, C), det)), 1.001), 1.0);
  const double ry =
      __dadd_rn(__dmul_rn(__dsqrt_rn(__ddiv_rn(__dmul_rn(Qp, A), det)), 1.001), 1.0);
  const double lx = ceil(__dsub_rn(X, rx)), hx = floor(__dadd_rn(X, rx));
  const double ly = ceil(__dsub_rn(Y, ry)), hy = floor(__dadd_rn(Y, ry));
  r.x0 = lx > tile - 1 ? tile : (lx < 0.0 ? 0 : static_cast<int>(lx));
  r.x1 = hx < 0.0 ? -1 : (hx > tile - 1 ? tile - 1 : static_cast<int>(hx));
  r.y0 = ly > tile - 1 ? tile : (ly < 0.0 ? 0 : static_cast<int>(ly));
  r.y1 = hy < 0.0 ? -1 : (hy > tile - 1 ? tile - 1 : static_cast<int>(hy));
  return r;
}

// Eight per-lane values v[0..7] summed over the warp with 9 shuffles,
// where eight trees take 40: at each butterfly step a lane keeps the half
// of its values that its lane bit selects and adds its partner's copy of
// that half. Returns term (lane bits 4, 3, 2) of the eight, summed over
// all 32 lanes (the four lanes of a group hold the same sum); the order of
// the additions is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_sum8(const float* v, int lane, int& term) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (h16 ? v[i + 4] : v[i])
            + __shfl_xor_sync(0xffffffffu, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (h8 ? w4[i + 2] : w4[i])
            + __shfl_xor_sync(0xffffffffu, h8 ? w4[i] : w4[i + 2], 8);
  float w1 = (h4 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, h4 ? w2[0] : w2[1], 4);
  w1 += __shfl_xor_sync(0xffffffffu, w1, 2);
  w1 += __shfl_xor_sync(0xffffffffu, w1, 1);
  term = (h16 ? 4 : 0) + (h8 ? 2 : 0) + (h4 ? 1 : 0);
  return w1;
}

// The thread's pixels: j = jx + 2 jy at tile-local (X[jx], Y[jy]).
struct Pixels {
  int start, end;  // the tile's window of the stream
  float tx0, ty0;  // the tile's origin, pixels
  int x0, y0;      // the tile's origin, integer
  int warp, lane;
  float X[2], Y[2];
  bool inside[kPixels];  // pixel within H x W
};

template <int TILE, bool kBlocks>
__device__ __forceinline__ Pixels pixels_of(const Stream& st, int H, int W, int tiles_x) {
  using G = Geo<TILE>;
  Pixels p;
  const int t = blockIdx.x;
  p.x0 = (t % tiles_x) * TILE;
  p.y0 = (t / tiles_x) * TILE;
  p.tx0 = static_cast<float>(p.x0);
  p.ty0 = static_cast<float>(p.y0);
  p.start = st.starts[t];
  p.end = kBlocks ? p.start + st.counts[t] : st.starts[t + 1];
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  int lx[2], ly[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lx[i] = 2 * kPatchW * (p.warp % G::kWarpsX) + kPatchW * i + p.lane % kPatchW;
    ly[i] = 2 * kPatchH * (p.warp / G::kWarpsX) + kPatchH * i + p.lane / kPatchW;
    p.X[i] = static_cast<float>(lx[i]);
    p.Y[i] = static_cast<float>(ly[i]);
  }
#pragma unroll
  for (int j = 0; j < kPixels; ++j)
    p.inside[j] = p.x0 + lx[j & 1] < W && p.y0 + ly[j >> 1] < H;
  return p;
}

// Pixel j's offset py * W + px in an [H, W] plane (0 outside H x W).
__device__ __forceinline__ size_t pixel_index(const Pixels& p, int j, int W) {
  return p.inside[j] ? static_cast<size_t>(p.y0 + static_cast<int>(p.Y[j >> 1])) * W
                           + p.x0 + static_cast<int>(p.X[j & 1])
                     : 0;
}

// A staged chunk of at most kBK slots, as per-slot columns: tile-local
// center, conic (a, 2b, c), premultiplied color matrix (o*r, o*g, o*b, o)
// and the slot's patch mask (bit 4w + j: patch j of warp w meets the
// slot's cull rectangle).
struct Slots {
  float gx[kBK], gy[kBK], a[kBK], b2[kBK], c[kBK];
  float cm[kC][kBK];
  unsigned hit[kBK];
};

// Thread k < kBK stages slot k of the chunk (its row `v`, where k < n)
// with its patch mask; slots n..kBK-1 meet no patch. The caller
// synchronises before the chunk is read.
template <int TILE>
__device__ __forceinline__ void stage_slots(Slots& s, const SlotRow& v, int n, float tx0,
                                            float ty0, float q_cut) {
  using G = Geo<TILE>;
  const int k = threadIdx.x;
  if (k >= kBK) return;
  unsigned hit = 0;
  if (k < n) {
    const float gx = __fsub_rn(v.x, tx0);
    const float gy = __fsub_rn(v.y, ty0);
    s.gx[k] = gx;
    s.gy[k] = gy;
    s.a[k] = v.a;
    s.b2[k] = __fmul_rn(2.0f, v.b);
    s.c[k] = v.c;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) s.cm[ch][k] = v.f[ch];
    const SlotCull cl = slot_cull(gx, gy, v.a, v.b, v.c, q_cut, TILE);
    if (cl.x0 <= cl.x1 && cl.y0 <= cl.y1) {
      // the patch columns (0..TILE/8-1) and rows (0..TILE/4-1) the
      // rectangle meets
      const unsigned cols = (2u << (cl.x1 / kPatchW)) - (1u << (cl.x0 / kPatchW));
      const unsigned rows = (2u << (cl.y1 / kPatchH)) - (1u << (cl.y0 / kPatchH));
#pragma unroll
      for (int w = 0; w < G::kWarps; ++w) {
        const unsigned cb = (cols >> (2 * (w % G::kWarpsX))) & 3u;
        const unsigned rb = (rows >> (2 * (w / G::kWarpsX))) & 3u;
        hit |= (((rb & 1u) ? cb : 0u) | ((rb & 2u) ? cb << 2 : 0u)) << (4 * w);
      }
    }
  }
  s.hit[k] = hit;
}

// The warp's slots of the staged chunk: bit k set where slot k's mask
// meets one of the warp's patches.
__device__ __forceinline__ unsigned long long warp_slots(const Slots& s, int warp, int lane) {
  const unsigned lo = __ballot_sync(0xffffffffu, (s.hit[lane] >> (4 * warp)) & 0xFu);
  const unsigned hi = __ballot_sync(0xffffffffu, (s.hit[lane + 32] >> (4 * warp)) & 0xFu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The forward walk over a staged chunk: acc[j] += cm w on the warp's
// slots, in stream order.
__device__ __forceinline__ void forward_slots(const Slots& s, const Pixels& p, float q_cut,
                                              float (&acc)[kPixels][kC]) {
  unsigned long long m = warp_slots(s, p.warp, p.lane);
  while (m) {
    const int k = __ffsll(static_cast<long long>(m)) - 1;
    m &= m - 1;
    const unsigned nib = (s.hit[k] >> (4 * p.warp)) & 0xFu;
    float adxdx[2], b2dx[2], dy[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float dx = __fsub_rn(p.X[i], s.gx[k]);
      adxdx[i] = __fmul_rn(__fmul_rn(s.a[k], dx), dx);
      b2dx[i] = __fmul_rn(s.b2[k], dx);
      dy[i] = __fsub_rn(p.Y[i], s.gy[k]);
    }
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      if (!((nib >> j) & 1u)) continue;  // warp-uniform
      const float q = quad_form(adxdx[j & 1], b2dx[j & 1], s.c[k], dy[j >> 1]);
      if (q <= q_cut) {
        const float w = pair_weight(q);
#pragma unroll
        for (int ch = 0; ch < kC; ++ch)
          acc[j][ch] = __fadd_rn(acc[j][ch], __fmul_rn(s.cm[ch][k], w));
      }
    }
  }
}

// The forward walk of the tile's window: acc[j] = sum over the window, in
// stream order, of cm w at the thread's pixel j. Threads 0-63 stage each
// chunk from `row` and, while the warps walk it, load the next chunk's
// rows into `row` and the ids of the one after into L1. kThenBack: after
// the last of several chunks `row` holds the chunk before it, the first a
// backward walk from the last chunk stages. Every thread of the CTA calls
// it; the last chunk stays staged in `s`.
template <int TILE, bool kBlocks, bool kThenBack>
__device__ __forceinline__ void walk_forward(Slots& s, const Stream& st, const Pixels& p,
                                             float q_cut, float (&acc)[kPixels][kC],
                                             SlotRow& row) {
  const int len = p.end - p.start;
  const int nch = len > 0 ? (len + kBK - 1) / kBK : 0;
  const int k_own = threadIdx.x;  // the slot this thread loads and stages
#pragma unroll
  for (int j = 0; j < kPixels; ++j)
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) acc[j][ch] = 0.0f;
  if (k_own < min(kBK, len)) row = load_slot<kBlocks>(st, p.start, k_own);
  prefetch_ids<kBlocks>(st, p.start + kBK, len - kBK);
  for (int ci = 0; ci < nch; ++ci) {
    const int base = p.start + ci * kBK;
    stage_slots<TILE>(s, row, min(kBK, p.end - base), p.tx0, p.ty0, q_cut);
    __syncthreads();
    if (ci + 1 < nch) {
      if (k_own < min(kBK, p.end - base - kBK)) row = load_slot<kBlocks>(st, base + kBK, k_own);
      prefetch_ids<kBlocks>(st, base + 2 * kBK, p.end - base - 2 * kBK);
    } else if (kThenBack && nch > 1 && k_own < kBK) {
      row = load_slot<kBlocks>(st, base - kBK, k_own);
    }
    forward_slots(s, p, q_cut, acc);
    if (ci + 1 < nch) __syncthreads();  // every warp is done with the chunk
  }
}

}  // namespace gsum
