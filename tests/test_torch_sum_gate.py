"""The gate of K1, K2 and K3 on the rows where it matters most: a conic
with an infinite coefficient, whose quadratic form is NaN where its pixel
offset is 0 (inf * 0) and, for an infinite b, -inf on two quadrants, and
indefinite conics, whose form is negative on a cone. The JAX
kernels (gaussianimage_tpu/ops/rasterize_sum.py ``_fwd_kernel``,
``_bwd_kernel``, ``_fused_l2_kernel``, Pallas interpret mode, jitted)
take q = jnp.maximum(form, 0): a negative form passes as q = 0 with
w = 1, and a NaN form stays NaN and fails q <= q_cut. The port's plain
versions (``sum_fwd_plain``, ``sum_bwd_plain``, ``sum_l2_plain`` and
their aligned twins) must decide every such pair the same way; on the
card the kernels are held to the plain versions (chip_smoke.py's
nan_form case).

The stream is binned from the scene's own conics, then rows of it carry
the adversarial conics, so every such row sits in the windows of the
tiles it overlaps. Flat and aligned (``flat_stream_limit=0``).

Tolerances: the image atol 2e-5 and the SSE rtol 1e-6 (the JAX
kernel's HIGHEST-precision contractions against the port's in-order
sums); the gradient rows NaN where JAX's are, and elsewhere the dcm
columns (direct sums in both) rtol 1e-4 / atol 1e-6 of the column's
largest magnitude, the position and conic columns 1e-2 of it (the JAX
kernel recombines tile-local moments, which cancels for small Gaussians
far from the tile origin: tests/test_torch_grad.py). A gate that let
the NaN-form pairs in would add w = 1 terms: 0.1-1 to the image and
whole cotangent entries to the dcm columns.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_sum as jrs  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig as TCfg  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402

N, H, W = 120, 64, 96
Q_CUT = 9.0


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _case(aligned):
    """(JAX stream, port stream, feat [N+1, 16], g [4, H, W], gt [3, H, W],
    the adversarial rows' ids)."""
    rng = np.random.default_rng(21)
    means = rng.uniform(-0.95, 0.95, (N, 2)).astype(np.float32)
    chol = rng.uniform(0.3, 2.0, (N, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, (N, 1)).astype(np.float32)
    tb = (-(-W // 16), -(-H // 16), 1)
    xys, _, radii, conics, _ = project_gaussians_2d(
        jnp.asarray(means), jnp.asarray(chol), H, W, tb)
    xys, radii, conics = (np.array(a) for a in (xys, radii, conics))
    nan_rows, neg_rows = np.arange(0, 12), np.arange(12, 24)
    # integer centers: dx = 0 on a column, dy = 0 on a row
    xys[nan_rows] = np.round(xys[nan_rows])
    xys[neg_rows] = np.round(xys[neg_rows]) + 0.5
    rx, ry = jrs._axis_radii(jnp.asarray(conics), jnp.asarray(radii), Q_CUT)
    kw = dict(flat_stream_limit=0) if aligned else {}
    jsp = jsc.prepare_stream(jnp.asarray(xys), (rx, ry), H, W, JCfg(**kw))
    tsp = tsc.prepare_stream(torch.from_numpy(xys),
                             (torch.from_numpy(np.array(rx)),
                              torch.from_numpy(np.array(ry))),
                             H, W, TCfg(**kw))
    assert bool(tsp.aligned) == aligned
    np.testing.assert_array_equal(tsp.gids.numpy(), np.asarray(jsp.gids))
    adv = conics.copy()
    adv[nan_rows[0::3], 0] = np.inf    # a = inf: NaN on the column dx = 0
    adv[nan_rows[1::3], 2] = np.inf    # c = inf: NaN on the row dy = 0
    adv[nan_rows[2::3], 1] = -np.inf   # b = -inf: NaN on both
    # indefinite conics with dyadic coefficients: on half-integer offsets
    # the float32 form is exact, so both packages see the same negative
    # cone (q = 0, w = 1) and the same q <= q_cut boundary
    indefinite = np.float32([[1.0, 3.0, 1.0], [0.5, -1.0, 0.25],
                             [2.0, -3.0, 1.0], [0.25, 0.5, -0.5],
                             [-1.0, 0.0, 0.125], [0.0, 0.75, 0.0]])
    adv[neg_rows] = indefinite[np.arange(neg_rows.size) % len(indefinite)]
    feat = tsc.pack_feat(*(torch.from_numpy(v) for v in
                           (xys, adv, colors, opac)), premultiply=True)
    g = rng.standard_normal((4, H, W)).astype(np.float32) * 1e-2
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return jsp, tsp, feat, g, gt, np.concatenate([nan_rows, neg_rows])


def _static(jsp, aligned):
    cfg = JCfg()
    return (cfg.tile_px, cfg.tiles_per_step, cfg.block_inst, Q_CUT,
            jsp.tiles_x, jsp.T, True, H, W, jsp.I, aligned)


def _gfeat(jsp, feat, aligned):
    f = jnp.asarray(feat.numpy())
    if aligned:
        return jsc.gather_stream_blocks(jsp.gids, f, 64, interpret=True)
    return jsc.gather_stream(jsp.gids, f, 64)


def _rows_equal(got, want):
    """Gradient rows [S, 16] against JAX's: NaN where JAX's are; the dcm
    columns 5-8 to 1e-4 of the column max, columns 0-4 to 1e-2 of it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert bool(np.isfinite(got[fin]).all())
    g0, w0 = np.where(fin, got, 0.0), np.where(fin, want, 0.0)
    scale = np.abs(w0).max(axis=0) + 1e-30
    for cols, tol in ((slice(0, 5), 1e-2), (slice(5, 9), 1e-4)):
        np.testing.assert_allclose(g0[:, cols], w0[:, cols], rtol=0,
                                   atol=tol * scale[cols].max())
    return int(np.isnan(want).any(axis=1).sum())


def _slot_rows(tsp, dg, aligned):
    """Per-slot rows [S, 16] of the windows' live slots, from the flat
    rows or the aligned gradient blocks."""
    if aligned:
        dg = torch.as_tensor(np.asarray(dg))
        dg = tsc.unblockize_stream_plain(dg)
    dg = np.asarray(dg)
    live = np.concatenate([np.arange(s, s + c) for s, c in
                           zip(tsp.starts[:tsp.T].tolist(),
                               tsp.counts[:tsp.T].tolist())])
    return dg[live], tsp.gids.numpy()[live]


@pytest.mark.parametrize("aligned", [False, True])
def test_forward_gate_matches_jax(aligned):
    jsp, tsp, feat, _, _, adv = _case(aligned)
    static = _static(jsp, aligned)
    want = np.asarray(jax.jit(lambda s, c, f: jrs._fwd_full(static, s, c, f))(
        jsp.starts, jsp.counts, _gfeat(jsp, feat, aligned)))
    if aligned:
        blocks = tsc.blockize_stream_plain(feat, tsp.gids)
        got = rs.sum_fwd_aligned_plain(blocks, tsp.starts, tsp.counts, H, W)
    else:
        got = rs.sum_fwd_plain(feat, tsp.gids, tsp.starts, H, W)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # the adversarial rows are in the stream and reach the gate
    assert np.isin(adv, tsp.gids.numpy()).all()


@pytest.mark.parametrize("aligned", [False, True])
def test_backward_gate_matches_jax(aligned):
    jsp, tsp, feat, g, _, adv = _case(aligned)
    static = _static(jsp, aligned)
    cfg = JCfg()
    G = jsc.tile_cotangent(jnp.asarray(g), cfg.tile_px, jsp.tiles_x, jsp.T,
                           H, W, n_chan=4)
    want = jax.jit(lambda s, c, f, G_: jrs._bwd_pallas(static, s, c, f, G_))(
        jsp.starts, jsp.counts, _gfeat(jsp, feat, aligned), G)
    gt = torch.from_numpy(g)
    if aligned:
        blocks = tsc.blockize_stream_plain(feat, tsp.gids)
        got = rs.sum_bwd_aligned_plain(blocks, tsp.starts, tsp.counts, gt,
                                       H, W)
    else:
        got = rs.sum_bwd_plain(feat, tsp.gids, tsp.starts, gt, H, W)
    rows_got, ids = _slot_rows(tsp, got, aligned)
    rows_want, _ = _slot_rows(tsp, want, aligned)
    # an infinite conic's rows: dgx or dgy is inf * 0 = NaN in both
    assert _rows_equal(rows_got, rows_want) > 0
    assert np.isin(adv, ids).all()


@pytest.mark.parametrize("aligned", [False, True])
def test_fused_l2_gate_matches_jax(aligned):
    jsp, tsp, feat, _, gt, _ = _case(aligned)
    static2 = _static(jsp, aligned) + (True,)
    cfg = JCfg()
    gt_tiles = jsc.tile_cotangent(jnp.asarray(gt), cfg.tile_px, jsp.tiles_x,
                                  jsp.T, H, W, n_chan=4)
    parts, want = jax.jit(lambda s, c, f, t: jrs._fused_l2_pallas(
        static2, s, c, f, t))(jsp.starts, jsp.counts,
                              _gfeat(jsp, feat, aligned), gt_tiles)
    tgt = torch.from_numpy(gt)
    if aligned:
        blocks = tsc.blockize_stream_plain(feat, tsp.gids)
        sse, got = rs.sum_l2_aligned_plain(blocks, tsp.starts, tsp.counts,
                                           tgt, H, W)
    else:
        sse, got = rs.sum_l2_plain(feat, tsp.gids, tsp.starts, tgt, H, W)
    np.testing.assert_allclose(float(sse.sum()), float(np.sum(parts)),
                               rtol=1e-6)
    rows_got, _ = _slot_rows(tsp, got, aligned)
    rows_want, _ = _slot_rows(tsp, want, aligned)
    assert _rows_equal(rows_got, rows_want) > 0
