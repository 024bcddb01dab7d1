"""The cull of the alpha-blend kernels K8 and K9 (ops/rasterize_blend.py
``blend_cull_plain``, the op-for-op mirror of ``blend_cull`` in
csrc/rasterize_blend_common.cuh and the ``slot_cull`` it calls in
csrc/rasterize_sum_common.cuh): each staged slot's gate q_cut and the
tile-local pixel rectangle it can reach. The kernels skip every pair
outside the rectangle or with q > q_cut, so their output stays that of
the plain versions only if no pair that the plain versions composite
(``_alpha_terms`` makes its alpha nonzero) is skipped. These tests hold
the mirror to that, exactly: no tolerance.

- seeded: ``cull_edge_scene`` rows (rotated conics up to 1e4 : 1,
  near-singular and not positive definite conics, NaN rows, opacities at
  alpha_min (1 -+ 1e-6) up to 1, centers on patch borders) against the
  tile that holds each center and its eight neighbours, at 16- and
  32-pixel tiles;
- hypothesis: single rows drawn over the same families and wider ranges,
  against one tile;
- fixed adversarial rows: large, nearly singular conics, singular and
  not positive definite ones, tiny and huge ones;
- thin ellipses (condition 1e2..3e6) with their far tip in the tile,
  where the float32 form's rounding is largest against the rectangle's
  edge: the rectangle's condition term is what holds there;
- efficacy on a seeded 3DGS state: the cull keeps fewer pairs than the
  stream hands the kernels, and every pair that composites.
"""

import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from gaussianimage_tpu_torch.blend_cull_scene import (  # noqa: E402
    cull_edge_scene)
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_blend as trb  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402
from gaussianimage_tpu_torch.ops.rasterize_sum import (  # noqa: E402
    cull_patches, window_pairs)

AMIN = 1.0 / 255.0
CLIP = 0.999
HEADER = (Path(trb.__file__).parent / "csrc" /
          "rasterize_blend_common.cuh").read_text()


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rows(xys, conics, colors, opac):
    n = xys.shape[0]
    rows = np.zeros((n, tsc.FW), np.float32)
    rows[:, 0:2], rows[:, 2:5] = xys, conics
    rows[:, 5:8], rows[:, 8] = colors, opac
    return torch.from_numpy(rows)


def _missed(rows, tx0, ty0, tile_px):
    """Rows [A, 16] against their tiles (origins tx0, ty0 [A]) ->
    (pairs on, pairs on that the cull would skip)."""
    P = tile_px * tile_px
    pidx = torch.arange(P)
    X = (pidx % tile_px).float()[None, :]
    Y = torch.div(pidx, tile_px, rounding_mode="floor").float()[None, :]
    live = torch.ones(rows.shape[0], 1, dtype=torch.bool)
    alpha, _, _, q, _, _ = trb._alpha_terms(rows[:, None], live, tx0, ty0,
                                            X, Y, CLIP, AMIN)
    on = (alpha[:, 0] != 0)
    cl = trb.blend_cull_plain(rows, tx0, ty0, AMIN, tile_px=tile_px)
    inside = ((X >= cl.x0[:, None]) & (X <= cl.x1[:, None])
              & (Y >= cl.y0[:, None]) & (Y <= cl.y1[:, None])
              & (q[:, 0] <= cl.q_cut[:, None]))
    return int(on.sum()), int((on & ~inside).sum())


def test_margin_matches_the_kernels():
    """The mirror's q_cut margin and warp patch are the device's kQMargin
    and kPatchW x kPatchH."""
    m = re.search(r"constexpr float kQMargin = ([0-9.e-]+)f;", HEADER)
    assert m and float(m.group(1)) == trb.Q_MARGIN
    patch = tuple(int(re.search(rf"constexpr int {k} = (\d+);", HEADER)
                      .group(1)) for k in ("kPatchW", "kPatchH"))
    assert patch == trb.PATCH


@pytest.mark.parametrize("tile_px", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_keeps_every_on_pair_seeded(seed, tile_px):
    sc_ = cull_edge_scene(3000, 96, 128, seed)
    rows = _rows(sc_["xys"], sc_["conics"], sc_["colors"], sc_["opac"])
    base = torch.floor(rows[:, :2] / tile_px) * tile_px
    on_total = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tx0 = base[:, 0] + dx * tile_px
            ty0 = base[:, 1] + dy * tile_px
            on, missed = _missed(rows, tx0, ty0, tile_px)
            assert missed == 0, (dx, dy)
            on_total += on
    # the scene does composite: the test is not vacuous
    assert on_total > 100 * tile_px


@pytest.mark.parametrize("a, b, c, x, y", [
    # thin, long and nearly singular at 45 degrees, large coefficients
    (1e4, 1e4 * (1 - 1e-7), 1e4, 15.5, 15.5),
    (1e4, -1e4 * (1 - 3e-6), 1e4, 3.0, 28.0),
    (1e3, 1e3 * (1 - 1e-5), 1e3, -20.0, 40.0),
    (50.0, 49.99, 50.0, 8.0, 4.0),
    # rotated 1e4 : 1
    (0.5 * (1 + 1e-4), 0.5 * (1 - 1e-4), 0.5 * (1 + 1e-4), 16.0, 16.0),
    # exactly singular in float32, and not positive definite
    (4.0, 2.0, 1.0, 10.0, 10.0),
    (1.0, 3.0, 1.0, 12.5, 7.25),
    (-1.0, 0.0, 1.0, 5.0, 5.0),
    (0.0, 0.0, 0.0, 5.0, 5.0),
    # tiny and huge
    (1e-6, 0.0, 1e-6, -500.0, 700.0),
    (1e6, 0.0, 1e6, 7.999, 4.0001),
])
@pytest.mark.parametrize("opac", [AMIN * (1 - 1e-6), AMIN * (1 + 1e-6), 0.1,
                                  0.999, 1.0])
def test_cull_adversarial_rows(a, b, c, x, y, opac):
    rows = _rows(np.float32([[x, y]]), np.float32([[a, b, c]]),
                 np.float32([[0.5, 0.5, 0.5]]), np.float32([opac]))
    for tile_px in (16, 32):
        for tx0 in (-tile_px, 0.0, tile_px):
            for ty0 in (-tile_px, 0.0, tile_px):
                _, missed = _missed(rows, torch.tensor([tx0]),
                                    torch.tensor([ty0]), tile_px)
                assert missed == 0, (tile_px, tx0, ty0)


def _tips(n, seed, tile_px):
    """n thin ellipses (condition 1e2..3e6, any angle, opacity up to 1)
    whose far tip lies in the tile [0, tile_px)^2: there the form's float32
    rounding is largest against the rectangle's edge."""
    rng = np.random.default_rng(seed)
    lam1 = 10.0 ** rng.uniform(-1.0, 4.0, n)
    lam2 = lam1 / (4.0 * 10.0 ** rng.uniform(2.0, 6.5, n))
    th = rng.uniform(0.0, math.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    conics = np.stack([lam1 * cs * cs + lam2 * sn * sn,
                       (lam1 - lam2) * sn * cs,
                       lam1 * sn * sn + lam2 * cs * cs], -1)
    opac = rng.choice([1.0, 0.999, 0.1, AMIN * (1 + 1e-6)], n)
    half = np.sqrt(2.0 * np.log(opac / AMIN) / lam2)  # the long half axis
    axis = np.stack([-sn, cs], -1) * rng.choice([-1.0, 1.0], (n, 1))
    tip = rng.uniform(0.0, tile_px, (n, 2))
    xys = tip - axis * (half * rng.uniform(0.97, 1.03, n))[:, None]
    return _rows(xys.astype(np.float32), conics.astype(np.float32),
                 np.full((n, 3), 0.5, np.float32), opac.astype(np.float32))


@pytest.mark.parametrize("tile_px", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cull_keeps_every_on_pair_at_thin_tips(seed, tile_px):
    """The rectangle's kappa term is what holds here: without it (half
    extents from q_cut alone, padded by 1e-3 and one pixel) these rows
    lose pairs that composite."""
    rows = _tips(4000, seed, tile_px)
    zero = torch.zeros(rows.shape[0])
    on, missed = _missed(rows, zero, zero, tile_px)
    assert missed == 0 and on > 10000


@st.composite
def _row(draw):
    kind = draw(st.sampled_from(["rotated", "near", "nonpd", "nan"]))
    lam1 = 10.0 ** draw(st.floats(-3.0, 4.0))
    lam2 = lam1 / 10.0 ** draw(st.floats(0.0, 4.0))
    th = draw(st.floats(0.0, math.pi))
    cs, sn = math.cos(th), math.sin(th)
    a = lam1 * cs * cs + lam2 * sn * sn
    c = lam1 * sn * sn + lam2 * cs * cs
    b = (lam1 - lam2) * sn * cs
    sgn = draw(st.sampled_from([-1.0, 1.0]))
    if kind == "near":
        b = sgn * math.sqrt(a * c) * (1 - 10.0 ** draw(st.floats(-8.0, -1.0)))
    elif kind == "nonpd":
        b = sgn * math.sqrt(a * c) * draw(st.floats(1.0, 4.0))
        a = a * draw(st.sampled_from([1.0, -1.0, 0.0]))
    conic = [a, b, c]
    if kind == "nan":
        conic[draw(st.integers(0, 2))] = math.nan
    opac = draw(st.sampled_from([AMIN * (1 - 1e-6), AMIN * (1 + 1e-6), 0.1,
                                 0.999, 1.0, math.nan]))
    tile_px = draw(st.sampled_from([16, 32]))
    on_border = draw(st.booleans())
    if on_border:
        x = 8.0 * draw(st.integers(-2, 6)) + draw(
            st.sampled_from([0.0, 1e-3, -1e-3, 0.5, -0.5]))
        y = 4.0 * draw(st.integers(-2, 10)) + draw(
            st.sampled_from([0.0, 1e-3, -1e-3, 0.5, -0.5]))
    else:
        x = draw(st.floats(-64.0, 96.0))
        y = draw(st.floats(-64.0, 96.0))
    return conic, opac, (x, y), tile_px


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_row())
def test_cull_keeps_every_on_pair_property(row):
    conic, opac, xy, tile_px = row
    rows = _rows(np.float32([xy]), np.float32([conic]),
                 np.float32([[0.2, 0.4, 0.6]]), np.float32([opac]))
    _, missed = _missed(rows, torch.zeros(1), torch.zeros(1), tile_px)
    assert missed == 0


def test_cull_efficacy_on_a_3dgs_state():
    """A seeded 3DGS state (Gaussian3D at 400 points, 128 x 96, its
    32-pixel tiles): the pairs in warp patches that meet a slot's
    rectangle, which the kernels evaluate, are fewer than the stream's
    pairs, and hold every pair that composites."""
    H, W = 96, 128
    model = make_model("3DGS", device="cpu", num_points=400, H=H, W=W)
    model.init_params(torch.Generator().manual_seed(3))
    cfg = model.blend_cfg
    with torch.no_grad():
        xys, depths, radii, conics, rgbs, opac = model.project()
        order, sp = trb.blend_stream(xys, depths, radii, H, W, cfg)
        feat = trb.blend_feat(xys, conics, rgbs, opac, order)
    rows = tsc.gather_stream(sp.gids, feat)
    tp = cfg.tile_px
    handed = kept = on_pairs = 0
    for pr in window_pairs(rows, sp.starts, sp.counts, H, W, tp):
        tx0 = ((pr.tile % sp.tiles_x) * tp).float()
        ty0 = (torch.div(pr.tile, sp.tiles_x, rounding_mode="floor")
               * tp).float()
        cl = trb.blend_cull_plain(pr.rows, tx0, ty0, cfg.alpha_min,
                                  tile_px=tp)
        meets = cull_patches(cl, tp, trb.PATCH)
        o = pr.rows[:, 8:9]
        on = pr.inside & (o * torch.exp(-0.5 * pr.q) >= cfg.alpha_min)
        handed += int(pr.inside.sum())
        kept += int((pr.inside & meets).sum())
        on_pairs += int(on.sum())
        assert not bool((on & ~meets).any())
    # measured: 100,576 of 713,728 pairs (a share of 0.141) kept, 26,370
    # on
    assert on_pairs > 0 and kept >= on_pairs
    assert kept / handed < 0.2, (kept, handed, on_pairs)
