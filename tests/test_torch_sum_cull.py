"""The cull that K1, K2 and K3 share (ops/rasterize_sum.py
``sum_cull_plain``, the op-for-op mirror of ``stage_slots`` in
csrc/rasterize_sum_common.cuh, whose rectangle is ``slot_cull_plain``,
the mirror of ``slot_cull`` there): each staged slot's tile-local pixel
rectangle for the gate q <= q_cut. The kernels skip every pair outside
it, so their output stays that of the plain versions only if no pair that
passes the gate lies outside. The oracle is the JAX kernel's gate
(gaussianimage_tpu/ops/rasterize_sum.py ``_tile_acc``: q =
jnp.maximum(form, 0) <= q_cut, jitted on the CPU), beside the port's own
(``window_pairs``' q, the kernels' op order). Exact: no tolerance.

- seeded: ``cull_edge_scene`` rows (rotated conics up to 1e4 : 1,
  near-singular and not positive definite conics, NaN rows, centers on
  patch borders and off the image) against the tile that holds each
  center and its eight neighbours;
- thin ellipses (condition 1e2..1e7) with their far tip at q = q_cut in
  the tile, where the float32 form's rounding is largest against the
  rectangle's edge;
- near-degenerate conics whose float32 form cancels below 0, which the
  gate's clamp lets in with q = 0, and rows with a NaN or an infinity;
- hypothesis: single rows over the same families and wider ranges;
- the pixel patches on a seeded Cholesky state: the pairs K1-K3
  evaluate (their 8 x 4 patches), the warps that visit a slot (16 x 8
  blocks) and the 32 x 4 strips of the earlier K1 / K2 layout, against
  the window's pairs.
"""

import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from gaussianimage_tpu_torch.blend_cull_scene import (  # noqa: E402
    cull_edge_scene)
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)

Q_CUT = 9.0  # RasterizeConfig's default gate
TILE = 32    # K1-K3's tile
CSRC = Path(rs.__file__).parent / "csrc"
HEADER = (CSRC / "rasterize_sum_common.cuh").read_text()


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@jax.jit
def _jax_gate(rows, tx0, ty0):
    """[S, P] the JAX kernel's gate over the tile's pixels, its
    expressions as ``_chunk_geom`` and ``_tile_acc`` write them."""
    pidx = jnp.arange(TILE * TILE)
    X = (pidx % TILE).astype(jnp.float32)[None, :]
    Y = (pidx // TILE).astype(jnp.float32)[None, :]
    gx = rows[:, 0:1] - tx0[:, None]
    gy = rows[:, 1:2] - ty0[:, None]
    a, b, c = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
    dx, dy = X - gx, Y - gy
    q = jnp.maximum(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy, 0.0)
    return q <= Q_CUT


def _port_gate(rows, tx0, ty0):
    """[S, P] the kernels' gate (``window_pairs``' q, op for op)."""
    pidx = torch.arange(TILE * TILE)
    X = (pidx % TILE).float()[None, :]
    Y = torch.div(pidx, TILE, rounding_mode="floor").float()[None, :]
    dx = X - (rows[:, 0:1] - tx0[:, None])
    dy = Y - (rows[:, 1:2] - ty0[:, None])
    a, b, c = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
    q = torch.clamp(a * dx * dx + 2.0 * b * dx * dy + c * dy * dy, min=0.0)
    return q <= Q_CUT


def _rows(xys, conics):
    rows = np.zeros((xys.shape[0], tsc.FW), np.float32)
    rows[:, 0:2], rows[:, 2:5] = xys, conics
    rows[:, 5:9] = 0.5
    return torch.from_numpy(rows)


def _missed(rows, tx0, ty0):
    """Rows [S, 16] against their tiles (origins tx0, ty0 [S]) -> (gated
    pairs, gated pairs outside the cull's rectangle), counted over both
    gates."""
    jg = torch.from_numpy(np.array(_jax_gate(
        jnp.asarray(rows.numpy()), jnp.asarray(tx0.numpy()),
        jnp.asarray(ty0.numpy()))))
    gated = jg | _port_gate(rows, tx0, ty0)
    cl = rs.sum_cull_plain(rows, tx0, ty0, Q_CUT)
    pidx = torch.arange(TILE * TILE)
    X = (pidx % TILE)[None, :]
    Y = torch.div(pidx, TILE, rounding_mode="floor")[None, :]
    inside = ((X >= cl.x0[:, None]) & (X <= cl.x1[:, None])
              & (Y >= cl.y0[:, None]) & (Y <= cl.y1[:, None]))
    return int(gated.sum()), int((gated & ~inside).sum())


def test_patch_matches_the_kernel():
    """The mirror's patch and warp block are the shared layout's kPatchW x
    kPatchH and the 2 x 2 patches of a warp (``pixels_of`` in
    csrc/rasterize_sum_common.cuh), and K1, K2 and K3 all take that layout
    and staging at their tile side: each kernel places its pixels with
    ``pixels_of<TILE, ...>`` and stages through ``stage_slots<TILE>`` (K1
    and K3 in ``walk_forward``), and neither kernel source defines a patch
    of its own."""
    for src, kernels in (("rasterize_sum_fwd.cu",
                          ("rasterize_sum_fwd_kernel",)),
                         ("rasterize_sum_bwd.cu",
                          ("rasterize_sum_bwd_kernel",
                           "rasterize_sum_l2_kernel"))):
        text = (CSRC / src).read_text()
        assert '#include "rasterize_sum_common.cuh"' in text
        assert "kPatchW =" not in text and "kPatchH =" not in text
        for kernel in kernels:
            body = text[text.index(kernel + "("):]
            body = body[:body.index("\n}\n")]
            assert "pixels_of<TILE, kBlocks>" in body, kernel
            assert ("walk_forward<" in body
                    or "stage_slots<TILE>(" in body), kernel
    assert "stage_slots<TILE>(" in HEADER.split("walk_forward(")[1]
    patch = tuple(int(re.search(rf"constexpr int {k} = (\d+);", HEADER)
                      .group(1)) for k in ("kPatchW", "kPatchH"))
    assert patch == rs.PATCH
    assert rs.WARP_BLOCK == (2 * patch[0], 2 * patch[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_keeps_every_gated_pair_seeded(seed):
    sc_ = cull_edge_scene(2000, 96, 128, seed)
    rows = _rows(sc_["xys"], sc_["conics"])
    base = torch.floor(rows[:, :2] / TILE) * TILE
    base = torch.where(torch.isfinite(base), base, torch.zeros_like(base))
    total = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            gated, missed = _missed(rows, base[:, 0] + dx * TILE,
                                    base[:, 1] + dy * TILE)
            assert missed == 0, (dx, dy)
            total += gated
    # the scene does pass the gate: the test is not vacuous
    assert total > 100 * TILE


def _tips(n, seed):
    """n thin ellipses (condition 1e2..1e7, any angle) whose far tip at
    q = Q_CUT lies in the tile [0, TILE)^2."""
    rng = np.random.default_rng(seed)
    lam1 = 10.0 ** rng.uniform(-1.0, 4.0, n)
    lam2 = lam1 / (4.0 * 10.0 ** rng.uniform(1.4, 6.4, n))
    th = rng.uniform(0.0, math.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    conics = np.stack([lam1 * cs * cs + lam2 * sn * sn,
                       (lam1 - lam2) * sn * cs,
                       lam1 * sn * sn + lam2 * cs * cs], -1)
    half = np.sqrt(Q_CUT / lam2)  # the long half axis
    axis = np.stack([-sn, cs], -1) * rng.choice([-1.0, 1.0], (n, 1))
    tip = rng.uniform(0.0, TILE, (n, 2))
    xys = tip - axis * (half * rng.uniform(0.97, 1.03, n))[:, None]
    return _rows(xys.astype(np.float32), conics.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cull_keeps_every_gated_pair_at_thin_tips(seed):
    rows = _tips(3000, seed)
    zero = torch.zeros(rows.shape[0])
    gated, missed = _missed(rows, zero, zero)
    assert missed == 0 and gated > 10000


@pytest.mark.parametrize("a, b, c, x, y", [
    # nearly singular at 45 degrees, large coefficients: the float32 form
    # cancels below 0 on a band through the center (q = 0 there)
    (1e4, 1e4 * (1 - 1e-7), 1e4, 15.5, 15.5),
    (1e4, -1e4 * (1 - 3e-6), 1e4, 3.0, 28.0),
    (1e3, 1e3 * (1 - 1e-5), 1e3, -20.0, 40.0),
    (50.0, 49.99, 50.0, 8.0, 4.0),
    # exactly singular in float32, indefinite, negative and zero
    (4.0, 2.0, 1.0, 10.0, 10.0),
    (1.0, 3.0, 1.0, 12.5, 7.25),
    (-1.0, 0.0, 1.0, 5.0, 5.0),
    (0.0, 0.0, 0.0, 5.0, 5.0),
    # an infinite coefficient: the form is NaN where its offset is 0
    (math.inf, 0.0, 1.0, 7.0, 9.0),
    (1.0, math.inf, 1.0, 7.0, 9.0),
    (1.0, 0.0, -math.inf, 7.0, 9.0),
    # a NaN coefficient or center, an infinite center
    (math.nan, 0.0, 1.0, 7.0, 9.0),
    (1.0, 0.0, 1.0, math.nan, 9.0),
    (1.0, 0.0, 1.0, math.inf, 9.0),
    # tiny and huge, centers off the tile
    (1e-6, 0.0, 1e-6, -500.0, 700.0),
    (1e6, 0.0, 1e6, 7.999, 4.0001),
    (0.02, 0.01, 0.03, -30.0, 70.0),
])
def test_cull_adversarial_rows(a, b, c, x, y):
    rows = _rows(np.float32([[x, y]]), np.float32([[a, b, c]]))
    for tx0 in (-TILE, 0.0, TILE):
        for ty0 in (-TILE, 0.0, TILE):
            _, missed = _missed(rows, torch.tensor([tx0]),
                                torch.tensor([ty0]))
            assert missed == 0, (tx0, ty0)


def test_negative_and_nan_forms_reach_the_gate_as_jax_decides():
    """A positive definite but nearly singular conic whose float32 form
    rounds below 0 at a pixel passes the gate there with q = 0 (the
    clamp); an infinite coefficient makes the form NaN where its offset is
    0, which fails the gate; an indefinite conic passes with q = 0 along
    its negative cone; a NaN center passes nowhere. The JAX gate and the
    port's agree pair for pair, the first three rows take the whole tile
    and the last none."""
    rows = _rows(np.float32([[26.239595, 28.139744], [7.0, 9.0],
                             [7.0, 9.0], [math.nan, 9.0]]),
                 np.float32([[200.94952, -212.50897, 224.73337],
                             [math.inf, 0.0, 1.0], [1.0, 3.0, 1.0],
                             [1.0, 0.0, 1.0]]))
    zero = torch.zeros(rows.shape[0])
    jg = np.asarray(_jax_gate(jnp.asarray(rows.numpy()),
                              jnp.asarray(zero.numpy()),
                              jnp.asarray(zero.numpy())))
    np.testing.assert_array_equal(_port_gate(rows, zero, zero).numpy(), jg)
    pidx = torch.arange(TILE * TILE)

    def form(i):
        dx = (pidx % TILE).float() - rows[i, 0]
        dy = torch.div(pidx, TILE, rounding_mode="floor").float() - rows[i, 1]
        a, b, c = rows[i, 2], rows[i, 3], rows[i, 4]
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    neg = form(0) < 0
    assert bool(neg.any()) and bool(jg[0][neg.numpy()].all())
    # column x = 7 (dx = 0): inf * 0 is NaN; elsewhere the form is inf
    assert bool(form(1)[7::TILE].isnan().all()) and not jg[1].any()
    assert jg[2].sum() > TILE
    assert not jg[3].any()
    cl = rs.sum_cull_plain(rows, zero, zero, Q_CUT)
    for i in range(3):
        assert (int(cl.x0[i]), int(cl.x1[i]), int(cl.y0[i]),
                int(cl.y1[i])) == (0, TILE - 1, 0, TILE - 1), i
    assert int(cl.x0[3]) > int(cl.x1[3]) and int(cl.y0[3]) > int(cl.y1[3])


@st.composite
def _row(draw):
    kind = draw(st.sampled_from(["rotated", "near", "nonpd", "nan", "inf"]))
    lam1 = 10.0 ** draw(st.floats(-3.0, 4.0))
    lam2 = lam1 / 10.0 ** draw(st.floats(0.0, 7.0))
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
    if kind in ("nan", "inf"):
        conic[draw(st.integers(0, 2))] = (math.nan if kind == "nan"
                                          else sgn * math.inf)
    if draw(st.booleans()):  # on a patch border, or an integer pixel
        x = 8.0 * draw(st.integers(-2, 6)) + draw(
            st.sampled_from([0.0, 1e-3, -1e-3, 0.5, -0.5, 1.0]))
        y = 4.0 * draw(st.integers(-2, 10)) + draw(
            st.sampled_from([0.0, 1e-3, -1e-3, 0.5, -0.5, 1.0]))
    else:
        x = draw(st.floats(-64.0, 96.0))
        y = draw(st.floats(-64.0, 96.0))
    return conic, (x, y)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_row())
def test_cull_keeps_every_gated_pair_property(row):
    conic, xy = row
    rows = _rows(np.float32([xy]), np.float32([conic]))
    _, missed = _missed(rows, torch.zeros(1), torch.zeros(1))
    assert missed == 0


def test_patch_choice_on_a_cholesky_state():
    """A seeded Cholesky state (300 points, 96 x 128, 32-pixel tiles):
    of the window's pairs, K1-K3 evaluate those in 8 x 4 patches that meet
    a slot's rectangle, fewer than the 16 x 8 warp blocks or 32 x 4 strips
    would; every gated pair is among them; and the warps visit a share of
    the (slot, warp) pairs."""
    N, H, W = 300, 96, 128
    rng = np.random.default_rng(11)
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W)
    model.load_state_dict(params_from_numpy({
        "_xyz": rng.uniform(-1.2, 1.2, (N, 2)),
        "_cholesky": rng.uniform(0.5, 3.0, (N, 3)),
        "_features_dc": rng.uniform(0.0, 1.0, (N, 3))}, "cpu"))
    with torch.no_grad():
        xys, radii, conics, colors, opac = model.splat()
        cfg = model.cfg.raster
        sp = tsc.prepare_stream(
            xys, rs._axis_radii(conics, radii.float(), cfg.q_cut), H, W, cfg)
        feat = tsc.pack_feat(xys, conics, colors, opac, premultiply=True)
    shapes = {"patch": rs.PATCH, "warp": rs.WARP_BLOCK, "strip": (32, 4)}
    kept = dict.fromkeys(shapes, 0)
    handed = gated = visits = slots = 0
    for pr in rs.window_pairs(tsc.gather_stream(sp.gids, feat), sp.starts,
                              sp.counts, H, W):
        tx0 = ((pr.tile % sp.tiles_x) * TILE).float()
        ty0 = (torch.div(pr.tile, sp.tiles_x, rounding_mode="floor")
               * TILE).float()
        cl = rs.sum_cull_plain(pr.rows, tx0, ty0, cfg.q_cut)
        on = pr.inside & (pr.q <= cfg.q_cut)
        handed += int(pr.inside.sum())
        gated += int(on.sum())
        for name, shape in shapes.items():
            meets = rs.cull_patches(cl, TILE, shape)
            kept[name] += int((pr.inside & meets).sum())
            assert not bool((on & ~meets).any()), name
        # a warp visits a slot when its block meets the rectangle: its
        # 128 pixels, one per lane and patch
        visits += int(rs.cull_patches(cl, TILE, rs.WARP_BLOCK).sum()) // 128
        slots += pr.rows.shape[0]
    # measured: 526,336 window pairs of 514 slots, 42,140 gated (8.0%);
    # kept 27.8% (8 x 4), 44.6% (16 x 8), 51.9% (32 x 4); the warps visit
    # 44.6% of the (slot, warp) pairs
    assert gated < kept["patch"] < kept["warp"] < kept["strip"] < handed
    assert kept["patch"] / handed < 0.32, (kept, handed, gated)
    assert visits / (8 * slots) < 0.5, (visits, slots)
