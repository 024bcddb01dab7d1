"""Port parity, K1-K3 at ``tile_px`` 16 (the sharded fit's default tile):
the plain versions the CPU takes, which the card holds K1 (bit for bit,
in order) and K2 / K3 (ROW_TOL, CHAIN_TOL) to, against the JAX package's
Pallas kernels at 16 in interpret mode (jitted), flat and aligned
(``flat_stream_limit=0``).

- the render (K1, backward K2) and the fused L2 (K3) at 16: image to atol
  2e-5 of JAX's, loss rtol 1e-5, gradients within rtol 1e-4 / atol 1e-8 of
  JAX's or else of the float64 dense oracle's (as tests/test_torch_aligned.py
  holds the 32-pixel tiles: the port sums the moments directly, the TPU
  kernel recombines tile-local ones);
- the in-order plain forward at 16 against ``index_add_`` and the aligned
  stream against the flat one, bit for bit;
- the cull the kernels share at 16 (``sum_cull_plain(..., tile_px=16)``):
  no pair that passes the gate outside a slot's rectangle, and the patches
  and warp blocks of a 16-pixel tile (two warps, an 8-bit patch mask);
- the wrappers take 16 and 32 and refuse another tile.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_gaussians_sum as j_raster  # noqa: E402
from gaussianimage_tpu.ops.rasterize_sum import (  # noqa: E402
    rasterize_gaussians_sum_l2 as j_raster_l2)
from gaussianimage_tpu_torch.core import render_sum_dense  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as sc  # noqa: E402

TILE = 16
NAMES = ("xys", "conics", "colors", "opac")
N, H, W = 220, 64, 96
LAYOUTS = {"flat": {}, "aligned": {"flat_stream_limit": 0}}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scene(seed):
    """(xys, radii, conics, colors, opac) as writable float32 numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.95, 0.95, (N, 2)).astype(np.float32)
    chol = rng.uniform(0.3, 2.0, (N, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, (N, 1)).astype(np.float32)
    tb = (-(-W // 16), -(-H // 16), 1)
    xys, _, radii, conics, _ = project_gaussians_2d(
        jnp.asarray(means), jnp.asarray(chol), H, W, tb)
    return tuple(np.array(a) for a in (xys, radii, conics)) + (colors, opac)


def _leaves(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def _stream(seed, layout):
    """(feat, stream) of the seeded scene at 16-pixel tiles."""
    xys, radii, conics, colors, opac = (torch.from_numpy(a)
                                        for a in _scene(seed))
    cfg = RasterizeConfig(tile_px=TILE, **LAYOUTS[layout])
    sp = sc.prepare_stream(xys, rs._axis_radii(conics, radii, cfg.q_cut),
                           H, W, cfg)
    return sc.pack_feat(xys, conics, colors, opac, premultiply=True), sp


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("objective", ["render", "fused_l2"])
def test_tile16_sum_matches_jax(objective, layout):
    xys, radii, conics, colors, opac = _scene(seed=21)
    gt = np.random.default_rng(4).uniform(0, 1, (3, H, W)).astype(np.float32)
    args = (xys, conics, colors, opac)
    jcfg = JCfg(tile_px=TILE, **LAYOUTS[layout])
    tcfg = RasterizeConfig(tile_px=TILE, **LAYOUTS[layout])

    if objective == "render":
        def j_loss(a):
            img, alpha, _ = j_raster(*a, H, W, radii=jnp.asarray(radii),
                                     config=jcfg)
            return jnp.sum(img ** 2) + 0.5 * jnp.sum(alpha ** 2), img
    else:
        def j_loss(a):
            mse, _ = j_raster_l2(*a, jnp.asarray(gt), H, W,
                                 radii=jnp.asarray(radii), config=jcfg)
            return mse, mse
    (j_val, j_img), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(tuple(map(jnp.asarray, args)))

    leaves = _leaves(args)
    if objective == "render":
        img, alpha, aux = rs.rasterize_gaussians_sum(
            *leaves, H, W, radii=torch.from_numpy(radii), config=tcfg)
        loss = (img ** 2).sum() + 0.5 * (alpha ** 2).sum()
        np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img),
                                   rtol=0, atol=2e-5)
    else:
        loss, aux = rs.rasterize_gaussians_sum_l2(
            *leaves, torch.from_numpy(gt), H, W,
            radii=torch.from_numpy(radii), config=tcfg)
    assert int(aux["n_dropped"]) == 0
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)

    oleaves = _leaves(args, torch.float64)
    o_img = render_sum_dense(*oleaves, H, W, q_cut=9.0)
    if objective == "render":
        o_alpha = render_sum_dense(oleaves[0], oleaves[1],
                                   torch.ones(N, 1, dtype=torch.float64),
                                   oleaves[3], H, W, q_cut=9.0)[..., 0]
        ((o_img ** 2).sum() + 0.5 * (o_alpha ** 2).sum()).backward()
    else:
        o_img = torch.clamp(o_img.permute(2, 0, 1), 0.0, 1.0)
        ((o_img - torch.from_numpy(gt).double()) ** 2).mean().backward()
    for name, a, b, o in zip(NAMES, [x.grad for x in leaves], j_grads,
                             [x.grad for x in oleaves]):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        o = o.numpy()
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(a[off], o[off], rtol=1e-4,
                                   atol=1e-5 * np.abs(o).max(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile16_in_order_and_aligned_equal_flat(seed):
    """At 16: the in-order forward equals index_add_'s (the CPU adds in
    stream order), flat and aligned; the aligned image, SSE and gradient
    rows equal the flat ones bit for bit."""
    feat, sp = _stream(seed, "flat")
    _, spa = _stream(seed, "aligned")
    assert spa.aligned and not sp.aligned
    blocks = sc.blockize_stream_plain(feat, spa.gids)
    img = rs.sum_fwd_plain(feat, sp.gids, sp.starts, H, W, TILE)
    assert torch.equal(img, rs.sum_fwd_plain(feat, sp.gids, sp.starts, H, W,
                                             TILE, in_order=True))
    img_a = rs.sum_fwd_aligned_plain(blocks, spa.starts, spa.counts, H, W,
                                     TILE, in_order=True)
    assert torch.equal(img_a, img)
    gt = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (3, H, W)).astype(np.float32))
    sse, dg = rs.sum_l2(feat, sp.gids, sp.starts, gt, H, W, TILE)
    sse_a, dgb = rs.sum_l2_aligned(blocks, spa.starts, spa.counts, gt, H, W,
                                   TILE)
    assert torch.equal(sse_a, sse)
    n = feat.shape[0]
    assert torch.equal(
        sc.scatter_block_grads(dgb, spa.gids, n, spa.m_span),
        sc.scatter_stream_grads(dg, sp.gids, n, sp.m_span))
    # K3 is K1 -> L2 -> K2 on the same stream, exactly
    diff, G = rs.l2_cotangent(img[:3], gt, H, W)
    assert torch.equal(dg, rs.sum_bwd(feat, sp.gids, sp.starts, G, H, W,
                                      TILE))
    assert sse.shape == ((H // TILE) * (W // TILE),)


def test_tile16_cull_keeps_every_gated_pair():
    """The cull K1-K3 stage at 16 (``sum_cull_plain(..., tile_px=16)``):
    every pair of a window that passes the gate lies in its slot's
    rectangle and in an 8 x 4 patch that meets it; a 16-pixel tile is two
    warps of one 16 x 8 block each, and each slot's mask has 8 bits (two
    warps x four patches), of which the kept patches are a subset."""
    feat, sp = _stream(7, "flat")
    pidx = torch.arange(TILE * TILE)
    X, Y = pidx % TILE, pidx // TILE
    gated = kept = visits = slots = 0
    for pr in rs.window_pairs(sc.gather_stream(sp.gids, feat), sp.starts,
                              sp.counts, H, W, TILE):
        tx0 = ((pr.tile % sp.tiles_x) * TILE).float()
        ty0 = (torch.div(pr.tile, sp.tiles_x, rounding_mode="floor")
               * TILE).float()
        cl = rs.sum_cull_plain(pr.rows, tx0, ty0, 9.0, tile_px=TILE)
        assert bool((cl.x1 < TILE).all() & (cl.y1 < TILE).all())
        on = pr.inside & (pr.q <= 9.0)
        rect = ((X >= cl.x0[:, None]) & (X <= cl.x1[:, None])
                & (Y >= cl.y0[:, None]) & (Y <= cl.y1[:, None]))
        meets = rs.cull_patches(cl, TILE, rs.PATCH)
        assert not bool((on & ~rect).any())
        assert not bool((on & ~meets).any())
        # the slot's mask: patch j = jx + 2 jy of warp w (the 16 x 8 block
        # at rows 8w), bit 4w + j
        px, py = (X // 8), (Y // 4)
        bit = 4 * (py // 2) + (px % 2) + 2 * (py % 2)
        mask = torch.zeros(pr.rows.shape[0], dtype=torch.int64)
        for b in range(8):
            mask |= (meets & (bit == b)).any(dim=1).long() << b
        assert int(mask.max()) < 256
        gated += int(on.sum())
        kept += int((pr.inside & meets).sum())
        visits += int(rs.cull_patches(cl, TILE, rs.WARP_BLOCK).sum()) // 128
        slots += pr.rows.shape[0]
    assert 0 < gated <= kept
    assert visits <= 2 * slots


def test_tile16_wrappers_take_16_and_32_only():
    feat, sp = _stream(3, "flat")
    for tile in (16, 32):
        rs._check_tile_px("K1", tile, rs._TILES)
    with pytest.raises(NotImplementedError, match="tile_px=8"):
        rs._check_tile_px("K1", 8, rs._TILES)
    # a CPU tensor takes the plain version at 16
    assert torch.equal(rs.sum_fwd(feat, sp.gids, sp.starts, H, W, TILE),
                       rs.sum_fwd_plain(feat, sp.gids, sp.starts, H, W,
                                        TILE))
