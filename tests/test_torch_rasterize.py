"""Port parity, forward rasterizer: the plain K1 path (what a CPU tensor
takes) against the JAX package's rasterize_gaussians_sum (Pallas interpret
mode) and against the port's dense oracle at q_cut=9, with the JAX suite's
tolerance (rtol 2e-3 / atol 2e-4, tests/test_rasterize_kernel.py); the
aligned stream renders as the flat one, the calls the port does not
support raise NotImplementedError, and inputs that require grad get a
render that backpropagates (K2)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_gaussians_sum as j_raster  # noqa: E402
from gaussianimage_tpu_torch.core import render_sum_dense  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as sc  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-4)
CFG = RasterizeConfig()


def _scene(N, H, W, seed):
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


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


CASES = [(150, 32, 32), (300, 32, 32), (150, 70, 100), (300, 70, 100)]


@pytest.mark.parametrize("N,H,W", CASES)
def test_plain_path_matches_jax_kernel(N, H, W):
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=N + W)
    img, alpha, aux = rs.rasterize_gaussians_sum(
        *_t((xys, conics, colors, opac)), H, W,
        radii=torch.from_numpy(radii), config=CFG)
    jimg, jalpha, jaux = j_raster(
        *(jnp.asarray(a) for a in (xys, conics, colors, opac)), H, W,
        radii=jnp.asarray(radii), config=JCfg())
    assert tuple(img.shape) == (H, W, 3) and tuple(alpha.shape) == (H, W)
    assert int(aux["n_dropped"]) == int(jaux["n_dropped"]) == 0
    assert int(aux["max_per_tile_used"]) == int(jaux["max_per_tile_used"])
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **TOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), **TOL)


@pytest.mark.parametrize("N,H,W", CASES)
def test_plain_path_matches_oracle(N, H, W):
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=N + H)
    img_chw, alpha, _ = rs.rasterize_gaussians_sum_chw(
        *_t((xys, conics, colors, opac)), H, W,
        radii=torch.from_numpy(radii), config=CFG)
    ref = render_sum_dense(*_t((xys, conics, colors, opac)), H, W,
                           q_cut=CFG.q_cut)
    ref_alpha = render_sum_dense(*_t((xys, conics, colors[:, :1] * 0 + 1,
                                      opac)), H, W, q_cut=CFG.q_cut)[..., 0]
    np.testing.assert_allclose(img_chw.permute(1, 2, 0).numpy(),
                               ref.numpy(), **TOL)
    np.testing.assert_allclose(alpha.numpy(), ref_alpha.numpy(), **TOL)


def test_sum_fwd_plain_matches_gathered_stream():
    """K1's plain version on a hand-checked stream: the sum over each tile's
    window of the gathered rows (stream_common.gather_stream)."""
    N, H, W = 300, 70, 100
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=3)
    rxy = rs._axis_radii(torch.from_numpy(conics), torch.from_numpy(radii),
                         9.0)
    sp = sc.prepare_stream(torch.from_numpy(xys), rxy, H, W, CFG)
    feat = sc.pack_feat(*_t((xys, conics, colors, opac)), premultiply=True)
    out = rs.sum_fwd(feat, sp.gids, sp.starts, H, W)
    assert tuple(out.shape) == (4, H, W) and out.dtype == torch.float32
    g = sc.gather_stream(sp.gids, feat).double()
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    ref = torch.zeros(4, H, W, dtype=torch.float64)
    tiles_x = -(-W // 32)
    for t in range(tiles_x * (-(-H // 32))):
        rows = g[int(sp.starts[t]):int(sp.starts[t + 1])]
        ty, tx = divmod(t, tiles_x)
        m = (ys // 32 == ty) & (xs // 32 == tx)
        dx = xs[m].double()[None] - rows[:, 0:1]
        dy = ys[m].double()[None] - rows[:, 1:2]
        q = (rows[:, 2:3] * dx * dx + 2 * rows[:, 3:4] * dx * dy
             + rows[:, 4:5] * dy * dy).clamp(min=0)
        w = torch.where(q <= 9.0, torch.exp(-0.5 * q), torch.zeros_like(q))
        ref[:, m] = rows[:, 5:9].T @ w
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_unsupported_calls_raise():
    N, H, W = 150, 32, 32
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=0)
    args = _t((xys, conics, colors, opac))
    # the generic render does not read fused_prep (only render_fast and the
    # fused decode take the fused prep, as in the JAX package): under
    # serving(N) it bins under that config's caps and, dropping nothing
    # here, draws the default config's image
    img, alpha, aux = rs.rasterize_gaussians_sum(*args, H, W, config=CFG)
    for cfg in (CFG._replace(fused_prep=True), RasterizeConfig.serving(N)):
        img_s, alpha_s, aux_s = rs.rasterize_gaussians_sum(*args, H, W,
                                                           config=cfg)
        assert int(aux_s["n_dropped"]) == 0 == int(aux["n_dropped"])
        np.testing.assert_array_equal(img_s.numpy(), img.numpy())
        np.testing.assert_array_equal(alpha_s.numpy(), alpha.numpy())
        chw, _, _ = rs.rasterize_gaussians_sum_chw(*args, H, W, config=cfg)
        np.testing.assert_array_equal(chw.permute(1, 2, 0).numpy(),
                                      img.numpy())
    colors_g = args[2].clone().requires_grad_(True)
    img, alpha, _ = rs.rasterize_gaussians_sum(args[0], args[1], colors_g,
                                               args[3], H, W)
    (img.sum() + alpha.sum()).backward()  # K2's plain version
    assert colors_g.grad is not None and colors_g.grad.abs().sum() > 0
    with torch.no_grad():  # no graph is built, so no backward is needed
        img, _, _ = rs.rasterize_gaussians_sum(args[0], args[1], colors_g,
                                               args[3], H, W)
    assert img.grad_fn is None
    # the aligned stream renders, and equals the flat one bit for bit; its
    # kernels are built for 64-slot chunks only
    img, alpha, _ = rs.rasterize_gaussians_sum(*args, H, W, config=CFG)
    img_a, alpha_a, aux_a = rs.rasterize_gaussians_sum(
        *args, H, W, config=CFG._replace(flat_stream_limit=1024))
    assert int(aux_a["n_dropped"]) == 0
    assert torch.equal(img_a, img) and torch.equal(alpha_a, alpha)
    with pytest.raises(NotImplementedError, match="block_inst"):
        rs.rasterize_gaussians_sum(*args, H, W, config=CFG._replace(
            flat_stream_limit=1024, block_inst=32))
