"""Port parity, core math: NDC->pixel, covariance, conic (with the 1e-6
determinant floor), radii and project_gaussians_2d against the JAX package
on the same numpy inputs (rtol/atol 1e-6: same float32 operations in the
same order), and the dense float64 oracle (atol 1e-10)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu import core as jcore  # noqa: E402
from gaussianimage_tpu_torch import core as tcore  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(N, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.98, 0.98, (N, 2)).astype(np.float32)
    chol = rng.uniform(0.2, 2.5, (N, 3)).astype(np.float32)
    chol[:, 1] = rng.uniform(-1.5, 1.5, N).astype(np.float32)
    # near-degenerate rows: det(L L^T) = (l11 l22)^2 falls below the floor
    chol[0] = (1e-4, 0.3, 1e-4)
    chol[1] = (2e-4, -0.7, 3e-4)
    return means, chol


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("H,W", [(32, 32), (70, 100), (512, 768)])
def test_ndc_to_pixel(H, W):
    means, _ = _inputs(257, seed=H)
    np.testing.assert_allclose(
        _np(tcore.ndc_to_pixel(torch.from_numpy(means), H, W)),
        _np(jcore.ndc_to_pixel(jnp.asarray(means), H, W)), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covariance_conic_radius(seed):
    _, chol = _inputs(300, seed)
    cov_t = tcore.cov2d_from_cholesky(torch.from_numpy(chol))
    cov_j = jcore.cov2d_from_cholesky(jnp.asarray(chol))
    np.testing.assert_allclose(_np(cov_t), _np(cov_j), **TOL)
    conic_t = tcore.conic_from_cov2d(cov_t)
    conic_j = jcore.conic_from_cov2d(cov_j)
    # the degenerate rows hit the 1e-6 floor: finite, and equal to JAX
    assert np.isfinite(_np(conic_t)).all()
    det = _np(cov_t)[:2, 0] * _np(cov_t)[:2, 2] - _np(cov_t)[:2, 1] ** 2
    assert (det < 1e-6).all()
    np.testing.assert_allclose(_np(conic_t), _np(conic_j), **TOL)
    np.testing.assert_allclose(_np(tcore.radius_from_cov2d(cov_t)),
                               _np(jcore.radius_from_cov2d(cov_j)), **TOL)


def test_det_floor_gradient_at_tie_matches_jax():
    """At det == 1e-6 exactly the floor splits the gradient between det
    and the floor, as jnp.maximum does (torch.clamp would pass it all to
    det); above and below the floor the two agree too."""
    eps = np.float32(1e-6)
    cov = np.asarray([[eps, 0.0, 1.0],        # det == eps: the tie
                      [eps / 2, 0.0, 1.0],    # below the floor
                      [2.0, 0.5, 1.0]], np.float32)
    w = np.asarray([[0.3, -1.2, 0.7], [1.1, 0.4, -0.5], [0.2, 0.9, 1.3]],
                   np.float32)
    cov_t = torch.from_numpy(cov).requires_grad_(True)
    (tcore.conic_from_cov2d(cov_t) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda c: jnp.sum(jcore.conic_from_cov2d(c) * w))(
        jnp.asarray(cov))
    # rtol 1e-5: the backward chains a few more roundings than the forward
    np.testing.assert_allclose(_np(cov_t.grad), _np(want), rtol=1e-5)
    # the tie row's det gradient is halved: d/dc of max(c * 1, eps) is 0.5
    det = torch.from_numpy(cov[:1, 0] * cov[:1, 2]).requires_grad_(True)
    torch.maximum(det, det.new_full((), 1e-6)).sum().backward()
    assert float(det.grad) == 0.5 == float(jax.grad(
        lambda d: jnp.sum(jnp.maximum(d, 1e-6)))(jnp.asarray(cov[:1, 0]))[0])


@pytest.mark.parametrize("N,H,W", [(150, 32, 32), (300, 70, 100),
                                   (1000, 512, 768)])
def test_project_gaussians_2d(N, H, W):
    means, chol = _inputs(N, seed=N)
    tb = (-(-W // 16), -(-H // 16), 1)
    got = tcore.project_gaussians_2d(torch.from_numpy(means),
                                     torch.from_numpy(chol), H, W, tb)
    want = jcore.project_gaussians_2d(jnp.asarray(means), jnp.asarray(chol),
                                      H, W, tb)
    assert len(got) == 5
    for name, g, w in zip(("xys", "depths", "radii", "conics",
                           "num_tiles_hit"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL)
    assert got[4].dtype == torch.int32


def _dense_scene(N, H, W, seed):
    rng = np.random.default_rng(seed)
    xys = np.stack([rng.uniform(-4, W + 4, N), rng.uniform(-4, H + 4, N)],
                   axis=1)
    l11, l22 = rng.uniform(0.7, 4.0, N), rng.uniform(0.7, 4.0, N)
    l21 = rng.uniform(-2.0, 2.0, N)
    s11, s12, s22 = l11 * l11, l11 * l21, l21 * l21 + l22 * l22
    det = s11 * s22 - s12 * s12
    conics = np.stack([s22 / det, -s12 / det, s11 / det], axis=1)
    colors = rng.uniform(-0.2, 1.0, (N, 3))
    opac = rng.uniform(0.2, 1.0, (N, 1))
    radii = np.ceil(3.0 * np.sqrt(np.maximum(s11, s22)))
    return xys, conics, colors, opac, radii


@pytest.mark.parametrize("q_cut,use_radii", [(None, False), (9.0, False),
                                             (None, True), (9.0, True)])
@pytest.mark.parametrize("N,H,W", [(150, 32, 32), (300, 70, 100)])
def test_render_sum_dense_matches_jax_oracle_f64(N, H, W, q_cut, use_radii):
    xys, conics, colors, opac, radii = _dense_scene(N, H, W, seed=N + H)
    r = radii if use_radii else None
    got = tcore.render_sum_dense(
        *(torch.from_numpy(a) for a in (xys, conics, colors, opac)), H, W,
        radii=None if r is None else torch.from_numpy(r), chunk=64,
        q_cut=q_cut)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(jcore.render_sum_dense(
            *(jnp.asarray(a) for a in (xys, conics, colors, opac)), H, W,
            radii=None if r is None else jnp.asarray(r), chunk=64,
            q_cut=q_cut))
    assert want.dtype == np.float64
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-10)
