"""Port parity, gradients: the port's differentiable rasterizer (K1 forward,
K2 backward, through torch.autograd) and its fused render + L2 + backward
(K3), taking their plain versions on the CPU, against jax.grad of the JAX
package's rasterizers (Pallas interpret mode) and against the port's own
float64 dense oracle.

Tolerances are the JAX suite's: rtol 5e-3 / atol 1e-3 x the gradient's
largest magnitude for a kernel against its oracle
(tests/test_rasterize_kernel.py:44-75), and loss rtol 1e-6, gradients rtol
1e-4 / atol 1e-8 for the fused objective against the unfused one
(:202-236). Between the two packages the backward's moments differ: the
port sums them directly over the pixel offsets, where the TPU kernel
recombines tile-local moments (da = mxx - 2 gx mx + gx^2 m0), which cancels
for small Gaussians far from the tile origin. So some fused position and
conic gradients of the JAX package sit up to ~1% relative off the float64
oracle (more under no_clamp, where the cotangents are larger), where the
port's agree with it to ~1e-7. Against the JAX fused gradients each entry
of the port is held to rtol 1e-4 / atol 1e-8 of the JAX entry or, where
that fails, to the same tolerance of the float64 oracle's entry, and nearer
to it than the JAX entry is."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_gaussians_sum as j_raster  # noqa: E402
from gaussianimage_tpu.ops.rasterize_sum import (  # noqa: E402
    rasterize_gaussians_sum_l2 as j_raster_l2)
from gaussianimage_tpu_torch.core import render_sum_dense  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as sc  # noqa: E402

NAMES = ("xys", "conics", "colors", "opac")
CASES = [(150, 32, 32), (300, 32, 32), (150, 70, 100), (300, 70, 100)]


@pytest.fixture(autouse=True)
def _two_threads():
    """The plain kernel versions run many small tensor ops. Under the
    suite's parallel workers, torch's default of one thread per core
    oversubscribes the CPU several times over and each op waits on its
    threads, so the tests here run on two."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scene(N, H, W, seed):
    """(xys, radii, conics, colors, opac) as writable float32 numpy, made
    as the JAX suite makes its scenes."""
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


def _assert_grads(got, want, rtol, atol_scale=None, atol=None):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        tol = atol if atol is not None else atol_scale * (np.abs(b).max()
                                                         + 1e-8)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=name)


@pytest.mark.parametrize("N,H,W", CASES)
def test_rasterize_grad_matches_jax_and_oracle(N, H, W):
    """MSE on the image plus 0.1 x mean alpha, so both parts of the
    cotangent reach K2; gradients for all four inputs."""
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=N + H + W)
    target = np.random.default_rng(N).uniform(0, 1, (H, W, 3)).astype(
        np.float32)

    def j_loss(args):
        img, alpha, _ = j_raster(*args, H, W, radii=jnp.asarray(radii),
                                 config=JCfg())
        return jnp.mean((img - target) ** 2) + 0.1 * jnp.mean(alpha)

    j_args = tuple(jnp.asarray(a) for a in (xys, conics, colors, opac))
    j_val, j_grads = jax.value_and_grad(j_loss)(j_args)

    leaves = _leaves((xys, conics, colors, opac))
    img, alpha, aux = rs.rasterize_gaussians_sum(
        *leaves, H, W, radii=torch.from_numpy(radii))
    assert int(aux["n_dropped"]) == 0
    loss = ((img - torch.from_numpy(target)) ** 2).mean() + 0.1 * alpha.mean()
    loss.backward()
    got = [x.grad for x in leaves]
    np.testing.assert_allclose(float(loss.detach()), float(j_val),
                               rtol=1e-5)
    _assert_grads(got, j_grads, rtol=5e-3, atol_scale=1e-3)

    # the port's float64 dense oracle at q_cut=9, through torch autograd
    oleaves = _leaves((xys, conics, colors, opac), torch.float64)
    o_img = render_sum_dense(*oleaves, H, W, q_cut=9.0)
    o_alpha = render_sum_dense(oleaves[0], oleaves[1],
                               torch.ones(N, 1, dtype=torch.float64),
                               oleaves[3], H, W, q_cut=9.0)[..., 0]
    o_loss = (((o_img - torch.from_numpy(target).double()) ** 2).mean()
              + 0.1 * o_alpha.mean())
    o_loss.backward()
    _assert_grads(got, [x.grad for x in oleaves], rtol=5e-3, atol_scale=1e-3)


def _fused_case(N, H, W, seed, clamp):
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=seed)
    gt = np.random.default_rng(seed + 1).uniform(0, 1, (3, H, W)).astype(
        np.float32)
    if not clamp:  # exercise the no_clamp branch with over-bright renders
        colors = colors * 3.0
    return (xys, conics, colors, opac), radii, gt


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("N,H,W", [(150, 64, 96), (300, 70, 100)])
def test_fused_l2_matches_jax_and_unfused(N, H, W, clamp):
    args, radii, gt = _fused_case(N, H, W, seed=17 + N, clamp=clamp)

    def j_fused(a):
        mse, _ = j_raster_l2(*a, jnp.asarray(gt), H, W,
                             radii=jnp.asarray(radii), config=JCfg(),
                             clamp=clamp)
        return mse

    j_val, j_grads = jax.value_and_grad(j_fused)(
        tuple(jnp.asarray(a) for a in args))

    leaves = _leaves(args)
    mse, aux = rs.rasterize_gaussians_sum_l2(
        *leaves, torch.from_numpy(gt), H, W, radii=torch.from_numpy(radii),
        clamp=clamp)
    assert int(aux["n_dropped"]) == 0
    mse.backward()
    fused = [x.grad for x in leaves]
    np.testing.assert_allclose(float(mse.detach()), float(j_val), rtol=1e-6)

    # the float64 oracle of the same objective decides between the two
    # packages where they differ by more than the stated tolerance
    oleaves = _leaves(args, torch.float64)
    o_img = render_sum_dense(*oleaves, H, W, q_cut=9.0).permute(2, 0, 1)
    if clamp:
        o_img = torch.clamp(o_img, 0.0, 1.0)
    ((o_img - torch.from_numpy(gt).double()) ** 2).mean().backward()
    for name, a, b, o in zip(NAMES, fused, j_grads, oleaves):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        o = o.grad.numpy()
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(a[off], o[off], rtol=1e-4, atol=1e-8,
                                   err_msg=name)
        assert np.all(np.abs(a - o)[off] <= np.abs(b - o)[off]), name

    # the port's own unfused path: render (K1) -> clip -> L2 -> K2
    leaves = _leaves(args)
    img, _, _ = rs.rasterize_gaussians_sum_chw(
        *leaves, H, W, radii=torch.from_numpy(radii))
    if clamp:
        img = torch.clamp(img, 0.0, 1.0)
    ref = ((img - torch.from_numpy(gt)) ** 2).mean()
    ref.backward()
    np.testing.assert_allclose(float(mse.detach()), float(ref.detach()),
                               rtol=1e-6)
    _assert_grads(fused, [x.grad for x in leaves], rtol=1e-4, atol=1e-8)


def test_fused_plain_is_k1_then_l2_then_k2():
    """sum_l2_plain against its parts, run by hand on one stream: the same
    render, the same cotangent and so the same gradient rows, exactly."""
    N, H, W = 300, 70, 100
    (xys, conics, colors, opac), radii, gt = _fused_case(N, H, W, 5, True)
    t = [torch.from_numpy(a) for a in (xys, conics, colors, opac)]
    rxy = rs._axis_radii(t[1], torch.from_numpy(radii), 9.0)
    sp = sc.prepare_stream(t[0], rxy, H, W, rs.RasterizeConfig())
    feat = sc.pack_feat(*t, premultiply=True)
    gt_t = torch.from_numpy(gt)
    sse, dg = rs.sum_l2(feat, sp.gids, sp.starts, gt_t, H, W)
    img = rs.sum_fwd(feat, sp.gids, sp.starts, H, W)[:3]
    diff, G = rs.l2_cotangent(img, gt_t, H, W)
    assert torch.equal(dg, rs.sum_bwd(feat, sp.gids, sp.starts, G, H, W))
    assert sse.shape == (3 * 4,)
    np.testing.assert_allclose(float(sse.sum()), float((diff ** 2).sum()),
                               rtol=1e-6)


def test_scatter_sums_rows_per_gaussian_deterministically():
    """scatter_stream_grads against a float64 index_add_ of the same rows;
    the sink row N gets nothing, and a second call is bit-identical."""
    rng = np.random.default_rng(0)
    N, I, m_span = 40, 200, 12
    ids = np.concatenate([np.repeat(np.arange(N), rng.integers(0, m_span + 1,
                                                              N)), [N] * 7])
    gids = torch.from_numpy(rng.permutation(ids)[:I].astype(np.int32))
    dg = torch.from_numpy(rng.standard_normal((gids.shape[0] + 5, 16))
                          .astype(np.float32))
    got = sc.scatter_stream_grads(dg, gids, N + 1, m_span)
    want = torch.zeros(N + 1, 16, dtype=torch.float64).index_add_(
        0, gids.long(), dg[:gids.shape[0]].double())
    want[N] = 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got, sc.scatter_stream_grads(dg, gids, N + 1, m_span))


def test_no_graph_through_the_binning():
    """The stream is binned on detached inputs: a render under grad builds
    its graph through the packed rows only, and a render under no_grad
    builds none."""
    N, H, W = 150, 32, 32
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=0)
    leaves = _leaves((xys, conics, colors, opac))
    img, alpha, _ = rs.rasterize_gaussians_sum(*leaves, H, W)
    assert img.requires_grad and img.grad_fn is not None
    with torch.no_grad():
        img, _, _ = rs.rasterize_gaussians_sum(*leaves, H, W)
    assert not img.requires_grad
