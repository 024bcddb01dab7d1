"""Port parity, the aligned instance stream (the layout above
``flat_stream_limit`` instances): the port's binning against the JAX
package's, integer for integer; the plain versions of K11a / K11b against
the JAX package's Pallas relayout kernels in interpret mode; the aligned
render, fused L2 and blend and their gradients against the JAX package's
aligned path; the port's aligned path against its own flat path, bit for
bit; the K11 wrappers' refusal to fall back; and the committed 20k / 40k
fits rendered by both packages, with the PSNR anchors that chip_smoke.py
holds the card's evaluation to.

Small scenes made from seeds with numpy: the JAX suite's N = 220 on 64x96
(tests/test_rasterize_kernel.py:150) and N = 100 on 32x48
(tests/test_gs3d.py:187), forced onto the aligned stream with
``flat_stream_limit=0``.

Tolerances:
- binning (gids, starts, counts, n_dropped), K11a / K11b: exact;
- the sum render against JAX: atol 2e-5; its gradients (render + K2, and
  the fused K3) rtol 1e-4 / atol 1e-8 of the JAX entry or, where that
  fails, rtol 1e-4 / atol 1e-5 x the gradient's largest magnitude of the
  float64 oracle's entry (tests/test_torch_grad.py: the TPU kernel
  recombines tile-local moments, the port sums them directly);
- the blend against JAX: image 1e-4, gradients 5e-4 of each column's
  largest magnitude (tests/test_torch_blend.py: JAX's bf16 prefix sums);
- the port's aligned path against its flat path: bit for bit, since both
  walk the same chunks of the same instances in the same order.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_blend as jrb  # noqa: E402
from gaussianimage_tpu.ops import rasterize_gaussians_sum as j_raster  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu.ops.rasterize_sum import _axis_radii  # noqa: E402
from gaussianimage_tpu.ops.rasterize_sum import (  # noqa: E402
    rasterize_gaussians_sum_l2 as j_raster_l2)
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu_torch.core import render_sum_dense  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig as TCfg  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_blend as trb  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402
from gaussianimage_tpu_torch.train import SimpleTrainer2d  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    image_path_to_array, synthetic_image)

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("xys", "conics", "colors", "opac")
ALIGNED = dict(flat_stream_limit=0)
GRAD_TOL = 5e-4  # blend gradients, of each column's largest magnitude


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scene(N, H, W, seed, spread=0.95):
    """(xys, radii, conics, colors, opac) as writable float32 numpy, made
    as the JAX suite makes its scenes."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (N, 2)).astype(np.float32)
    chol = rng.uniform(0.3, 2.0, (N, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, (N, 1)).astype(np.float32)
    tb = (-(-W // 16), -(-H // 16), 1)
    xys, _, radii, conics, _ = project_gaussians_2d(
        jnp.asarray(means), jnp.asarray(chol), H, W, tb)
    return tuple(np.array(a) for a in (xys, radii, conics)) + (colors, opac)


def _rxy(xys, radii, conics):
    rx, ry = _axis_radii(jnp.asarray(conics), jnp.asarray(radii), 9.0)
    return np.array(rx), np.array(ry)


def _same_stream(jsp, tsp):
    assert tsp.aligned and bool(jsp.aligned)
    for name in ("gids", "starts", "counts", "n_dropped"):
        got = getattr(tsp, name).numpy()
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(getattr(jsp, name)),
                                      err_msg=name)
    assert (tsp.tiles_x, tsp.T, tsp.I) == (jsp.tiles_x, jsp.T, jsp.I)


# ------------------------------------------------------------- the binning


@pytest.mark.parametrize("case,cfg_kw,force_pair", [
    ("live", {}, False),
    ("stream_cap", dict(max_instances=64), False),
    ("span_cap", dict(max_tiles_per_gauss=2), False),
    ("pair_key", {}, True),
])
def test_aligned_stream_matches_jax(case, cfg_kw, force_pair):
    """``prepare_stream`` with ``flat_stream_limit=0`` against the JAX
    package's aligned binning: the windows rounded up to 64 slots, the
    capacity I0 + T_real * 64, the counts clipped at it and n_dropped, also
    when the stream cap cuts windows (counts clip) or the span cap
    truncates, and on the pair-key branch."""
    N, H, W = 300, 70, 100
    xys, radii, conics, _, _ = _scene(N, H, W, seed=7, spread=1.05)
    rx, ry = _rxy(xys, radii, conics)
    cfg_kw = dict(ALIGNED, **cfg_kw)
    jsp = jsc.prepare_stream(jnp.asarray(xys), (jnp.asarray(rx),
                                                jnp.asarray(ry)),
                             H, W, JCfg(**cfg_kw))
    tsp = tsc.prepare_stream(torch.from_numpy(xys),
                             (torch.from_numpy(rx), torch.from_numpy(ry)),
                             H, W, TCfg(**cfg_kw), force_pair=force_pair)
    _same_stream(jsp, tsp)
    assert int(tsp.starts[tsp.T]) % 64 == 0
    assert bool((tsp.starts % 64 == 0).all())
    dropped = int(tsp.n_dropped)
    assert (dropped > 0) == (case in ("stream_cap", "span_cap"))
    if case == "stream_cap":  # the capacity cuts the last windows
        assert int(tsp.starts[-1]) == tsp.I


def test_aligned_stream_of_depth_ordered_inputs_matches_jax():
    """The port bins depth-ordered inputs where the JAX package takes an
    ``order``: the JAX package's order mapped over the port's ids is its
    stream, slot for slot."""
    N, H, W = 300, 70, 100
    xys, radii, conics, _, _ = _scene(N, H, W, seed=9)
    rx, ry = _rxy(xys, radii, conics)
    order = np.random.default_rng(4).permutation(N).astype(np.int32)
    jsp = jsc.prepare_stream(jnp.asarray(xys), (jnp.asarray(rx),
                                                jnp.asarray(ry)),
                             H, W, JCfg(**ALIGNED), order=jnp.asarray(order))
    tsp = tsc.prepare_stream(torch.from_numpy(xys[order]),
                             (torch.from_numpy(rx[order]),
                              torch.from_numpy(ry[order])),
                             H, W, TCfg(**ALIGNED))
    order_pad = np.concatenate([order, [N]])
    np.testing.assert_array_equal(order_pad[tsp.gids.numpy()],
                                  np.asarray(jsp.gids))
    for name in ("starts", "counts", "n_dropped"):
        np.testing.assert_array_equal(getattr(tsp, name).numpy(),
                                      np.asarray(getattr(jsp, name)))


# ---------------------------------------------------------------- K11a, K11b


def test_plain_k11_matches_jax_relayout():
    """The plain K11a against the JAX package's ``gather_stream_blocks``
    (the gather, then ``blockize_stream``) and its ``blockize_stream`` on
    the gathered rows; the plain K11b against ``unblockize_stream``; the
    CPU wrappers take the plain versions. All bit for bit."""
    rng = np.random.default_rng(0)
    N, NB = 500, 40
    feat = np.concatenate([rng.standard_normal((N, 16)).astype(np.float32),
                           np.zeros((1, 16), np.float32)])
    gids = rng.integers(0, N + 1, NB * 64).astype(np.int32)
    dgb = rng.standard_normal((NB, 16, 64)).astype(np.float32)
    j_blocks, j_relayout, j_rows = jax.jit(lambda f, g, d: (
        jsc.gather_stream_blocks(g, f, 64, interpret=True),
        jsc.blockize_stream(f[g], 64, interpret=True),
        jsc.unblockize_stream(d, 64, interpret=True)))(
            *map(jnp.asarray, (feat, gids, dgb)))
    tfeat, tgids = torch.from_numpy(feat), torch.from_numpy(gids)
    blocks = tsc.blockize_stream_plain(tfeat, tgids)
    assert blocks.shape == (NB, 16, 64) and blocks.dtype == torch.float32
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(j_blocks))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(j_relayout))
    rows = tsc.unblockize_stream_plain(torch.from_numpy(dgb))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    assert torch.equal(tsc.blockize_stream(tfeat, tgids), blocks)
    assert torch.equal(tsc.unblockize_stream(blocks), tfeat[tgids.long()])


def test_k11_wrappers_never_fall_back():
    """A non-CPU tensor launches K11a / K11b or raises: on meta tensors (no
    CUDA here) the wrappers refuse rather than take the plain versions."""
    feat = torch.zeros(65, 16, device="meta")
    gids = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsc.blockize_stream(feat, gids)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsc.unblockize_stream(torch.zeros(2, 16, 64, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsc.scatter_block_grads(torch.zeros(2, 16, 64, device="meta"), gids,
                                65, 4)


# --------------------------------------------- the sum rasterizer against JAX


def _leaves(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def _against_jax_or_oracle(got, jax_grads, oracle_grads):
    """Each entry within rtol 1e-4 / atol 1e-8 of JAX's or else of the
    float64 oracle's, there with atol 1e-5 of the gradient's largest
    magnitude: float32 sums over a tile's pixels keep ~1e-6 of the largest
    term where they cancel."""
    for name, a, b, o in zip(NAMES, got, jax_grads, oracle_grads):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        o = o.numpy()
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(a[off], o[off], rtol=1e-4,
                                   atol=1e-5 * np.abs(o).max(), err_msg=name)


@pytest.mark.parametrize("objective", ["render", "fused_l2"])
def test_aligned_sum_matches_jax(objective):
    """The aligned render (K11a, K1; backward K2, K11b, the scatter) and the
    fused objective (K11a, K3, K11b, the scatter) against the JAX
    package's aligned path, which runs its Pallas kernels and
    ``scatter_block_grads`` in interpret mode."""
    N, H, W = 220, 64, 96
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=12)
    gt = np.random.default_rng(3).uniform(0, 1, (3, H, W)).astype(np.float32)
    args = (xys, conics, colors, opac)
    jcfg, tcfg = JCfg(**ALIGNED), TCfg(**ALIGNED)

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
    _against_jax_or_oracle([x.grad for x in leaves], j_grads,
                           [x.grad for x in oleaves])


# ---------------------------------------------------- the blend against JAX


def _blend_scene():
    """tests/test_gs3d.py:187's scene."""
    rng = np.random.default_rng(21)
    N, H, W = 100, 32, 48
    xys = rng.uniform(0, 48, (N, 2)).astype(np.float32)
    s2 = rng.uniform(0.05, 0.5, N).astype(np.float32)
    conics = np.stack([s2, np.zeros(N, np.float32), s2], -1)
    colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    opac = rng.uniform(0.1, 0.9, (N,)).astype(np.float32)
    depths = rng.uniform(1, 10, N).astype(np.float32)
    radii = np.full((N,), 12.0, np.float32)
    return (xys, conics, colors, opac), depths, radii, H, W


def _port_blend(args, depths, radii, H, W, cfg):
    leaves = _leaves(args)
    img, alpha, aux = trb.rasterize_gaussians_blend(
        leaves[0], torch.from_numpy(depths), torch.from_numpy(radii),
        leaves[1], leaves[2], leaves[3], H, W, config=cfg)
    loss = (img ** 2).sum() + 0.3 * (alpha ** 2).sum()
    loss.backward()
    return img.detach(), alpha.detach(), loss.detach(), leaves, aux


def test_aligned_blend_matches_jax():
    """The aligned blend (K11a, K8; backward K9, K11b, the scatter) against
    the JAX package's aligned blend in interpret mode."""
    args, depths, radii, H, W = _blend_scene()

    def j_loss(a):
        img, alpha, _ = jrb.rasterize_gaussians_blend(
            a[0], jnp.asarray(depths), jnp.asarray(radii), *a[1:], H, W,
            config=jrb.BlendConfig(**ALIGNED))
        return jnp.sum(img ** 2) + 0.3 * jnp.sum(alpha ** 2), (img, alpha)
    (j_val, (j_img, j_alpha)), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(tuple(map(jnp.asarray, args)))
    img, alpha, loss, leaves, aux = _port_blend(
        args, depths, radii, H, W, trb.BlendConfig(**ALIGNED))
    assert int(aux["n_dropped"]) == 0
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-4)
    for name, a, b in zip(NAMES, leaves, j_grads):
        b = np.asarray(b).reshape(a.grad.shape)
        scale = np.abs(b).max(axis=0, keepdims=True)
        assert np.all(np.abs(a.grad.numpy() - b) <= GRAD_TOL * scale), name


# ------------------------------------------ the port's aligned against flat


def test_aligned_sum_equals_flat_bit_for_bit():
    """Render, K2's gradients, the fused loss and K3's gradients: the
    aligned stream gives the flat stream's values bit for bit."""
    N, H, W = 220, 64, 96
    xys, radii, conics, colors, opac = _scene(N, H, W, seed=12)
    gt = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (3, H, W)).astype(np.float32))
    out = []
    for cfg in (TCfg(), TCfg(**ALIGNED)):
        r = _leaves((xys, conics, colors, opac))
        img, alpha, aux = rs.rasterize_gaussians_sum(
            *r, H, W, radii=torch.from_numpy(radii), config=cfg)
        ((img ** 2).sum() + 0.5 * (alpha ** 2).sum()).backward()
        f = _leaves((xys, conics, colors, opac))
        mse, aux_l2 = rs.rasterize_gaussians_sum_l2(
            *f, gt, H, W, radii=torch.from_numpy(radii), config=cfg)
        mse.backward()
        out.append([img.detach(), alpha.detach(), mse.detach()]
                   + [x.grad for x in r + f]
                   + [aux["n_dropped"], aux_l2["n_dropped"]])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_aligned_blend_equals_flat_bit_for_bit():
    args, depths, radii, H, W = _blend_scene()
    flat = _port_blend(args, depths, radii, H, W, trb.BlendConfig())
    aligned = _port_blend(args, depths, radii, H, W,
                          trb.BlendConfig(**ALIGNED))
    for a, b in zip(flat[:3], aligned[:3]):
        assert torch.equal(a, b)
    for a, b in zip(flat[3], aligned[3]):
        assert torch.equal(a.grad, b.grad)
    assert int(flat[4]["n_dropped"]) == int(aligned[4]["n_dropped"]) == 0


def test_aligned_fit_equals_flat_fit(tmp_path):
    """20 steps of ``SimpleTrainer2d`` (K3 through the aligned stream): the
    losses, the PSNRs and the parameters equal the flat twin's bit for
    bit."""
    args = SimpleNamespace(shape_bucket=0, save_imgs=False, profile=None,
                           lr=1e-3, opt_type="adan", seed=1, viz_every=0,
                           log_every=0, ckpt_every=0, resume=False)
    img = synthetic_image(48, 64, seed=5)
    fits = []
    for name, cfg in (("flat", TCfg()), ("aligned", TCfg(**ALIGNED))):
        tr = SimpleTrainer2d(img, "synth", num_points=200, iterations=20,
                             args=args, log_dir=tmp_path / name,
                             chunk_size=10, device="cpu")
        tr.model.cfg = dataclasses.replace(tr.model.cfg, raster=cfg)
        tr.fit()
        fits.append(tr)
    flat, aligned = fits
    assert flat._hist["loss"] == aligned._hist["loss"]
    assert flat._hist["psnr"] == aligned._hist["psnr"]
    assert flat.chunk_dropped == aligned.chunk_dropped == [0, 0]
    for (name, a), (_, b) in zip(flat.model.named_parameters(),
                                 aligned.model.named_parameters()):
        assert torch.equal(a, b), name


# the JAX package's render of the committed 20k and 40k fits, the anchors
# of chip_smoke.py's aligned_slice phase (the TPU runs' train.txt read
# 44.7886 / 33.2482 and 48.6414 / 39.5424: TPU numerics, 0.003-0.029 dB
# above the same checkpoints rendered by the JAX package off the TPU)
FIT_PSNR = {(20000, "flower"): 44.7811, (20000, "china"): 33.2452,
            (40000, "flower"): 48.6119, (40000, "china"): 39.5167}


@pytest.mark.parametrize("n,image", sorted(FIT_PSNR))
def test_fit_above_16384_points_renders_as_the_jax_package_renders_it(
        n, image):
    """The committed 20k and 40k fits of each photo through ``render()``:
    both packages take the aligned stream, drop nothing and score the same
    PSNR, within 0.005 dB of each other (tests/test_torch_slice.py's bound
    at 10k) and of the anchor."""
    params = load_checkpoint(
        ROOT / f"results/photos/GaussianImage_Cholesky_50000_{n}" / image
        / "gaussian_model.npz")["params"]
    H, W = 512, 768
    gt = image_path_to_array(ROOT / f"data/{image}_768x512.png")

    def psnr(img):
        d = np.asarray(img, np.float64) - gt
        return 10 * np.log10(1.0 / np.mean(d ** 2))

    jm = j_make_model("GaussianImage_Cholesky", num_points=n, H=H, W=W)
    jout = jm.render({k: jnp.asarray(v) for k, v in params.items()})
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=n,
                       H=H, W=W)
    model.load_state_dict(params_from_numpy(params))
    assert tsc.stream_caps(n, model.cfg.raster)[2]  # the aligned stream
    with torch.no_grad():
        out = model.render()
    assert int(out["raster_aux"]["n_dropped"]) == 0
    assert int(jout["raster_aux"]["n_dropped"]) == 0
    p_port, p_jax = psnr(out["render"].numpy()), psnr(jout["render"])
    assert abs(p_port - p_jax) <= 0.005, (p_port, p_jax)
    assert abs(p_jax - FIT_PSNR[(n, image)]) <= 0.005, p_jax
