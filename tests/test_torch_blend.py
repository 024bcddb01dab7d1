"""Port parity, the depth-sorted alpha-blend rasterizer of the 3DGS baseline
(ops/rasterize_blend.py): the depth order bit for bit, the plain versions of
K8 (forward) and K9 (backward) against the JAX package's Pallas kernels in
interpret mode, K9's plain version against autograd through the plain K8,
and the wrappers' refusal to fall back. The scenes are the JAX suite's
(tests/test_gs3d.py): N = 120 on 32x48 with a colored background, and the
early-stop case, N = 512 near-opaque Gaussians on 32x32; and the N = 120
scene under caps that drop instances (a 2-tile span, a 128-slot stream),
where the truncated stream, the scatter over the capped span and the
gradients must still be JAX's.

Tolerances:
- the depth order, the stream (gids, starts) and the chunks each tile
  consumed: exact;
- image and alpha: atol 1e-4. JAX's kernel takes its per-chunk prefix sums
  of log(1 - alpha) with two bf16 matmul passes, which leave up to 4e-5 in
  logT (gaussianimage_tpu/ops/rasterize_blend.py:89-100); the port walks
  the slots in float32;
- gradients: 5e-4 of each column's largest magnitude, as the JAX suite
  holds its kernels to its XLA oracle (tests/test_gs3d.py:181-185); K9's
  plain version against autograd through the plain K8 to 1e-4 of it
  (measured 4.3e-5 on the near-opaque scene, where (S + G_T T_fin) /
  (1 - alpha) cancels against (G.c) T_k at alpha up to 0.95: K9 takes
  T_k as exp(logT_fin - suffix), autograd differentiates the prefix
  walk).
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.ops import rasterize_blend as jrb  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_blend as trb  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402

IMG_TOL = 1e-4
GRAD_TOL = 5e-4
SELF_TOL = 1e-4
INPUTS = ("xys", "conics", "colors", "opac")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scene(name):
    """The JAX suite's blend scenes, from its seeds, with their stream caps
    (BlendConfig fields; none but in the dropping case)."""
    caps = {}
    if name == "n120_drop":
        caps = dict(max_instances=128, max_tiles_per_gauss=2)
    if name.startswith("n120"):  # tests/test_gs3d.py:151
        rng = np.random.default_rng(11)
        N, H, W = 120, 32, 48
        xys = rng.uniform(-4, 52, (N, 2)).astype(np.float32)
        s2 = rng.uniform(0.05, 0.6, N).astype(np.float32)
        b = (0.3 * s2 * rng.uniform(-1, 1, N)).astype(np.float32)
        conics = np.stack([s2, b, s2], -1)
        colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        opac = rng.uniform(0.1, 0.95, (N,)).astype(np.float32)
        depths = rng.uniform(1, 10, N).astype(np.float32)
        radii = np.full((N,), 14.0, np.float32)
        bg = np.asarray([0.2, 0.5, 0.8], np.float32)
    else:  # "n512", the early-stop case, tests/test_gs3d.py:222
        rng = np.random.default_rng(33)
        N, H, W = 512, 32, 32
        xys = rng.uniform(4, 28, (N, 2)).astype(np.float32)
        s2 = rng.uniform(0.01, 0.04, N).astype(np.float32)
        conics = np.stack([s2, np.zeros(N, np.float32), s2], -1)
        colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        opac = rng.uniform(0.7, 0.95, (N,)).astype(np.float32)
        depths = rng.uniform(1, 10, N).astype(np.float32)
        radii = np.full((N,), 10.0, np.float32)
        bg = np.zeros(3, np.float32)
    return dict(xys=xys, conics=conics, colors=colors, opac=opac,
                depths=depths, radii=radii, bg=bg, H=H, W=W, caps=caps)


def _cotangent(s, seed=5):
    """A cotangent of (rgb [H, W, 3], T_fin [H, W]) from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s["H"], s["W"], 3)).astype(np.float32),
            rng.standard_normal((s["H"], s["W"])).astype(np.float32))


def _jax_kernels(s, cfg, g):
    """The JAX package's blend internals on scene s: (rgb, T_fin, the chunks
    each tile consumed, gids, starts, the cotangent of the ordered rows for
    the cotangent g), with its K8 and K9 in interpret mode."""
    H, W = s["H"], s["W"]
    N = s["xys"].shape[0]

    @jax.jit
    def run(xys, depths, radii, conics, colors, opac, g_rgb, g_t):
        order = jrb._depth_order(depths)
        sp = jsc.prepare_stream(jnp.take(xys, order, axis=0),
                                jnp.take(radii, order, axis=0), H, W, cfg)
        order_pad = jnp.concatenate([order, jnp.asarray([N], jnp.int32)])
        feat = jsc.pack_feat(xys, conics, colors, opac)[order_pad]
        static = (cfg.tile_px, cfg.tiles_per_step, cfg.block_inst,
                  sp.tiles_x, sp.T, True, H, W, sp.I, float(cfg.alpha_clip),
                  float(cfg.alpha_min), sp.aligned,
                  float(np.log(cfg.early_stop_T)) if cfg.early_stop_T > 0
                  else float("-inf"))
        (rgb, tfin), res = jrb._blend_fwd(static, sp.gids, sp.starts,
                                          sp.counts, feat)
        dfeat = jrb._blend_bwd(static, res, (g_rgb, g_t))[3]
        T_real = sp.tiles_x * (-(-H // cfg.tile_px))
        return (rgb, tfin, res[4][:T_real, 5, 0], sp.gids, sp.starts, dfeat,
                sp.n_dropped)

    out = run(*(jnp.asarray(s[k]) for k in
                ("xys", "depths", "radii", "conics", "colors", "opac")),
              jnp.asarray(g[0]), jnp.asarray(g[1]))
    return [np.asarray(x) for x in out]


def _port_stream(s, cfg):
    """The port's (feat rows in depth order, StreamPrep) of scene s."""
    t = {k: torch.from_numpy(s[k]) for k in s if isinstance(s[k], np.ndarray)}
    order, sp = trb.blend_stream(t["xys"], t["depths"], t["radii"], s["H"],
                                 s["W"], cfg)
    feat = trb.blend_feat(t["xys"], t["conics"], t["colors"], t["opac"],
                          order)
    return feat, sp


def _kw(cfg):
    return dict(tile_px=cfg.tile_px, block_inst=cfg.block_inst,
                alpha_clip=cfg.alpha_clip, alpha_min=cfg.alpha_min)


def _col_err(got, want):
    """Largest |got - want| / the column's largest |want| (last axis)."""
    got = np.asarray(got).reshape(-1, np.asarray(got).shape[-1])
    want = np.asarray(want).reshape(got.shape)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("n", [384, 20000])
def test_depth_order_is_jax_bit_for_bit(n):
    """The packed-key order (N <= 16384, low depth bits dropped) and the
    stable argsort (N > 16384) equal JAX's exactly, on the model's depth
    range [7, 9] where many depths share their kept bits."""
    d = np.random.default_rng(n).uniform(7.0, 9.0, n).astype(np.float32)
    want = np.asarray(jrb._depth_order(jnp.asarray(d)))
    got = trb._depth_order(torch.from_numpy(d)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if n <= 16384:  # the dropped bits matter: not a plain argsort
        assert not np.array_equal(got, np.argsort(d, kind="stable"))


@pytest.mark.parametrize("name", ["n120", "n512", "n120_drop"])
def test_plain_blend_kernels_match_jax(name):
    """The port's stream (and its drop count) equals JAX's; the plain K8's
    rgb, T_fin and chunks per tile match JAX's K8; the plain K9's rows,
    scattered onto the ordered rows, match JAX's K9 for a random
    cotangent."""
    s = _scene(name)
    cfg_j = jrb.BlendConfig(**s["caps"])
    cfg_t = trb.BlendConfig(**s["caps"])
    g = _cotangent(s)
    (rgb_j, tfin_j, nch_j, gids_j, starts_j, dfeat_j,
     dropped_j) = _jax_kernels(s, cfg_j, g)
    feat, sp = _port_stream(s, cfg_t)
    np.testing.assert_array_equal(sp.gids.numpy(), gids_j)
    np.testing.assert_array_equal(sp.starts.numpy(), starts_j)
    assert int(sp.n_dropped) == int(dropped_j)
    assert (int(dropped_j) > 0) == bool(s["caps"])

    out, nch = trb.blend_fwd_plain(feat, sp.gids, sp.starts, s["H"], s["W"],
                                   log_stop=trb.log_stop(cfg_t), **_kw(cfg_t))
    np.testing.assert_array_equal(nch.numpy(), nch_j.astype(np.int32))
    np.testing.assert_allclose(out[:3].permute(1, 2, 0).numpy(), rgb_j,
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(out[3].numpy(), tfin_j, rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(out[3].numpy(), np.exp(out[4].numpy()),
                               rtol=1e-6)

    G = torch.cat([torch.from_numpy(g[0]).permute(2, 0, 1),
                   torch.from_numpy(g[1])[None]]).contiguous()
    dg = trb.blend_bwd_plain(feat, sp.gids, sp.starts, out[4], nch, G,
                             s["H"], s["W"], **_kw(cfg_t))
    dfeat = tsc.scatter_stream_grads(dg, sp.gids, feat.shape[0], sp.m_span)
    assert _col_err(dfeat.numpy()[:, :9], dfeat_j[:, :9]) <= GRAD_TOL
    assert not dfeat[:, 9:].any()

    if name == "n512":  # the early stop is live here: without it every
        # tile walks its whole window
        _, nch_all = trb.blend_fwd_plain(feat, sp.gids, sp.starts, s["H"],
                                         s["W"], log_stop=-math.inf,
                                         **_kw(cfg_t))
        assert (nch < nch_all).all()


@pytest.mark.parametrize("name", ["n120", "n512", "n120_drop"])
def test_blend_gradients_match_jax_grad(name):
    """rasterize_gaussians_blend through autograd (the plain K8 and K9, the
    scatter and the reorder) against jax.grad of JAX's
    rasterize_gaussians_blend, for sum(img^2) + 0.3 sum(alpha^2) (the JAX
    suite's loss): the image, alpha, the drop count and all four
    gradients."""
    s = _scene(name)
    H, W = s["H"], s["W"]

    def jloss(args):
        img, alpha, aux = jrb.rasterize_gaussians_blend(
            args[0], jnp.asarray(s["depths"]), jnp.asarray(s["radii"]),
            args[1], args[2], args[3], H, W, background=jnp.asarray(s["bg"]),
            config=jrb.BlendConfig(**s["caps"]))
        return (jnp.sum(img ** 2) + 0.3 * jnp.sum(alpha ** 2),
                (img, alpha, aux["n_dropped"]))

    (_, (img_j, alpha_j, dropped_j)), grads_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(tuple(jnp.asarray(s[k]) for k in INPUTS))
    args = [torch.from_numpy(s[k]).requires_grad_() for k in INPUTS]
    img, alpha, aux = trb.rasterize_gaussians_blend(
        args[0], torch.from_numpy(s["depths"]), torch.from_numpy(s["radii"]),
        args[1], args[2], args[3], H, W, background=torch.from_numpy(s["bg"]),
        config=trb.BlendConfig(**s["caps"]))
    assert int(aux["n_dropped"]) == int(dropped_j)
    assert (int(dropped_j) > 0) == bool(s["caps"])
    ((img ** 2).sum() + 0.3 * (alpha ** 2).sum()).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(alpha_j),
                               rtol=0, atol=IMG_TOL)
    for a, b, k in zip(args, grads_j, INPUTS):
        want = np.asarray(b).reshape(len(b), -1)
        assert _col_err(a.grad.numpy().reshape(want.shape), want) \
            <= GRAD_TOL, k


@pytest.mark.parametrize("name", ["n120", "n512"])
def test_plain_k9_is_autograd_of_plain_k8(name):
    """K9's plain version is the gradient of the plain K8 (differentiated
    by autograd through its walk, over the chunks it consumed) for a random
    cotangent of (rgb, T_fin), row by row."""
    s = _scene(name)
    cfg = trb.BlendConfig()
    feat, sp = _port_stream(s, cfg)
    g = _cotangent(s, seed=9)
    G = torch.cat([torch.from_numpy(g[0]).permute(2, 0, 1),
                   torch.from_numpy(g[1])[None]]).contiguous()
    leaf = feat.detach().requires_grad_()
    out, nch = trb.blend_fwd_plain(leaf, sp.gids, sp.starts, s["H"], s["W"],
                                   log_stop=trb.log_stop(cfg), **_kw(cfg))
    want, = torch.autograd.grad((out[:4] * G).sum(), leaf)
    dg = trb.blend_bwd_plain(feat, sp.gids, sp.starts, out[4].detach(), nch,
                             G, s["H"], s["W"], **_kw(cfg))
    got = tsc.scatter_stream_grads(dg, sp.gids, feat.shape[0], sp.m_span)
    assert _col_err(got[:-1, :9].numpy(), want[:-1, :9].numpy()) <= SELF_TOL


def test_blend_wrappers_never_fall_back():
    """A non-CPU tensor either launches K8 / K9 or raises: on meta tensors
    (no CUDA here) the wrappers refuse instead of taking the plain
    versions."""
    feat = torch.zeros(5, 16, device="meta")
    gids = torch.zeros(64, dtype=torch.int32, device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        trb.blend_fwd(feat, gids, starts, 16, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        trb.blend_bwd(feat, gids, starts, torch.zeros(16, 16, device="meta"),
                      torch.zeros(1, dtype=torch.int32, device="meta"),
                      torch.zeros(4, 16, 16, device="meta"), 16, 16)
