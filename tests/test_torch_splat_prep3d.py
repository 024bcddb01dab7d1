"""Port parity, the fused 3DGS prep (K10): the plain version against the JAX
package's fused_prep_blend3d (Pallas interpret mode) at SH degrees 0-4 and
under a rotated camera with tight caps; the gate fused_blend_supported
against JAX's; Gaussian3D.render_fast under fused_prep against the JAX
render_fast and against the port's render(), with its aux; and the
wrapper's refusal to fall back. The scene is the JAX suite's
(tests/test_gs3d.py): 64x96, N = 384, from JAX's own init carried across as
numpy, the log scales made anisotropic, the higher SH bands and the
opacities drawn from a seed.

Tolerances. Sorted live keys, trunc and n_total are integer-exact. Feature
rows: rtol 1e-6 / atol 1e-6 (tests/test_torch_core.py's for the same
float32 operations). The port rounds op by op; inside the jitted Pallas
body XLA's CPU code does not (the conic's and the SH sums' last ulp), and
its exp and sigmoid may sit an ulp off torch's. No row of these scenes
needs a mask at this tolerance (measured at degrees 0-4: 85-97% of the
rows differ in the conic, color or opacity columns, by up to 2.3e-6 on a
conic entry of a few units), so every row is held to it. Images: the JAX
suite's fused-against-render envelope (tests/test_gs3d.py:279-284), max
|diff| < 5e-4 and a share of pixels above 5e-5 < 1e-3; the fused image against JAX's fused image to atol 1e-4,
the blend's (tests/test_torch_blend.py: JAX's bf16 prefix sums leave up to
4e-5 in log T).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import camera3d as jcam  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import rasterize_blend as jrb  # noqa: E402
from gaussianimage_tpu.ops import splat_prep3d as j3  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_blend as rb  # noqa: E402
from gaussianimage_tpu_torch.ops import splat_prep3d as p3  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    synthetic_image)

N, H, W = 384, 64, 96
TOL = dict(rtol=1e-6, atol=1e-6)
ENV_MAX = 5e-4     # fused against render(): max |diff|
ENV_PX = 5e-5      # ... and the share of pixels above this
ENV_SHARE = 1e-3
IMG_TOL = 1e-4     # the port's fused image against JAX's
INT_MAX = 2 ** 31 - 1
STEPS = 5          # Fusion2 steps of the JAX state before serving it


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(sh_degree, seed):
    """JAX's 3DGS init at PRNGKey(seed), its log scales made anisotropic
    (normal(0, 0.4)), the SH bands above DC normal(0, 0.3) and the opacity
    logits normal(-1, 1.5), as numpy."""
    jm = j_make_model("3DGS", num_points=N, H=H, W=W, loss_type="Fusion2",
                      sh_degree=sh_degree)
    st = jm.init_state(jax.random.PRNGKey(seed))
    p = {k: np.array(v) for k, v in st.params.items()}
    rng = np.random.default_rng(seed)
    p["_scaling"] = p["_scaling"] + rng.normal(0.0, 0.4, (N, 3)).astype(
        np.float32)
    p["_features_rest"] = rng.normal(
        0.0, 0.3, p["_features_rest"].shape).astype(np.float32)
    p["_opacity"] = rng.normal(-1.0, 1.5, (N, 1)).astype(np.float32)
    return jm, p


def _rows(p, sh_degree, order):
    """The kernel's five depth-ordered row inputs."""
    if sh_degree > 0:
        coeffs = np.concatenate([p["_features_dc"], p["_features_rest"]],
                                axis=1).reshape(N, -1)
    else:
        coeffs = p["_features_dc"][:, 0, :]
    return [np.ascontiguousarray(a[order]) for a in (
        p["_xyz"], p["_scaling"], p["_rotation"], p["_opacity"], coeffs)]


@pytest.mark.parametrize("case", ["deg0", "deg1", "deg2", "deg3", "deg4",
                                  "rotated_capped"])
def test_blend3d_prep_plain_matches_jax(case):
    """The plain K10 against JAX's fused_prep_blend3d on the same
    depth-ordered rows. ``rotated_capped``: degree 3 under a camera
    rotated by a random quaternion, 8% of the centers pushed behind its
    near plane (culled: no keys), 16-pixel tiles and a 3-tile span, so
    trunc > 0."""
    deg = 3 if case == "rotated_capped" else int(case[3:])
    jm, p = _params(deg, seed=10 + deg)
    V, tr = jm.viewmat, jm.translation
    tile_px, m_span = jm.blend_cfg.tile_px, None
    if case == "rotated_capped":
        q = np.random.default_rng(3).standard_normal((1, 4)).astype(
            np.float32)
        V = np.eye(4, dtype=np.float32)
        V[:3, :3] = np.asarray(jcam.quat_to_rotmat(jnp.asarray(q)))[0]
        V[:3, 3] = [0.3, -0.2, 8.0]
        tr = -V[:3, 3][None]
        # centers whose camera depth is below clip_near
        back = np.arange(0, N, 12)
        p["_xyz"][back] = (V[:3, :3].T @ np.asarray(
            [0.0, 0.0, -8.5], np.float32))
        tile_px, m_span = 16, 3
    bcfg = jm.blend_cfg._replace(tile_px=tile_px)
    if m_span is None:
        _, m_span, _ = jsc.stream_caps(N, bcfg)
    depth = p["_xyz"] @ V[2, :3] + V[2, 3]
    order = np.argsort(depth, kind="stable")
    rows = _rows(p, deg, order)
    jfeat, jkeys, jtrunc, jn_total = jax.jit(
        lambda *a: j3.fused_prep_blend3d(
            *a, V, jm.focal, jm.focal, W / 2, H / 2, tr, deg, H, W, bcfg,
            m_span))(*(jnp.asarray(r) for r in rows))
    jfeat, jkeys = np.asarray(jfeat), np.asarray(jkeys)
    cam = p3.camera(V, jm.focal, jm.focal, W / 2, H / 2, tr)
    before = p3.blend3d_prep.launches
    feat, keys, stats = p3.blend3d_prep(*(_t(r) for r in rows), cam, deg, H,
                                        W, tile_px, m_span)
    assert p3.blend3d_prep.launches == before  # CPU tensors: the plain K10
    assert feat.shape == (N + 1, 16) and keys.shape == (m_span, N + 1)
    keys = keys.numpy()
    live, jlive = keys[keys != INT_MAX], jkeys[jkeys != INT_MAX]
    np.testing.assert_array_equal(np.sort(live), np.sort(jlive))
    assert int(stats[0].sum()) == int(jtrunc)
    assert int(stats[1].sum()) == int(jn_total) == live.size
    if case == "rotated_capped":
        assert int(jtrunc) > 0
        culled = np.isin(order, back)
        assert culled.sum() == back.size
        assert not np.isin(live & ((1 << 9) - 1), np.nonzero(culled)[0]).any()
    np.testing.assert_array_equal(feat[N].numpy(), 0.0)
    np.testing.assert_allclose(feat.numpy(), jfeat[:N + 1], **TOL)


@pytest.mark.parametrize("deg", [0, 3])
@pytest.mark.parametrize("n", [1, 33, 65])
def test_blend3d_prep_plain_rows_match_jax(deg, n):
    """The plain K10 on the first n depth-ordered rows (the card's K10
    stages 64-row blocks: n = 1, 33, 65 leave a partial block and warp)
    against JAX's fused_prep_blend3d, under 16-pixel tiles and a 3-tile
    span so that rows are cut: the keys equal in their slot-major [M, N+1]
    layout, and each row's counts (trunc, live) equal min / excess of its
    area over M, the area read off JAX's keys under a span of every
    tile."""
    jm, p = _params(deg, seed=10 + deg)
    V, tr = jm.viewmat, jm.translation
    tile_px, m_span = 16, 3
    bcfg = jm.blend_cfg._replace(tile_px=tile_px)
    all_tiles = -(-H // tile_px) * -(-W // tile_px)
    depth = p["_xyz"] @ V[2, :3] + V[2, 3]
    rows = [r[:n] for r in _rows(p, deg, np.argsort(depth, kind="stable"))]

    def jax_keys(m):
        _, jkeys, jtrunc, jn_total = jax.jit(
            lambda *a: j3.fused_prep_blend3d(
                *a, V, jm.focal, jm.focal, W / 2, H / 2, tr, deg, H, W,
                bcfg, m))(*(jnp.asarray(r) for r in rows))
        jkeys = np.asarray(jkeys).reshape(m, -1)[:, :n + 1]
        return jkeys, int(jtrunc), int(jn_total)

    jkeys, jtrunc, jn_total = jax_keys(m_span)
    area = (jax_keys(all_tiles)[0] != INT_MAX).sum(axis=0)
    cam = p3.camera(V, jm.focal, jm.focal, W / 2, H / 2, tr)
    _, keys, stats = p3.blend3d_prep(*(_t(r) for r in rows), cam, deg, H, W,
                                     tile_px, m_span)
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(stats[0].numpy(),
                                  np.maximum(area - m_span, 0))
    np.testing.assert_array_equal(stats[1].numpy(),
                                  np.minimum(area, m_span))
    assert (int(stats[0].sum()), int(stats[1].sum())) == (jtrunc, jn_total)
    if n == 65:
        assert jtrunc > 0


def test_blend3d_prep_refuses_unaligned_rows():
    """K10 loads its row inputs as 16-byte vectors: the wrapper's
    alignment check passes a fresh tensor and refuses a view one [N, 3]
    row (12 bytes) into its storage. CPU tensors reach the plain version,
    so the check is called as the wrapper calls it on a CUDA tensor."""
    xyz = torch.zeros(9, 3)
    p3._check_aligned("K10", [("xyz", xyz), ("coeffs", torch.zeros(9, 48))])
    with pytest.raises(ValueError, match="16-byte"):
        p3._check_aligned("K10", [("xyz", xyz[1:])])


@pytest.mark.parametrize("n, h, w, kw", [
    (384, 64, 96, {"fused_prep": False}),                    # flag off
    (384, 64, 96, {"fused_prep": True}),
    (10000, 512, 768, {"fused_prep": True, "tile_px": 32,
                       "max_tiles_per_gauss": 36}),          # the model's
    (20000, 512, 768, {"fused_prep": True}),                 # aligned
    (1 << 20, 4096, 4096, {"fused_prep": True,               # wide keys
                           "flat_stream_limit": 1 << 30}),
])
def test_fused_blend_supported_matches_jax(n, h, w, kw):
    cfg, jcfg = rb.BlendConfig(**kw), jrb.BlendConfig(**kw)
    assert p3.fused_blend_supported(n, h, w, cfg) == \
        j3.fused_blend_supported(n, h, w, jcfg)


@pytest.fixture(scope="module")
def fitted():
    """{sh_degree: (JAX model, JAX params after STEPS Fusion2 steps)} from
    _params's scenes (the JAX suite trains its scene the same way)."""
    out = {}
    gt = jnp.asarray(synthetic_image(H, W, seed=11))
    for deg in (3, 0):
        jm, p = _params(deg, seed=5)
        st = jm.init_state(jax.random.PRNGKey(5))
        st = st._replace(params={k: jnp.asarray(v) for k, v in p.items()})
        st, _ = jax.jit(lambda s: jm.train_chunk(
            s, gt, None, jnp.asarray(1), STEPS))(st)
        out[deg] = {k: np.asarray(v) for k, v in st.params.items()}
    return out


@pytest.mark.parametrize("case", ["sh3", "sh0", "sh3_drop"])
def test_render_fast_fused_matches_jax_and_render(fitted, case):
    """render_fast under fused_prep (the plain K10, one sort, the plain K8)
    against the JAX model's render_fast under fused_prep, and against the
    port's render() within the envelope; its aux against render()'s.
    ``sh3_drop`` caps the stream at 256 instances, below the scene's
    ~730, so both paths cut it."""
    deg = 0 if case == "sh0" else 3
    params = fitted[deg]
    raster = RasterizeConfig(fused_prep=True)
    fused = make_model("3DGS", device="cpu", num_points=N, H=H, W=W,
                       loss_type="Fusion2", sh_degree=deg, raster=raster)
    fused.load_state_dict(params_from_numpy(params))
    jm = j_make_model("3DGS", num_points=N, H=H, W=W, loss_type="Fusion2",
                      sh_degree=deg, raster=JCfg(fused_prep=True))
    if case == "sh3_drop":
        fused.blend_cfg = fused.blend_cfg._replace(max_instances=256)
        jm.blend_cfg = jm.blend_cfg._replace(max_instances=256)
    assert p3.fused_blend_supported(N, H, W, fused.blend_cfg)
    before = (p3.blend3d_prep.launches, rb.blend_fwd.launches)
    fast, aux = fused.render_fast(with_aux=True)
    assert (p3.blend3d_prep.launches, rb.blend_fwd.launches) == before
    with torch.no_grad():
        pkg = fused.render()
    ref = pkg["render"].numpy()
    assert fast.shape == (1, 3, H, W)
    err = np.abs(fast.numpy() - ref)
    assert err.max() < ENV_MAX, err.max()
    assert (err > ENV_PX).mean() < ENV_SHARE
    nd = int(aux["n_dropped"])
    assert nd == int(pkg["raster_aux"]["n_dropped"])
    assert (nd > 0) == (case == "sh3_drop")
    assert int(aux["max_count"]) == int(pkg["raster_aux"]["max_count"])
    jfast = np.asarray(jax.jit(jm.render_fast)(
        {k: jnp.asarray(v) for k, v in params.items()}))
    np.testing.assert_allclose(fast.numpy(), jfast, rtol=0, atol=IMG_TOL)


def test_render_fast_flag_off_and_forward_only(fitted):
    """Without fused_prep render_fast is render()'s image, bit for bit; the
    keys' blend refuses a feature tensor that autograd would need."""
    model = make_model("3DGS", device="cpu", num_points=N, H=H, W=W,
                       loss_type="Fusion2")
    model.load_state_dict(params_from_numpy(fitted[3]))
    with torch.no_grad():
        np.testing.assert_array_equal(model.render_fast().numpy(),
                                      model.render()["render"].numpy())
    feat = torch.zeros(N + 1, 16, requires_grad=True)
    keys = torch.full((12 * (N + 1),), INT_MAX, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward only"):
        rb.rasterize_blend_from_keys_chw(feat, keys, zero, zero, H, W, None,
                                         model.blend_cfg, 4096)


def test_blend3d_prep_never_falls_back():
    """A non-CPU tensor launches K10 or raises: on meta tensors (no CUDA
    here) it refuses instead of taking the plain version; a model asked for
    the card without one raises; a degree outside 0-4 raises."""
    meta = dict(device="meta")
    cam = p3.camera(np.eye(4), 48.0, 48.0, 48.0, 32.0, [0.0, 0.0, -8.0])
    args = (torch.zeros(4, 3, **meta), torch.zeros(4, 3, **meta),
            torch.zeros(4, 4, **meta), torch.zeros(4, 1, **meta),
            torch.zeros(4, 48, **meta), cam, 3, H, W, 32, 12)
    before = p3.blend3d_prep.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        p3.blend3d_prep(*args)
    with pytest.raises(ValueError, match="sh_degree"):
        p3.blend3d_prep(*args[:6], 5, *args[7:])
    assert p3.blend3d_prep.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model("3DGS", device="cuda", num_points=N, H=H, W=W,
                       raster=RasterizeConfig(fused_prep=True))
