"""Port parity, the fused splat prep: the plain versions of K5 (raw
parameters) and K4 (code arrays) against the JAX package's
fused_raw_prep_cholesky / fused_prep_cholesky (Pallas interpret mode) on a
seeded 512-Gaussian 64x96 scene; the gate; rasterize_from_keys_chw's
accounting; render_fast against render() and against the JAX render_fast;
the fused decode against the generic decode.

Tolerances. Keys (sorted), trunc and n_total are integer-exact. Feature
rows: the port computes them op for op, so given the same means they agree
with JAX's to rtol 1e-6 / atol 1e-6 (tests/test_torch_core.py's tolerance
for the same float32 operations). XLA's CPU tanh is one ulp off torch's on
most inputs (ROADMAP.md, section 3), which moves the pixel coordinates by up
to ~2e-6 relative; so the rows of the port's own tanh are held to that
tolerance in every column except the two coordinates, and the whole row is
held to it through the shared front fed JAX's tanh. Images: atol 2e-5, the
JAX suite's fused-against-generic bound (tests/test_splat_prep.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import splat_prep as jsp  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import splat_prep as sp  # noqa: E402
from gaussianimage_tpu_torch.ops.rasterize_sum import (  # noqa: E402
    rasterize_from_keys_chw)
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)

N, H, W = 512, 64, 96
BOUND = np.asarray([0.5, 0.0, 0.5], np.float32)
TOL = dict(rtol=1e-6, atol=1e-6)
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _raw_scene(seed=0):
    """Raw Cholesky parameters: means uniform in NDC +-0.95 (atanh space),
    Cholesky elements before the bound in [0.3, 2), colors in [-0.2, 1)."""
    rng = np.random.default_rng(seed)
    xyz = np.arctanh(rng.uniform(-0.95, 0.95, (N, 2))).astype(np.float32)
    chol = rng.uniform(0.3, 2.0, (N, 3)).astype(np.float32)
    colors = rng.uniform(-0.2, 1.0, (N, 3)).astype(np.float32)
    return xyz, chol, colors


def _code_scene(seed=1):
    """Code arrays as the codec writes them: float16 means, 6-bit Cholesky
    codes with a scale and beta, 2-layer VQ indices and a combined
    codebook."""
    rng = np.random.default_rng(seed)
    xyz16 = np.arctanh(rng.uniform(-0.95, 0.95, (N, 2))).astype(np.float16)
    codes = rng.integers(0, 64, (N, 3)).astype(np.int32)
    scale = np.asarray([0.03, 0.02, 0.03], np.float32)
    beta = np.asarray([0.2, -0.6, 0.2], np.float32)
    idx = rng.integers(0, 8, (N, 2)).astype(np.int32)
    embed = rng.uniform(-0.3, 0.6, (2, 8, 3)).astype(np.float32)
    comb = (embed[0][:, None, :] + embed[1][None, :, :]).reshape(-1, 3)
    return xyz16, codes, scale, beta, idx, comb


def _caps(cap):
    jcfg = JCfg(fused_prep=True, max_instances=cap)
    cfg = RasterizeConfig(fused_prep=True, max_instances=cap)
    _, m_span, _ = jsc.stream_caps(N, jcfg)
    return jcfg, cfg, m_span


def _check_stream(got, want):
    """Sorted keys, trunc and n_total integer-exact; returns the rows."""
    feat, keys, trunc, n_total = got
    jfeat, jkeys, jtrunc, jn_total = (np.asarray(x) for x in want)
    skeys, sjkeys = np.sort(keys.numpy()), np.sort(jkeys)
    assert (sjkeys != INT_MAX).sum() > N  # most Gaussians live, some wide
    np.testing.assert_array_equal(skeys[skeys != INT_MAX],
                                  sjkeys[sjkeys != INT_MAX])
    assert int(trunc) == int(jtrunc) and int(n_total) == int(jn_total)
    assert feat.shape == (N + 1, 16)
    np.testing.assert_array_equal(feat[N].numpy(), 0.0)
    np.testing.assert_allclose(feat[:, 2:].numpy(), jfeat[:N + 1, 2:],
                               **TOL)
    np.testing.assert_allclose(feat[:, :2].numpy(), jfeat[:N + 1, :2],
                               rtol=3e-6, atol=1e-6)
    return jfeat


@pytest.mark.parametrize("cap", [None, 256])
def test_raw_prep_plain_matches_jax(cap):
    """K5's plain version against the JAX kernel, also under a stream cap
    of 256 (tests/test_splat_prep.py:48's case; the cap drops nothing in
    the prep itself, it sets the span M)."""
    jcfg, cfg, m_span = _caps(cap)
    xyz, chol, colors = _raw_scene()
    want = jsp.fused_raw_prep_cholesky(jnp.asarray(xyz), jnp.asarray(chol),
                                       jnp.asarray(colors), BOUND, H, W,
                                       jcfg, m_span)
    got = sp.fused_raw_prep_cholesky(torch.from_numpy(xyz),
                                     torch.from_numpy(chol),
                                     torch.from_numpy(colors), BOUND, H, W,
                                     cfg, m_span)
    jfeat = _check_stream(got, want)
    # the shared front on JAX's means: the whole row to TOL
    means = torch.from_numpy(np.array(jnp.tanh(jnp.asarray(xyz))))
    l = torch.from_numpy(chol) + torch.from_numpy(BOUND)
    feat, _, _ = sp._project_pack_bin(
        means[:, 0], means[:, 1], *sp._cov_from_chol(l[:, 0], l[:, 1],
                                                     l[:, 2]),
        torch.from_numpy(colors), H, W, cfg.tile_px, m_span, cfg.q_cut)
    np.testing.assert_allclose(feat.numpy(), jfeat[:N + 1], **TOL)


@pytest.mark.parametrize("cap", [None, 256])
def test_decode_prep_plain_matches_jax(cap):
    jcfg, cfg, m_span = _caps(cap)
    xyz16, codes, scale, beta, idx, comb = _code_scene()
    want = jsp.fused_prep_cholesky(
        jnp.asarray(xyz16.astype(np.float32)), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(beta), BOUND, jnp.asarray(idx),
        jnp.asarray(comb), H, W, jcfg, m_span)
    got = sp.fused_prep_cholesky(
        torch.from_numpy(xyz16), torch.from_numpy(codes),
        torch.from_numpy(scale), torch.from_numpy(beta), BOUND,
        torch.from_numpy(idx), torch.from_numpy(comb), H, W, cfg, m_span)
    jfeat = _check_stream(got, want)
    means = torch.from_numpy(np.array(jnp.tanh(jnp.asarray(
        xyz16.astype(np.float32)))))
    l = (torch.from_numpy(codes).float() * torch.from_numpy(scale)
         + torch.from_numpy(beta)) + torch.from_numpy(BOUND)
    colors = torch.from_numpy(comb)[torch.from_numpy(idx[:, 0] * 8
                                                     + idx[:, 1]).long()]
    feat, _, _ = sp._project_pack_bin(
        means[:, 0], means[:, 1], *sp._cov_from_chol(l[:, 0], l[:, 1],
                                                     l[:, 2]),
        colors, H, W, cfg.tile_px, m_span, cfg.q_cut)
    np.testing.assert_allclose(feat.numpy(), jfeat[:N + 1], **TOL)


@pytest.mark.parametrize("n", [1, 33, 65])
def test_decode_prep_plain_rows_match_jax(n):
    """The plain K4 on the first n code rows (the card's K4 stages 64-row
    blocks: n = 1, 33, 65 leave a partial block and warp) against JAX's
    fused_prep_cholesky under a 3-tile span: the keys equal in their
    slot-major [M, N+1] layout, and each row's counts (trunc, live) equal
    min / excess of its area over M, the area read off JAX's keys under a
    span of every tile."""
    jcfg, cfg = JCfg(fused_prep=True), RasterizeConfig(fused_prep=True)
    m_span = 3
    all_tiles = -(-H // cfg.tile_px) * -(-W // cfg.tile_px)
    xyz16, codes, scale, beta, idx, comb = _code_scene()
    xyz = xyz16[:n].astype(np.float32)
    rows = (xyz, codes[:n], idx[:n])

    def jax_keys(m):
        _, jkeys, jtrunc, jn_total = jax.jit(
            lambda x, c, i: jsp.fused_prep_cholesky(
                x, c, jnp.asarray(scale), jnp.asarray(beta), BOUND, i,
                jnp.asarray(comb), H, W, jcfg, m))(
            *(jnp.asarray(r) for r in rows))
        jkeys = np.asarray(jkeys).reshape(m, -1)[:, :n + 1]
        return jkeys, int(jtrunc), int(jn_total)

    jkeys, jtrunc, jn_total = jax_keys(m_span)
    area = (jax_keys(all_tiles)[0] != INT_MAX).sum(axis=0)
    _, keys, stats = sp.decode_prep(
        *(torch.from_numpy(np.ascontiguousarray(r)) for r in rows),
        torch.from_numpy(scale), torch.from_numpy(beta),
        torch.from_numpy(comb), BOUND, H, W, cfg.tile_px, m_span,
        float(cfg.q_cut))
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(stats[0].numpy(),
                                  np.maximum(area - m_span, 0))
    np.testing.assert_array_equal(stats[1].numpy(),
                                  np.minimum(area, m_span))
    assert (int(stats[0].sum()), int(stats[1].sum())) == (jtrunc, jn_total)
    if n == 65:
        assert jtrunc > 0



@pytest.mark.parametrize("n", [1, 33, 65])
def test_raw_prep_plain_rows_match_jax(n):
    """The plain K5 on the first n raw rows (the card's K5 stages 64-row
    blocks, as K4 does: n = 1, 33, 65 leave a partial block and warp)
    against JAX's fused_raw_prep_cholesky under a 3-tile span: the keys
    equal in their slot-major [M, N+1] layout, and each row's counts
    (trunc, live) equal min / excess of its area over M, the area read off
    JAX's keys under a span of every tile."""
    jcfg, cfg = JCfg(fused_prep=True), RasterizeConfig(fused_prep=True)
    m_span = 3
    all_tiles = -(-H // cfg.tile_px) * -(-W // cfg.tile_px)
    rows = tuple(np.ascontiguousarray(a[:n]) for a in _raw_scene())

    def jax_keys(m):
        _, jkeys, jtrunc, jn_total = jax.jit(
            lambda x, c, col: jsp.fused_raw_prep_cholesky(
                x, c, col, BOUND, H, W, jcfg, m))(
            *(jnp.asarray(r) for r in rows))
        jkeys = np.asarray(jkeys).reshape(m, -1)[:, :n + 1]
        return jkeys, int(jtrunc), int(jn_total)

    jkeys, jtrunc, jn_total = jax_keys(m_span)
    area = (jax_keys(all_tiles)[0] != INT_MAX).sum(axis=0)
    _, keys, stats = sp.raw_prep(
        *(torch.from_numpy(r) for r in rows), BOUND, H, W, cfg.tile_px,
        m_span, float(cfg.q_cut))
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(stats[0].numpy(),
                                  np.maximum(area - m_span, 0))
    np.testing.assert_array_equal(stats[1].numpy(),
                                  np.minimum(area, m_span))
    assert (int(stats[0].sum()), int(stats[1].sum())) == (jtrunc, jn_total)
    if n == 65:
        assert jtrunc > 0

def test_decode_prep_refuses_unaligned_rows():
    """K4 loads its row inputs as 16-byte vectors: the wrapper's alignment
    check passes fresh tensors and refuses a view one [N, 2] row (8 bytes)
    into its storage. CPU tensors reach the plain version, so the check is
    called as the wrapper calls it on a CUDA tensor."""
    xyz = torch.zeros(9, 2)
    codes = torch.zeros(9, 3, dtype=torch.int32)
    sp._check_aligned("K4", [("xyz", xyz), ("codes", codes)])
    with pytest.raises(ValueError, match="16-byte"):
        sp._check_aligned("K4", [("xyz", xyz[1:])])
    with pytest.raises(ValueError, match="16-byte"):
        sp._check_aligned("K4", [("codes", codes[1:])])



@pytest.mark.parametrize("kernel", ["K5", "K7"])
def test_raw_and_batch_prep_refuse_unaligned_rows(kernel, monkeypatch):
    """K5 and K7 stage their rows as K4 does: their wrappers refuse a row
    input whose data starts off 16 bytes (a view one [N, 2] row, 8 bytes,
    into its storage) and pass fresh tensors on to the launch. Meta tensors
    stand in for CUDA ones (their data_ptr() carries a view's offset), with
    the device check and the launch replaced by stubs."""
    monkeypatch.setattr(sp, "_check_inputs", lambda kernel, named: None)
    monkeypatch.setattr(sp, "_launch", lambda *args, **kw: "launched")
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    if kernel == "K5":
        wrapper = sp.raw_prep
        rows = [torch.zeros(9, 2, **meta), torch.zeros(9, 3, **meta),
                torch.zeros(9, 3, **meta)]
        rest = (BOUND, 32, 32, 32, 9, 9.0)
    else:
        wrapper = sp.batch_decode_prep
        rows = [torch.zeros(9, 2, **meta), torch.zeros(9, 3, **i32),
                torch.zeros(9, 2, **i32)]
        rest = (torch.zeros(1, 3, **meta), torch.zeros(1, 3, **meta),
                torch.zeros(64, 3, **meta), BOUND, 1, 32, 32, 32, 9, 9.0)
    monkeypatch.setattr(wrapper, "launches", 0)
    assert wrapper(*rows, *rest) == "launched"
    for i in range(len(rows)):
        views = list(rows)
        views[i] = torch.zeros(10, rows[i].shape[1], dtype=rows[i].dtype,
                               **meta)[1:]
        assert views[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"{kernel} loads .* 16-byte"):
            wrapper(*views, *rest)
    assert wrapper.launches == 1

def test_prep_kernels_take_power_of_two_tiles():
    """The fused prep kernels bin with the reciprocal of tile_px, exact
    only for a power of two: the wrappers' check passes 16 and 32 (the
    rasterizers' tiles) and refuses 24 and 0, as the C launchers do."""
    for tile_px in (16, 32):
        sp._check_tile("K4", tile_px)
    for tile_px in (24, 0):
        with pytest.raises(ValueError, match="power-of-two"):
            sp._check_tile("K4", tile_px)


STACK_N = 9999  # not a multiple of 4: frame 1 of a stack is off 16 bytes


@pytest.mark.parametrize("front", ["cholesky", "rs_decode", "rs_raw",
                                   "cholesky_raw", "cholesky_batch"])
def test_fused_fronts_hand_aligned_rows_of_a_stacked_frame(front,
                                                           monkeypatch):
    """The scan decode (batched.decode_many) hands each frame of a stacked
    encoding over as a view ``enc_b[b]``, which starts b x STACK_N rows
    into its storage. Frame 1 of a [2, STACK_N, ...] stack goes through
    fused_prep_cholesky (K4), fused_prep_rs (K6a), fused_raw_prep_rs
    (K6b), fused_raw_prep_cholesky (K5) and, as three stacked frames of
    STACK_N / 3 rows, fused_prep_cholesky_batch (K7) with the kernel's
    wrapper replaced by a recorder: every row input reaches it on a
    16-byte boundary and equal to the frame's rows."""
    rng = np.random.default_rng(3)
    cfg = RasterizeConfig(fused_prep=True)

    def stack(width, kind):
        if kind == "f16":
            a = rng.uniform(-2.0, 2.0, (2, STACK_N, width)).astype(np.float16)
        elif kind == "f32":
            a = rng.uniform(-2.0, 2.0, (2, STACK_N, width)).astype(np.float32)
        else:
            a = rng.integers(0, 8, (2, STACK_N, width)).astype(np.int32)
        return torch.from_numpy(a)[1]

    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.uniform(0.01, 0.5, shape).astype(np.float32))
    comb = torch.from_numpy(_code_scene()[5])
    if front == "cholesky":
        wrapper = "decode_prep"
        rows = (stack(2, "f16"), stack(3, "i32"), stack(2, "i32"))
        call = lambda: sp.fused_prep_cholesky(  # noqa: E731
            rows[0], rows[1], f32(3), f32(3), BOUND, rows[2], comb, H, W,
            cfg, 3)
    elif front == "rs_decode":
        wrapper = "rs_decode_prep"
        rows = (stack(2, "f16"), stack(2, "i32"), stack(1, "i32"),
                stack(2, "i32"))
        call = lambda: sp.fused_prep_rs(  # noqa: E731
            *rows[:3], f32(2), f32(2), f32(1), f32(1), (0.5, 0.5), rows[3],
            comb, H, W, cfg, 3)
    elif front == "rs_raw":
        wrapper = "rs_raw_prep"
        rows = (stack(2, "f32"), stack(2, "f32"), stack(1, "f32"),
                stack(3, "f32"))
        call = lambda: sp.fused_raw_prep_rs(  # noqa: E731
            *rows, (0.5, 0.5), H, W, cfg, 3)
    elif front == "cholesky_raw":
        wrapper = "raw_prep"
        rows = (stack(2, "f32"), stack(3, "f32"), stack(3, "f32"))
        call = lambda: sp.fused_raw_prep_cholesky(  # noqa: E731
            *rows, BOUND, H, W, cfg, 3)
    else:
        wrapper = "batch_decode_prep"
        rows = (stack(2, "f16"), stack(3, "i32"), stack(2, "i32"))
        call = lambda: sp.fused_prep_cholesky_batch(  # noqa: E731
            rows[0], rows[1], f32(3, 3), f32(3, 3), BOUND, rows[2],
            comb.repeat(3, 1), 3, 3 * H, W, cfg, 3)
    assert any(r.data_ptr() % 16 for r in rows)
    seen = []
    real = getattr(sp, wrapper)

    def recorder(*args):
        seen.append(args[:len(rows)])
        return real(*args)

    monkeypatch.setattr(sp, wrapper, recorder)
    call()
    (got,) = seen
    for g, r in zip(got, rows):
        assert g.data_ptr() % 16 == 0
        assert g.is_contiguous()
        assert torch.equal(g, r.to(g.dtype))


@pytest.mark.parametrize("n,h,w,kw", [
    (10000, 512, 768, {}),                                   # default: off
    (10000, 512, 768, {"fused_prep": True}),
    (10000, 512, 768, "serving"),
    (70000, 512, 768, "serving"),
    (10000, 512, 768, {"fused_prep": True, "flat_stream_limit": 1000}),
    (40000, 512, 768, {"fused_prep": True}),                 # aligned
    (1 << 20, 4096, 4096, {"fused_prep": True,               # wide keys
                           "flat_stream_limit": 1 << 30}),
    (512, 64, 96, {"fused_prep": True, "max_instances": 256}),
])
def test_fused_gate_matches_jax(n, h, w, kw):
    if kw == "serving":
        cfg, jcfg = RasterizeConfig.serving(n), JCfg.serving(n)
    else:
        cfg, jcfg = RasterizeConfig(**kw), JCfg(**kw)
    assert tuple(cfg) == tuple(jcfg)
    assert (sp.fused_decode_supported(n, h, w, cfg)
            == jsp.fused_decode_supported(n, h, w, jcfg))


@pytest.mark.parametrize("cap", [None, 256])
def test_fused_decode_accounting_matches_jax(cap):
    """rasterize_from_keys_chw after the plain K4: image, n_dropped and
    max_per_tile_used against the JAX fused decode (cap 256 drops)."""
    jcfg, cfg, _ = _caps(cap)
    xyz16, codes, scale, beta, idx, comb = _code_scene()
    jimg, _, jaux = jsp.fused_decode_cholesky(
        jnp.asarray(xyz16.astype(np.float32)), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(beta), BOUND, jnp.asarray(idx),
        jnp.asarray(comb), H, W, jcfg)
    img, _, aux = sp.fused_decode_cholesky(
        torch.from_numpy(xyz16), torch.from_numpy(codes),
        torch.from_numpy(scale), torch.from_numpy(beta), BOUND,
        torch.from_numpy(idx), torch.from_numpy(comb), H, W, cfg)
    assert int(aux["n_dropped"]) == int(jaux["n_dropped"])
    assert int(aux["max_per_tile_used"]) == int(jaux["max_per_tile_used"])
    assert (int(aux["n_dropped"]) > 0) == (cap is not None)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=2e-5)


def test_render_fast_matches_render_and_jax():
    xyz, chol, colors = _raw_scene(seed=2)
    params = {"_xyz": xyz, "_cholesky": chol, "_features_dc": colors}
    default = make_model("GaussianImage_Cholesky", device="cpu",
                         num_points=N, H=H, W=W)
    serving = make_model("GaussianImage_Cholesky", device="cpu",
                         num_points=N, H=H, W=W,
                         raster=RasterizeConfig.serving(N))
    for m in (default, serving):
        m.load_state_dict(params_from_numpy(params))
    with torch.no_grad():
        ref = default.render()["render"]
    np.testing.assert_array_equal(default.render_fast().numpy(), ref.numpy())
    before = sp.raw_prep.launches
    fast, aux = serving.render_fast(with_aux=True)
    assert sp.raw_prep.launches == before  # CPU tensors: the plain K5
    assert int(aux["n_dropped"]) == 0 and fast.shape == (1, 3, H, W)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=0, atol=2e-5)
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W,
                      raster=JCfg.serving(N))
    jfast = np.asarray(jm.render_fast({k: jnp.asarray(v)
                                       for k, v in params.items()}))
    np.testing.assert_allclose(fast.numpy(), jfast, rtol=0, atol=2e-5)


def test_render_fast_odd_size_and_gate_off():
    """A non-tile-multiple image through the fused path, and a gate that is
    false (aligned stream) taking render()."""
    n, h, w = 256, 67, 101
    rng = np.random.default_rng(3)
    params = {"_xyz": np.arctanh(rng.uniform(-0.95, 0.95, (n, 2))),
              "_cholesky": rng.uniform(0.3, 2.0, (n, 3)),
              "_features_dc": rng.uniform(0.0, 1.0, (n, 3))}
    ref_m = make_model("GaussianImage_Cholesky", device="cpu", num_points=n,
                       H=h, W=w)
    ref_m.load_state_dict(params_from_numpy(params))
    with torch.no_grad():
        ref = ref_m.render()["render"]
    for raster in (RasterizeConfig(fused_prep=True),
                   RasterizeConfig(fused_prep=True, flat_stream_limit=1024,
                                   max_instances=512)):
        m = make_model("GaussianImage_Cholesky", device="cpu", num_points=n,
                       H=h, W=w, raster=raster)
        m.load_state_dict(params_from_numpy(params))
        fast = m.render_fast()
        assert fast.shape == (1, 3, h, w)
        np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-5)


def test_from_keys_matches_generic_stream():
    """The prep's keys, sorted and bounded, give the generic binning's
    stream: K1's inputs are the same, so the image is bit-equal."""
    xyz, chol, colors = _raw_scene(seed=4)
    params = {"_xyz": xyz, "_cholesky": chol, "_features_dc": colors}
    cfg = RasterizeConfig.serving(N)
    m = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                   H=H, W=W, raster=cfg)
    m.load_state_dict(params_from_numpy(params))
    I0, m_span, _ = sp.sc.stream_caps(N, cfg)
    feat, keys, trunc, n_total = sp.fused_raw_prep_cholesky(
        m._xyz.detach(), m._cholesky.detach(), m._features_dc.detach(),
        BOUND, H, W, cfg, m_span)
    img, alpha, aux = rasterize_from_keys_chw(feat, keys, trunc, n_total, H,
                                              W, cfg, I0)
    with torch.no_grad():
        full = m.render()
    np.testing.assert_array_equal(img.clamp(0, 1).numpy(),
                                  full["render"][0].numpy())
    assert int(aux["n_dropped"]) == int(full["raster_aux"]["n_dropped"])
    assert alpha.shape == (H, W)


def test_prep_wrappers_never_fall_back():
    """A non-CPU tensor launches the kernel or raises: on meta tensors (no
    CUDA here) K5 and K4 refuse instead of taking the plain version."""
    meta = dict(device="meta")
    f32 = torch.zeros(4, 2, **meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sp.raw_prep(f32, torch.zeros(4, 3, **meta), torch.zeros(4, 3, **meta),
                    BOUND, 32, 32, 32, 9, 9.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sp.decode_prep(f32, torch.zeros(4, 3, dtype=torch.int32, **meta),
                       torch.zeros(4, 2, dtype=torch.int32, **meta),
                       torch.zeros(3, **meta), torch.zeros(3, **meta),
                       torch.zeros(64, 3, **meta), BOUND, 32, 32, 32, 9, 9.0)
    with pytest.raises(ValueError, match="packed-key"):
        sp.prep_geometry(1 << 20, 4096, 4096, 32)
