"""Port parity, batched decode: the plain version of K7 (the batched fused
decode prep) against the JAX kernel in interpret mode, against the
single-frame prep (K4's plain version) at B = 1 and frame by frame;
``render_batch``, ``decompress_wo_ec_batch`` and ``decode_many`` against
the JAX package's and against per-frame renders and decodes; band
containment; the fused batch against the generic stacked decode; the
strategy gate and the refusal of an unknown strategy; the codec CLI's
whole-dataset decode probe.

Small scenes: 64x96 frames, N = 256, B <= 3, made from a seed with numpy.
Tolerances are stated at each test."""

import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu import batched as jbatched  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import splat_prep as jsp  # noqa: E402
from gaussianimage_tpu_torch import batched  # noqa: E402
from gaussianimage_tpu_torch import test_quantize  # noqa: E402
from gaussianimage_tpu_torch.codec import ResidualVQState  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import splat_prep as sp  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    synthetic_image)

H, W, N, B = 64, 96, 256, 3
M = 9
BOUND = np.asarray([0.5, 0.0, 0.5], np.float32)
INT_MAX = 2 ** 31 - 1
TOL = dict(rtol=1e-6, atol=1e-6)  # test_torch_splat_prep.py's row tolerance
IMG_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_batched.py:104-108


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- K7's plain


def _code_scene(nb, seed=1):
    """nb frames of N code rows each, as the codec writes them: float16
    means, 6-bit Cholesky codes, 2-layer VQ indices; per frame a scale,
    a beta and a combined codebook."""
    rng = np.random.default_rng(seed)
    n = nb * N
    xyz16 = np.arctanh(rng.uniform(-0.95, 0.95, (n, 2))).astype(np.float16)
    codes = rng.integers(0, 64, (n, 3)).astype(np.int32)
    idx = rng.integers(0, 8, (n, 2)).astype(np.int32)
    scale = (np.asarray([0.03, 0.02, 0.03], np.float32)
             * rng.uniform(0.8, 1.2, (nb, 3))).astype(np.float32)
    beta = (np.asarray([0.2, -0.6, 0.2], np.float32)
            + rng.uniform(-0.1, 0.1, (nb, 3))).astype(np.float32)
    embed = rng.uniform(-0.3, 0.6, (nb, 2, 8, 3)).astype(np.float32)
    comb = (embed[:, 0][:, :, None, :] + embed[:, 1][:, None, :, :]
            ).reshape(nb * 64, 3)
    return xyz16, codes, idx, scale, beta, comb


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_batch_decode_prep_plain_matches_jax():
    """B = 3 against the JAX kernel (interpret mode): the live keys after a
    sort, trunc and n_total integer-exact; the feature rows to TOL (the x,
    y columns to rtol 3e-6: XLA's CPU tanh is one ulp off torch's), and
    the whole row to TOL through the shared front fed JAX's means."""
    xyz16, codes, idx, scale, beta, comb = _code_scene(B)
    xyz = xyz16.astype(np.float32)
    cfg = JCfg(fused_prep=True)
    jfeat, jkeys, jtrunc, jn = (np.asarray(a) for a in
                                jsp.fused_prep_cholesky_batch(
        jnp.asarray(xyz), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(beta), BOUND, jnp.asarray(idx), jnp.asarray(comb), B,
        H * B, W, cfg, M))
    feat, keys, trunc, n_total = sp.fused_prep_cholesky_batch(
        *_t(xyz16, codes, scale, beta), BOUND, *_t(idx, comb), B, H * B, W,
        RasterizeConfig(fused_prep=True), M)
    skeys, sjkeys = np.sort(keys.numpy()), np.sort(jkeys)
    assert (sjkeys != INT_MAX).sum() > B * N
    np.testing.assert_array_equal(skeys[skeys != INT_MAX],
                                  sjkeys[sjkeys != INT_MAX])
    assert int(trunc) == int(jtrunc) and int(n_total) == int(jn)
    assert feat.shape == (B * N + 1, 16)
    np.testing.assert_array_equal(feat[B * N].numpy(), 0.0)
    np.testing.assert_allclose(feat[:, 2:].numpy(), jfeat[:B * N + 1, 2:],
                               **TOL)
    np.testing.assert_allclose(feat[:, :2].numpy(), jfeat[:B * N + 1, :2],
                               rtol=3e-6, atol=1e-6)
    means = torch.from_numpy(np.array(jnp.tanh(jnp.asarray(xyz))))
    frame = torch.arange(B * N) // N
    s, b = torch.from_numpy(scale)[frame], torch.from_numpy(beta)[frame]
    l = torch.from_numpy(codes).float() * s + b + torch.from_numpy(BOUND)
    colors = torch.from_numpy(comb)[(frame * 64 + torch.from_numpy(
        idx[:, 0] * 8 + idx[:, 1])).long()]
    rows, _, _ = sp._project_pack_bin(
        means[:, 0], means[:, 1], *sp._cov_from_chol(l[:, 0], l[:, 1],
                                                     l[:, 2]),
        colors, H, W, 32, M, 9.0, frame=frame, B=B)
    np.testing.assert_allclose(rows.numpy(), jfeat[:B * N + 1], **TOL)



@pytest.mark.parametrize("nb,n", [(3, 33), (2, 65)])
def test_batch_decode_prep_plain_rows_match_jax(nb, n):
    """Frames whose boundaries fall inside the card's 64-row blocks (K7
    stages 64 rows a block: nb frames of n = 33 or 65 rows) through the
    plain K7 against JAX's fused_prep_cholesky_batch under a 3-tile span:
    the keys equal slot by slot in their [M, N+1] layout; each row's
    counts (trunc, live) the excess and min of its area over M, the area
    read off JAX's keys under a span of every tile of the canvas; the
    feature rows to TOL (x, y to rtol 3e-6: XLA's CPU tanh)."""
    m_span = 3
    xyz16, codes, idx, scale, beta, comb = _code_scene(nb, seed=5)
    rows = (xyz16[:nb * n].astype(np.float32), codes[:nb * n],
            idx[:nb * n])
    tables = (scale, beta, comb)
    cfg = JCfg(fused_prep=True)
    tp = cfg.tile_px
    all_tiles = nb * -(-H // tp) * -(-W // tp)

    def jax_prep(m):
        jfeat, jkeys, jtrunc, jn_total = jax.jit(
            lambda x, c, i: jsp.fused_prep_cholesky_batch(
                x, c, jnp.asarray(scale), jnp.asarray(beta), BOUND, i,
                jnp.asarray(comb), nb, H * nb, W, cfg, m))(
            *(jnp.asarray(r) for r in rows))
        jkeys = np.asarray(jkeys).reshape(m, -1)[:, :nb * n + 1]
        return np.asarray(jfeat), jkeys, int(jtrunc), int(jn_total)

    jfeat, jkeys, jtrunc, jn_total = jax_prep(m_span)
    area = (jax_prep(all_tiles)[1] != INT_MAX).sum(axis=0)
    feat, keys, stats = sp.batch_decode_prep(
        *_t(*rows), *_t(*tables), tuple(BOUND), nb, H * nb, W, tp, m_span,
        float(cfg.q_cut))
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(stats[0].numpy(),
                                  np.maximum(area - m_span, 0))
    np.testing.assert_array_equal(stats[1].numpy(),
                                  np.minimum(area, m_span))
    assert (int(stats[0].sum()), int(stats[1].sum())) == (jtrunc, jn_total)
    assert jtrunc > 0
    np.testing.assert_array_equal(feat[nb * n].numpy(), 0.0)
    np.testing.assert_allclose(feat[:, 2:].numpy(),
                               jfeat[:nb * n + 1, 2:], **TOL)
    np.testing.assert_allclose(feat[:, :2].numpy(), jfeat[:nb * n + 1, :2],
                               rtol=3e-6, atol=1e-6)

def test_batch_decode_prep_plain_at_one_frame_is_k4_plain():
    """B = 1: bit for bit the single-frame prep's plain version."""
    xyz16, codes, idx, scale, beta, comb = _code_scene(1, seed=2)
    args = _t(xyz16.astype(np.float32), codes, idx)
    got = sp.batch_decode_prep_plain(*args, *_t(scale, beta, comb),
                                     tuple(BOUND), 1, H, W, 32, M, 9.0)
    want = sp.decode_prep_plain(*args, *_t(scale[0], beta[0], comb),
                                tuple(BOUND), H, W, 32, M, 9.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batch_prep_frames_equal_single_frame_preps():
    """Frame f of a stack equals the single-frame prep of frame f alone:
    its rows with y shifted by f * H, its (tile, row) key pairs with rows
    shifted by f * n and tiles by f * rows * tiles_x (the band clip is the
    frame's whole canvas; the means stay inside their frame)."""
    xyz16, codes, idx, scale, beta, comb = _code_scene(B, seed=3)
    feat, keys, stats = sp.batch_decode_prep_plain(
        *_t(xyz16.astype(np.float32), codes, idx, scale, beta, comb),
        tuple(BOUND), B, H * B, W, 32, M, 9.0)
    tiles_x, rows = -(-W // 32), H // 32
    bits_b = (B * N - 1).bit_length()
    live = keys[keys != INT_MAX]
    pairs_b = {(int(k) >> bits_b, int(k) & ((1 << bits_b) - 1))
               for k in live}
    pairs = set()
    for f in range(B):
        sl = slice(f * N, (f + 1) * N)
        f1, k1, s1 = sp.decode_prep_plain(
            *_t(xyz16[sl].astype(np.float32), codes[sl], idx[sl], scale[f],
                beta[f], comb[f * 64:(f + 1) * 64]), tuple(BOUND), H, W, 32,
            M, 9.0)
        shifted = f1[:N].clone()
        shifted[:, 1] = shifted[:, 1] + float(f * H)
        assert torch.equal(feat[sl], shifted)
        assert torch.equal(stats[:, sl], s1[:, :N])
        bits = (N - 1).bit_length()
        pairs |= {((int(k) >> bits) + f * rows * tiles_x,
                   (int(k) & ((1 << bits) - 1)) + f * N)
                  for k in k1[k1 != INT_MAX]}
    assert pairs == pairs_b and len(pairs) == live.numel()


# ------------------------------------------------------ render_batch


def _params(seeds, n=N, h=H, w=W):
    """JAX init_params of each seed: (stacked numpy dict, list of dicts)."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=n, H=h, W=w)
    ps = [{k: np.asarray(v) for k, v in
           jm.init_params(jax.random.PRNGKey(s)).items()} for s in seeds]
    return {k: np.stack([p[k] for p in ps]) for k in ps[0]}, ps


def _model(**kw):
    return make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                      H=H, W=W, **kw)


def test_render_batch_matches_jax_and_per_frame():
    """The stacked render against the JAX package's (IMG_TOL; the one-ulp
    tanh difference stays below it here) and each frame against the
    port's single-frame render (IMG_TOL, the JAX suite's bound)."""
    pb, ps = _params(range(B))
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W)
    want = np.asarray(jbatched.render_batch(
        jm, {k: jnp.asarray(v) for k, v in pb.items()})["render"])
    model = _model()
    with torch.no_grad():
        out = batched.render_batch(model, {k: torch.from_numpy(v)
                                           for k, v in pb.items()})
    got = out["render"].numpy()
    assert got.shape == (B, 3, H, W) and out["alpha_map"].shape == (B, 1, H,
                                                                     W)
    np.testing.assert_allclose(got, want, **IMG_TOL)
    for b in range(B):
        model.load_state_dict(params_from_numpy(ps[b]))
        with torch.no_grad():
            ref = model.render()["render"][0].numpy()
        np.testing.assert_allclose(got[b], ref, **IMG_TOL)


def test_render_batch_band_containment():
    """Frame 1's Gaussians pushed to its bottom edge and made huge must not
    bleed into frame 2 (tests/test_batched.py:34): every frame equals its
    single-frame render (IMG_TOL)."""
    pb, _ = _params(range(B))
    pb["_xyz"][1] = np.arctanh(np.clip(np.concatenate(
        [np.tanh(pb["_xyz"][1][:, :1]), np.full((N, 1), 0.98)], axis=1),
        -0.999, 0.999))
    pb["_cholesky"][1] = 8.0
    model = _model()
    with torch.no_grad():
        got = batched.render_batch(model, {k: torch.from_numpy(v)
                                           for k, v in pb.items()})["render"]
    for b in range(B):
        model.load_state_dict(params_from_numpy(
            {k: v[b] for k, v in pb.items()}))
        with torch.no_grad():
            ref = model.render()["render"][0]
        np.testing.assert_allclose(got[b].numpy(), ref.numpy(), **IMG_TOL)


# ------------------------------------------------------------ decodes


def _codec_states(seeds):
    """Per frame: the JAX package's QAT warm start (quantizer ranges and
    k-means codebooks) of distinct random parameters, and its code arrays;
    stacked for both packages."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W,
                      quantize=True)
    states, encs = [], []
    for s in seeds:
        st = jm.init_quantizer_data(jm.init_state(jax.random.PRNGKey(s)))
        states.append(st)
        encs.append({k: np.array(v) for k, v in
                     jm.compress_wo_ec(st.params, st.extra).items()})
    jpb = jax.tree.map(lambda *x: jnp.stack(x), *[s.params for s in states])
    jeb = jax.tree.map(lambda *x: jnp.stack(x), *[s.extra for s in states])
    jencb = {k: jnp.asarray(np.stack([e[k] for e in encs])) for k in encs[0]}
    pb = {k: torch.from_numpy(np.array(v)) for k, v in jpb.items()}
    eb = {"vq": ResidualVQState(*(torch.from_numpy(np.array(v))
                                  for v in jeb["vq"]))}
    encb = {k: torch.from_numpy(np.array(v)) for k, v in jencb.items()}
    return jm, (jpb, jeb, jencb), (pb, eb, encb), states, encs


def _frame_decodes(model, states, encs):
    outs = []
    for st, enc in zip(states, encs):
        model.load_state_dict(params_from_numpy(
            {k: np.asarray(v) for k, v in st.params.items()}, "cpu",
            {f"vq/{k}": np.asarray(v)
             for k, v in st.extra["vq"]._asdict().items()}))
        outs.append(model.decompress_wo_ec(enc)["render"][0].numpy())
    return np.stack(outs)


def test_decompress_wo_ec_batch_matches_jax_and_per_frame():
    """The generic stacked decode against the JAX package's (IMG_TOL) and
    against the port's per-frame decodes (IMG_TOL)."""
    jm, jargs, args, states, encs = _codec_states(range(B))
    want = np.asarray(jbatched.decompress_wo_ec_batch(jm, *jargs)["render"])
    model = _model(quantize=True)
    assert model.fused_decode_batch(*args) is None  # the fused prep is off
    out = batched.decompress_wo_ec_batch(model, *args)
    assert out["render"].shape == (B, 3, H, W)
    assert int(out["raster_aux"]["n_dropped"]) == 0
    np.testing.assert_allclose(out["render"].numpy(), want, **IMG_TOL)
    np.testing.assert_allclose(out["render"].numpy(),
                               _frame_decodes(model, states, encs),
                               **IMG_TOL)


def test_fused_batch_decode_matches_generic_and_jax():
    """Through K7's plain version: against the generic stacked decode and
    the per-frame decodes (atol 2e-5, the fused prep's binning-edge
    envelope of tests/test_batched.py:154-163), and against the JAX
    package's fused batch decode (atol 2e-5)."""
    jm, jargs, args, states, encs = _codec_states(range(B))
    jmf = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W,
                       quantize=True, raster=JCfg(fused_prep=True))
    want = np.asarray(jbatched.decompress_wo_ec_batch(jmf, *jargs)["render"])
    fused = _model(quantize=True, raster=RasterizeConfig(fused_prep=True))
    out = fused.fused_decode_batch(*args)
    assert out is not None and int(out["raster_aux"]["n_dropped"]) == 0
    got = out["render"].numpy()
    generic = batched.decompress_wo_ec_batch(_model(quantize=True), *args)
    np.testing.assert_allclose(got, generic["render"].numpy(), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got, _frame_decodes(_model(quantize=True),
                                                   states, encs),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_decode_many_strategies_gate_and_unknown_force():
    """Both strategies equal the per-frame decodes (IMG_TOL), under the
    fused prep too; the default follows prefer_batched; an unknown
    strategy raises ValueError (the JAX package treats it as "scan")."""
    _, _, args, states, encs = _codec_states(range(B))
    refs = _frame_decodes(_model(quantize=True), states, encs)
    for raster in (RasterizeConfig(), RasterizeConfig(fused_prep=True)):
        model = _model(quantize=True, raster=raster)
        for force in ("batched", "scan", None):
            out = batched.decode_many(model, *args, force=force)
            assert out["render"].shape == (B, 3, H, W), force
            np.testing.assert_allclose(out["render"].numpy(), refs,
                                       **IMG_TOL, err_msg=str(force))
    # the gate measured on the H100: stacking wins up to 768x512 at
    # B = 2..6 (the JAX package's TPU gate stops at 131072 pixels), where
    # the stacked stream fits the flat layout (3 B N <= 196,608)
    assert batched.prefer_batched(H, W, B, N)
    for b in (2, 4, 6):
        assert batched.prefer_batched(512, 768, b, 10000), b
    assert not batched.prefer_batched(1024, 768, 2, 10000)
    assert not batched.prefer_batched(512, 768, 1, 10000)
    assert not batched.prefer_batched(512, 768, 7, 1000)
    assert batched.prefer_batched(512, 768, 4, 16384)
    assert not batched.prefer_batched(512, 768, 5, 13200)
    # the Kodak sweep's 18 landscape frames at 5000 Gaussians
    assert not batched.prefer_batched(512, 768, 18, 5000)
    assert not jbatched.prefer_batched(512, 768)
    with pytest.raises(ValueError, match="unknown decode strategy"):
        batched.decode_many(_model(quantize=True), *args, force="bached")


def test_batched_config_matches_jax():
    for n, b in ((N, 3), (10000, 2), (10000, 6)):
        jm = j_make_model("GaussianImage_Cholesky", num_points=n, H=512,
                          W=768)
        m = make_model("GaussianImage_Cholesky", device="cpu", num_points=n,
                       H=512, W=768)
        assert tuple(m.cfg.raster.stacked(n, b)) == tuple(
            jbatched._batched_raster_config(jm, b))


def test_dataset_decode_probe(tmp_path):
    """The codec CLI's whole-dataset probe on two 64x96 evaluators: the
    frames per pass, a rate and the strategy prefer_batched picks; a group
    of one image gives no rate."""
    _, _, _, states, encs = _codec_states((0, 1))
    evs = []
    for i, st in enumerate(states):
        ev = test_quantize.CodecEvaluator2d(
            synthetic_image(H, W, seed=i), f"im{i}", num_points=N,
            log_dir=tmp_path / f"im{i}", device="cpu")
        ev.model.load_state_dict(params_from_numpy(
            {k: np.asarray(v) for k, v in st.params.items()}, "cpu",
            {f"vq/{k}": np.asarray(v)
             for k, v in st.extra["vq"]._asdict().items()}))
        ev.enc = encs[i]
        evs.append(ev)
    b, fps, strategy = test_quantize.batched_dataset_decode_fps(
        evs, reps=1, scan_len=2)
    assert (b, strategy) == (2, "batched") and fps > 0
    assert test_quantize.batched_dataset_decode_fps(evs[:1]) == (1, None,
                                                                 None)


def test_codec_cli_routes_a_group_past_the_flat_stream_to_the_scan(
        tmp_path, monkeypatch):
    """The codec CLI on five 32x32 frames of 13,200 Gaussians: the stacked
    stream would need 198,000 instances, past the flat layout's 196,608,
    while each frame's own stream fits it. The whole-dataset probe takes
    the scan, completes and prints its line. The per-image probes are cut
    to one decode each, and the dataset probe to one burst of one decode,
    to keep the test short."""
    n, frames, hw = 13200, 5, (32, 32)
    real = test_quantize.iterate_dataset
    monkeypatch.setattr(
        test_quantize, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=hw), frames))
    monkeypatch.setattr(test_quantize, "FPS_FRAMES", 1)
    monkeypatch.setattr(test_quantize, "EC_FRAMES", 1)
    monkeypatch.setattr(test_quantize, "timed_bursts",
                        lambda burst, dev: (burst(), 1.0)[1])
    monkeypatch.setattr(test_quantize, "batched_dataset_decode_fps",
                        functools.partial(
                            test_quantize.batched_dataset_decode_fps,
                            reps=1, scan_len=1))
    assert not batched.prefer_batched(*hw, frames, n)
    results = test_quantize.main([
        "--data_name", "synthetic_large", "--num_points", str(n),
        "--device", "cpu", "--checkpoint_root", str(tmp_path)])
    assert len(results) == frames
    log = (tmp_path / "synthetic_large" /
           f"GaussianImage_Cholesky_50000_{n}" / "test.txt").read_text()
    assert f"Dataset decode ({frames} frames/pass, scan strategy):" in log


def test_batched_decode_raises_past_the_flat_stream():
    """3 frames of 22,000 Gaussians need 198,000 instances, past the flat
    stream's 196,608: the fused batch is not supported there (it returns
    None), and the generic stacked decode, forced, runs on the aligned
    stream, with the fused prep on or off. Its frames equal the scan's
    (each frame alone is aligned too) within IMG_TOL, frame 0 bit for bit;
    ``prefer_batched`` still picks the scan, whose speed against the
    stacked pass was not measured there."""
    n, b = 22000, 3
    rng = np.random.default_rng(0)
    enc_b = {"xyz": torch.from_numpy(np.arctanh(rng.uniform(
                 -0.9, 0.9, (b, n, 2))).astype(np.float16)),
             "quant_cholesky": torch.from_numpy(rng.integers(
                 0, 64, (b, n, 3)).astype(np.int32)),
             "feature_dc_index": torch.from_numpy(rng.integers(
                 0, 8, (b, n, 2)).astype(np.int32))}
    params_b = {"cholesky_quant_scale": torch.full((b, 3), 0.03),
                "cholesky_quant_beta": torch.full((b, 3), 0.1)}
    extra_b = {"vq": ResidualVQState(torch.rand(b, 2, 8, 3),
                                     torch.ones(b, 2, 8),
                                     torch.rand(b, 2, 8, 3),
                                     torch.ones(b, dtype=torch.bool))}
    assert not batched.prefer_batched(H, W, b, n)
    for raster in (RasterizeConfig(), RasterizeConfig(fused_prep=True)):
        model = make_model("GaussianImage_Cholesky", device="cpu",
                           num_points=n, H=H, W=W, quantize=True,
                           raster=raster)
        assert model.fused_decode_batch(params_b, extra_b, enc_b) is None
        stacked = batched.decode_many(model, params_b, extra_b, enc_b,
                                      force="batched")
        scan = batched.decode_many(model, params_b, extra_b, enc_b)
        assert int(stacked["raster_aux"]["n_dropped"]) == 0
        got, want = stacked["render"].numpy(), scan["render"].numpy()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, **IMG_TOL)


def test_k7_wrapper_never_falls_back():
    """A non-CPU tensor launches K7 or raises: on meta tensors (no CUDA
    here) the wrapper refuses rather than taking the plain version; frames
    of unequal size are refused on any device."""
    n = 2 * N
    args = [torch.zeros(n, 2, device="meta"),
            torch.zeros(n, 3, dtype=torch.int32, device="meta"),
            torch.zeros(n, 2, dtype=torch.int32, device="meta"),
            torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"),
            torch.zeros(128, 3, device="meta")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sp.batch_decode_prep(*args, tuple(BOUND), 2, 2 * H, W, 32, M, 9.0)
    with pytest.raises(ValueError, match="equal size"):
        sp.batch_decode_prep(*args, tuple(BOUND), 3, 3 * H, W, 32, M, 9.0)
