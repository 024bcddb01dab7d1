"""Port parity, the RS model (GaussianImage_RS): the scale-rotation
covariance and projection, the plain versions of K6b (raw parameters) and
K6a (code arrays) against the JAX package's fused_raw_prep_rs /
fused_prep_rs (Pallas interpret mode), the model's render, render_fast and
decode on JAX-trained parameters, one fit step's and one QAT step's
gradients, the checkpoints in both directions, and the wrappers' refusal
to fall back. Small scenes (64x96, N = 512, as the JAX suite's RS cases)
from seeds.

The angle. XLA's CPU ``sigmoid(r) * 2 pi``, ``cos`` and ``sin`` differ
from torch's by an ulp or two on 0.3-10% of inputs (the same cause as the
tanh of ROADMAP.md section 3). One ulp of an angle moves the covariance by
~1e-7 relative and can move a binning extent across a tile edge. So each
test computes the rows where the two packages' angle, cos and sin agree bit
for bit (the mask), holds those rows exactly (keys, counts, covariance,
projection) and every row to the stated tolerance, and asserts how many
rows fall outside the mask.

The reference's kernel. Inside JAX's fused prep (one jitted Pallas body)
XLA does not round the conic op by op; on a few rows of elongated
Gaussians (scale ratio ~7, where the determinant cancels) its conic sits
up to ~5e-6 relative off the JAX package's own op-by-op expression. The
port rounds op by op and equals that expression bit for bit on the masked
rows; those few rows are counted (MAX_FUSED_ROWS) and the rest held to TOL.

Tolerances: rtol 1e-6 / atol 1e-6 (TOL, tests/test_torch_core.py's for the
same float32 operations); pixel coordinates after the port's own tanh to
rtol 3e-6 (tests/test_torch_splat_prep.py); images atol 2e-5 with at most
MAX_EDGE_PX pixels above 1e-4, the allowance the Cholesky tests make for
XLA's tanh; gradients rtol 1e-4 / atol 1e-8 of JAX's entry or, where JAX's
K2/K3 recombine moments, of the float64 oracle (tests/test_torch_qat.py).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu import core as jcore  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import splat_prep as jsp  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu_torch import core as tcore  # noqa: E402
from gaussianimage_tpu_torch.codec import (ResidualVQ,  # noqa: E402
                                           UniformQuantizer,
                                           UniformQuantizerState,
                                           fake_quantize_half)
from gaussianimage_tpu_torch.core.render_ref import (  # noqa: E402
    render_sum_dense)
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import splat_prep as sp  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    synthetic_image)

N, H, W = 512, 64, 96
BOUND = np.asarray([0.5, 0.5], np.float32)
TOL = dict(rtol=1e-6, atol=1e-6)
INT_MAX = 2 ** 31 - 1
MAX_EDGE_PX = 16
# rows outside the mask: cos or sin off by one ulp on ~10% of angles here
MAX_OFF_MASK = 0.15
# rows of 512 where JAX's fused kernel departs from its own op-by-op conic
# by more than TOL (1 and 6 measured in the two scenes)
MAX_FUSED_ROWS = 12
# position gradients sum signed per-pixel terms that cancel: float32 sums
# leave the port up to 7.7e-6 (fit) / 4.0e-6 (QAT) of the largest entry off
# the float64 oracle on this scene, and JAX 1.3e-5 / 1.1e-5
XYZ_ORACLE_TOL = 1e-5
PARAMS = ("_xyz", "_scaling", "_rotation", "_features_dc")
QPARAMS = PARAMS + ("scaling_quant_scale", "scaling_quant_beta",
                    "rotation_quant_scale", "rotation_quant_beta")


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


def _theta_jax(raw):
    return np.asarray(jax.nn.sigmoid(jnp.asarray(raw)) * (2.0 * np.pi))


def _theta_port(raw):
    return (torch.sigmoid(_t(raw)) * sp.TWO_PI).numpy()


def _agree(theta_j, theta_t):
    """[n] mask of the rows whose angle, cos and sin are bit-equal between
    the packages (theta_j computed by JAX, theta_t by the port; [n] or
    [n, 1]). Each package's cos and sin are taken as its functions take
    them, of the [n] vector of angles: cov2d_from_scale_rot takes
    theta[..., 0] of an [n, 1] angle, and the fused fronts compute the
    angle of each row as a vector; an op on an [n, 1] array is another
    compiled op than the one the functions run."""
    tj = np.ascontiguousarray(np.reshape(theta_j, -1))
    tt = np.ascontiguousarray(np.reshape(theta_t, -1))
    jt, pt = jnp.asarray(tj), _t(tt)
    return ((tj == tt)
            & (np.asarray(jnp.cos(jt)) == torch.cos(pt).numpy())
            & (np.asarray(jnp.sin(jt)) == torch.sin(pt).numpy()))


def _equal_on(name, got, want, mask):
    """``got`` and ``want`` ([n, ...]) bit-equal on the rows of ``mask``;
    a failure names the output and counts the masked rows that differ."""
    differ = (got != want).reshape(len(mask), -1).any(axis=1) & mask
    np.testing.assert_array_equal(
        got[mask], want[mask],
        err_msg=f"{name}: {int(differ.sum())} of {int(mask.sum())} masked "
                f"rows differ (rows {np.flatnonzero(differ)[:8].tolist()})")


def _raw_scene(seed=0):
    """Raw RS parameters: means uniform in NDC +-0.95 (atanh space), raw
    scaling in [0, 3) (scales 0.5-3.5 px), raw rotation normal(0, 2),
    colors in [-0.2, 1)."""
    rng = np.random.default_rng(seed)
    xyz = np.arctanh(rng.uniform(-0.95, 0.95, (N, 2))).astype(np.float32)
    scaling = rng.uniform(0.0, 3.0, (N, 2)).astype(np.float32)
    rotation = rng.normal(0.0, 2.0, (N, 1)).astype(np.float32)
    colors = rng.uniform(-0.2, 1.0, (N, 3)).astype(np.float32)
    return xyz, scaling, rotation, colors


def _code_scene(seed=1):
    """RS code arrays as the codec writes them: float16 means, 6-bit
    scaling codes and rotation codes (radians) with their scale and beta,
    2-layer VQ indices and a combined codebook."""
    rng = np.random.default_rng(seed)
    xyz16 = np.arctanh(rng.uniform(-0.95, 0.95, (N, 2))).astype(np.float16)
    scodes = rng.integers(0, 64, (N, 2)).astype(np.int32)
    rcodes = rng.integers(0, 64, (N, 1)).astype(np.int32)
    s_scale = np.asarray([0.045, 0.04], np.float32)
    s_beta = np.asarray([-0.2, -0.1], np.float32)
    r_scale = np.asarray([2 * np.pi / 63], np.float32)
    r_beta = np.asarray([0.01], np.float32)
    idx = rng.integers(0, 8, (N, 2)).astype(np.int32)
    embed = rng.uniform(-0.3, 0.6, (2, 8, 3)).astype(np.float32)
    comb = (embed[0][:, None, :] + embed[1][None, :, :]).reshape(-1, 3)
    return xyz16, scodes, rcodes, s_scale, s_beta, r_scale, r_beta, idx, comb


# ------------------------------------------------------------- core


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_rot_covariance_and_projection_match_jax(seed):
    """cov2d_from_scale_rot and project_gaussians_2d_scale_rot on the same
    angles ([N, 1] and [N]): every output to TOL on all rows, bit-equal on
    the rows where cos and sin agree, as both functions take them (of the
    [N] vector: _agree). The activation sigmoid(r) * 2 pi differs from
    XLA's on under 1% of inputs (0.3% measured), by at most two ulps. Each
    assertion's message carries its numbers."""
    rng = np.random.default_rng(seed)
    n = 4096
    means = rng.uniform(-0.95, 0.95, (n, 2)).astype(np.float32)
    scales = np.abs(rng.uniform(0.0, 3.0, (n, 2)) + 0.5).astype(np.float32)
    raw = rng.normal(0.0, 2.0, (n, 1)).astype(np.float32)
    tj, tt = _theta_jax(raw), _theta_port(raw)
    ulps = np.abs(tj.view(np.int32).astype(np.int64)
                  - tt.view(np.int32).astype(np.int64))
    share, worst = float((ulps > 0).mean()), int(ulps.max())
    assert share < 0.01 and worst <= 2, (
        f"sigmoid(r) * 2 pi: {int((ulps > 0).sum())} of {n} angles "
        f"({share:.4f}, bound 0.01) differ from XLA's, by up to {worst} "
        f"ulps (bound 2)")
    mask = _agree(tj, tj)
    off = float((~mask).mean())
    assert off < MAX_OFF_MASK, (
        f"{int((~mask).sum())} of {n} rows ({off:.4f}) off the cos / sin "
        f"mask (bound {MAX_OFF_MASK})")
    tb = (-(-W // 16), -(-H // 16), 1)
    for theta in (tj, tj[:, 0]):
        shape = f"theta {list(theta.shape)}"
        cj = np.asarray(jcore.cov2d_from_scale_rot(jnp.asarray(scales),
                                                   jnp.asarray(theta)))
        ct = tcore.cov2d_from_scale_rot(_t(scales), _t(theta)).numpy()
        np.testing.assert_allclose(ct, cj, err_msg=f"cov, {shape}", **TOL)
        _equal_on(f"cov, {shape}", ct, cj, mask)
        pj = jcore.project_gaussians_2d_scale_rot(
            jnp.asarray(means), jnp.asarray(scales), jnp.asarray(theta), H,
            W, tb)
        pt = tcore.project_gaussians_2d_scale_rot(_t(means), _t(scales),
                                                  _t(theta), H, W, tb)
        for name, a, b in zip(("xys", "depths", "radii", "conics",
                               "num_tiles_hit"), pt, pj):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a, b, err_msg=f"{name}, {shape}",
                                       **TOL)
            _equal_on(f"{name}, {shape}", a, b, mask)


# ------------------------------------------------ the fused fronts


def _caps(cap):
    jcfg = JCfg(fused_prep=True, max_instances=cap)
    cfg = RasterizeConfig(fused_prep=True, max_instances=cap)
    _, m_span, _ = jsc.stream_caps(N, jcfg)
    return jcfg, cfg, m_span


def _jax_conic(scales, theta):
    """The JAX package's covariance and conic, one operation at a time
    (eager jnp, as core/covariance.py writes them)."""
    cov = jcore.cov2d_from_scale_rot(jnp.asarray(scales), jnp.asarray(theta))
    return np.asarray(cov), np.asarray(jcore.conic_from_cov2d(cov))


def _check_stream(got, want, mask, m_span, jconic):
    """The port's stream against JAX's kernel. Keys of every masked row
    (slot by slot), the sorted live keys and the totals trunc and n_total
    integer-exact. The masked rows' conic bit-equal to the JAX package's
    op-by-op conic ``jconic``. JAX's kernel itself departs from that
    expression on a few rows of elongated Gaussians (XLA fuses the kernel's
    arithmetic; ROADMAP.md section 3), so on every other row the feature
    row is held to TOL (the coordinates, after each package's tanh, to
    rtol 3e-6); the departed rows are counted. Returns (JAX's rows, the
    rows where JAX's kernel keeps its op-by-op conic)."""
    feat, keys, trunc, n_total = got
    jfeat, jkeys, jtrunc, jn_total = (np.asarray(x) for x in want)
    jfeat = jfeat[:N + 1]
    rows = keys.numpy().reshape(m_span, N + 1)[:, :N]
    jrows = jkeys.reshape(m_span, -1)[:, :N]   # JAX pads its row blocks
    assert (jrows != INT_MAX).sum() > N        # most live, some wide
    np.testing.assert_array_equal(rows[:, mask], jrows[:, mask])
    skeys, sjkeys = np.sort(rows.ravel()), np.sort(jrows.ravel())
    np.testing.assert_array_equal(skeys, sjkeys)
    assert int(trunc) == int(jtrunc) and int(n_total) == int(jn_total)
    f = feat.numpy()
    np.testing.assert_array_equal(f[N], 0.0)
    np.testing.assert_array_equal(f[:N, 2:5][mask], jconic[mask])
    np.testing.assert_array_equal(f[:N, 5:], jfeat[:N, 5:])
    kept = np.isclose(jfeat[:N, 2:5], jconic, **TOL).all(axis=1)
    assert (~kept).sum() <= MAX_FUSED_ROWS, (~kept).sum()
    np.testing.assert_allclose(f[:N, 2:5][kept], jfeat[:N, 2:5][kept], **TOL)
    np.testing.assert_allclose(f[:N, :2], jfeat[:N, :2], rtol=3e-6,
                               atol=1e-6)
    return jfeat, kept


@pytest.mark.parametrize("cap", [None, 256])
def test_rs_raw_prep_plain_matches_jax(cap):
    """K6b's plain version against the JAX kernel (also under a stream cap
    of 256, which sets the span M); then the shared front fed JAX's means
    and op-by-op covariance gives JAX's rows to TOL on every row where
    JAX's kernel keeps that covariance's conic."""
    jcfg, cfg, m_span = _caps(cap)
    xyz, scaling, rotation, colors = _raw_scene()
    mask = _agree(_theta_jax(rotation), _theta_port(rotation))
    assert (~mask).mean() < MAX_OFF_MASK, (~mask).sum()
    want = jsp.fused_raw_prep_rs(jnp.asarray(xyz), jnp.asarray(scaling),
                                 jnp.asarray(rotation), jnp.asarray(colors),
                                 BOUND, H, W, jcfg, m_span)
    got = sp.fused_raw_prep_rs(_t(xyz), _t(scaling), _t(rotation),
                               _t(colors), BOUND, H, W, cfg, m_span)
    cov, jconic = _jax_conic(np.abs(scaling + BOUND), _theta_jax(rotation))
    jfeat, kept = _check_stream(got, want, mask, m_span, jconic)
    means = _t(np.array(jnp.tanh(jnp.asarray(xyz))))
    feat, _, _ = sp._project_pack_bin(
        means[:, 0], means[:, 1], *_t(cov).unbind(1), _t(colors), H, W,
        cfg.tile_px, m_span, cfg.q_cut)
    np.testing.assert_allclose(feat.numpy()[:N][kept], jfeat[:N][kept],
                               **TOL)


@pytest.mark.parametrize("cap", [None, 256])
def test_rs_decode_prep_plain_matches_jax(cap):
    """K6a's plain version against the JAX kernel: the dequantized angle
    (code * scale + beta, no sigmoid) is bit-equal in both, so the mask is
    the rows whose cos and sin agree."""
    jcfg, cfg, m_span = _caps(cap)
    (xyz16, scodes, rcodes, s_scale, s_beta, r_scale, r_beta, idx,
     comb) = _code_scene()
    theta = (rcodes.astype(np.float32) * r_scale + r_beta).astype(np.float32)
    mask = _agree(theta, theta)
    assert (~mask).mean() < MAX_OFF_MASK, (~mask).sum()
    xyz = xyz16.astype(np.float32)
    want = jsp.fused_prep_rs(
        jnp.asarray(xyz), jnp.asarray(scodes), jnp.asarray(rcodes),
        jnp.asarray(s_scale), jnp.asarray(s_beta), jnp.asarray(r_scale),
        jnp.asarray(r_beta), BOUND, jnp.asarray(idx), jnp.asarray(comb), H,
        W, jcfg, m_span)
    got = sp.fused_prep_rs(
        _t(xyz16), _t(scodes), _t(rcodes), _t(s_scale), _t(s_beta),
        _t(r_scale), _t(r_beta), BOUND, _t(idx), _t(comb), H, W, cfg,
        m_span)
    s = np.abs(scodes.astype(np.float32) * s_scale + s_beta + BOUND)
    cov, jconic = _jax_conic(s, theta)
    jfeat, kept = _check_stream(got, want, mask, m_span, jconic)
    means = _t(np.array(jnp.tanh(jnp.asarray(xyz))))
    feat, _, _ = sp._project_pack_bin(
        means[:, 0], means[:, 1], *_t(cov).unbind(1),
        _t(comb)[_t(idx[:, 0] * 8 + idx[:, 1]).long()], H, W, cfg.tile_px,
        m_span, cfg.q_cut)
    np.testing.assert_allclose(feat.numpy()[:N][kept], jfeat[:N][kept],
                               **TOL)


def test_rs_prep_wrappers_never_fall_back():
    """A non-CPU tensor launches the kernel or raises: on meta tensors (no
    CUDA here) K6b and K6a refuse instead of taking the plain version."""
    meta = dict(device="meta")
    f32 = torch.zeros(4, 2, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    before = (sp.rs_raw_prep.launches, sp.rs_decode_prep.launches)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sp.rs_raw_prep(f32, torch.zeros(4, 2, **meta),
                       torch.zeros(4, 1, **meta), torch.zeros(4, 3, **meta),
                       BOUND, 32, 32, 32, 9, 9.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sp.rs_decode_prep(f32, torch.zeros(4, 2, **i32),
                          torch.zeros(4, 1, **i32), torch.zeros(4, 2, **i32),
                          torch.zeros(2, **meta), torch.zeros(2, **meta),
                          torch.zeros(1, **meta), torch.zeros(1, **meta),
                          torch.zeros(64, 3, **meta), BOUND, 32, 32, 32, 9,
                          9.0)
    assert (sp.rs_raw_prep.launches, sp.rs_decode_prep.launches) == before


def _check_prefix_rows(jax_keys, m_span, stats, keys, mask):
    """The first n rows' keys [M, n+1] and per-row counts against JAX's
    kernel under a 3-tile span: keys equal slot by slot on the rows of
    ``mask`` (where both packages' angle, cos and sin agree) and on the
    sentinel column; each such row's (trunc, live) the excess and min of
    its area over M, the area read off JAX's keys under a span of every
    tile."""
    jkeys, jtrunc, jn_total = jax_keys(m_span)
    area = (jax_keys(-(-H // 16) * -(-W // 16))[0] != INT_MAX).sum(axis=0)
    cols = np.append(mask, True)
    keys, stats = keys.numpy(), stats.numpy()
    np.testing.assert_array_equal(keys[:, cols], jkeys[:, cols])
    np.testing.assert_array_equal(stats[0][cols],
                                  np.maximum(area - m_span, 0)[cols])
    np.testing.assert_array_equal(stats[1][cols],
                                  np.minimum(area, m_span)[cols])
    if mask.all():
        assert (int(stats[0].sum()), int(stats[1].sum())) == (jtrunc,
                                                               jn_total)
    return jtrunc


def _jax_prefix_keys(fn, rows, n):
    """m -> (JAX's keys [m, n+1], trunc, n_total) of ``fn`` (a jitted
    fused front on ``rows``) under a span of m tiles."""
    def keys(m):
        _, jkeys, jtrunc, jn_total = jax.jit(
            lambda *r: fn(*r, m))(*(jnp.asarray(r) for r in rows))
        return (np.asarray(jkeys).reshape(m, -1)[:, :n + 1], int(jtrunc),
                int(jn_total))
    return keys


@pytest.mark.parametrize("n", [1, 33, 65])
def test_rs_raw_prep_plain_rows_match_jax(n):
    """The plain K6b on the first n raw rows (the card's K6b stages 64-row
    blocks: n = 1, 33, 65 leave a partial block and warp) against JAX's
    fused_raw_prep_rs under a 3-tile span (_check_prefix_rows). The share
    of rows off the angle mask is held over the whole scene by
    test_rs_raw_prep_plain_matches_jax; row 0 is on it."""
    jcfg, cfg = JCfg(fused_prep=True), RasterizeConfig(fused_prep=True)
    m_span = 3
    rows = tuple(np.ascontiguousarray(a[:n]) for a in _raw_scene())
    mask = _agree(_theta_jax(rows[2]), _theta_port(rows[2]))
    assert mask[0]
    jax_keys = _jax_prefix_keys(
        lambda x, s, r, c, m: jsp.fused_raw_prep_rs(x, s, r, c, BOUND, H, W,
                                                    jcfg, m), rows, n)
    _, keys, stats = sp.rs_raw_prep(*(_t(r) for r in rows), BOUND, H, W,
                                    cfg.tile_px, m_span, float(cfg.q_cut))
    jtrunc = _check_prefix_rows(jax_keys, m_span, stats, keys, mask)
    if n == 65:
        assert jtrunc > 0


@pytest.mark.parametrize("n", [1, 33, 65])
def test_rs_decode_prep_plain_rows_match_jax(n):
    """The plain K6a on the first n code rows against JAX's fused_prep_rs
    under a 3-tile span (_check_prefix_rows); the dequantized angle is
    bit-equal in both, so the mask is the rows whose cos and sin agree."""
    jcfg, cfg = JCfg(fused_prep=True), RasterizeConfig(fused_prep=True)
    m_span = 3
    (xyz16, scodes, rcodes, s_scale, s_beta, r_scale, r_beta, idx,
     comb) = _code_scene()
    rows = (xyz16[:n].astype(np.float32), scodes[:n], rcodes[:n], idx[:n])
    theta = (rows[2].astype(np.float32) * r_scale + r_beta).astype(
        np.float32)
    mask = _agree(theta, theta)
    assert mask[0]
    tables = tuple(jnp.asarray(a) for a in (s_scale, s_beta, r_scale,
                                            r_beta))
    jax_keys = _jax_prefix_keys(
        lambda x, s, r, i, m: jsp.fused_prep_rs(
            x, s, r, *tables, BOUND, i, jnp.asarray(comb), H, W, jcfg, m),
        rows, n)
    _, keys, stats = sp.rs_decode_prep(
        *(_t(r) for r in rows[:3]), _t(rows[3]), _t(s_scale), _t(s_beta),
        _t(r_scale), _t(r_beta), _t(comb), BOUND, H, W, cfg.tile_px,
        m_span, float(cfg.q_cut))
    jtrunc = _check_prefix_rows(jax_keys, m_span, stats, keys, mask)
    if n == 65:
        assert jtrunc > 0


@pytest.mark.parametrize("kernel,names", [
    ("K6b", ("xyz", "scaling", "rotation", "colors")),
    ("K6a", ("xyz", "scodes", "rcodes", "idx"))])
def test_rs_prep_refuses_unaligned_rows(kernel, names):
    """K6b and K6a load their row inputs as 16-byte vectors: the wrapper's
    alignment check passes fresh tensors and refuses a view one row into
    its storage ([N, 1] rotation codes: 4 bytes; [N, 2]: 8; [N, 3]: 12).
    CPU tensors reach the plain version, so the check is called as the
    wrapper calls it on a CUDA tensor."""
    widths = {"xyz": 2, "scaling": 2, "rotation": 1, "colors": 3,
              "scodes": 2, "rcodes": 1, "idx": 2}
    dtypes = {"scodes": torch.int32, "rcodes": torch.int32,
              "idx": torch.int32}
    rows = {k: torch.zeros(9, widths[k], dtype=dtypes.get(k, torch.float32))
            for k in names}
    sp._check_aligned(kernel, list(rows.items()))
    for k, x in rows.items():
        with pytest.raises(ValueError, match=f"{kernel} loads {k} as 16-byte"):
            sp._check_aligned(kernel, [(k, x[1:])])


# ------------------------------------------------------ the model


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX suite's RS scene (tests/test_splat_prep.py:97-107): 50 JAX
    fit steps from init_state(PRNGKey(3)), adaptive init, at 64x96, N=512;
    and a QAT state (init_quantizer_data) of those parameters."""
    gt = jnp.asarray(synthetic_image(H, W, seed=6))
    jm = j_make_model("GaussianImage_RS", num_points=N, H=H, W=W)
    st = jm.init_state(jax.random.PRNGKey(3), gt_image=gt)
    st, _ = jm.train_chunk(st, gt, None, jnp.asarray(1), 50)
    jq = j_make_model("GaussianImage_RS", num_points=N, H=H, W=W,
                      quantize=True)
    qst = jq.init_state(jax.random.PRNGKey(0))
    qst = jq.init_quantizer_data(qst._replace(params={
        **qst.params, **st.params}))
    return jm, st, jq, qst, np.asarray(gt)


def _port_model(params, extra=None, **kw):
    m = make_model("GaussianImage_RS", device="cpu", num_points=N, H=H, W=W,
                   **kw)
    m.load_state_dict(params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu",
        None if extra is None else {
            f"vq/{k}": np.asarray(v)
            for k, v in extra["vq"]._asdict().items()}))
    return m


def _assert_image(got, want):
    diff = np.abs(got - want)
    assert int((diff > 1e-4).sum()) <= MAX_EDGE_PX, int((diff > 1e-4).sum())
    np.testing.assert_allclose(got[diff <= 1e-4], want[diff <= 1e-4],
                               rtol=0, atol=2e-5)


def test_rs_render_render_fast_and_decode_match_jax(jax_trained):
    """On JAX-trained RS parameters: render() (default config), render_fast
    under serving(N) (the plain K6b) and the decode through the plain K6a
    and through the generic path, each against the JAX package's output of
    the same call; n_dropped equal. render_fast equals the port's render()
    within the same tolerance, and render_fast under the default config
    is render()."""
    jm, st, jq, qst, _ = jax_trained
    want = np.asarray(jm.render(st.params)["render"])
    m = _port_model(st.params)
    with torch.no_grad():
        out = m.render()
    got = out["render"].numpy()
    _assert_image(got, want)
    assert int(out["raster_aux"]["n_dropped"]) == int(
        jm.render(st.params)["raster_aux"]["n_dropped"])
    np.testing.assert_array_equal(m.render_fast().numpy(), got)
    ms = _port_model(st.params, raster=RasterizeConfig.serving(N))
    before = sp.rs_raw_prep.launches
    fast, aux = ms.render_fast(with_aux=True)
    assert sp.rs_raw_prep.launches == before  # CPU tensors: the plain K6b
    assert int(aux["n_dropped"]) == 0 and fast.shape == (1, 3, H, W)
    jms = j_make_model("GaussianImage_RS", num_points=N, H=H, W=W,
                       raster=JCfg.serving(N))
    _assert_image(fast.numpy(), np.asarray(jms.render_fast(st.params)))
    _assert_image(fast.numpy(), got)

    # the decode: the port's codes of the QAT state equal JAX's; both
    # decodes against JAX's
    jenc = jq.compress_wo_ec(qst.params, qst.extra)
    q = _port_model(qst.params, qst.extra, quantize=True)
    enc = q.compress_wo_ec()
    for k in ("quant_scaling", "quant_rotation", "feature_dc_index", "xyz"):
        np.testing.assert_array_equal(enc[k], np.asarray(jenc[k]), err_msg=k)
    jdec = jq.decompress_wo_ec(qst.params, qst.extra,
                               {k: jnp.asarray(v) for k, v in jenc.items()})
    generic = q.decompress_wo_ec(enc)
    _assert_image(generic["render"].numpy(), np.asarray(jdec["render"]))
    # JAX's fused decode (its model's decompress_wo_ec under fused_prep
    # returns no aux, so the entry point it calls)
    p, embed = qst.params, qst.extra["vq"].embed
    jimg, _, jaux = jsp.fused_decode_rs(
        jnp.asarray(jenc["xyz"], jnp.float32),
        jnp.asarray(jenc["quant_scaling"]),
        jnp.asarray(jenc["quant_rotation"]), p["scaling_quant_scale"],
        p["scaling_quant_beta"], p["rotation_quant_scale"],
        p["rotation_quant_beta"], BOUND, jnp.asarray(jenc["feature_dc_index"]),
        (embed[0][:, None, :] + embed[1][None, :, :]).reshape(-1, 3), H, W,
        JCfg(fused_prep=True))
    qf = _port_model(qst.params, qst.extra, quantize=True,
                     raster=RasterizeConfig(fused_prep=True))
    before = sp.rs_decode_prep.launches
    fused = qf.decompress_wo_ec(enc)
    assert sp.rs_decode_prep.launches == before  # the plain K6a
    _assert_image(fused["render"].numpy(),
                  np.clip(np.asarray(jimg), 0.0, 1.0)[None])
    assert int(fused["raster_aux"]["n_dropped"]) == int(jaux["n_dropped"])
    _assert_image(fused["render"].numpy(), generic["render"].numpy())
    with torch.no_grad():
        evr = q.render_quantize(training=False)["render"].numpy()
    np.testing.assert_allclose(generic["render"].numpy(), evr, rtol=0,
                               atol=1e-6)


def _grads_vs_jax_or_oracle(model, names, jg, oracle):
    """Each entry at rtol 1e-4 / atol 1e-8 of JAX's or, where that fails,
    nearer the float64 oracle than JAX's and within the same tolerance of
    it (the quantizers' summed scale and beta gradients within 1e-4 of the
    parameter's largest). Position gradients off JAX's are held to the
    oracle within XYZ_ORACLE_TOL of the largest."""
    for k in names:
        a = getattr(model, k).grad.numpy().astype(np.float64)
        b, o = np.asarray(jg[k], np.float64), oracle[k]
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-8)
        if k == "_xyz":
            np.testing.assert_allclose(
                a[off], o[off], rtol=0,
                atol=XYZ_ORACLE_TOL * np.abs(o).max(), err_msg=k)
            continue
        assert np.all(np.abs(a - o)[off] <= np.abs(b - o)[off]), k
        atol = 1e-4 * np.abs(o).max() if "quant" in k else 1e-8
        np.testing.assert_allclose(a[off], o[off], rtol=1e-4, atol=atol,
                                   err_msg=k)


def _dense_loss(means, scales, theta, colors, gt):
    """The float64 oracle's loss: projection and dense render
    (core/render_ref.py, q_cut 9) in float64, clip, mean squared error."""
    tb = (-(-W // 16), -(-H // 16), 1)
    xys, _, _, conics, _ = tcore.project_gaussians_2d_scale_rot(
        means.double(), scales.double(), theta.double(), H, W, tb)
    img = render_sum_dense(xys, conics, colors.double(),
                           torch.ones(N, 1, dtype=torch.float64), H, W,
                           q_cut=9.0)[..., :3].permute(2, 0, 1)[None]
    img = torch.minimum(torch.maximum(img, img.new_zeros(())),
                        img.new_ones(()))
    return ((img - _t(gt).double()) ** 2).mean()


def test_rs_fit_step_gradients_match_jax_or_oracle(jax_trained):
    """One fit step's loss (the fused render + L2 + backward, plain K3)
    from JAX-trained parameters: the loss to rtol 1e-6, the gradients of
    every parameter, _scaling and _rotation included, against jax.grad of
    the JAX model's loss or the float64 oracle."""
    jm, st, _, _, gt = jax_trained
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(gt)), has_aux=True)(st.params)
    m = _port_model(st.params)
    loss, _ = m.loss(_t(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    leaves = {k: getattr(m, k).detach().clone().requires_grad_()
              for k in PARAMS}
    _dense_loss(torch.tanh(leaves["_xyz"]),
                torch.abs(leaves["_scaling"] + m.scaling_bound),
                torch.sigmoid(leaves["_rotation"]) * sp.TWO_PI,
                leaves["_features_dc"], gt).backward()
    _grads_vs_jax_or_oracle(m, PARAMS, jg, {
        k: v.grad.numpy().astype(np.float64) for k, v in leaves.items()})


def test_rs_qat_step_gradients_match_jax_or_oracle(jax_trained):
    """One QAT loss (the generic render through plain K1/K2, the uniform
    quantizers on the raw scaling and the activated rotation, the VQ) from
    the same QAT state: the loss to rtol 1e-6, every parameter's gradient
    against jax.grad or the float64 oracle."""
    _, _, jq, qst, gt = jax_trained
    (jl, _), jg = jax.value_and_grad(
        lambda p: jq.loss(p, jnp.asarray(gt), extra=qst.extra),
        has_aux=True)(qst.params)
    m = _port_model(qst.params, qst.extra, quantize=True)
    loss, aux = m.loss(_t(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert "vq_state" in aux["pkg"]
    lv = {k: getattr(m, k).detach().clone().requires_grad_()
          for k in QPARAMS}
    s = UniformQuantizer(6, num_channels=2)(UniformQuantizerState(
        lv["scaling_quant_scale"], lv["scaling_quant_beta"]), lv["_scaling"])
    r = UniformQuantizer(6, num_channels=1)(UniformQuantizerState(
        lv["rotation_quant_scale"], lv["rotation_quant_beta"]),
        torch.sigmoid(lv["_rotation"]) * sp.TWO_PI)
    cols, _, commit, _ = ResidualVQ()(m.vq_state(), lv["_features_dc"])
    (_dense_loss(torch.tanh(fake_quantize_half(lv["_xyz"])),
                 torch.abs(s + m.scaling_bound), r, cols, gt)
     + commit).backward()
    _grads_vs_jax_or_oracle(m, QPARAMS, jg, {
        k: v.grad.numpy().astype(np.float64) for k, v in lv.items()})


def test_rs_weights_load_both_ways(jax_trained, tmp_path):
    """JAX RS parameters and a JAX RS QAT state (the quantizers' scale and
    beta, vq/*) load into the port unchanged; the port's QAT checkpoint
    (checkpoint_trees) loads into the JAX RS codec evaluator unchanged."""
    from gaussianimage_tpu.test_quantize import (
        CodecEvaluator2d as JCodecEvaluator2d)
    from gaussianimage_tpu_torch.utils.checkpoint import (checkpoint_trees,
                                                          save_checkpoint)

    _, st, _, qst, gt = jax_trained
    m = _port_model(st.params)
    for k in PARAMS:
        np.testing.assert_array_equal(getattr(m, k).detach().numpy(),
                                      np.asarray(st.params[k]), err_msg=k)
    q = _port_model(qst.params, qst.extra, quantize=True)
    assert set(q.state_dict()) == set(QPARAMS) | {
        f"vq.{k}" for k in ("embed", "cluster_size", "embed_avg", "initted")}
    for k in QPARAMS:
        np.testing.assert_array_equal(getattr(q, k).detach().numpy(),
                                      np.asarray(qst.params[k]), err_msg=k)
    for k, v in qst.extra["vq"]._asdict().items():
        np.testing.assert_array_equal(getattr(q.vq, k).numpy(),
                                      np.asarray(v), err_msg=k)
    path = tmp_path / "gaussian_model.best.npz"
    save_checkpoint(path, *checkpoint_trees(q))
    jev = JCodecEvaluator2d(gt, "a", num_points=N,
                            model_name="GaussianImage_RS", model_path=path,
                            log_dir=tmp_path / "jeval")
    for k in QPARAMS:
        np.testing.assert_array_equal(np.asarray(jev.state.params[k]),
                                      np.asarray(qst.params[k]), err_msg=k)
    for k, v in qst.extra["vq"]._asdict().items():
        np.testing.assert_array_equal(
            np.asarray(getattr(jev.state.extra["vq"], k)), np.asarray(v),
            err_msg=k)
