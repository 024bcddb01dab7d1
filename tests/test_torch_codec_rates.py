"""Port parity, the codec away from 10k points: the committed QAT states of
both photos (results_quant/photos/GaussianImage_Cholesky_50000_<N>) through
the port's ``CodecEvaluator2d.evaluate`` (the codec CLI's evaluation
without its timed probes) and through the JAX package's evaluation
(gaussianimage_tpu/test_quantize.py, ``CodecEvaluator2d.test`` without its
probes: the jitted decode, its PSNR, ``analysis_wo_ec`` and ``analysis``).

- 800 points, the lowest committed rate (~0.12 bpp): the code arrays and
  the rANS streams equal, the bpp breakdown and the entropy-coded bits
  exactly equal, the round trip exact, PSNR within 1e-4 dB, and the image
  as tests/test_torch_slice.py holds it (below).
- 20,000 and 40,000 points (aligned stream): the JAX package's evaluation
  equals the anchors ``chip_smoke.py`` gates the card's run on
  (``CODEC_RATE_ANCHORS``), which this test computed; the port's codes and
  bits equal JAX's, and its PSNR is within 1e-4 dB of the anchor.

The image at 800 points. XLA's CPU tanh is one ulp off torch's on most
means, so the port first rasterizes JAX's dequantized means: that image is
held to JAX's within 2e-5 but for the pixels of "needle" rows, whose conic
XLA's jit computes more than 1e-4 relative off the op-by-op float32 one: a
near-singular covariance (a c / det above 1e3) inverted with fused
multiply-adds. The test asserts that the port's conics equal the JAX
package's op-by-op ones (under ``jax.disable_jit``) on every row, bit for
bit, and picks the needles by the JAX package's jit against those, so a
fault of the port cannot hide its own rows. Those rows are at most 1% of N, and the pixels any of them
gates in either package are counted and left out. Then the port's own
decode, tanh included, has at most 16 pixels above 1e-4 outside them, as
tests/test_torch_slice.py bounds the pixels the tanh moves.

The JAX package's rANS runs through its NumPy coder: its native coder would
build a library inside the JAX package's tree. Both write the same words
(tests/test_torch_codec.py)."""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.codec import rans as jrans  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.utils import ms_ssim as j_ms_ssim  # noqa: E402
from gaussianimage_tpu_torch.test_quantize import CodecEvaluator2d  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    image_path_to_array)

ROOT = Path(__file__).resolve().parent.parent
H, W = 512, 768
BITS = ("bpp", "position_bpp", "cholesky_bpp", "feature_dc_bpp")
NEEDLE_REL = 1e-4   # conic rows XLA's jit computes this far off op by op
NEEDLE_COND = 1e3   # ... all of them near-singular: a c / det above this
NEEDLE_SHARE = 0.01


def _anchors():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.CODEC_RATE_ANCHORS


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_numpy_coder(monkeypatch):
    monkeypatch.setattr(jrans, "_LIB", None)
    monkeypatch.setattr(jrans, "_LIB_TRIED", True)


def _state(n, image):
    return (ROOT / f"results_quant/photos/GaussianImage_Cholesky_50000_{n}"
            / image / "gaussian_model.best.npz")


def _jax_eval(n, image, gt, full=False):
    """The JAX package's evaluation of the state: its model, the code
    arrays, the jitted decode, PSNR, the bpp breakdown and the
    entropy-coded bpp; with ``full`` also MS-SSIM and the serving twin's
    n_dropped."""
    ck = load_checkpoint(_state(n, image))
    jm = j_make_model("GaussianImage_Cholesky", num_points=n, H=H, W=W,
                      loss_type="L2", quantize=True)
    st = jm.init_state(jax.random.PRNGKey(1))
    params = dict(st.params)
    params.update({k: jnp.asarray(v) for k, v in ck["params"].items()})
    extra = dict(st.extra)
    extra["vq"] = extra["vq"]._replace(**{
        k.split("/", 1)[1]: jnp.asarray(v) for k, v in ck["extra"].items()})
    enc = jm.compress_wo_ec(params, extra)
    enc_dev = {k: jnp.asarray(v) for k, v in enc.items()}
    out = jax.jit(lambda p, e, x: jm.decompress_wo_ec(p, e, x))(
        params, extra, enc_dev)
    img = np.asarray(out["render"])
    data = jm.analysis_wo_ec(params, extra, enc)
    enc_ec = jm.compress(params, extra)
    data.update(psnr=10 * math.log10(1.0 / float(np.mean((img - gt) ** 2))),
                bpp_ec=jm.analysis(params, extra, enc_ec)["bpp"],
                n_dropped=int(out["raster_aux"]["n_dropped"]))
    if full:
        data["ms-ssim"] = float(j_ms_ssim(jnp.asarray(img), jnp.asarray(gt),
                                          data_range=1.0))
        jms = j_make_model("GaussianImage_Cholesky", num_points=n, H=H, W=W,
                           loss_type="L2", quantize=True,
                           raster=JCfg.serving(n))
        data["serving_n_dropped"] = int(jax.jit(
            lambda p, e, x: jms.decompress_wo_ec(p, e, x)["raster_aux"]
            ["n_dropped"])(params, extra, enc_dev))
    return data, enc, enc_ec, img, (jm, params, extra, enc_dev)


def _port_eval(n, image, gt, tmp_path):
    ev = CodecEvaluator2d(gt, image, num_points=n, model_path=_state(n, image),
                          log_dir=tmp_path / image, device="cpu")
    return ev, ev.evaluate()


def _same_codes_and_streams(ev, enc, enc_ec):
    assert sorted(ev.enc) == sorted(enc)
    for k in enc:
        assert ev.enc[k].dtype == enc[k].dtype, k
        np.testing.assert_array_equal(ev.enc[k], enc[k], err_msg=k)
    for k, v in enc_ec.items():
        if k.endswith("_bitstream"):
            for got, want in zip(ev.enc_ec[k], v):
                assert got.dtype == want.dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("image", ["china", "flower"])
def test_lowest_rate_codec_matches_jax(image, tmp_path):
    n = 800
    gt = image_path_to_array(ROOT / f"data/{image}_768x512.png")
    want, enc, enc_ec, jimg, (jm, jparams, jextra, jenc_dev) = _jax_eval(
        n, image, gt)
    ev, got = _port_eval(n, image, gt, tmp_path)

    _same_codes_and_streams(ev, enc, enc_ec)
    for k in BITS + ("bpp_ec",):
        assert got[k] == want[k], (k, got[k], want[k])
    dec = ev.model.entropy_decode(ev.enc_ec)
    for k in enc:
        np.testing.assert_array_equal(dec[k], enc[k], err_msg=k)
    assert got["ec_roundtrip_err"] == 0.0
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4, (got["psnr"],
                                                     want["psnr"])

    # the needle rows and every pixel either package's conic gates for them
    model = ev.model
    with torch.no_grad():
        means, geo, colors = model.dequantize_wo_ec(ev.enc)
        jmeans = np.array(jm.dequantize_wo_ec(jparams, jextra, jenc_dev)[0])
        xys, radii, conics, _, _ = model._quantized_splat(
            None, torch.from_numpy(jmeans), geo, colors)
        same, _, aux = model._rasterize_quantized(
            None, torch.from_numpy(jmeans), geo, colors)
        mine = model.decompress_wo_ec(ev.enc_dev)

    def jsplat(p, e, x):
        m, g, c = jm.dequantize_wo_ec(p, e, x)
        return jm._quantized_splat(p, m, g, c)

    _, _, jconics, _, _ = jax.jit(jsplat)(jparams, jextra, jenc_dev)
    with jax.disable_jit():
        econics = np.asarray(jsplat(jparams, jextra, jenc_dev)[2])
    # the port's conics are the JAX package's op-by-op ones, every row bit
    # for bit; the needles are where the JAX package's own jit departs from
    # them, so no row of the port picks itself
    np.testing.assert_array_equal(conics.numpy(), econics)
    cn, jcn = econics.astype(np.float64), np.asarray(jconics, np.float64)
    rel = (np.abs(cn - jcn) / np.abs(cn).max(axis=1, keepdims=True)).max(1)
    needle = np.nonzero(rel > NEEDLE_REL)[0]
    port_rel = (np.abs(conics.double().numpy() - jcn)
                / np.abs(cn).max(axis=1, keepdims=True)).max(1)
    assert (np.delete(port_rel, needle) <= NEEDLE_REL).all()
    assert len(needle) <= NEEDLE_SHARE * n, len(needle)
    a, b, c = cn[needle].T
    assert (a * c / (a * c - b * b) > NEEDLE_COND).all(), needle
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    masked = np.zeros((H, W), bool)
    xy = xys.double().numpy()
    for i in needle:
        dx, dy = xs - xy[i, 0], ys - xy[i, 1]
        box = (np.abs(dx) <= float(radii[i])) & (np.abs(dy) <= float(radii[i]))
        for aa, bb, cc in (cn[i], jcn[i]):
            q = aa * dx * dx + 2 * bb * dx * dy + cc * dy * dy
            masked |= box & (q <= 9.0)
    keep = np.broadcast_to(~masked, (1, 3, H, W))

    # 1. on JAX's means, within 2e-5 outside the needles' pixels
    same = same.clamp(0, 1).permute(2, 0, 1)[None].numpy()
    assert int(aux["n_dropped"]) == want["n_dropped"]
    np.testing.assert_allclose(same[keep], jimg[keep], rtol=0, atol=2e-5)
    # 2. the port's own decode: the pixels its tanh moves past 1e-4
    got_img = mine["render"].numpy()
    assert int(mine["raster_aux"]["n_dropped"]) == want["n_dropped"]
    moved = int((np.abs(got_img - jimg)[keep] > 1e-4).sum())
    assert moved <= 16, (moved, int(masked.sum()), len(needle))


@pytest.mark.parametrize("n,image", [(20000, "china"), (20000, "flower"),
                                     (40000, "china"), (40000, "flower")])
def test_codec_anchors_at_20k_and_40k_are_the_jax_package_s(n, image,
                                                            tmp_path):
    """The JAX package's evaluation of the state equals chip_smoke.py's
    pinned anchor (PSNR to 1e-4 dB, MS-SSIM to 1e-6, bpp and bpp_ec to 4
    decimals, the serving twin's n_dropped exactly); the port's codes,
    streams and bits equal JAX's and its PSNR is within 1e-4 dB."""
    pin = _anchors()[n][image]
    gt = image_path_to_array(ROOT / f"data/{image}_768x512.png")
    want, enc, enc_ec, _, _ = _jax_eval(n, image, gt, full=True)
    assert abs(want["psnr"] - pin["psnr"]) <= 1e-4, want["psnr"]
    assert abs(want["ms-ssim"] - pin["ms-ssim"]) <= 1e-6, want["ms-ssim"]
    assert round(want["bpp"], 4) == pin["bpp"], want["bpp"]
    assert round(want["bpp_ec"], 4) == pin["bpp_ec"], want["bpp_ec"]
    assert want["serving_n_dropped"] == pin["serving_n_dropped"]
    assert want["n_dropped"] == 0

    ev, got = _port_eval(n, image, gt, tmp_path)
    _same_codes_and_streams(ev, enc, enc_ec)
    for k in BITS + ("bpp_ec",):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["ec_roundtrip_err"] == 0.0
    assert got["serving_n_dropped"] == pin["serving_n_dropped"]
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4, (got["psnr"],
                                                     want["psnr"])
