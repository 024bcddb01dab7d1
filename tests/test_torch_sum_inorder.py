"""The in-order plain forward (``sum_fwd_plain(..., in_order=True)`` and its
aligned twin): each pixel adds its gated pairs one at a time in stream
order, as K1 does, so that the card can hold K1 to it bit for bit
(chip_smoke.py). ``sum_fwd_plain`` sums with ``index_add_``, which adds
in stream order on the CPU but in the atomics' order on the card.

- against ``sum_fwd_plain`` on the CPU: bit for bit, on seeded states and
  on the NaN-form rows of tests/test_torch_sum_gate.py (a NaN form fails
  the gate, a negative one passes as q = 0), flat and aligned;
- against the JAX kernel (gaussianimage_tpu/ops/rasterize_sum.py
  ``_fwd_full``, Pallas interpret mode, jitted) on the NaN-form rows:
  atol 2e-5, the tolerance of tests/test_torch_sum_gate.py (the JAX
  kernel's HIGHEST-precision contractions against in-order sums);
- the order itself: one pixel whose terms do not commute in float32 takes
  the stream order's sum, and not the one of any other order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gaussianimage_tpu.ops import rasterize_sum as jrs  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_sum as rs  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as sc  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)
from test_torch_sum_gate import H, W, _case, _gfeat, _static  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _both(feat, sp, H_, W_):
    """(in-order image, index_add_ image) of the stream ``sp``."""
    if sp.aligned:
        blocks = sc.blockize_stream_plain(feat, sp.gids)
        return tuple(rs.sum_fwd_aligned_plain(blocks, sp.starts, sp.counts,
                                              H_, W_, in_order=o)
                     for o in (True, False))
    return tuple(rs.sum_fwd_plain(feat, sp.gids, sp.starts, H_, W_,
                                  in_order=o) for o in (True, False))


def _bits_equal(a, b):
    """NaN at the same entries and equal bit for bit elsewhere."""
    nan = b.isnan()
    return (torch.equal(nan, a.isnan())
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_in_order_equals_index_add_seeded(seed, aligned):
    N, H_, W_ = 300, 70, 100
    rng = np.random.default_rng(seed)
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H_, W=W_, raster=RasterizeConfig(
                           flat_stream_limit=0 if aligned else 65536))
    model.load_state_dict(params_from_numpy({
        "_xyz": rng.uniform(-1.6, 1.6, (N, 2)),
        "_cholesky": rng.uniform(0.0, 2.5, (N, 3)),
        "_features_dc": rng.uniform(-0.2, 1.0, (N, 3))}, "cpu"))
    with torch.no_grad():
        xys, radii, conics, colors, opac = model.splat()
        rxy = rs._axis_radii(conics, radii.float(), model.cfg.raster.q_cut)
        sp = sc.prepare_stream(xys, rxy, H_, W_, model.cfg.raster)
        feat = sc.pack_feat(xys, conics, colors, opac, premultiply=True)
    assert bool(sp.aligned) == aligned
    # windows of different depths, some empty: the loop's live mask matters
    cnt = sp.counts[:sp.T]
    assert int(cnt.max()) > 2 * int(cnt.float().mean()) and int(cnt.min()) == 0
    got, want = _both(feat, sp, H_, W_)
    assert got.shape == (4, H_, W_) and bool(torch.isfinite(got).all())
    assert _bits_equal(got, want)


@pytest.mark.parametrize("aligned", [False, True])
def test_in_order_gate_matches_jax(aligned):
    jsp, tsp, feat, _, _, adv = _case(aligned)
    static = _static(jsp, aligned)
    want = np.asarray(jax.jit(lambda s, c, f: jrs._fwd_full(static, s, c, f))(
        jsp.starts, jsp.counts, _gfeat(jsp, feat, aligned)))
    got, plain = _both(feat, tsp, H, W)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert _bits_equal(got, plain)
    assert np.isin(adv, tsp.gids.numpy()).all()


def test_in_order_takes_the_stream_order():
    """Three rows centred on pixel (5, 5) of one tile, w = 1 there, with
    color sums 2^25, 1 and -2^25 in stream order: in float32 (2^25 + 1) -
    2^25 = 0, where adding the 1 last gives 1."""
    xys = np.full((3, 2), 5.0, np.float32)
    conics = np.tile(np.float32([[0.5, 0.0, 0.5]]), (3, 1))
    colors = np.zeros((3, 3), np.float32)
    colors[:, 0] = [2.0 ** 25, 1.0, -(2.0 ** 25)]
    opac = np.ones((3, 1), np.float32)
    feat = sc.pack_feat(*(torch.from_numpy(v) for v in
                          (xys, conics, colors, opac)), premultiply=True)
    gids = torch.tensor([0, 1, 2], dtype=torch.int32)
    starts = torch.tensor([0, 3], dtype=torch.int32)
    img = rs.sum_fwd_plain(feat, gids, starts, 32, 32, in_order=True)
    expect = np.float32(0.0)
    for v in colors[:, 0]:
        expect = np.float32(expect + v)
    assert expect == 0.0
    assert float(img[0, 5, 5]) == float(expect)
    assert float(img[3, 5, 5]) == 3.0
    # the same rows in another order sum to 1
    other = rs.sum_fwd_plain(feat, torch.tensor([0, 2, 1], dtype=torch.int32),
                             starts, 32, 32, in_order=True)
    assert float(other[0, 5, 5]) == 1.0
