"""Port parity, binning: the instance stream (gids, window bounds, counts,
n_dropped) of gaussianimage_tpu_torch must equal the JAX package's exactly,
integer for integer, on the same float32 xys / axis radii."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.ops import stream_common as jsc  # noqa: E402
from gaussianimage_tpu.ops import tiles as jtiles  # noqa: E402
from gaussianimage_tpu.ops.rasterize_sum import _axis_radii  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig as TCfg  # noqa: E402
from gaussianimage_tpu_torch.ops import stream_common as tsc  # noqa: E402
from gaussianimage_tpu_torch.ops import tiles as ttiles  # noqa: E402


def _xys_rxy(N, H, W, seed, spread=0.95):
    """float32 (xys, rx, ry) numpy arrays from a seeded projected scene."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (N, 2)).astype(np.float32)
    chol = rng.uniform(0.3, 3.0, (N, 3)).astype(np.float32)
    chol[:, 1] = rng.uniform(-2.0, 2.0, N).astype(np.float32)
    tb = (-(-W // 16), -(-H // 16), 1)
    xys, _, radii, conics, _ = project_gaussians_2d(
        jnp.asarray(means), jnp.asarray(chol), H, W, tb)
    rx, ry = _axis_radii(conics, radii, 9.0)
    return np.array(xys), np.array(rx), np.array(ry)


def _prep_both(xys, rx, ry, H, W, **cfg_kw):
    jsp = jsc.prepare_stream(jnp.asarray(xys),
                             (jnp.asarray(rx), jnp.asarray(ry)), H, W,
                             JCfg(**cfg_kw))
    tsp = tsc.prepare_stream(torch.from_numpy(xys),
                             (torch.from_numpy(rx), torch.from_numpy(ry)),
                             H, W, TCfg(**cfg_kw))
    return jsp, tsp


def _assert_same_stream(jsp, tsp):
    for name in ("gids", "starts", "counts", "n_dropped"):
        want = np.asarray(getattr(jsp, name))
        got = getattr(tsp, name).numpy()
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tsp.tiles_x, tsp.T, tsp.I) == (jsp.tiles_x, jsp.T, jsp.I)


@pytest.mark.parametrize("N,H,W,seed", [(300, 70, 100, 0), (300, 70, 100, 1),
                                        (150, 32, 32, 2), (2000, 256, 384, 3)])
def test_stream_matches_jax(N, H, W, seed):
    xys, rx, ry = _xys_rxy(N, H, W, seed, spread=1.05)
    jsp, tsp = _prep_both(xys, rx, ry, H, W)
    assert int(tsp.n_dropped) == 0
    _assert_same_stream(jsp, tsp)


@pytest.mark.parametrize("cap,span", [(256, 25), (1024, 1)])
def test_stream_overflow_matches_jax(cap, span):
    """Stream-cap and span-cap overflow: the same instances survive and the
    same number is reported dropped."""
    xys, rx, ry = _xys_rxy(300, 70, 100, seed=7)
    jsp, tsp = _prep_both(xys, rx, ry, 70, 100, max_instances=cap,
                          max_tiles_per_gauss=span)
    assert int(tsp.n_dropped) > 0
    _assert_same_stream(jsp, tsp)


def test_pair_sort_branch_matches_jax():
    """The pair-sort branch gives the packed key's (tile, rank) order: the
    port's forced pair sort equals the JAX package's packed stream, and its
    live prefix equals the JAX pair sort's."""
    N, H, W = 300, 70, 100
    xys, rx, ry = _xys_rxy(N, H, W, seed=11)
    jsp = jsc.prepare_stream(jnp.asarray(xys),
                             (jnp.asarray(rx), jnp.asarray(ry)), H, W, JCfg())
    tsp = tsc.prepare_stream(torch.from_numpy(xys),
                             (torch.from_numpy(rx), torch.from_numpy(ry)),
                             H, W, TCfg(), force_pair=True)
    _assert_same_stream(jsp, tsp)

    tiles_x, tiles_y, tp, M = 4, 3, 32, 12
    T = tiles_x * tiles_y
    jt = jtiles._expand_instances(jnp.asarray(xys),
                                  (jnp.asarray(rx), jnp.asarray(ry)),
                                  tiles_x, tiles_y, tp, M, None)
    tt = ttiles._expand_instances(torch.from_numpy(xys),
                                  (torch.from_numpy(rx), torch.from_numpy(ry)),
                                  tiles_x, tiles_y, tp, M)
    jpair = jtiles._sorted_stream(*jt[:2], N, T, force_pair=True)
    tpair = ttiles._sorted_stream(*tt[:2], N, T, force_pair=True)
    dead = np.asarray(jpair[1])
    np.testing.assert_array_equal(tpair[1].numpy(), dead)
    np.testing.assert_array_equal(tpair[0].numpy()[~dead],
                                  np.asarray(jpair[0])[~dead])
    np.testing.assert_array_equal(tpair[2].numpy(), np.asarray(jpair[2]))
    np.testing.assert_array_equal(tpair[3].numpy(), np.asarray(jpair[3]))


def test_expand_instances_with_band_matches_jax():
    N, H, W = 300, 96, 100
    xys, rx, ry = _xys_rxy(N, H, W, seed=5)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, 2, N).astype(np.int32)
    hi = (lo + rng.integers(0, 2, N)).astype(np.int32)
    tiles_x, tiles_y = -(-W // 32), -(-H // 32)
    jt = jtiles._expand_instances(
        jnp.asarray(xys), (jnp.asarray(rx), jnp.asarray(ry)), tiles_x,
        tiles_y, 32, 12, None, band=(jnp.asarray(lo), jnp.asarray(hi)))
    tt = ttiles._expand_instances(
        torch.from_numpy(xys), (torch.from_numpy(rx), torch.from_numpy(ry)),
        tiles_x, tiles_y, 32, 12, band=(torch.from_numpy(lo),
                                        torch.from_numpy(hi)))
    live = np.asarray(jt[1])
    np.testing.assert_array_equal(tt[1].numpy(), live)
    np.testing.assert_array_equal(tt[0].numpy()[live], np.asarray(jt[0])[live])
    assert int(tt[2]) == int(jt[2])


def test_sorted_window_bounds_matches_jax():
    rng = np.random.default_rng(0)
    for L in (7, 513, 40960 - 3):
        keys = np.sort(rng.integers(0, 2 ** 20, size=L)).astype(np.int32)
        keys[-max(1, L // 10):] = np.int32(2 ** 31 - 1)
        queries = np.unique(np.concatenate(
            [rng.integers(0, 2 ** 20, size=100),
             [0, 2 ** 20, 2 ** 30]])).astype(np.int32)
        got = ttiles.sorted_window_bounds(torch.from_numpy(keys),
                                          torch.from_numpy(queries))
        want = jtiles.sorted_window_bounds(jnp.asarray(keys),
                                           jnp.asarray(queries))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 300, 10000, 20000, 40000, 70000])
def test_stream_caps_match_jax(n):
    for jcfg, tcfg in ((JCfg(), TCfg()),
                       (JCfg.serving(n), TCfg.serving(n)),
                       (JCfg(max_instances=5000), TCfg(max_instances=5000))):
        assert tsc.stream_caps(n, tcfg) == jsc.stream_caps(n, jcfg)
        assert tcfg == TCfg(**jcfg._asdict())
