"""Port parity, the 3DGS baseline: spherical harmonics, the quaternion
rotation and the EWA projection, the 3-NN scale init, and the whole model
(render, Fusion2 loss and gradients, 20 Adan steps) against the JAX
package, whose blend kernels run in Pallas interpret mode; the fit and
evaluation CLI with ``--model_name 3DGS`` and its checkpoint read back by
the JAX package; ``render_fast`` without ``fused_prep`` (with it: K10,
tests/test_torch_splat_prep3d.py); the caps probe's two fits. The model's
scene is the JAX suite's (tests/test_gs3d.py:266): 64x96, N = 384, from
JAX's own ``init_state`` carried across as numpy.

Tolerances:
- SH (degrees 0-4), rotations, projections (every output) and the 3-NN
  distances: rtol 1e-6 / atol 1e-6, the same float32 operations in the
  same order (some 3-term sums may associate differently); radii and
  num_tiles_hit exact;
- render: atol 1e-4, the blend's (tests/test_torch_blend.py: JAX's bf16
  prefix sums leave up to 4e-5 in logT);
- the Fusion2 loss: rtol 1e-4. On the same image the two packages' SSIM
  differ by 3.9e-5 (measured): the scene's render is near-white, so
  E[x^2] - E[x]^2 cancels in each float32 convolution, whose sums XLA and
  torch take in other orders (the loss, measured 2.1e-5 relative off);
  each parameter's gradient: 5e-4 of its largest magnitude, the blend's
  (measured up to 7.8e-5, through the SSIM and the projection);
- 20 Adan steps: the losses to rtol 1e-4; the parameters to atol 1e-4, a
  tenth of one Adan step at lr 1e-3 (tests/test_torch_train.py's), on at
  least 99% of the entries and to atol 1e-3, one step, on all: Adan's
  normalised update turns the rounding of a near-zero gradient (an
  occluded Gaussian's, through the SSIM's cancellation) into a move of up
  to lr (measured: 0.26% of the _xyz entries past 1e-4, up to 2.0e-4).
"""

import itertools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.core import camera3d as jcam  # noqa: E402
from gaussianimage_tpu.core import sh as jsh  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.models import gs3d as jgs  # noqa: E402
from gaussianimage_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint)
from gaussianimage_tpu_torch import blend_caps_probe  # noqa: E402
from gaussianimage_tpu_torch import train as port_train  # noqa: E402
from gaussianimage_tpu_torch.core import camera3d as tcam  # noqa: E402
from gaussianimage_tpu_torch.core import sh as tsh  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.models import gs3d as tgs  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    save_image_array, synthetic_image)

TOL = dict(rtol=1e-6, atol=1e-6)
IMG_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-4
STEP_LOSS_RTOL = 1e-4
STEP_ATOL = 1e-4
STEP_MAX_ATOL = 1e-3
N, H, W = 384, 64, 96
PARAMS = ("_xyz", "_scaling", "_opacity", "_rotation", "_features_dc",
          "_features_rest")
VIEWMAT = np.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 8.0],
                      [0, 0, 0, 1.0]], np.float32)


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


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics_match_jax(degree):
    rng = np.random.default_rng(degree)
    K = tsh.num_sh_bases(degree)
    assert K == jsh.num_sh_bases(degree)
    dirs = rng.standard_normal((257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coeffs = rng.standard_normal((257, K, 3)).astype(np.float32)
    want = np.asarray(jsh.spherical_harmonics(degree, jnp.asarray(dirs),
                                              jnp.asarray(coeffs)))
    got = tsh.spherical_harmonics(degree, _t(dirs), _t(coeffs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _rotated_viewmat(seed):
    """A camera rotated by a random quaternion, at distance 8."""
    q = np.random.default_rng(seed).standard_normal((1, 4)).astype(np.float32)
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = np.asarray(jcam.quat_to_rotmat(jnp.asarray(q)))[0]
    V[:3, 3] = [0.3, -0.2, 8.0]
    return V


@pytest.mark.parametrize("view", ["model", "rotated"])
def test_rotation_and_projection_match_jax(view):
    """quat_to_rotmat and project_gaussians on 768x512 with the model's
    focal (W/2), 10% of the centers behind the model camera's near plane
    (culled there: radius and tiles 0): every output to TOL, radii and
    num_tiles_hit exact. Under a rotated camera XLA's CPU dot associates
    the 3-term sums of the view transform differently on ~0.7% of the
    positions (the model's camera has no such sums: its rotation is the
    identity), and the conic's determinant cancels on elongated Gaussians:
    there at most 1% of the conic entries may pass TOL, all within rtol
    1e-5 (measured: 4 of 3000, up to 4.4e-6)."""
    rng = np.random.default_rng(7)
    n, h, w = 1000, 512, 768
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:100, 2] = rng.uniform(-12, -8.5, 100)  # behind the camera
    scales = np.exp(rng.normal(-3.0, 0.7, (n, 3))).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    V = VIEWMAT if view == "model" else _rotated_viewmat(3)
    np.testing.assert_allclose(
        tcam.quat_to_rotmat(_t(quats)).numpy(),
        np.asarray(jcam.quat_to_rotmat(jnp.asarray(quats))), **TOL)
    f = w / 2.0
    tb = (-(-w // 16), -(-h // 16), 1)
    want = jcam.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(V), jnp.asarray(V), f, f, w / 2, h / 2, h, w, tb)
    got = tcam.project_gaussians(_t(means), _t(scales), 1.0, _t(quats),
                                 _t(V), _t(V), f, f, w / 2, h / 2, h, w, tb)
    names = ("xys", "depths", "radii", "conics", "num_tiles_hit", "cov3d")
    for g, j, name in zip(got, want, names):
        j = np.asarray(j)
        if name in ("radii", "num_tiles_hit"):
            np.testing.assert_array_equal(g.numpy(), j, err_msg=name)
        elif name == "conics" and view == "rotated":
            off = ~np.isclose(g.numpy(), j, **TOL)
            assert off.mean() <= 0.01, off.mean()
            np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), j, err_msg=name, **TOL)
    if view == "model":  # the first 100 centers sit behind its camera
        assert (got[2].numpy()[:100] == 0).all()
        assert (got[2].numpy()[100:] > 0).all()


def test_knn_mean_dist_and_init_shapes():
    """knn_mean_dist on JAX's init points (not a multiple of the chunk)
    equals JAX's; the port's init has the JAX init's structure."""
    xyz = np.asarray(2.0 * (jax.random.uniform(jax.random.PRNGKey(2),
                                               (600, 3)) - 0.5))
    want = np.asarray(jgs.knn_mean_dist(jnp.asarray(xyz), k=3))
    np.testing.assert_allclose(tgs.knn_mean_dist(_t(xyz), k=3).numpy(), want,
                               **TOL)
    model = make_model("3DGS", device="cpu", num_points=600, H=H, W=W)
    model.init_params(torch.Generator().manual_seed(0))
    x = model._xyz.detach()
    assert float(x.abs().max()) <= 1.0
    np.testing.assert_allclose(
        model._scaling.detach().numpy(),
        np.log(tgs.knn_mean_dist(x).numpy())[:, None].repeat(3, 1), **TOL)
    np.testing.assert_allclose(torch.sigmoid(model._opacity).detach()
                               .numpy(), 0.1, rtol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(model._rotation, dim=1)
                               .detach().numpy(), 1.0, rtol=1e-6)
    assert model._features_rest.shape == (600, 15, 3)
    assert not model._features_rest.detach().any()


def _pair(sh_degree, key=5):
    """The JAX model at JAX's init_state(PRNGKey(key)) and the port's model
    with those parameters, the log scales of both made anisotropic by the
    same normal(0, 0.4) draw: at the isotropic init the covariance does not
    depend on the rotation, so its gradient is rounding noise (~4e-7), and
    Adan's normalised first step would turn that noise into +-lr moves."""
    jm = j_make_model("3DGS", num_points=N, H=H, W=W, loss_type="Fusion2",
                      sh_degree=sh_degree)
    state = jm.init_state(jax.random.PRNGKey(key))
    params = {k: np.asarray(v) for k, v in state.params.items()}
    params["_scaling"] = params["_scaling"] + np.random.default_rng(
        key).normal(0.0, 0.4, (N, 3)).astype(np.float32)
    state = state._replace(params={k: jnp.asarray(v)
                                   for k, v in params.items()})
    model = make_model("3DGS", device="cpu", num_points=N, H=H, W=W,
                       loss_type="Fusion2", sh_degree=sh_degree)
    model.load_state_dict(params_from_numpy(params))
    return jm, state, model


@pytest.mark.parametrize("sh_degree", [3, 0])
def test_model_render_loss_and_steps_match_jax(sh_degree):
    """From JAX's init: the render, the Fusion2 loss and every parameter's
    gradient, then 20 Adan steps of train_step against JAX's train_chunk."""
    gt = synthetic_image(H, W, seed=11)
    jm, state, model = _pair(sh_degree)
    want = np.asarray(jax.jit(lambda p: jm.render(p)["render"])(state.params))
    with torch.no_grad():
        pkg = model.render()
    np.testing.assert_allclose(pkg["render"].numpy(), want, rtol=0,
                               atol=IMG_TOL)
    assert int(pkg["raster_aux"]["n_dropped"]) == 0

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(gt)), has_aux=True))(state.params)
    loss, _ = model.loss(_t(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    for k in PARAMS:
        jg = np.asarray(j_grads[k])
        if jg.size == 0:
            continue
        scale = max(float(np.abs(jg).max()), 1e-30)
        err = float(np.abs(getattr(model, k).grad.numpy() - jg).max()) / scale
        assert err <= GRAD_TOL, (k, err)

    chunk = jax.jit(lambda s: jm.train_chunk(s, jnp.asarray(gt), None,
                                             jnp.asarray(1), 20))
    j_state, j_metrics = chunk(state)
    _, _, model = _pair(sh_degree)
    opt = model.make_optimizer()
    losses = [float(model.train_step(opt, _t(gt))["loss"])
              for _ in range(20)]
    np.testing.assert_allclose(losses, np.asarray(j_metrics["loss"]),
                               rtol=STEP_LOSS_RTOL)
    assert losses[-1] < losses[0]
    for k in PARAMS:
        got = getattr(model, k).detach().numpy()
        want = np.asarray(j_state.params[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_MAX_ATOL,
                                   err_msg=k)
        if got.size:
            assert (np.abs(got - want) > STEP_ATOL).mean() <= 0.01, k


def test_render_fast_refuses_fused_prep_until_k10():
    """Without fused_prep render_fast is render()'s image. With it,
    render_fast no longer refuses: K10 is ported, and its path is held to
    JAX and to render() in tests/test_torch_splat_prep3d.py."""
    _, _, model = _pair(3)
    with torch.no_grad():
        np.testing.assert_array_equal(model.render_fast().numpy(),
                                      model.render()["render"].numpy())
    fused = make_model("3DGS", device="cpu", num_points=N, H=H, W=W,
                       raster=RasterizeConfig(fused_prep=True))
    fused.load_state_dict(model.state_dict())
    assert fused.render_fast().shape == (1, 3, H, W)


def test_cli_3dgs_fit_and_evaluation(tmp_path, monkeypatch):
    """main(--model_name 3DGS) on one synthetic image at 32x48: Fusion2
    training, train.txt, training.npy with the JAX keys, the viz PNGs the
    model gives (render, alpha, center overlay) and gaussian_model.npz,
    which the JAX package loads and renders to the port's image; then the
    evaluation (--iterations 0) of that checkpoint reads the fit's PSNR."""
    real = port_train.iterate_dataset
    monkeypatch.setattr(
        port_train, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(32, 48)), 1))
    common = ["--data_name", "synthetic", "--model_name", "3DGS",
              "--sh_degree", "1", "--num_points", "64", "--device", "cpu",
              "--chunk_size", "20"]
    fit = port_train.main(common + [
        "--iterations", "60", "--checkpoint_root", str(tmp_path / "fit"),
        "--viz_every", "60", "--save_imgs"])
    d = tmp_path / "fit" / "synthetic" / "3DGS_60_64" / "synth01"
    assert "Test PSNR:" in (d / "train.txt").read_text()
    rec = np.load(d / "training.npy", allow_pickle=True).item()
    assert set(rec) == {"iterations", "training_psnr", "training_time",
                        "psnr", "ms-ssim", "rendering_time", "rendering_fps",
                        "initial_points", "final_points"}
    assert len(rec["training_psnr"]) == 60
    assert rec["training_psnr"][-1] > rec["training_psnr"][0]
    for kind in ("render", "alpha", "overlay"):
        assert (d / "viz" / f"iter_000060_{kind}.png").is_file()
    assert (d / "synth01_fitting.png").is_file()

    params = j_load_checkpoint(d / "gaussian_model.npz")["params"]
    assert set(params) == set(PARAMS)
    jm = j_make_model("3DGS", num_points=64, H=32, W=48, sh_degree=1)
    want = np.asarray(jax.jit(lambda p: jm.render(p)["render"])(
        {k: jnp.asarray(v) for k, v in params.items()}))
    model = make_model("3DGS", device="cpu", num_points=64, H=32, W=48,
                       sh_degree=1)
    model.load_state_dict(params_from_numpy(
        load_checkpoint(d / "gaussian_model.npz")["params"]))
    with torch.no_grad():
        got = model.render()["render"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_TOL)

    ev = port_train.main(common + [
        "--iterations", "0", "--model_path", str(d),
        "--checkpoint_root", str(tmp_path / "eval")])
    assert abs(ev[0]["psnr"] - fit[0]["psnr"]) <= 1e-4
    assert math.isfinite(ev[0]["fps"])


def test_blend_caps_probe_fits_both_variants(tmp_path):
    """blend_caps_probe on a 32x48 photo at N = 64: the default fit keeps
    the model's caps, the lifted one takes the flat stream's 65,536 slots
    and the asked span, the uncapped one N x span slots and the span; where
    none drops an instance the three fits are the same fit, step for
    step."""
    img = tmp_path / "synth.png"
    save_image_array(synthetic_image(32, 48, seed=3), img)
    out = tmp_path / "caps.jsonl"
    default, lifted, uncapped = blend_caps_probe.main(
        ["--image", str(img), "--num_points", "64", "--iterations", "6",
         "--span", "4", "--device", "cpu", "--out", str(out)])
    assert default["blend_cfg"] == {"tile_px": 32, "max_instances": None,
                                    "max_tiles_per_gauss": 36}
    assert lifted["blend_cfg"]["max_instances"] == 65536
    assert (lifted["stream_slots"], lifted["tile_span"]) == (256, 4)
    assert uncapped["blend_cfg"]["max_instances"] == 64 * 4
    assert (uncapped["stream_slots"], uncapped["tile_span"]) == (256, 4)
    for rec in (lifted, uncapped):
        assert default["chunk_n_dropped"] == rec["chunk_n_dropped"] == [0]
        assert default["chunk_training_psnr"] == rec["chunk_training_psnr"]
        assert default["test_psnr"] == rec["test_psnr"]
    assert math.isfinite(default["test_psnr"])
    assert len(out.read_text().splitlines()) == 3
