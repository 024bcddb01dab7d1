"""Port parity for the slice as a whole: the fitted flower@10k checkpoint
(results/photos/GaussianImage_Cholesky_50000_10000/flower) rendered at
768x512 through the port's model on the CPU against the JAX package's
model.render of the same parameters, and scored against the photo; plus the
evaluation entry point (SimpleTrainer2d, --iterations 0) end to end on a
small scene."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu_torch.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum  # noqa: E402
from gaussianimage_tpu_torch.train import SimpleTrainer2d  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy, save_checkpoint)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    image_path_to_array, synthetic_image)

ROOT = Path(__file__).resolve().parent.parent
CKPT = (ROOT / "results/photos/GaussianImage_Cholesky_50000_10000/flower/"
        "gaussian_model.npz")
PHOTO = ROOT / "data/flower_768x512.png"


def _psnr(img, gt):
    return 10 * np.log10(1.0 / np.mean((img.astype(np.float64) - gt) ** 2))


def test_flower_checkpoint_matches_jax_render():
    params = load_checkpoint(CKPT)["params"]
    H, W, N = 512, 768, params["_xyz"].shape[0]
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W)
    model.load_state_dict(params_from_numpy(params))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jmodel = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W)
    want = np.asarray(jmodel.render(jparams)["render"])

    # 1. the same means on both sides: XLA's CPU tanh is off by one ulp on
    # most inputs where torch's is correctly rounded, so hand the port
    # JAX's tanh(_xyz) and hold everything after it to atol 2e-5, with at
    # most 16 pixels above 1e-4 where an instance may cross a binning
    # boundary (ops/splat_prep.py:28-33 in the JAX package)
    jmeans = np.array(jmodel.get_xyz(jparams))
    means = torch.from_numpy(jmeans)
    with torch.no_grad():
        xys, _, radii, conics, _ = project_gaussians_2d(
            means, model.get_cholesky_elements(), H, W, model.cfg.tile_bounds)
        img, _, aux = rasterize_gaussians_sum(
            xys, conics, model.get_features(), torch.ones(N, 1), H, W,
            radii=radii, config=model.cfg.raster)
    same = img.clamp(0, 1).permute(2, 0, 1)[None].numpy()
    diff = np.abs(same - want)
    assert int(aux["n_dropped"]) == 0
    assert int((diff > 1e-4).sum()) <= 16, int((diff > 1e-4).sum())
    np.testing.assert_allclose(same[diff <= 1e-4], want[diff <= 1e-4],
                               rtol=0, atol=2e-5)

    # 2. the port's own model.render, tanh included: its means are within
    # two ulps of JAX's, and those shifts leave at most 16 pixels above
    # 1e-4, and the PSNR
    with torch.no_grad():
        np.testing.assert_allclose(model.get_xyz().numpy(), jmeans, rtol=0,
                                   atol=2.4e-7)
        out = model.render()
    got = out["render"].numpy()
    assert got.shape == (1, 3, H, W) and np.isfinite(got).all()
    assert int(out["raster_aux"]["n_dropped"]) == 0
    assert int((np.abs(got - want) > 1e-4).sum()) <= 16

    gt = image_path_to_array(PHOTO)
    p_port, p_jax = _psnr(got, gt), _psnr(want, gt)
    assert abs(p_port - p_jax) <= 0.005, (p_port, p_jax)
    assert abs(p_port - 41.906) <= 0.01, p_port


def test_evaluation_entry_point_on_cpu(tmp_path):
    """SimpleTrainer2d with --iterations 0 on a small seeded checkpoint:
    train.txt lines in the JAX package's format, the fitting PNG, and the
    checkpoint written back unchanged."""
    H, W, N = 48, 64, 60
    rng = np.random.default_rng(0)
    params = {"_xyz": rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32),
              "_cholesky": rng.uniform(0.5, 3.0, (N, 3)).astype(np.float32),
              "_features_dc": rng.uniform(0, 0.4, (N, 3)).astype(np.float32)}
    save_checkpoint(tmp_path / "ckpt" / "gaussian_model.npz", params)
    gt = synthetic_image(H, W, seed=1)

    class Args:
        save_imgs = True

    tr = SimpleTrainer2d(gt, "synth01", num_points=N, iterations=0,
                         model_path=tmp_path / "ckpt", args=Args(),
                         log_dir=tmp_path / "log", device="cpu")
    r = tr.train()
    assert r["n_dropped"] == 0 and np.isfinite(r["psnr"])
    lines = (tmp_path / "log" / "train.txt").read_text().splitlines()
    assert re.fullmatch(r"Test PSNR:\d+\.\d{4}, MS_SSIM:-?\d\.\d{6}, "
                        rf"Final_points:{N}", lines[-2]), lines[-2]
    assert re.fullmatch(r"Training Complete in \d+\.\d{4}s, "
                        r"Eval time:\d+\.\d{8}s, FPS:\d+\.\d{4}",
                        lines[-1]), lines[-1]
    assert (tmp_path / "log" / "synth01_fitting.png").is_file()
    back = load_checkpoint(tmp_path / "log" / "gaussian_model.npz")["params"]
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="num_points"):
        SimpleTrainer2d(gt, "synth01", num_points=N + 1, iterations=0,
                        model_path=tmp_path / "ckpt", log_dir=tmp_path / "x",
                        device="cpu")


def test_fps_probe_times_two_bursts(monkeypatch):
    """The FPS probe renders one warm-up burst and times two, 300 renders
    in all, and divides the time of the two by 200, as the JAX package's
    probe does (gaussianimage_tpu/train.py:353-357)."""
    import types

    from gaussianimage_tpu_torch import train

    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=16,
                       H=16, W=16)
    model.init_params(torch.Generator().manual_seed(0))
    calls = []
    render = model.render

    def counting(*args, **kw):
        calls.append(1)
        return render(*args, **kw)

    monkeypatch.setattr(model, "render", counting)
    clock = iter([10.0, 12.0])  # the timed bursts' start and end
    monkeypatch.setattr(train.time, "perf_counter", lambda: next(clock))
    probe = train.SimpleTrainer2d.fps_probe(
        types.SimpleNamespace(model=model, device=torch.device("cpu")))
    assert len(calls) == 3 * train.FPS_FRAMES == 300
    assert probe == 2.0 / 200
