"""Port parity, the RS slice as a whole on the CPU: the fit CLI with
``--model_name GaussianImage_RS`` (its viz PNGs: render, alpha and overlay,
no Gaussian-shape render, as the JAX trainer writes them for RS; its
checkpoint rendered by the JAX RS model), the QAT CLI from an RS stage-1
checkpoint (its best checkpoint decoded by the JAX package), and the codec
CLI on that state (its bpp breakdown, scaling_bpp and rotation_bpp
included, equal to the JAX model's analysis_wo_ec and analysis), and the
model's device default.

Small scenes (48x64 and 32x64) so that each CLI runs in seconds. Images:
atol 2e-5 with at most MAX_EDGE_PX pixels above 1e-4, the allowance the
Cholesky tests make for XLA's tanh (here also its sigmoid, cos and sin;
tests/test_torch_rs.py)."""

import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.test_quantize import (  # noqa: E402
    CodecEvaluator2d as JCodecEvaluator2d)
from gaussianimage_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint)
from gaussianimage_tpu_torch import test_quantize  # noqa: E402
from gaussianimage_tpu_torch import train as port_train  # noqa: E402
from gaussianimage_tpu_torch import train_quantize  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy, save_checkpoint)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    synthetic_image)

RS = "GaussianImage_RS"
MAX_EDGE_PX = 16
QPARAMS = ("_xyz", "_scaling", "_rotation", "_features_dc",
           "scaling_quant_scale", "scaling_quant_beta",
           "rotation_quant_scale", "rotation_quant_beta")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _assert_image(got, want):
    diff = np.abs(got - want)
    assert int((diff > 1e-4).sum()) <= MAX_EDGE_PX, int((diff > 1e-4).sum())
    np.testing.assert_allclose(got[diff <= 1e-4], want[diff <= 1e-4],
                               rtol=0, atol=2e-5)


def test_rs_model_runs_on_cuda_unless_asked_for_the_cpu():
    """make_model builds RS on cuda by default: without a GPU it raises,
    naming the CPU option; with device="cpu" it builds there."""
    m = make_model(RS, device="cpu", num_points=8, H=16, W=16)
    assert m._xyz.device.type == "cpu" and m.name == RS
    assert tuple(m._rotation.shape) == (8, 1)
    if torch.cuda.is_available():
        assert make_model(RS, num_points=8, H=16, W=16)._xyz.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(RS, num_points=8, H=16, W=16)


def test_rs_fit_cli_viz_and_jax_render(tmp_path, monkeypatch):
    """main() with --model_name GaussianImage_RS on the synthetic dataset,
    cut to its first image at 48x64: the fit improves, the viz dump writes
    the render, alpha and overlay PNGs and no gauss PNG (the RS render has
    no Gaussian-shape visualization; the JAX trainer skips it too), and
    its gaussian_model.npz renders through the JAX RS model to the port's
    image."""
    real = port_train.iterate_dataset
    monkeypatch.setattr(
        port_train, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(48, 64)), 1))
    results = port_train.main([
        "--data_name", "synthetic", "--iterations", "200", "--num_points",
        "256", "--device", "cpu", "--checkpoint_root", str(tmp_path),
        "--chunk_size", "100", "--model_name", RS, "--save_imgs"])
    assert len(results) == 1 and results[0]["n_dropped"] == 0
    d = tmp_path / "synthetic" / f"{RS}_200_256" / "synth01"
    viz = sorted(p.name for p in (d / "viz").iterdir())
    assert viz == [f"iter_000200_{k}.png"
                   for k in ("alpha", "overlay", "render")], viz
    assert (d / "synth01_fitting.png").is_file()
    rec = np.load(d / "training.npy", allow_pickle=True).item()
    assert rec["training_psnr"][-1] > rec["training_psnr"][0] + 3.0

    params = j_load_checkpoint(d / "gaussian_model.npz")["params"]
    assert sorted(params) == ["_features_dc", "_rotation", "_scaling",
                              "_xyz"]
    jm = j_make_model(RS, num_points=256, H=48, W=64)
    want = np.asarray(jm.render({k: jnp.asarray(v)
                                 for k, v in params.items()})["render"])
    model = make_model(RS, device="cpu", num_points=256, H=48, W=64)
    model.load_state_dict(params_from_numpy(
        load_checkpoint(d / "gaussian_model.npz")["params"]))
    with torch.no_grad():
        got = model.render()["render"].numpy()
    _assert_image(got, want)
    psnr = 10 * np.log10(1.0 / np.mean((got - synthetic_image(48, 64, 0))
                                      ** 2))
    assert abs(psnr - rec["psnr"]) < 1e-3


def test_rs_qat_and_codec_clis_match_jax(tmp_path, monkeypatch):
    """The QAT CLI (20 iterations from a JAX RS stage-1 checkpoint, two
    32x64 synthetic images) writes checkpoints in the JAX schema, which the
    JAX package's codec evaluator decodes to the port's evaluation render;
    the codec CLI on those states reports the JAX model's bpp, its
    per-component scaling_bpp and rotation_bpp and their sum cholesky_bpp,
    without and with entropy coding, and the dataset decode line. The
    probes are cut to one decode each, only to keep the test short."""
    H, W, N = 32, 64, 256
    for mod in (train_quantize, test_quantize):
        real = mod.iterate_dataset
        monkeypatch.setattr(
            mod, "iterate_dataset",
            lambda name, d, real=real: real(name, d, image_hw=(H, W)))
    monkeypatch.setattr(test_quantize, "FPS_FRAMES", 1)
    monkeypatch.setattr(test_quantize, "EC_FRAMES", 1)
    monkeypatch.setattr(test_quantize, "timed_bursts",
                        lambda burst, dev: (burst(), 1.0)[1])
    monkeypatch.setattr(test_quantize, "batched_dataset_decode_fps",
                        functools.partial(
                            test_quantize.batched_dataset_decode_fps,
                            reps=1, scan_len=1))
    jm = j_make_model(RS, num_points=N, H=H, W=W)
    for i, name in enumerate(("synth01", "synth02")):
        params = jm.init_params(jax.random.PRNGKey(10 + i))
        save_checkpoint(tmp_path / "stage1" / name / "gaussian_model.npz",
                        {k: np.asarray(v) for k, v in params.items()})
    train_quantize.main([
        "--data_name", "synthetic", "--iterations", "20", "--num_points",
        str(N), "--device", "cpu", "--checkpoint_root", str(tmp_path / "q"),
        "--chunk_size", "10", "--model_name", RS, "--model_path",
        str(tmp_path / "stage1")])
    qroot = tmp_path / "q" / "synthetic" / f"{RS}_20_{N}"
    best = qroot / "synth01" / "gaussian_model.best.npz"
    assert sorted(np.load(best).files) == sorted(
        [f"params/{k}" for k in QPARAMS]
        + [f"extra/vq/{k}" for k in ("embed", "cluster_size", "embed_avg",
                                     "initted")])

    gt = synthetic_image(H, W, seed=0)
    jev = JCodecEvaluator2d(gt, "synth01", num_points=N, model_name=RS,
                            model_path=best, log_dir=tmp_path / "jeval")
    jp, jx = jev.state.params, jev.state.extra
    jenc = jev.model.compress_wo_ec(jp, jx)
    jdec = np.asarray(jev.model.decompress_wo_ec(jp, jx, jenc)["render"])
    model = make_model(RS, device="cpu", num_points=N, H=H, W=W,
                       quantize=True)
    ck = load_checkpoint(best)
    model.load_state_dict(params_from_numpy(ck["params"], "cpu",
                                            ck["extra"]))
    with torch.no_grad():
        evr = model.render_quantize(training=False)["render"].numpy()
    _assert_image(evr, jdec)

    results = test_quantize.main([
        "--data_name", "synthetic", "--num_points", str(N), "--device",
        "cpu", "--model_name", RS, "--model_path", str(qroot),
        "--iterations", "20", "--checkpoint_root", str(tmp_path / "e")])
    r = results[0]
    assert r["image"] == "synth01" and r["ec_roundtrip_err"] < 1e-6
    want = jev.model.analysis_wo_ec(jp, jx, jenc)
    want_ec = jev.model.analysis(jp, jx, jev.model.compress(jp, jx))
    for key in ("bpp", "position_bpp", "scaling_bpp", "rotation_bpp",
                "cholesky_bpp", "feature_dc_bpp"):
        assert r[key] == pytest.approx(want[key], rel=1e-12), key
    assert r["bpp_ec"] == pytest.approx(want_ec["bpp"], rel=1e-12)
    assert r["scaling_bpp"] + r["rotation_bpp"] == pytest.approx(
        r["cholesky_bpp"])
    jpsnr = 10 * np.log10(1.0 / np.mean((jdec - gt) ** 2))
    assert abs(r["psnr"] - jpsnr) < 1e-3
    root_txt = (tmp_path / "e" / "synthetic" / f"{RS}_20_{N}" /
                "test.txt").read_text()
    assert "Dataset decode (2 frames/pass, batched strategy)" in root_txt
