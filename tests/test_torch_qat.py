"""Port parity, quantization-aware training: the residual VQ's k-means and
its training call, the warm start (``init_quantizer_data``), one QAT step's
gradients (against JAX, or against a float64 oracle where the two
packages differ), a 20-step trajectory, and the QAT trainer and CLI, whose
best checkpoint the JAX package's codec evaluator decodes to the port's
image.

The k-means draw differs between ``jax.random.choice`` and a
``torch.Generator``, so the port is handed JAX's starting indices. Small
scenes (32x64, N = 256) from seeds; tolerances are stated at each test."""

import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.codec import ResidualVQ as JVQ  # noqa: E402
from gaussianimage_tpu.codec.vq import _kmeans as j_kmeans  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.test_quantize import (  # noqa: E402
    CodecEvaluator2d as JCodecEvaluator2d)
from gaussianimage_tpu_torch import train_quantize  # noqa: E402
from gaussianimage_tpu_torch.codec import (ResidualVQ,  # noqa: E402
                                           ResidualVQState, UniformQuantizer,
                                           UniformQuantizerState,
                                           fake_quantize_half)
from gaussianimage_tpu_torch.codec.vq import _kmeans  # noqa: E402
from gaussianimage_tpu_torch.core import project_gaussians_2d  # noqa: E402
from gaussianimage_tpu_torch.core.render_ref import (  # noqa: E402
    render_sum_dense)
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.models.quantize_mixin import (  # noqa: E402
    KMEANS_SEED)
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy, save_checkpoint)
from gaussianimage_tpu_torch.utils.image_io import (  # noqa: E402
    synthetic_image)

H, W, N = 32, 64, 256
S = 8  # codebook size
VQ_TOL = dict(rtol=1e-6, atol=1e-7)
PARAMS = ("_xyz", "_cholesky", "_features_dc", "cholesky_quant_scale",
          "cholesky_quant_beta")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _colors(seed=0, n=N):
    return np.random.default_rng(seed).normal(0.4, 0.3, (n, 3)).astype(
        np.float32)


def _jax_draws(key, n):
    """The starting centers JAX's _kmeans_init draws for each layer."""
    return [torch.from_numpy(np.array(jax.random.choice(
        jax.random.fold_in(key, qi), n, (S,), replace=False)))
        for qi in range(2)]


def _assert_state(st, jst, tol=VQ_TOL):
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), **tol,
                                   err_msg=name)
    assert bool(st.initted) and bool(jst.initted)


# ------------------------------------------------------------- the VQ


def test_kmeans_matches_jax_on_injected_centers():
    """_kmeans from JAX's drawn centers: centers to 1e-6 relative, the last
    assignment's counts exact; the sequential residual init of both
    layers likewise."""
    x = _colors()
    key = jax.random.PRNGKey(3)
    jc, jn = j_kmeans(key, jnp.asarray(x), S, 5)
    idx = torch.from_numpy(np.array(jax.random.choice(key, x.shape[0], (S,),
                                                      replace=False)))
    c, n = _kmeans(torch.from_numpy(x), S, 5, idx)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **VQ_TOL)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    jst = JVQ()._kmeans_init(key, jnp.asarray(x))
    st = ResidualVQ()._kmeans_init(torch.from_numpy(x),
                                   init_idx=_jax_draws(key, x.shape[0]))
    _assert_state(st, jst)


def test_vq_training_call_matches_jax():
    """One training call from a k-means state: out and indices, the
    commitment loss and the EMA state (counts, sums, Laplace-smoothed
    codebooks) to 1e-6 relative; the gradient of the output plus the
    commitment loss with respect to the input likewise."""
    x = _colors(1)
    key = jax.random.PRNGKey(5)
    jst = JVQ()._kmeans_init(key, jnp.asarray(x))
    st = ResidualVQ()._kmeans_init(torch.from_numpy(x),
                                   init_idx=_jax_draws(key, x.shape[0]))
    xn = _colors(2)

    def j_fn(v):
        out, idx, commit, new = JVQ()(jst, v, training=True)
        return out.sum() * 0.1 + commit, (out, idx, commit, new)

    (_, (jout, jidx, jcommit, jnew)), jg = jax.value_and_grad(
        j_fn, has_aux=True)(jnp.asarray(xn))
    xt = torch.tensor(xn, requires_grad=True)
    out, idx, commit, new = ResidualVQ()(st, xt, training=True)
    (out.sum() * 0.1 + commit).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **VQ_TOL)
    np.testing.assert_allclose(float(commit.detach()), float(jcommit),
                               rtol=1e-6)
    _assert_state(new, jnew)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **VQ_TOL)


# ------------------------------------------------ the model's QAT


def _jax_start(seed=0):
    """A JAX quantize model after init_state + init_quantizer_data, and the
    port's model in the same state."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W,
                      quantize=True)
    st = jm.init_quantizer_data(jm.init_state(jax.random.PRNGKey(seed)))
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W, quantize=True)
    opt = model.init_state(torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_numpy(
        {k: np.asarray(v) for k, v in st.params.items()}, "cpu",
        {f"vq/{k}": np.asarray(v)
         for k, v in st.extra["vq"]._asdict().items()}))
    return jm, st, model, opt


def test_init_quantizer_data_matches_jax():
    """The warm start from the same parameters: the quantizer ranges
    exact, the k-means codebooks (on JAX's draws) to 1e-6 relative."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W,
                      quantize=True)
    st0 = jm.init_state(jax.random.PRNGKey(4))
    jst = jm.init_quantizer_data(st0)
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W, quantize=True)
    model.load_state_dict(params_from_numpy(
        {k: np.asarray(v) for k, v in st0.params.items()}, "cpu",
        {f"vq/{k}": np.asarray(v)
         for k, v in st0.extra["vq"]._asdict().items()}))
    assert not bool(model.vq.initted)
    model.init_quantizer_data(
        init_idx=_jax_draws(jax.random.PRNGKey(0), N))
    for k in ("cholesky_quant_scale", "cholesky_quant_beta"):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(),
                                      np.asarray(jst.params[k]), err_msg=k)
    _assert_state(model.vq_state(), jst.extra["vq"])
    # without injected draws the port seeds its own generator
    model.init_quantizer_data()
    assert bool(model.vq.initted)


def test_training_forward_initialises_an_uninitialised_vq():
    """A QAT forward on a VQ state that is not initialised installs the
    k-means codebooks of the colors first (the JAX VQ call initialises the
    state it returns); so does the first forward after such a state is
    loaded into a model that has already trained."""
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W, quantize=True)
    model.init_state(torch.Generator().manual_seed(0))
    empty = {k: v.clone() for k, v in model.state_dict().items()}
    gt = torch.from_numpy(synthetic_image(H, W, seed=0))
    for _ in range(2):
        assert not bool(model.vq.initted)
        want = model.features_vq._kmeans_init(
            model.get_features(),
            torch.Generator().manual_seed(KMEANS_SEED))
        _, aux = model.loss(gt)
        _assert_state(model.vq_state(), want)
        assert bool(aux["pkg"]["vq_state"].initted)
        model.update_extra(aux)
        model.load_state_dict(empty)


def _oracle_grads(model, gt):
    """The QAT loss with the port's float32 quantizers and VQ and a float64
    projection and dense render (core/render_ref.py, q_cut 9): the
    gradients of the parameters, free of any kernel's summation."""
    leaves = {k: getattr(model, k).detach().clone().requires_grad_()
              for k in PARAMS}
    means = torch.tanh(fake_quantize_half(leaves["_xyz"])).double()
    chol = UniformQuantizer(6, num_channels=3)(UniformQuantizerState(
        leaves["cholesky_quant_scale"], leaves["cholesky_quant_beta"]),
        leaves["_cholesky"])
    cols, _, commit, _ = ResidualVQ()(model.vq_state(),
                                      leaves["_features_dc"])
    xys, _, _, conics, _ = project_gaussians_2d(
        means, (chol + model.cholesky_bound).double(), H, W,
        model.cfg.tile_bounds)
    img = render_sum_dense(xys, conics, cols.double(),
                           torch.ones(N, 1, dtype=torch.float64), H, W,
                           q_cut=9.0)[..., :3].permute(2, 0, 1)[None]
    img = torch.minimum(torch.maximum(img, img.new_zeros(())),
                        img.new_ones(()))
    loss = ((img - torch.from_numpy(gt).double()) ** 2).mean() + commit
    loss.backward()
    return {k: v.grad.numpy().astype(np.float64) for k, v in leaves.items()}


def test_qat_step_gradients_match_jax_or_oracle():
    """One QAT loss from the same parameters and VQ state: the loss to
    rtol 1e-6; every parameter's gradient at rtol 1e-4 / atol 1e-8 of
    JAX's entry (test_torch_grad.py's tolerance) or, where that fails,
    nearer the float64 oracle than JAX's entry and within the same
    tolerance of it. The quantizers' scale and beta gradients are sums of
    N terms that cancel, so where they fail the oracle's rtol their
    float32 sum is held to 1e-4 of the parameter's largest gradient."""
    jm, st, model, _ = _jax_start()
    gt = synthetic_image(H, W, seed=0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(gt), extra=st.extra),
        has_aux=True)(st.params)
    loss, aux = model.loss(torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert "vq_state" in aux["pkg"]
    oracle = _oracle_grads(model, gt)
    for k in PARAMS:
        a = getattr(model, k).grad.numpy().astype(np.float64)
        b, o = np.asarray(jg[k], np.float64), oracle[k]
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-8)
        assert np.all(np.abs(a - o)[off] <= np.abs(b - o)[off]), k
        atol = 1e-4 * np.abs(o).max() if "quant" in k else 1e-8
        np.testing.assert_allclose(a[off], o[off], rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_qat_trajectory_matches_jax():
    """20 QAT steps of each package from the same state (JAX scans them in
    one chunk): the losses within 1e-3 relative of JAX's, the VQ state
    installed after every step (initted, codebooks moved), K3 never used
    (quantize opts out of the fused L2)."""
    jm, st, model, opt = _jax_start(1)
    gt = synthetic_image(H, W, seed=1)
    js, jmet = jax.jit(lambda s: jm.train_chunk(
        s, jnp.asarray(gt), None, jnp.asarray(1), 20))(st)
    embed0 = model.vq.embed.clone()
    gtt = torch.from_numpy(gt)
    losses = [float(model.train_step(opt, gtt)["loss"]) for _ in range(20)]
    np.testing.assert_allclose(losses, np.asarray(jmet["loss"]), rtol=1e-3)
    assert losses[-1] < losses[0]
    assert bool(model.vq.initted) and not torch.equal(model.vq.embed, embed0)
    np.testing.assert_allclose(model.vq.embed.numpy(),
                               np.asarray(js.extra["vq"].embed), rtol=0,
                               atol=1e-3)


def _stage1(root, name, seed):
    """A stage-1 checkpoint of random parameters in the JAX schema."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W)
    params = jm.init_params(jax.random.PRNGKey(seed))
    save_checkpoint(root / name / "gaussian_model.npz",
                    {k: np.asarray(v) for k, v in params.items()})


def test_qat_cli_artifacts_and_jax_codec_decode(tmp_path, monkeypatch):
    """main() on the synthetic dataset cut to its first image at 32x64, 20
    iterations from a stage-1 checkpoint: train.txt's lines, the two
    checkpoints in the JAX schema, training.npy with the JAX keys; the
    JAX package's CodecEvaluator2d loads the best checkpoint and decodes
    it to the port's evaluation render of the same state (atol 2e-5:
    XLA's one-ulp tanh of the means)."""
    real = train_quantize.iterate_dataset
    monkeypatch.setattr(
        train_quantize, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(H, W)), 1))
    _stage1(tmp_path / "stage1", "synth01", 2)
    results = train_quantize.main([
        "--data_name", "synthetic", "--iterations", "20", "--num_points",
        str(N), "--device", "cpu", "--checkpoint_root", str(tmp_path / "q"),
        "--chunk_size", "10", "--model_path", str(tmp_path / "stage1")])
    d = tmp_path / "q" / "synthetic" / f"GaussianImage_Cholesky_20_{N}"
    r = results[0]
    assert r["best_training_psnr"] >= max(
        np.load(d / "synth01" / "training.npy",
                allow_pickle=True).item()["training_psnr"]) - 1e-6
    txt = (d / "synth01" / "train.txt").read_text()
    for line in ("loading model path:", "Test PSNR:", "Best Test PSNR:",
                 "Training Complete in"):
        assert line in txt
    assert "Average: PSNR:" in (d / "train.txt").read_text()
    rec = np.load(d / "synth01" / "training.npy", allow_pickle=True).item()
    assert set(rec) == {"iterations", "training_psnr", "training_time",
                        "psnr", "ms-ssim", "rendering_time",
                        "rendering_fps", "bpp", "best_psnr", "best_ms-ssim",
                        "best_bpp"}
    assert rec["iterations"] == list(range(1, 21))
    for name in ("gaussian_model.npz", "gaussian_model.best.npz"):
        ck = np.load(d / "synth01" / name)
        assert sorted(ck.files) == sorted(
            [f"params/{k}" for k in PARAMS]
            + [f"extra/vq/{k}" for k in ("embed", "cluster_size",
                                         "embed_avg", "initted")])
    best = d / "synth01" / "gaussian_model.best.npz"
    jev = JCodecEvaluator2d(synthetic_image(H, W, seed=0), "synth01",
                            num_points=N, model_path=best,
                            log_dir=tmp_path / "jeval")
    jenc = jev.model.compress_wo_ec(jev.state.params, jev.state.extra)
    want = np.asarray(jev.model.decompress_wo_ec(
        jev.state.params, jev.state.extra, jenc)["render"])
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W, quantize=True)
    ck = load_checkpoint(best)
    model.load_state_dict(params_from_numpy(ck["params"], "cpu",
                                            ck["extra"]))
    with torch.no_grad():
        got = model.render_quantize(training=False)["render"].numpy()
        dec = model.decompress_wo_ec(model.compress_wo_ec())["render"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(dec.numpy(), got, rtol=0, atol=1e-6)
    assert r["best_bpp"] == pytest.approx(
        sum(model.measure_unit_bits()) / H / W)
