"""Port parity, training: Adan and StepLR against the JAX package's optax
Adan step by step; 20 training steps against the JAX package's train_step
from the same start; a 1000-step golden fit; adaptive init and reseeding by
structure and distribution (torch and JAX draw different random numbers);
kill-and-resume; and the CLI end to end, its checkpoint loaded and rendered
by the JAX package. Everything runs on the CPU, the port through its plain
kernel versions, JAX with Pallas in interpret mode."""

import itertools
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from gaussianimage_tpu.core import init as j_init  # noqa: E402
from gaussianimage_tpu.core.reseed import (  # noqa: E402
    default_schedule as j_default_schedule)
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.opt import adan as j_adan  # noqa: E402
from gaussianimage_tpu.opt import step_lr as j_step_lr  # noqa: E402
from gaussianimage_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint)
from gaussianimage_tpu_torch import train as port_train  # noqa: E402
from gaussianimage_tpu_torch.core import init as p_init  # noqa: E402
from gaussianimage_tpu_torch.core.reseed import (  # noqa: E402
    default_schedule, reseed_state)
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.ops import RasterizeConfig  # noqa: E402
from gaussianimage_tpu_torch.opt import Adan, step_lr  # noqa: E402
from gaussianimage_tpu_torch.train import SimpleTrainer2d  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import synthetic_image  # noqa: E402

H, W, N = 64, 96, 768  # the JAX golden fit's scene (tests/test_golden_fit.py)
NAMES = ("_xyz", "_cholesky", "_features_dc")


@pytest.fixture(autouse=True)
def _two_threads():
    """The plain kernel versions run many small tensor ops. Under the
    suite's parallel workers, torch's default of one thread per core
    oversubscribes the CPU several times over and each op waits on its
    threads, so the tests here run on two."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Adan + StepLR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"weight_decay": 0.02}, {"weight_decay": 0.02, "no_prox": True},
    {"max_grad_norm": 0.5}, {"schedule": True}])
def test_adan_matches_jax_step_by_step(kw):
    """Two parameters, 20 steps of random gradients; the tolerance is
    tests/test_adan.py's (rtol 1e-5 / atol 1e-6)."""
    kw = dict(kw)
    lr = (step_lr(1e-2, 5, 0.5), j_step_lr(1e-2, 5, 0.5)) if kw.pop(
        "schedule", False) else (1e-2, 1e-2)
    rng = np.random.default_rng(len(kw))
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((8,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(20)]

    j_opt = j_adan(lr[1], **kw)
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = j_opt.init(j_params)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = Adan(list(params.values()), lr=lr[0], **kw)
    for g in grads:
        updates, j_state = j_opt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(j_params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert opt.param_groups[0]["count"] == 20


def test_step_lr_matches_jax():
    for t in (0, 1, 19999, 20000, 39999, 40000, 50000):
        assert step_lr(1e-3)(t) == pytest.approx(float(j_step_lr(1e-3)(t)),
                                                 rel=1e-7)


# ---------------------------------------------------------------------------
# training steps from the JAX package's start
# ---------------------------------------------------------------------------


def _jax_start():
    """The JAX golden fit's start: init_state(PRNGKey(1)), uniform init."""
    jm = j_make_model("GaussianImage_Cholesky", num_points=N, H=H, W=W)
    state = jm.init_state(jax.random.PRNGKey(1))
    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W)
    model.load_state_dict(params_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()}))
    return jm, state, model


def test_train_steps_match_jax():
    """20 steps of each package's train_step from the same parameters. Per
    step the loss agrees to rtol 1e-6 (measured 2.6e-7: the summation
    order); the parameters to atol 1e-4, a tenth of one Adan step at
    lr 1e-3 (measured 4.2e-5 on _cholesky, where Adan's normalised update
    magnifies the last bits of a near-zero gradient)."""
    gt = synthetic_image(H, W, seed=0)
    jm, state, model = _jax_start()
    chunk = jax.jit(lambda s: jm.train_chunk(s, jnp.asarray(gt), None,
                                             jnp.asarray(1), 20))
    j_state, j_metrics = chunk(state)
    opt = model.make_optimizer()
    gt_t = torch.from_numpy(gt)
    losses = [float(model.train_step(opt, gt_t)["loss"]) for _ in range(20)]
    np.testing.assert_allclose(losses, np.asarray(j_metrics["loss"]),
                               rtol=1e-6)
    for k in NAMES:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(j_state.params[k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_golden_fit():
    """The JAX golden fit (tests/test_golden_fit.py: 64x96, N = 768, uniform
    init, 1000 iterations) run by the port from the same start: above the
    JAX suite's 30.4 dB floor, and within 0.1 dB of the JAX package's PSNR
    at the same step (30.897 dB on a CPU)."""
    gt = synthetic_image(H, W, seed=0)
    jm, state, model = _jax_start()
    chunk = jax.jit(lambda st, s: jm.train_chunk(st, jnp.asarray(gt), None,
                                                 s, 250))
    for it in range(0, 1000, 250):
        state, metrics = chunk(state, jnp.asarray(it + 1))
    j_psnr = float(np.asarray(metrics["psnr"])[-1])
    opt = model.make_optimizer()
    gt_t = torch.from_numpy(gt)
    for _ in range(1000):
        m = model.train_step(opt, gt_t)
    psnr = float(m["psnr"])
    assert psnr > 30.4, psnr
    assert abs(psnr - j_psnr) < 0.1, (psnr, j_psnr)


@pytest.mark.parametrize("model_name", ["GaussianImage_Cholesky",
                                        "GaussianImage_Cholesky_wMask"])
def test_train_chunk_is_train_step_n_times(model_name):
    """``train_chunk`` (JAX: ``GaussianModelBase.train_chunk``) over 8 steps
    from iteration 5 equals 8 calls of ``train_step`` at iterations 5..12
    bit for bit: the per-step loss, PSNR and step metrics (wMask's
    sparsities, its Gumbel noise drawn from the same generator), the
    parameters and Adan's moments; its ``n_dropped_max`` is the steps'
    largest overflow, under a 768-instance cap that drops 189-196
    instances a step."""
    gt = torch.from_numpy(synthetic_image(H, W, seed=0))

    def fresh():
        m = make_model(model_name, device="cpu", num_points=N, H=H, W=W,
                       raster=RasterizeConfig(max_instances=768))
        m.init_params(torch.Generator().manual_seed(1))
        return m, m.make_optimizer(), torch.Generator().manual_seed(2)

    chunked, opt_c, gen_c = fresh()
    stepped, opt_s, gen_s = fresh()
    out = chunked.train_chunk(opt_c, gt, 5, 8, gen_c)
    steps = [stepped.train_step(opt_s, gt, iteration=5 + i, generator=gen_s)
             for i in range(8)]
    assert sorted(out) == sorted(
        [k for k in steps[0] if k != "n_dropped"] + ["n_dropped_max"])
    for k in out:
        if k != "n_dropped_max":
            assert out[k].shape == (8,), k
            assert torch.equal(out[k], torch.stack([m[k] for m in steps])), k
    dropped = [int(m["n_dropped"]) for m in steps]
    assert int(out["n_dropped_max"]) == max(dropped) > 0, dropped
    for (name, a), b in zip(chunked.named_parameters(),
                            stepped.parameters()):
        assert torch.equal(a, b), name
        for key, v in opt_c.state[a].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(opt_s.state[b][key])), (
                name, key)


# ---------------------------------------------------------------------------
# adaptive init and reseeding
# ---------------------------------------------------------------------------


def test_adaptive_init_structure_and_distribution():
    gt = synthetic_image(H, W, seed=0)
    gt_t = torch.from_numpy(gt)
    # the deterministic parts equal the JAX package's
    p = p_init.gradient_density(gt_t, H, W)
    np.testing.assert_allclose(p.numpy(), np.asarray(
        j_init.gradient_density(jnp.asarray(gt), H, W)), rtol=1e-5,
        atol=1e-9)
    xyz = p_init.adaptive_init_xyz(torch.Generator().manual_seed(0), gt_t,
                                   N, H, W)
    assert xyz.shape == (N, 2) and torch.isfinite(xyz).all()
    pos = torch.tanh(xyz)
    assert (pos.abs() < 1).all()
    x, y = p_init._pixel_of(xyz, H, W)
    assert len(set((y * W + x).tolist())) == N  # without replacement
    sig = p_init.adaptive_init_sigma(gt_t, xyz, N, H, W)
    assert ((sig >= 0.7) & (sig <= 12.0)).all()
    np.testing.assert_allclose(sig.numpy(), np.asarray(
        j_init.adaptive_init_sigma(jnp.asarray(gt), jnp.asarray(xyz.numpy()),
                                   N, H, W)), rtol=1e-5)
    np.testing.assert_allclose(
        p_init.init_colors_from_gt(gt_t, xyz, H, W).numpy(),
        np.asarray(j_init.init_colors_from_gt(
            jnp.asarray(gt), jnp.asarray(xyz.numpy()), H, W)), rtol=1e-6)
    # the draws: both packages favour the dense pixels alike. The mean
    # density at the drawn pixels of ten draws each agrees within 5%.
    pn = p.numpy()

    def mean_density(xyz_np):
        pos = np.tanh(xyz_np)
        xi = np.clip(((pos[:, 0] + 1) * 0.5 * W).astype(np.int32), 0, W - 1)
        yi = np.clip(((pos[:, 1] + 1) * 0.5 * H).astype(np.int32), 0, H - 1)
        return pn[yi * W + xi].mean()

    port = np.mean([mean_density(p_init.adaptive_init_xyz(
        torch.Generator().manual_seed(s), gt_t, N, H, W).numpy())
        for s in range(10)])
    ref = np.mean([mean_density(np.asarray(j_init.adaptive_init_xyz(
        jax.random.PRNGKey(s), jnp.asarray(gt), N, H, W))) for s in range(10)])
    assert abs(port / ref - 1) < 0.05, (port, ref)
    assert port > 1.0 / (H * W)  # denser than uniform sampling


def test_reseed_relocates_the_jax_victims_and_zeroes_their_moments():
    gt = synthetic_image(H, W, seed=0)
    gt_t = torch.from_numpy(gt)
    jm, state, model = _jax_start()
    opt = model.make_optimizer()
    for _ in range(3):  # non-zero moments
        model.train_step(opt, gt_t)
    params = {k: getattr(model, k).detach().clone() for k in NAMES}
    moments = {id(p): {k: v.clone() for k, v in opt.state[p].items()}
               for p in model.parameters()}
    victims = reseed_state(model, opt, gt_t, torch.Generator().manual_seed(3),
                           frac=0.05)
    k = int(N * 0.05)
    _, j_victims = jax.lax.top_k(-jm.importance(
        {n: jnp.asarray(v.numpy()) for n, v in params.items()}), k)
    assert sorted(victims.tolist()) == sorted(np.asarray(j_victims).tolist())

    keep = torch.ones(N, dtype=torch.bool)
    keep[victims] = False
    for name in NAMES:
        p = getattr(model, name)
        np.testing.assert_array_equal(p.detach()[keep].numpy(),
                                      params[name][keep].numpy())
        for key, v in opt.state[p].items():
            assert (v[victims] == 0).all(), (name, key)
            np.testing.assert_array_equal(
                v[keep].numpy(), moments[id(p)][key][keep].numpy())
            assert (moments[id(p)][key][victims] != 0).any(), (name, key)
    chol = model._cholesky.detach()[victims]
    np.testing.assert_allclose(chol.numpy(), np.tile([[1.0, 0.0, 1.0]],
                                                     (k, 1)))
    assert torch.isfinite(model._xyz[victims]).all()
    assert (model._features_dc[victims].abs() <= 0.7 + 1e-6).all()
    for iters in (1000, 5000, 50000):
        assert default_schedule(iters) == j_default_schedule(iters)


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------


def _args(**kw):
    base = dict(shape_bucket=0, save_imgs=False, profile=None, lr=1e-3,
                opt_type="adan", seed=1, viz_every=0, log_every=0,
                ckpt_every=0, resume=False)
    base.update(kw)
    return SimpleNamespace(**base)


def test_kill_and_resume_reproduces_the_fit(tmp_path):
    """tests/test_resume.py:31-56 for the port: a fit resumed from its
    iteration-200 snapshot lands on the uninterrupted fit's PSNR."""
    img = synthetic_image(48, 64, seed=2)
    tr_a = SimpleTrainer2d(img, "a", num_points=256, iterations=300,
                           args=_args(ckpt_every=100), log_dir=tmp_path / "a",
                           chunk_size=100, device="cpu")
    tr_a.train()
    psnr_a = tr_a.test()[0]
    assert (tmp_path / "a" / "resume.pt").exists()

    tr_b = SimpleTrainer2d(img, "a", num_points=256, iterations=300,
                           args=_args(ckpt_every=100, resume=True),
                           log_dir=tmp_path / "a", chunk_size=100,
                           device="cpu")
    assert tr_b.start_iter == 200
    tr_b.train()
    psnr_b = tr_b.test()[0]
    assert abs(psnr_a - psnr_b) < 1e-3, (psnr_a, psnr_b)
    rec = np.load(tmp_path / "a" / "training.npy", allow_pickle=True).item()
    assert len(rec["iterations"]) == 300
    assert rec["iterations"][0] == 1 and rec["iterations"][-1] == 300


def test_shape_bucketing_pads_and_crops(tmp_path):
    """tests/test_golden_fit.py's shape-bucketing case for the port: the fit
    runs at the padded shape, the metrics on the original crop."""
    img = synthetic_image(50, 70, seed=3)
    tr = SimpleTrainer2d(img, "tiny", num_points=256, iterations=100,
                         args=_args(shape_bucket=64, save_imgs=True),
                         log_dir=tmp_path, chunk_size=50, device="cpu")
    assert (tr.H, tr.W) == (64, 128)
    assert (tr.crop_h, tr.crop_w) == (50, 70)
    r = tr.train()
    assert r["n_dropped"] == 0 and np.isfinite(r["psnr"]) and r["psnr"] > 11
    from PIL import Image
    assert Image.open(tmp_path / "tiny_fitting.png").size == (70, 50)


def test_cli_fit_writes_the_jax_artifacts(tmp_path, monkeypatch):
    """main() on the synthetic dataset, cut to its first image at 48x64 so
    it runs in seconds on a CPU: train.txt, scalars.jsonl, the viz PNGs and
    training.npy with the JAX keys; its gaussian_model.npz loads through
    the JAX package and renders through the JAX model to the port's image
    (atol 2e-5)."""
    real = port_train.iterate_dataset
    monkeypatch.setattr(
        port_train, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(48, 64)), 1))
    results = port_train.main([
        "--data_name", "synthetic", "--iterations", "300", "--num_points",
        "256", "--device", "cpu", "--checkpoint_root", str(tmp_path),
        "--chunk_size", "100", "--viz_every", "100", "--log_every", "50",
        "--save_imgs"])
    assert len(results) == 1 and results[0]["n_dropped"] == 0
    d = tmp_path / "synthetic" / "GaussianImage_Cholesky_300_256" / "synth01"
    txt = (d / "train.txt").read_text()
    assert "Test PSNR:" in txt and "Training Complete in" in txt
    steps = [json.loads(l)["iteration"]
             for l in (d / "scalars.jsonl").read_text().splitlines()]
    assert steps == [1, 50, 100, 150, 200, 250, 300]
    for it in (100, 200, 300):
        for kind in ("render", "alpha", "gauss", "overlay"):
            assert (d / "viz" / f"iter_{it:06d}_{kind}.png").is_file()
    assert (d / "synth01_fitting.png").is_file()
    rec = np.load(d / "training.npy", allow_pickle=True).item()
    assert set(rec) == {"iterations", "training_psnr", "training_time",
                        "psnr", "ms-ssim", "rendering_time", "rendering_fps",
                        "initial_points", "final_points"}
    assert len(rec["training_psnr"]) == 300
    assert rec["training_psnr"][-1] > rec["training_psnr"][0] + 3.0

    params = j_load_checkpoint(d / "gaussian_model.npz")["params"]
    jm = j_make_model("GaussianImage_Cholesky", num_points=256, H=48, W=64)
    want = np.asarray(jm.render({k: jnp.asarray(v)
                                 for k, v in params.items()})["render"])
    model = make_model("GaussianImage_Cholesky", device="cpu",
                       num_points=256, H=48, W=64)
    model.load_state_dict(params_from_numpy(
        load_checkpoint(d / "gaussian_model.npz")["params"]))
    with torch.no_grad():
        got = model.render()["render"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    psnr = 10 * np.log10(1.0 / np.mean((got - synthetic_image(48, 64, 0))
                                      ** 2))
    assert abs(psnr - rec["psnr"]) < 1e-3
