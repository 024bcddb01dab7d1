"""Port parity, the wMask model (GaussianImage_Cholesky_wMask) against the
JAX package's, at the JAX suite's size (tests/test_mask_model.py: 128
points, 32 x 48): the phase schedule and the temperature; the Gumbel
sigmoid on JAX's own uniforms; the loss and its gradients under each
regularizer in each phase; 12 training steps through both phase switches
with the EMA's finalization; pruning; the masked QAT decode, single and
stacked; and the fit CLI, whose pruned checkpoint the JAX model renders.

torch cannot draw jax.random's numbers, so the port's model is handed
JAX's uniforms through its ``uniforms`` seam. The port runs its plain
kernel versions on the CPU, JAX its Pallas kernels in interpret mode.
Between the two packages the rasterizer's backward sums its moments
differently (tests/test_torch_grad.py), so a gradient entry of the port
is held to rtol 1e-4 / atol 1e-8 of JAX's or, where that fails, to the
same tolerance of a float64 oracle of the same loss, and nearer to it
than JAX's entry is."""

import itertools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu import batched as jbatched  # noqa: E402
from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.models.base import MaskConfig as JMask  # noqa: E402
from gaussianimage_tpu.models.cholesky_mask import (  # noqa: E402
    gumbel_sigmoid as j_gumbel_sigmoid)
from gaussianimage_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as j_load_checkpoint)
from gaussianimage_tpu_torch import batched  # noqa: E402
from gaussianimage_tpu_torch import train as port_train  # noqa: E402
from gaussianimage_tpu_torch.codec import ResidualVQState  # noqa: E402
from gaussianimage_tpu_torch.core import (project_gaussians_2d,  # noqa: E402
                                          render_sum_dense)
from gaussianimage_tpu_torch.models import MaskConfig, make_model  # noqa: E402
from gaussianimage_tpu_torch.models.cholesky import (  # noqa: E402
    CHOLESKY_BOUND)
from gaussianimage_tpu_torch.models.cholesky_mask import (  # noqa: E402
    gumbel_sigmoid, tile_sums)
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)
from gaussianimage_tpu_torch.utils.image_io import synthetic_image  # noqa: E402

N, H, W = 128, 32, 48  # tests/test_mask_model.py:16-19
WMASK = "GaussianImage_Cholesky_wMask"
EVAL = 1 << 30
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)


@pytest.fixture(autouse=True)
def _two_threads():
    """The plain kernel versions run many small tensor ops; under the
    suite's parallel workers torch's default thread count oversubscribes
    the CPU, so the tests here run on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _models(quantize=False, **mask_kw):
    jm = j_make_model(WMASK, num_points=N, H=H, W=W, quantize=quantize,
                      mask=JMask(**mask_kw))
    m = make_model(WMASK, device="cpu", num_points=N, H=H, W=W,
                   quantize=quantize, mask=MaskConfig(**mask_kw))
    return jm, m


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _start(jm, m, seed=0, logit_scale=2.0):
    """JAX's init_state with seeded N(0, logit_scale) logits (so the masks
    differ from Gaussian to Gaussian), loaded into the port's model."""
    st = jm.init_state(jax.random.PRNGKey(seed))
    logits = np.random.default_rng(seed).normal(
        0.0, logit_scale, (N, 1)).astype(np.float32)
    extra = dict(st.extra)
    if "mask_ema" in extra:
        extra["mask_ema"] = jax.nn.sigmoid(jnp.asarray(logits))
    st = st._replace(params={**st.params, "_mask_logits": jnp.asarray(logits)},
                     extra=extra)
    _load(m, st)
    return st


def _load(m, st):
    """A JAX state into the port's model: its parameters, the EMA and the
    VQ state as their buffers."""
    extra = {}
    for k, v in st.extra.items():
        if k == "vq":
            extra.update({f"vq/{n}": np.asarray(x)
                          for n, x in v._asdict().items()})
        else:
            extra[k] = np.array(v)
    m.load_state_dict(params_from_numpy(_np(st.params), "cpu", extra))


def _jax_uniforms(key):
    """The two uniform draws of JAX's gumbel_sigmoid under ``key``."""
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (N, 1))))
                 for k in (key, jax.random.fold_in(key, 1)))


def _feed(m, u):
    m.uniforms = lambda generator=None: u


# ------------------------------------------------------------ schedule


def test_phase_and_temperature_match_jax():
    """The phase at the JAX suite's iterations, exactly; the annealed
    temperature within one float32 ulp (XLA's and torch's exp) at the
    suite's iterations and around the window's ends; a constant
    temperature exactly."""
    kw = dict(start_mask_training=100, stop_mask_training=500)
    jm, m = _models(**kw)
    for it in (0, 50, 99, 100, 499, 500, 10 ** 6, EVAL):
        assert m.phase(it) == int(jm.phase(it)), it
    for kw in (dict(start_mask_training=0, stop_mask_training=1000,
                    temp_init=1.0, temp_final=0.1),
               dict(start_mask_training=600, stop_mask_training=2400,
                    temp_init=2.0, temp_final=0.3),
               dict(start_mask_training=5, stop_mask_training=5,
                    temp_init=1.0, temp_final=0.5)):
        jm, m = _models(**kw)
        for it in (0, 1, 5, 250, 500, 599, 600, 999, 1000, 1500, 2400,
                   5000):
            got = np.float32(m.temperature(it))
            want = np.float32(jm.temperature(it))
            assert abs(int(got.view(np.int32)) - int(want.view(np.int32))
                       ) <= 1, (kw, it, got, want)
    jm, m = _models(temp_init=0.5, temp_final=0.5)
    assert m.temperature(123) == float(jm.temperature(123)) == 0.5


def test_gumbel_sigmoid_matches_jax():
    """Soft and hard samples on JAX's uniforms from ``key`` and
    ``fold_in(key, 1)`` (rtol 1e-6), and the hard sample's straight-through
    gradient against jax.grad (rtol 1e-5), at the default temperature 0.5,
    at 1.0 and at 1.7. (XLA's CPU log is one ulp off torch's on a fifth of
    the noise values; at temperature 0.1 that moves samples near 1e-13 by
    up to 4e-6 relative, so colder temperatures are left to the loss and
    step tests.)"""
    key = jax.random.PRNGKey(3)
    logits = np.random.default_rng(1).normal(0, 2, (N, 1)).astype(np.float32)
    w = np.random.default_rng(2).normal(0, 1, (N, 1)).astype(np.float32)
    u = _jax_uniforms(key)
    for temp in (0.5, 1.0, 1.7):
        want = np.asarray(j_gumbel_sigmoid(key, jnp.asarray(logits), temp))
        got = gumbel_sigmoid(torch.from_numpy(logits), u, temp)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        hard = np.asarray(j_gumbel_sigmoid(key, jnp.asarray(logits), temp,
                                           hard=True))
        x = torch.from_numpy(logits).requires_grad_(True)
        y = gumbel_sigmoid(x, u, temp, hard=True)
        np.testing.assert_array_equal(y.detach().numpy(), hard)
        assert set(np.unique(hard).tolist()) <= {0.0, 1.0}
        (y * torch.from_numpy(w)).sum().backward()
        jg = jax.grad(lambda z: jnp.sum(j_gumbel_sigmoid(
            key, z, temp, hard=True) * w))(jnp.asarray(logits))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-12)


# ------------------------------------------------------------ the loss


def _oracle_loss(m, params, gt, it, u):
    """The port's loss at ``iteration`` ``it`` in float64 on the dense
    summation (q_cut 9, the kernels' gate), from ``params``; returns the
    float64 leaves and the loss."""
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in params.items()}
    xys, _, radii, conics, _ = project_gaussians_2d(
        torch.tanh(p["_xyz"]),
        p["_cholesky"] + torch.tensor(CHOLESKY_BOUND, dtype=torch.float64),
        H, W, m.cfg.tile_bounds)
    logits = p["_mask_logits"]
    ph = m.phase(it)
    if ph == 0:
        opac = torch.ones_like(logits)
    elif ph == 2:
        opac = (torch.sigmoid(logits) > 0.5).double()
    else:
        x = logits
        if m.mask_cfg.use_score:
            ch = p["_cholesky"].detach() + torch.tensor(CHOLESKY_BOUND)
            x = logits * torch.abs(ch[:, 0] * ch[:, 2])[:, None]
        opac = gumbel_sigmoid(x, tuple(v.double() for v in u),
                              m.temperature(it))
    img = render_sum_dense(xys, conics, p["_features_dc"], opac, H, W,
                           q_cut=9.0)
    img = torch.clamp(img, 0.0, 1.0).permute(2, 0, 1)[None]
    gt64 = torch.from_numpy(gt).double()
    loss = torch.mean((img - gt64) ** 2)
    if ph == 1:
        loss = loss + m.mask_cfg.lambda_reg * m.regularizer(
            torch.sigmoid(logits), gt64, {"pkg": {"xys": xys}})
    return p, loss


LOSS_CASES = [(reg, it) for reg in ("kl", "ada_kl", "l1", "l1sq")
              for it in (5, 15, 25)] + [("score", 15)]


@pytest.mark.parametrize("reg,it", LOSS_CASES)
def test_loss_and_grads_match_jax(reg, it):
    """Phases 0, 1 and 2 (iterations 5, 15, 25 of a 10-20 mask window)
    under each regularizer (and the kl with ``use_score``): the loss to
    rtol 1e-5, every gradient entry to JAX's or the float64 oracle's (the
    module docstring); the logits' gradient is zero outside phase 1, as
    jax.value_and_grad gives it, and the step hands Adan that zero."""
    kw = dict(start_mask_training=10, stop_mask_training=20,
              reg_type="kl" if reg == "score" else reg, target_sparsity=0.6,
              lambda_reg=0.5, temp_init=1.0, temp_final=0.2,
              use_score=reg == "score")
    jm, m = _models(**kw)
    st = _start(jm, m)
    gt = synthetic_image(H, W, seed=1)
    key = jax.random.PRNGKey(2)
    u = _jax_uniforms(key)
    _feed(m, u)
    j_val, j_grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(gt), key=key, iteration=it)[0]))(st.params)
    loss, _ = m.loss(torch.from_numpy(gt), iteration=it)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_val),
                               rtol=1e-5)
    leaves, o_loss = _oracle_loss(m, _np(st.params), gt, it, u)
    o_loss.backward()
    for name in st.params:
        g = getattr(m, name).grad
        if name == "_mask_logits" and m.phase(it) != 1:
            assert g is None
            assert not np.asarray(j_grads[name]).any()
            continue
        a = g.numpy().astype(np.float64)
        b = np.asarray(j_grads[name], np.float64)
        o = leaves[name].grad.numpy()
        off = ~np.isclose(a, b, **GRAD_TOL)
        np.testing.assert_allclose(a[off], o[off], **GRAD_TOL, err_msg=name)
        assert np.all(np.abs(a - o)[off] <= np.abs(b - o)[off]), name
    opt = m.make_optimizer()
    m.train_step(opt, torch.from_numpy(gt), iteration=it)
    assert opt.param_groups[1]["count"] == 1  # the logits' group stepped


def test_ada_kl_bins_by_truncation_in_a_fixed_order():
    """Tile indices truncate toward zero as astype(int32) does (a center at
    x = -3 lands in tile 0, at x = -17 in none), the overflow bucket takes
    the rest, and the per-tile sums equal a float64 index_add_ of the same
    values (to float32 rounding) and repeat bit for bit."""
    jm, m = _models(reg_type="ada_kl", target_sparsity=0.6)
    st = _start(jm, m)
    gt = synthetic_image(H, W, seed=1)
    xys = np.random.default_rng(4).uniform(-20, 60, (N, 2)).astype(
        np.float32)
    xys[:4] = [[-3.0, 5.0], [-17.0, 5.0], [47.9, 31.9], [5.0, -0.5]]
    probs = jax.nn.sigmoid(st.params["_mask_logits"])
    want = jm._adaptive_kl(st.params, jnp.asarray(gt), probs,
                           {"pkg": {"xys": jnp.asarray(xys)}})
    pt = torch.sigmoid(m._mask_logits.detach())
    aux = {"pkg": {"xys": torch.from_numpy(xys)}}
    got = m._adaptive_kl(torch.from_numpy(gt), pt, aux)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert torch.equal(got, m._adaptive_kl(torch.from_numpy(gt), pt, aux))

    lin = torch.tensor([0, 0, 2, 5, 2, 0, 6], dtype=torch.int32)
    vals = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, 7).astype(np.float32))
    sums, counts = tile_sums(lin, vals, 7)
    ref = torch.zeros(7, dtype=torch.float64).index_add_(
        0, lin.long(), vals.double())
    np.testing.assert_allclose(sums.numpy(), ref.numpy(), rtol=1e-7)
    assert counts.tolist() == [3, 0, 2, 0, 0, 1, 1]
    ix = (torch.tensor([-3.0, -17.0, 15.9, 16.0]) / 16).to(torch.int32)
    assert ix.tolist() == [0, -1, 0, 1]


# ------------------------------------------------------------ training


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5])
def test_adan_groups_match_optax_multi_transform(max_grad_norm):
    """Two parameter groups, each on its own StepLR schedule (the logits'
    at 0.005, not the default's scaled), against optax.multi_transform of
    two JAX Adans, 12 steps of random gradients, the second group's zero on
    every third step (it still steps): rtol 1e-5 / atol 1e-6
    (tests/test_adan.py's); the clip takes each group's own norm."""
    import optax

    from gaussianimage_tpu.opt import adan as j_adan
    from gaussianimage_tpu.opt import step_lr as j_step_lr
    from gaussianimage_tpu_torch.opt import Adan, step_lr

    rng = np.random.default_rng(11)
    p0 = {"a": rng.standard_normal((6, 3)).astype(np.float32),
          "m": rng.standard_normal((6, 1)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              * (0.0 if k == "m" and i % 3 == 0 else 1.0)
              for k, v in p0.items()} for i in range(12)]
    j_opt = optax.multi_transform(
        {"default": j_adan(j_step_lr(1e-3, 4, 0.5),
                           max_grad_norm=max_grad_norm),
         "m": j_adan(j_step_lr(0.005, 4, 0.5), max_grad_norm=max_grad_norm)},
        lambda p: {k: ("m" if k == "m" else "default") for k in p})
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = j_opt.init(j_params)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = Adan([{"params": [params["a"]], "lr": step_lr(1e-3, 4, 0.5)},
                {"params": [params["m"]], "lr": step_lr(0.005, 4, 0.5)}],
               max_grad_norm=max_grad_norm)
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
    assert [g["count"] for g in opt.param_groups] == [12, 12]
    assert opt.state_dict()["param_groups"][1]["lr"] is None


@pytest.mark.parametrize("opt_type", ["adan", "adam"])
def test_train_steps_match_jax(opt_type):
    """12 steps of each package's train_step with a 3-9 mask window,
    use_ema and an annealed temperature, the port fed JAX's per-step
    uniforms: per step the loss and the logits to rtol 1e-5 (the logits'
    own group at lr 0.005, stepped on zero gradients in phases 0 and 2),
    the EMA to 1e-6, the other parameters to atol 1e-4 (a tenth of an Adan
    step, test_torch_train.py), the step metrics equal; at the stop
    iteration every logit is +-10 by the EMA, and after it the logits
    still move."""
    kw = dict(start_mask_training=3, stop_mask_training=9, use_ema=True,
              reg_type="kl", target_sparsity=0.6, lambda_reg=0.05,
              temp_init=1.0, temp_final=0.2)
    jm = j_make_model(WMASK, num_points=N, H=H, W=W, opt_type=opt_type,
                      mask=JMask(**kw))
    m = make_model(WMASK, device="cpu", num_points=N, H=H, W=W,
                   opt_type=opt_type, mask=MaskConfig(**kw))
    st = _start(jm, m, logit_scale=1.0)
    gt = synthetic_image(H, W, seed=1)
    gt_t = torch.from_numpy(gt)
    opt = m.make_optimizer()
    assert [fn(0) for fn in (opt.lr_fns if opt_type == "adam"
                             else opt.lr_fns)] == [1e-3, 0.005]
    step = jax.jit(lambda s, k, it: jm.train_step(s, jnp.asarray(gt), key=k,
                                                  iteration=it))
    for j in range(12):
        it = j + 1
        key = jax.random.fold_in(jax.random.PRNGKey(7), j)
        _feed(m, _jax_uniforms(key))
        st, jmet = step(st, key, it)
        met = m.train_step(opt, gt_t, iteration=it)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=str(it))
        logits = m._mask_logits.detach().numpy()
        np.testing.assert_allclose(logits, np.asarray(
            st.params["_mask_logits"]), rtol=1e-5, atol=1e-7,
            err_msg=str(it))
        np.testing.assert_allclose(m.mask_ema.numpy(), np.asarray(
            st.extra["mask_ema"]), rtol=0, atol=1e-6, err_msg=str(it))
        for k in ("_xyz", "_cholesky", "_features_dc"):
            np.testing.assert_allclose(
                getattr(m, k).detach().numpy(), np.asarray(st.params[k]),
                rtol=0, atol=1e-4, err_msg=f"{k} {it}")
        for k in ("sparsity_hard", "num_points_active"):
            assert float(met[k]) == float(jmet[k]), (k, it)
        np.testing.assert_allclose(float(met["sparsity_soft"]),
                                   float(jmet["sparsity_soft"]), rtol=1e-6)
        assert met["num_points_active"].dtype == torch.int32
        if it == 9:
            assert set(np.unique(logits).tolist()) == {-10.0, 10.0}
            np.testing.assert_array_equal(
                logits > 0, m.mask_ema.numpy() > 0.5)
    assert not set(np.unique(logits).tolist()) <= {-10.0, 10.0}
    assert np.all(np.abs(np.abs(logits) - 10.0) < 0.5)
    assert [g["count"] for g in opt.param_groups] == [12, 12]


def test_prune_points_matches_jax(capsys):
    """The same kept rows as JAX's prune_points (every per-Gaussian
    parameter and the EMA), the message, a fresh optimizer over the kept
    rows, and the pruned render at 1 << 30 equal to the unpruned one."""
    jm, m = _models(use_ema=True)
    st = _start(jm, m)
    jst = jm.prune_points(st, threshold=0.5)
    want_msg = capsys.readouterr().out.strip()
    before = m.render(iteration=EVAL)["render"].detach()
    opt = m.prune_points(threshold=0.5)
    assert capsys.readouterr().out.strip() == want_msg
    kept = int(jst.params["_xyz"].shape[0])
    assert 0 < kept < N and want_msg == f"Pruned points: {N} to {kept} points."
    for k, v in jst.params.items():
        np.testing.assert_array_equal(getattr(m, k).detach().numpy(),
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(m.mask_ema.numpy(),
                                  np.asarray(jst.extra["mask_ema"]))
    assert m.cfg.num_points == kept
    assert all(not s["exp_avg"].any() for s in opt.state.values())
    assert {p.shape[0] for g in opt.param_groups for p in g["params"]} == {
        kept}
    after = m.render(iteration=EVAL)["render"].detach()
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=0,
                               atol=1e-6)
    want = np.asarray(jm.render(jst.params, iteration=EVAL)["render"])
    np.testing.assert_allclose(after.numpy(), want, rtol=0, atol=2e-5)


# ------------------------------------------------------------ QAT, codec


def _qat_state(jm, m, seed):
    st = jm.init_quantizer_data(_start(jm, m, seed=seed))
    _load(m, st)
    return st


def test_qat_decode_of_a_masked_state_matches_jax():
    """Under QAT (JAX's default MaskConfig, as its QAT trainer builds it):
    the loss at a phase-1 iteration (the deterministic mask in the
    quantized render, the kl added) to rtol 1e-5; the codec decode of a
    state whose masks differ from Gaussian to Gaussian against JAX's
    decompress_wo_ec (atol 2e-5, but for at most 4 pixels at a binning
    edge) and against the port's evaluation render (1e-6); and a stacked
    decode of two frames with different masks against the two
    single-frame decodes, frame 0 bit for bit."""
    jm, m = _models(quantize=True)
    st = _qat_state(jm, m, seed=0)
    gt = synthetic_image(H, W, seed=1)
    key = jax.random.PRNGKey(5)
    j_loss, _ = jm.loss(st.params, jnp.asarray(gt), key=key, iteration=7,
                        extra=st.extra)
    loss, _ = m.loss(torch.from_numpy(gt), iteration=7)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)

    enc = {k: np.array(v) for k, v in jm.compress_wo_ec(
        st.params, st.extra).items()}
    want = np.asarray(jm.decompress_wo_ec(
        st.params, st.extra, {k: jnp.asarray(v) for k, v in enc.items()}
    )["render"])
    got = m.decompress_wo_ec(enc)["render"].numpy()
    assert int((np.abs(got - want) > 2e-5).sum()) <= 4
    with torch.no_grad():
        evalr = m.render_quantize(training=False)["render"].numpy()
    np.testing.assert_allclose(got, evalr, rtol=0, atol=1e-6)
    plain = make_model("GaussianImage_Cholesky", device="cpu", num_points=N,
                       H=H, W=W, quantize=True)
    plain.load_state_dict({k: v for k, v in m.state_dict().items()
                           if k != "_mask_logits"})
    assert np.abs(plain.decompress_wo_ec(enc)["render"].numpy()
                  - got).max() > 1e-2  # the mask changes the image

    jm1, m1 = _models(quantize=True)
    st1 = _qat_state(jm1, m1, seed=1)
    enc1 = {k: np.array(v) for k, v in jm1.compress_wo_ec(
        st1.params, st1.extra).items()}
    assert (np.asarray(st.params["_mask_logits"] > 0)
            != np.asarray(st1.params["_mask_logits"] > 0)).any()
    models = (m, m1)
    named = [dict(x.named_parameters()) for x in models]
    pb = {k: torch.stack([p[k].detach() for p in named]) for k in named[0]}
    eb = {"vq": ResidualVQState(*(torch.stack(v) for v in zip(
        *(x.vq_state() for x in models))))}
    encb = {k: torch.from_numpy(np.stack([enc[k], enc1[k]])) for k in enc}
    out = batched.decompress_wo_ec_batch(m, pb, eb, encb)["render"].numpy()
    single = [got, m1.decompress_wo_ec(enc1)["render"].numpy()]
    np.testing.assert_array_equal(out[0], single[0][0])
    np.testing.assert_allclose(out[1], single[1][0], rtol=1e-5, atol=1e-5)
    jout = np.asarray(jbatched.decompress_wo_ec_batch(
        jm, jax.tree.map(lambda *x: jnp.stack(x), st.params, st1.params),
        jax.tree.map(lambda *x: jnp.stack(x), st.extra, st1.extra),
        {k: jnp.asarray(v) for k, v in encb.items()})["render"])
    assert int((np.abs(out - jout) > 2e-5).sum()) <= 8


def test_reference_quirks_are_matched():
    """The JAX model's quirks, kept: its update_extra does not call the QAT
    mixin's, so a QAT step leaves the VQ codebooks at their k-means start;
    ada_kl under QAT has no render centers (JAX: KeyError, the port a
    ValueError naming them); render() defaults to iteration 0, the soft
    phase when the window starts at 0."""
    jm, m = _models(quantize=True)
    st = _qat_state(jm, m, seed=0)
    gt = synthetic_image(H, W, seed=1)
    embed = m.vq.embed.clone()
    jst, _ = jm.train_step(st, jnp.asarray(gt), key=jax.random.PRNGKey(1),
                           iteration=3)
    np.testing.assert_array_equal(np.asarray(jst.extra["vq"].embed),
                                  np.asarray(st.extra["vq"].embed))
    m.train_step(m.make_optimizer(), torch.from_numpy(gt), iteration=3)
    assert torch.equal(m.vq.embed, embed)

    jm, m = _models(quantize=True, reg_type="ada_kl")
    st = _qat_state(jm, m, seed=0)
    with pytest.raises(KeyError):
        jm.loss(st.params, jnp.asarray(gt), key=None, iteration=3,
                extra=st.extra)
    with pytest.raises(ValueError, match="xys"):
        m.loss(torch.from_numpy(gt), iteration=3)

    jm, m = _models()
    _start(jm, m)
    assert m.phase(0) == int(jm.phase(0)) == 1
    soft = m.render()["final_opacities"]
    assert ((soft > 0) & (soft < 1)).any()


# ------------------------------------------------------------ the CLI


def test_cli_fit_with_the_mask_flags_prunes_and_jax_reads_it(tmp_path,
                                                             monkeypatch):
    """main() on the first synthetic image at 32 x 48, 40 iterations, with
    all ten mask flags: the pruned checkpoint (JAX's keys, extra/mask_ema
    with --use_ema) rendered by the JAX model at 1 << 30 gives the port's
    test PSNR within 1e-4 dB; training.npy's final_points is the pruned
    count; scalars.jsonl carries the sparsity keys, num_points_active an
    integer."""
    real = port_train.iterate_dataset
    monkeypatch.setattr(
        port_train, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(H, W)), 1))
    results = port_train.main([
        "--data_name", "synthetic", "--iterations", "40", "--num_points",
        str(N), "--device", "cpu", "--checkpoint_root", str(tmp_path),
        "--chunk_size", "10", "--viz_every", "0", "--log_every", "10",
        "--model_name", WMASK, "--start_mask_training", "10",
        "--stop_mask_training", "30", "--reg_type", "ada_kl",
        "--target_sparsity", "0.1", "--lambda_reg", "0.3",
        "--init_mask_logit", "0.0", "--use_ema", "--use_score",
        "--temp_init", "1.0", "--temp_final", "0.1"])
    d = tmp_path / "synthetic" / f"{WMASK}_40_{N}" / "synth01"
    rec = np.load(d / "training.npy", allow_pickle=True).item()
    ck = j_load_checkpoint(d / "gaussian_model.npz")
    kept = ck["params"]["_xyz"].shape[0]
    assert sorted(ck["params"]) == ["_cholesky", "_features_dc",
                                    "_mask_logits", "_xyz"]
    assert sorted(ck["extra"]) == ["mask_ema"]
    assert 0 < kept < N and rec["final_points"] == kept
    assert rec["initial_points"] == N
    assert f"Final_points:{kept}" in (d / "train.txt").read_text()
    lines = [json.loads(l) for l in
             (d / "scalars.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in lines] == [1, 10, 20, 30, 40]
    for r in lines:
        assert set(r) == {"iteration", "loss", "psnr", "sparsity_hard",
                          "sparsity_soft", "num_points_active"}
        assert isinstance(r["num_points_active"], int)
    assert lines[-1]["num_points_active"] == kept

    jm = j_make_model(WMASK, num_points=kept, H=H, W=W)
    img = np.asarray(jm.render({k: jnp.asarray(v) for k, v in
                                ck["params"].items()}, iteration=EVAL)
                     ["render"])
    gt = synthetic_image(H, W, seed=0)  # synth01
    psnr = 10 * math.log10(1.0 / float(np.mean((img - gt) ** 2)))
    assert abs(psnr - results[0]["psnr"]) < 1e-4, (psnr, results[0])
