"""Port parity, the clip of a render to [0, 1] (``core.clip01``): its values
and gradient against ``jax.grad`` of ``jnp.clip`` at and around the
bounds, and the generic Cholesky and RS losses, whose renders clip through
it, against ``jax.value_and_grad`` of the JAX models' losses where whole
channels render exactly 0.

At exactly 0 or 1, ``jnp.clip`` passes half the cotangent (a tie of its
max / min), as ``torch.maximum`` / ``torch.minimum`` do; ``torch.clamp``
passes all of it. Adaptive init gives a Gaussian on a black pixel a color
of exactly 0, so ties are common in a fit.

Tolerances are those of tests/test_torch_grad.py for the generic render
against the JAX package's (K2 against its Pallas backward): loss rtol 1e-5,
gradients rtol 5e-3 / atol 1e-3 x the gradient's largest magnitude. A
gradient that passed the whole cotangent at a tie would sit 2x off on every
color of the zero channel."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu_torch.core import clip01  # noqa: E402
from gaussianimage_tpu_torch.models import make_model  # noqa: E402
from gaussianimage_tpu_torch.utils.checkpoint import (  # noqa: E402
    params_from_numpy)

X = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
N, H, W = 96, 32, 48


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("lower", [True, False])
def test_clip01_value_and_gradient_are_jnp_clip(lower):
    """clip01 (and its upper-only form, the 3DGS render's) gives the values
    of ``jnp.clip`` (``jnp.minimum``) and their gradient: half the
    cotangent at exactly 0 and 1, all of it inside, none outside; without
    a gradient to carry, the same values."""
    def j_fn(v):
        return (jnp.clip(v, 0.0, 1.0) if lower else jnp.minimum(v, 1.0))

    t = torch.tensor(X, requires_grad=True)
    y = clip01(t, lower=lower)
    y.sum().backward()
    jx = jnp.asarray(X)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(j_fn(jx)))
    np.testing.assert_array_equal(
        t.grad.numpy(), np.asarray(jax.grad(lambda v: j_fn(v).sum())(jx)))
    with torch.no_grad():
        np.testing.assert_array_equal(
            clip01(t, lower=lower).numpy(), np.asarray(j_fn(jx)))
    np.testing.assert_array_equal(clip01(torch.tensor(X), lower=lower)
                                  .numpy(), np.asarray(j_fn(jx)))


def _params(model_name, seed):
    """Seeded parameters of ``model_name`` at N points, Gaussians of a few
    pixels; every red color and every color of the first quarter of the
    Gaussians exactly 0, so the red channel renders exactly 0 everywhere
    and the other two wherever only those Gaussians reach."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.05, 0.6, (N, 3)).astype(np.float32)
    colors[:, 0] = 0.0
    colors[:N // 4] = 0.0
    p = {"_xyz": rng.uniform(-1.2, 1.2, (N, 2)), "_features_dc": colors}
    if model_name == "GaussianImage_RS":
        p["_scaling"] = rng.uniform(0.5, 2.5, (N, 2))
        p["_rotation"] = rng.uniform(-2.0, 2.0, (N, 1))
    else:
        p["_cholesky"] = np.stack([rng.uniform(0.5, 2.5, N),
                                   rng.uniform(-0.5, 0.5, N),
                                   rng.uniform(0.5, 2.5, N)], 1)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("loss_type", ["Fusion2", "L2"])
@pytest.mark.parametrize("model_name", ["GaussianImage_Cholesky",
                                        "GaussianImage_RS"])
def test_generic_loss_at_exact_zeros_matches_jax(model_name, loss_type):
    """The generic loss (Fusion2, and L2 with the fused branch off) renders
    through K1 / K2 and the clip: its value and gradients equal
    ``jax.value_and_grad`` of the JAX model's loss from the same
    parameters, where the red channel renders exactly 0 everywhere."""
    params = _params(model_name, seed=3 if loss_type == "L2" else 4)
    gt = np.random.default_rng(5).uniform(0, 1, (1, 3, H, W)).astype(
        np.float32)

    model = make_model(model_name, device="cpu", num_points=N, H=H, W=W,
                       loss_type=loss_type)
    model.fused_l2 = False
    model.load_state_dict(params_from_numpy(params), strict=False)
    with torch.no_grad():
        img = model.render()["render"]
    assert bool((img[0, 0] == 0).all())
    assert int((img[0, 1:] == 0).sum()) > 0
    loss, _ = model.loss(torch.from_numpy(gt))
    loss.backward()

    jm = j_make_model(model_name, num_points=N, H=H, W=W,
                      loss_type=loss_type)
    jm.fused_l2 = False
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(gt))[0]))(
        {k: jnp.asarray(v) for k, v in params.items()})

    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    for name in params:
        got = getattr(model, name).grad.numpy().astype(np.float64)
        want = np.asarray(j_grads[name], np.float64)
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)
