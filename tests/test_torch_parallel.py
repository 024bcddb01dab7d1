"""Port parity, the sharded fit (gaussianimage_tpu_torch/parallel and
train_sharded.py) on real multi-process gloo runs on the CPU.

- ``mesh_axes_for`` against the JAX package's table; single-worker launch
  environments start no process group.
- The sharded step against JAX's ``make_sharded_train_step`` on the
  8-device CPU mesh (tests/conftest.py), on the meshes (2, 2, 2), (1, 1, 2)
  (the fused K3 path), (1, 2, 2) under ``shard_opt`` and (1, 1, 4): JAX's
  init (parameters and Adan state, as numpy) carried onto every rank's
  shard, 3 steps at tile 16, N = 256, 32x48 (64x48 on the tile axis of 4,
  so that H splits into whole 16-pixel tiles): parameters at JAX's own
  sharded-vs-single tolerance (rtol 2e-4, atol 2e-5,
  tests/test_parallel.py), loss at rtol 1e-4.
- The sharded CLI at 2 ranks (tile axis 2) on ``synthetic``: its
  checkpoints render through the JAX model to the final-state PSNR it
  logged, within 1e-4 dB; a resume from its mid-fit snapshot equals the
  uninterrupted fit bit for bit.

Ranks are processes started from this file (``python <this file>
--worker ...``), one torch thread each, meeting through a ``file://``
rendezvous (or, for the CLI, a free localhost port) under ``tmp_path``,
each with a timeout.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
H, W, N = 32, 48, 256
STEPS = 3
SEED = 3
TIMEOUT = 300


# --------------------------------------------------------------- the worker


def _worker(a) -> None:
    """One rank: carry JAX's init onto its shards, run the step, gather the
    fit and (rank 0) save it."""
    import torch.distributed as dist

    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import RasterizeConfig
    from gaussianimage_tpu_torch.parallel import (
        init_sharded_fit, make_mesh, make_sharded_train_step)
    from gaussianimage_tpu_torch.parallel.fit import (gather_fit,
                                                      image_metrics, load_fit)

    torch.set_num_threads(1)
    d, g, t = (int(x) for x in a.mesh.split(","))
    dist.init_process_group("gloo", init_method=f"file://{a.rendezvous}",
                            rank=a.rank, world_size=d * g * t)
    mesh = make_mesh({"data": d, "gauss": g, "tile": t})
    src = np.load(a.inp)
    images = src["images"]
    caps = {k: getattr(a, k) for k in ("max_instances", "max_tiles_per_gauss")
            if getattr(a, k) is not None}
    model = make_model("GaussianImage_Cholesky", device="cpu",
                       num_points=a.n, H=images.shape[2], W=images.shape[3],
                       raster=RasterizeConfig(tile_px=16, **caps))
    state = init_sharded_fit(model, mesh, images, seed=SEED,
                             shard_opt=a.shard_opt)
    names = [k[len("p/"):] for k in src.files if k.startswith("p/")]
    opt = {"count": src["count"]}
    for mom in ("exp_avg", "exp_avg_sq", "exp_avg_diff", "prev_grad"):
        opt[mom] = {k: src[f"{mom}/{k}"] for k in names}
    load_fit(state, mesh, {k: src[f"p/{k}"] for k in names}, opt)
    step = make_sharded_train_step(model, mesh, n_steps=STEPS,
                                   shard_opt=a.shard_opt)
    loss, psnr, nd = step(state)
    params, _ = gather_fit(state, mesh)
    loss, nd = image_metrics(mesh, loss, nd)
    if a.rank == 0:
        np.savez(a.out, loss=loss, n_dropped=nd,
                 **{k: v.numpy() for k, v in params.items()})
    dist.barrier()
    dist.destroy_process_group()


def _spawn(argv, env=None, n=1):
    """Start ``n`` processes of ``argv`` (rank appended per process for
    the worker); one torch thread each."""
    base = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    procs = []
    for r in range(n):
        e = dict(base, **(env(r) if env else {}))
        procs.append(subprocess.Popen(
            argv(r), env=e, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return logs


# --------------------------------------------------------------- the tests

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gaussianimage_tpu.models import make_model as j_make_model  # noqa: E402
from gaussianimage_tpu.ops import RasterizeConfig as JCfg  # noqa: E402
from gaussianimage_tpu.parallel import (  # noqa: E402
    init_sharded_fit as j_init, make_mesh as j_mesh,
    make_sharded_train_step as j_step, mesh_axes_for as j_axes)
from gaussianimage_tpu.utils.image_io import synthetic_image  # noqa: E402
from gaussianimage_tpu_torch.parallel import (  # noqa: E402
    make_mesh, maybe_initialize_distributed, mesh_axes_for)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_mesh_axes_match_jax(n):
    assert mesh_axes_for(n) == j_axes(n)
    for kw in ({"want_data": False}, {"want_tile": False},
               {"want_gauss": False}):
        assert mesh_axes_for(n, **kw) == j_axes(n, **kw)


def test_single_worker_environments_start_nothing(monkeypatch):
    """WORLD_SIZE=1 (torchrun with one process), SLURM_NTASKS=1 and one
    SLURM node start no process group; the mesh is then 1 x 1 x 1, every
    axis without a group."""
    for k in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_PROCID",
              "SLURM_JOB_NUM_NODES", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert maybe_initialize_distributed() is False
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    assert maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "gauss": 1, "tile": 1}
    assert all(mesh.group(a) is None for a in ("data", "gauss", "tile"))
    with pytest.raises(ValueError, match="processes"):
        make_mesh({"data": 1, "gauss": 1, "tile": 2})


# stream caps that make every step drop instances, at the scale of the
# blend's dropping scene (tests/test_torch_blend.py, n120_drop)
DROP = {"max_instances": 128, "max_tiles_per_gauss": 2}
MESHES = [("2,2,2", False, H, {}), ("1,1,2", False, H, {}),
          ("1,2,2", True, H, {}), ("1,1,4", False, 64, {}),
          ("1,1,2", False, H, DROP), ("1,2,1", False, H, DROP)]


@pytest.mark.parametrize("mesh_s,shard_opt,h,caps", [
    pytest.param(*m, id="-".join(map(str, m[:3])) + ("-drop" if m[3] else ""))
    for m in MESHES])
def test_sharded_step_matches_jax(tmp_path, mesh_s, shard_opt, h, caps):
    """The last two cases overflow the stream (``DROP``): on (1, 1, 2)
    through the fused K3 step, on (1, 2, 1) through the generic one. Both
    packages drop the same number, and the fit agrees as it does without
    a drop."""
    d, g, t = (int(x) for x in mesh_s.split(","))
    model = j_make_model("GaussianImage_Cholesky", num_points=N, H=h, W=W,
                         raster=JCfg(tile_px=16, **caps))
    mesh = j_mesh({"data": d, "gauss": g, "tile": t},
                  devices=jax.devices()[:d * g * t])
    images = np.concatenate([synthetic_image(h, W, seed=i)
                             for i in range(d)], axis=0)
    params, opt_state, gt = j_init(model, mesh, jnp.asarray(images),
                                   seed=SEED, shard_opt=shard_opt)
    # the init as numpy, before the step donates its buffers
    inp = tmp_path / "init.npz"
    arrays = {"images": images, "count": np.asarray(opt_state.count)}
    arrays.update({f"p/{k}": np.asarray(v) for k, v in params.items()})
    for mom in ("exp_avg", "exp_avg_sq", "exp_avg_diff", "prev_grad"):
        arrays.update({f"{mom}/{k}": np.asarray(v)
                       for k, v in getattr(opt_state, mom).items()})
    np.savez(inp, **arrays)
    out = tmp_path / "out.npz"
    procs = _spawn(lambda r: [
        sys.executable, __file__, "--worker", "--rank", str(r),
        "--mesh", mesh_s, "--rendezvous", str(tmp_path / "rdv"),
        "--inp", str(inp), "--out", str(out), "--n", str(N)]
        + (["--shard_opt"] if shard_opt else [])
        + [f"--{k}={v}" for k, v in caps.items()], n=d * g * t)
    try:
        step = j_step(model, mesh, n_steps=STEPS, shard_opt=shard_opt)(
            params, opt_state, gt)
        p2, _, loss, _, nd = step(params, opt_state, gt, jnp.asarray(1))
        want = {k: np.asarray(v) for k, v in p2.items()}
        j_loss, j_nd = np.asarray(loss), np.asarray(nd)
    finally:
        _join(procs)
    got = np.load(out)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-4)
    np.testing.assert_array_equal(got["n_dropped"], j_nd)
    assert (int(j_nd.max()) > 0) == bool(caps), j_nd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(root, extra=()):
    port = _free_port()
    args = [sys.executable, "-m", "gaussianimage_tpu_torch.train_sharded",
            "--device", "cpu", "--data_name", "synthetic",
            "--num_points", "256", "--iterations", "6", "--chunk_size", "3",
            "--ckpt_every", "3", "--mesh", "1,1,2",
            "--checkpoint_root", str(root), *extra]
    return _join(_spawn(lambda r: args, env=lambda r: dict(
        WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)), n=2))


def test_sharded_cli_checkpoints_render_in_jax_and_resume(tmp_path):
    """Two ranks on the tile axis fit both synthetic images (two groups of
    one). Each checkpoint, rendered by the JAX model at the CLI's config,
    scores the final-state PSNR the CLI logged (1e-4 dB); training.npy has
    the JAX CLI's keys. Then a kill after the first chunk: the images'
    training.npy removed, the group resumed from the snapshot the first
    chunk left, to the same checkpoint bit for bit."""
    from gaussianimage_tpu.models import make_model as jm
    from gaussianimage_tpu.utils.checkpoint import load_checkpoint

    root = tmp_path / "ck"
    logs = _cli(root)
    run = root / "synthetic" / "sharded_6_256"
    text = (run / "train.txt").read_text()
    assert "mesh axes: {'data': 1, 'gauss': 1, 'tile': 2} over 2" in text
    model = jm("GaussianImage_Cholesky", num_points=256, H=512, W=768,
               raster=JCfg(tile_px=16), block_h=16, block_w=16)
    render = jax.jit(lambda p: model.render(p)["render"])
    first = {}
    for i, name in enumerate(("synth01", "synth02")):
        rec = np.load(run / name / "training.npy", allow_pickle=True).item()
        assert set(rec) == {"iterations", "training_time", "psnr",
                            "initial_points"}
        logged = float(text.split(f"{name}: final state PSNR:")[1].split()[0])
        ck = load_checkpoint(run / name / "gaussian_model.npz")
        first[name] = ck["params"]
        img = np.asarray(render({k: jnp.asarray(v)
                                 for k, v in ck["params"].items()}))
        gt = synthetic_image(512, 768, seed=i)
        psnr = float(10 * np.log10(1 / np.mean((img - gt) ** 2)))
        assert abs(psnr - logged) <= 1e-4, (name, psnr, logged, logs[0])
        assert (run / f"resume_{name}.pt").exists()
    for name in first:
        (run / name / "training.npy").unlink()
    _cli(root, ["--resume"])
    assert "resumed group ['synth01'] at iteration 3" in (
        run / "train.txt").read_text()
    for name, params in first.items():
        again = load_checkpoint(run / name / "gaussian_model.npz")["params"]
        for k, v in params.items():
            np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_parallel_modules_import_no_jax():
    code = (
        "import sys\n"
        "import gaussianimage_tpu_torch.parallel.scaling_bench\n"
        "import gaussianimage_tpu_torch.train_sharded\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.split('.')[0] == 'gaussianimage_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0 and p.stdout.strip() == "clean", p.stderr


def test_cli_flags_and_defaults_match_jax():
    """Every flag of the JAX sharded CLI at its default (``--tile_px 16``,
    ``--init_mode adaptive`` among them); the port adds ``--device``."""
    from gaussianimage_tpu import train_sharded as j_cli
    from gaussianimage_tpu_torch import train_sharded as t_cli
    want = vars(j_cli.parse_args([]))
    got = vars(t_cli.parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    assert got["tile_px"] == 16 and got["init_mode"] == "adaptive"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gaussianimage_tpu_torch import train_sharded
    from gaussianimage_tpu_torch.parallel import scaling_bench
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_sharded.main(["--data_name", "synthetic"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        scaling_bench.main([])


@pytest.mark.parametrize("shard_opt", [False, True])
@pytest.mark.parametrize("axes", [(1, 1, 1), (1, 2, 2), (2, 1, 4),
                                  (1, 8, 1), (1, 3, 2)])
def test_comm_accounting_matches_jax(axes, shard_opt):
    from gaussianimage_tpu.parallel.scaling_bench import (
        comm_accounting as j_comm)
    from gaussianimage_tpu_torch.parallel.scaling_bench import comm_accounting
    mesh = dict(zip(("data", "gauss", "tile"), axes))
    for hw in ((512, 768), (256, 256)):
        assert (comm_accounting(*hw, 10000, 8, mesh, shard_opt)
                == j_comm(*hw, 10000, 8, mesh, shard_opt))


def test_sharded_clip_gradient_is_jax_clip():
    """The sharded render clips as ``jnp.clip`` does, through the shared
    ``core.clip01``: on the one-rank mesh (no process group) at tile 16,
    with every red color exactly 0 so that the red channel renders exactly
    0, ``sum(render * G)`` and its gradients equal ``jax.value_and_grad``
    of the JAX model's render (which clips with ``jnp.clip``) from the
    same parameters, at tests/test_torch_grad.py's tolerance (value rtol
    1e-5, gradients rtol 5e-3 / atol 1e-3 x the largest). A clip that
    passed the whole cotangent at 0 would double every red gradient."""
    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import RasterizeConfig
    from gaussianimage_tpu_torch.parallel import make_mesh
    from gaussianimage_tpu_torch.parallel.fit import sharded_render
    from gaussianimage_tpu_torch.utils.checkpoint import params_from_numpy
    n = 96
    rng = np.random.default_rng(SEED)
    colors = rng.uniform(0.05, 0.6, (n, 3)).astype(np.float32)
    colors[:, 0] = 0.0
    params = {"_xyz": rng.uniform(-1.2, 1.2, (n, 2)),
              "_cholesky": np.stack([rng.uniform(0.5, 2.5, n),
                                     rng.uniform(-0.5, 0.5, n),
                                     rng.uniform(0.5, 2.5, n)], 1),
              "_features_dc": colors}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    G = rng.uniform(-1, 1, (3, H, W)).astype(np.float32)

    model = make_model("GaussianImage_Cholesky", device="cpu", num_points=n,
                       H=H, W=W, raster=RasterizeConfig(tile_px=16))
    model.load_state_dict(params_from_numpy(params), strict=False)
    img, _ = sharded_render(model, make_mesh({"data": 1, "gauss": 1,
                                              "tile": 1}))
    assert bool((img[..., 0] == 0).all())
    val = (img.permute(2, 0, 1) * torch.from_numpy(G)).sum()
    val.backward()

    jm = j_make_model("GaussianImage_Cholesky", num_points=n, H=H, W=W,
                      raster=JCfg(tile_px=16))
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p: (jm.render(p)["render"][0] * jnp.asarray(G)).sum()))(
        {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    for name in params:
        got = getattr(model, name).grad.numpy().astype(np.float64)
        want = np.asarray(j_grads[name], np.float64)
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)


def test_scaling_bench_on_one_rank(capsys):
    from gaussianimage_tpu_torch.parallel import scaling_bench
    res = scaling_bench.run(n_steps=1, H=32, W=32, N=64, device="cpu",
                            reps=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"world_size": 1' in out[0]
    assert res["backend"].startswith("none") and res["device"] == "cpu"
    for key in ("strong", "strong_tile_fused", "weak_data"):
        (row,) = res[key]
        assert row["devices"] == 1 and row["efficiency"] == 1.0
        assert row["pixels_per_s"] > 0
    assert res["strong_tile_fused"][0]["pixels_per_s_shard_opt"] > 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--mesh")
    ap.add_argument("--rendezvous")
    ap.add_argument("--inp")
    ap.add_argument("--out")
    ap.add_argument("--n", type=int)
    ap.add_argument("--shard_opt", action="store_true")
    ap.add_argument("--max_instances", type=int, default=None)
    ap.add_argument("--max_tiles_per_gauss", type=int, default=None)
    _worker(ap.parse_args())
