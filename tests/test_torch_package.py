"""The port stands alone and runs on CUDA unless told otherwise:
gaussianimage_tpu_torch imports neither JAX nor the JAX package; its entry
points raise without a GPU when the CPU was not asked for; its import sets
up torch's CPU vector math on one thread; chip_smoke.py exits non-zero,
with no result line, where there is no card or no repository around it;
checkpoints round-trip with the JAX package."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import gaussianimage_tpu_torch, gaussianimage_tpu_torch.train\n"
        "import gaussianimage_tpu_torch.ops._build\n"
        "import gaussianimage_tpu_torch.test_quantize\n"
        "import gaussianimage_tpu_torch.ops.splat_prep\n"
        "import gaussianimage_tpu_torch.codec.rans\n"
        "import gaussianimage_tpu_torch.codec.bitstream\n"
        "import gaussianimage_tpu_torch.models.quantize_mixin\n"
        "import gaussianimage_tpu_torch.train_quantize\n"
        "import gaussianimage_tpu_torch.batched\n"
        "import gaussianimage_tpu_torch.ops.rasterize_blend\n"
        "import gaussianimage_tpu_torch.models.gs3d\n"
        "import gaussianimage_tpu_torch.blend_caps_probe\n"
        "import gaussianimage_tpu_torch.blend_cull_scene\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'gaussianimage_tpu' "
        "or m.startswith('gaussianimage_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    p = _run(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "clean"



def test_cpu_vector_math_is_set_up_on_import():
    """torch's CPU exp, log, sin, cos, tanh and sqrt of float tensors go
    through MKL's vector math, whose first use sets it up without a lock: a
    first call that torch splits across threads can compute one thread's
    chunk on a wrong path (cos off by up to 2534 ulps on half of 4096
    angles, in up to 5% of fresh processes started eight at a time).
    Importing the port makes that first use on one thread. In 16 fresh
    processes that import it, started eight at a time, the first split call
    of cos (4096 angles on two threads) is within one ulp of the float64
    cosine on every element."""
    code = (
        "import numpy as np, torch\n"
        "import gaussianimage_tpu_torch\n"
        "torch.set_num_threads(2)\n"
        "x = np.random.default_rng(0).uniform(0.0, 6.28, 4096)"
        ".astype(np.float32)\n"
        "c = torch.cos(torch.from_numpy(x)).numpy()\n"
        "r = np.cos(x.astype(np.float64)).astype(np.float32)\n"
        "print(int(np.abs(c.view(np.int32).astype(np.int64)"
        " - r.view(np.int32).astype(np.int64)).max()))\n")
    ulps = []
    for _ in range(2):
        procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(8)]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            ulps.append(int(out.strip()))
    assert max(ulps) <= 1, ulps

def test_port_sources_do_not_name_jax():
    for path in [*(ROOT / "gaussianimage_tpu_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "gaussianimage_tpu"), \
                    f"{path}: {s}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gaussianimage_tpu_torch import resolve_device
    from gaussianimage_tpu_torch import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--data_name", "synthetic", "--iterations", "0",
                    "--num_points", "10", "--model_path", "unused.npz"])
    from gaussianimage_tpu_torch import test_quantize
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_quantize.main(["--data_name", "synthetic", "--num_points",
                            "10"])
    from gaussianimage_tpu_torch import train_quantize
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_quantize.main(["--data_name", "synthetic", "--num_points",
                             "10"])


def test_training_and_other_models_are_not_ported(tmp_path, monkeypatch):
    """wMask and --profile are ported since this test was written, and
    with them every model and every flag of the JAX fit CLI: the wMask
    model builds (on the CPU when asked), the parser takes the ten mask
    flags with JAX's defaults, ``--profile`` writes a torch.profiler trace
    of the second chunk and logs where, and an unknown model name still
    raises."""
    import itertools

    from gaussianimage_tpu_torch import train
    from gaussianimage_tpu_torch.models import make_model

    args = train.parse_args(["--data_name", "synthetic", "--iterations",
                             "10", "--device", "cpu"])
    assert args.iterations == 10 and args.init_mode == "adaptive"
    assert (args.start_mask_training, args.stop_mask_training,
            args.reg_type, args.target_sparsity, args.lambda_reg,
            args.init_mask_logit, args.use_ema, args.use_score,
            args.temp_init, args.temp_final) == (
        0, 50000, "kl", 0.7, 0.005, 2.0, False, False, 0.5, 0.5)
    m = make_model("GaussianImage_Cholesky_wMask", device="cpu",
                   num_points=4, H=8, W=8)
    assert type(m).__name__ == "GaussianImageCholeskyMask"
    assert tuple(m._mask_logits.shape) == (4, 1)
    assert not (m.fused_l2 or m.fused_prep_ok or m.reseed_ok)
    gs = make_model("3DGS", device="cpu", num_points=4, H=8, W=8)
    assert type(gs).__name__ == "Gaussian3D" and gs.cfg.sh_degree == 3
    assert tuple(gs._features_rest.shape) == (4, 15, 3)
    with pytest.raises(ValueError, match="unknown model"):
        make_model("NoSuchModel", num_points=4, H=8, W=8)

    real = train.iterate_dataset
    monkeypatch.setattr(
        train, "iterate_dataset",
        lambda name, d: itertools.islice(real(name, d, image_hw=(32, 48)), 1))
    prof = tmp_path / "prof"
    train.main(["--data_name", "synthetic", "--iterations", "4",
                "--chunk_size", "2", "--num_points", "32", "--device", "cpu",
                "--viz_every", "0", "--checkpoint_root", str(tmp_path),
                "--model_name", "GaussianImage_Cholesky_wMask",
                "--profile", str(prof)])
    trace = json.loads((prof / "synth01.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mul" in n for n in names), sorted(names)[:20]
    txt = (tmp_path / "synthetic" / "GaussianImage_Cholesky_wMask_4_32" /
           "synth01" / "train.txt").read_text()
    assert f"profiler trace written to {prof}" in txt


def test_cuda_wrapper_never_falls_back():
    """A non-CPU tensor either launches K1 or raises: on a meta tensor (no
    CUDA here) the wrapper refuses instead of taking the plain version."""
    from gaussianimage_tpu_torch.ops import rasterize_sum as rs

    feat = torch.zeros(5, 16, device="meta")
    gids = torch.zeros(64, dtype=torch.int32, device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rs.sum_fwd(feat, gids, starts, 32, 32)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(["chip_smoke.py"], tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_checkpoint_round_trip_with_jax_package(tmp_path):
    from gaussianimage_tpu.utils.checkpoint import load_checkpoint as j_load
    from gaussianimage_tpu.utils.checkpoint import save_checkpoint as j_save
    from gaussianimage_tpu_torch.utils.checkpoint import (
        load_checkpoint, params_from_numpy, save_checkpoint)

    rng = np.random.default_rng(0)
    params = {"_xyz": rng.normal(size=(7, 2)).astype(np.float32),
              "_cholesky": rng.normal(size=(7, 3)).astype(np.float32)}
    j_save(tmp_path / "j.npz", params, {"step": np.int32(3)})
    ck = load_checkpoint(tmp_path / "j.npz")
    assert int(ck["extra"]["step"]) == 3
    state = params_from_numpy(ck["params"])
    assert all(v.dtype == torch.float32 for v in state.values())
    save_checkpoint(tmp_path / "t.npz", state)
    back = j_load(tmp_path / "t.npz")["params"]
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    assert json.dumps(sorted(back)) == json.dumps(sorted(params))
