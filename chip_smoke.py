#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (gaussianimage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (with ``elapsed_s``):

1. env     torch, CUDA, nvcc, Triton / ninja presence, the card's name and
           power limit;
2. build   every CUDA kernel of the port from the sources in this checkout
           (one nvcc per source, started together);
3. kernel  each kernel against its plain PyTorch version on the card, at the
           main path's shapes (max |diff| <= 1e-5);
4. slice   the evaluation entry point ``gaussianimage_tpu_torch.train
           --iterations 0`` on the fitted flower@10k checkpoint (768x512):
           PSNR within 0.01 dB of 41.906, n_dropped == 0, and every kernel
           of the path launched during that run;
5. timing  kernel, plain version, whole render and the FPS probe, on the
           card, with each kernel's bound; a torch.profiler trace of one
           FPS-probe burst gives each kernel's device time and where a
           render's time goes (device busy share, launches and host
           operator calls per frame).

Then the raw ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that last line. It needs a CUDA card and a checkout of the
repository around it; without either it exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLOWER_DIR = ROOT / "results/photos/GaussianImage_Cholesky_50000_10000"
FLOWER_PSNR = 41.906  # the JAX package's render of this checkpoint
KERNEL_TOL = 1e-5

# H100 SXM published peaks (dense, no sparsity) at the full 700 W limit
PEAK_BYTES_S = 3.35e12
# 67 TFLOP/s FP32 outside the tensor cores counts an FMA as 2 flops: one
# FP32 instruction per lane per clock (132 SMs x 128 lanes x 1.98 GHz)
PEAK_F32_INSTR_S = 67e12 / 2
PEAK_MUFU_S = PEAK_F32_INSTR_S / 8  # SFU: 16 results/clk/SM vs 128 lanes

T0 = time.time()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str, **kw) -> None:
    emit({"phase": name, "elapsed_s": round(time.time() - T0, 3), **kw})


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd) -> str:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (p.stdout or p.stderr).strip()


def burst_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """ms per call: one CUDA event pair around ``reps`` back-to-back calls,
    so each call's host work overlaps the device work queued before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def k1_work(rs, feat, gids, starts, H, W, q_cut):
    """(pairs, gated pairs) K1 evaluates on this data: (instance, pixel)
    pairs of a live slot and a pixel inside the image, and those that pass
    the q <= q_cut gate."""
    pairs = gated = 0
    for _, _, q, inside in rs.window_pairs(feat, gids, starts, H, W):
        pairs += int(inside.sum())
        gated += int((inside & (q <= q_cut)).sum())
    return pairs, gated


def _us_per_launch(kernels, name):
    hits = [e for e in kernels if name in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n if n else None


def render_profile(torch, train, model, ported):
    """One FPS-probe burst under torch.profiler: per-frame device time,
    launches and host operator calls, device time by kernel, and the device
    time per launch of each ported kernel (by name)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        train.render_burst(model)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train.render_burst(model)
            torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == cuda),
                     key=lambda e: -e.self_device_time_total)
    host_ops = [e for e in events
                if e.device_type == cpu and e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in kernels)
    wall_us = max(e.time_range.end for e in prof.events()) - min(
        e.time_range.start for e in prof.events())
    n = train.FPS_FRAMES
    return {
        "frames": n,
        "device_kernel_ms_per_frame": dev_us / 1e3 / n,
        "device_busy_share_profiled": dev_us / max(wall_us, 1e-9),
        "kernel_launches_per_frame": sum(e.count for e in kernels) / n,
        "host_op_calls_per_frame": sum(e.count for e in host_ops) / n,
        "kernels_us_per_frame": {e.key[:60]: e.self_device_time_total / n
                                 for e in kernels[:8]},
        "ported_us_per_launch": {name: _us_per_launch(kernels, name)
                                 for name in ported},
    }


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "CUDA card")
    if not (ROOT / "gaussianimage_tpu_torch").is_dir():
        fail(f"no gaussianimage_tpu_torch package beside {__file__}: run it "
             "from a checkout of the repository")

    from gaussianimage_tpu_torch import train
    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import _build
    from gaussianimage_tpu_torch.ops import rasterize_sum as rs
    from gaussianimage_tpu_torch.ops import stream_common as sc
    from gaussianimage_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          params_from_numpy)

    dev = torch.device("cuda", 0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=run([_build.nvcc_path(), "--version"]).splitlines()[-1],
          driver=run(["nvidia-smi", "--query-gpu=driver_version",
                      "--format=csv,noheader"]),
          triton=importlib.util.find_spec("triton") is not None,
          ninja=shutil.which("ninja") is not None,
          device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi)

    # -- build --------------------------------------------------------------
    t = time.time()
    try:
        libs = _build.build()
    except RuntimeError as e:
        fail(f"kernel build failed:\n{e}")
    ptxas = []
    for p in libs.values():
        log = Path(str(p) + ".log")
        if log.is_file():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    phase("build", seconds=round(time.time() - t, 3),
          libraries=[p.name for p in libs.values()], ptxas=ptxas)

    # -- kernel: K1 against its plain version on the card ---------------------
    def stream_inputs(model):
        with torch.no_grad():
            xys, radii, conics, colors, opac = model.splat()
            cfg = model.cfg.raster
            rxy = rs._axis_radii(conics, radii.float(), cfg.q_cut)
            sp = sc.prepare_stream(xys, rxy, model.cfg.H, model.cfg.W, cfg)
            feat = sc.pack_feat(xys, conics, colors, opac, premultiply=True)
        return feat, sp

    import numpy as np
    rng = np.random.default_rng(0)
    N, H, W = 300, 70, 100
    small = make_model("GaussianImage_Cholesky", device=dev, num_points=N,
                       H=H, W=W)
    small.load_state_dict(params_from_numpy({
        "_xyz": rng.uniform(-1.6, 1.6, (N, 2)),
        "_cholesky": rng.uniform(0.0, 2.5, (N, 3)),
        "_features_dc": rng.uniform(-0.2, 1.0, (N, 3))}, dev))
    ckpt = load_checkpoint(FLOWER_DIR / "flower" / "gaussian_model.npz")
    flower = make_model("GaussianImage_Cholesky", device=dev,
                        num_points=ckpt["params"]["_xyz"].shape[0], H=512,
                        W=768)
    flower.load_state_dict(params_from_numpy(ckpt["params"], dev))

    cases = {}
    for name, model in (("random_300_70x100", small),
                        ("flower_10k_768x512", flower)):
        feat, sp = stream_inputs(model)
        Hm, Wm = model.cfg.H, model.cfg.W
        out = rs.sum_fwd(feat, sp.gids, sp.starts, Hm, Wm)
        torch.cuda.synchronize()
        ref = rs.sum_fwd_plain(feat, sp.gids, sp.starts, Hm, Wm)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (math.isfinite(err) and err <= KERNEL_TOL):
            fail(f"K1 disagrees with its plain version on {name}: "
                 f"max |diff| {err} > {KERNEL_TOL}")
        cases[name] = {"shape": list(out.shape), "max_abs_err": err,
                       "instances": int(sp.starts[sp.T]),
                       "n_dropped": int(sp.n_dropped)}
    phase("kernel", kernel="rasterize_sum_fwd", tol=KERNEL_TOL, cases=cases)
    k1_err = max(c["max_abs_err"] for c in cases.values())

    # -- slice: the evaluation entry point, counts read around it ------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        rs.sum_fwd.launches = 0
        results = train.main([
            "--data_name", "photos", "--dataset", str(ROOT / "data"),
            "--model_path", str(FLOWER_DIR), "--iterations", "0",
            "--num_points", "10000", "--checkpoint_root", out_dir,
            "--save_imgs"])
        torch.cuda.synchronize()
        k1_launches = rs.sum_fwd.launches
        log = (Path(out_dir) / "photos" / "GaussianImage_Cholesky_0_10000"
               / "flower" / "train.txt").read_text()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    by_image = {r["image"]: r for r in results}
    fl = by_image["flower"]
    if k1_launches == 0:
        fail("the evaluation run never launched K1")
    if any(r["n_dropped"] != 0 for r in results):
        fail(f"instances dropped: {[r['n_dropped'] for r in results]}")
    if abs(fl["psnr"] - FLOWER_PSNR) > 0.01:
        fail(f"flower PSNR {fl['psnr']} is not within 0.01 dB of "
             f"{FLOWER_PSNR}")
    if "MS_SSIM:" not in log or not math.isfinite(fl["ms_ssim"]):
        fail("no MS-SSIM in the flower train.txt")
    phase("slice", launches={"rasterize_sum_fwd": k1_launches},
          images={k: {m: r[m] for m in ("psnr", "ms_ssim", "fps",
                                        "eval_time", "n_dropped")}
                  for k, r in by_image.items()},
          train_txt=log.strip().splitlines()[-2:])

    # -- timing ---------------------------------------------------------------
    feat, sp = stream_inputs(flower)
    Hf, Wf = flower.cfg.H, flower.cfg.W
    q_cut = float(flower.cfg.raster.q_cut)
    k1_ms = burst_ms(torch, lambda: rs.sum_fwd(feat, sp.gids, sp.starts,
                                               Hf, Wf), reps=50)
    plain_ms = burst_ms(torch, lambda: rs.sum_fwd_plain(
        feat, sp.gids, sp.starts, Hf, Wf), reps=5, warmup=1)
    with torch.no_grad():
        render_ms = burst_ms(torch, flower.render, reps=30)
    prof = render_profile(torch, train, flower, ("rasterize_sum_fwd",))
    k1_dev_us = prof["ported_us_per_launch"]["rasterize_sum_fwd"]
    k1_dev_ms = None if k1_dev_us is None else k1_dev_us / 1e3
    pairs, gated = k1_work(rs, feat, sp.gids, sp.starts, Hf, Wf, q_cut)
    n_live = int(sp.starts[sp.T])
    # FP32 issue slots, FMA counted as one (K1 rounds op by op, so it has
    # none). Per pair: dy, b2dx*dy, c*dy, *dy, 2 adds, clamp, compare (8),
    # plus dx, a*dx*dx and 2b*dx shared by a thread's 4 pixels (1). Per
    # gated pair: -q/2, expf's 4 FP32 instructions around its MUFU ex2, and
    # 4 multiplies + 4 adds into the accumulators (13 + 1 MUFU).
    instr = 9 * pairs + 13 * gated
    nbytes = 4 * (feat.numel() + n_live + sp.starts.numel() + 4 * Hf * Wf)
    t_ops = max(instr / PEAK_F32_INSTR_S, gated / PEAK_MUFU_S)
    t_bytes = nbytes / PEAK_BYTES_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    phase("timing", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
          k1_ms=k1_ms, k1_device_ms=k1_dev_ms,
          k1_plain_ms=plain_ms, render_ms=render_ms,
          fps_probe={k: r["fps"] for k, r in by_image.items()},
          k1_bound_ms=bound_ms, k1_pairs=pairs, k1_gated_pairs=gated,
          k1_fp32_instr=instr, k1_bytes=nbytes, k1_instances=n_live,
          render_profile=prof)

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "rasterize_sum_fwd",
        "route": "cuda",
        "source": "gaussianimage_tpu_torch/ops/csrc/rasterize_sum_fwd.cu",
        "replaces": "gaussianimage_tpu/ops/rasterize_sum.py:205",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "kernel_ms": k1_ms,
        "device_ms": k1_dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
