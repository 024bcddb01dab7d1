#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (gaussianimage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (with ``elapsed_s``):

1. env       torch, CUDA, nvcc, Triton / ninja presence, the card's name
             and power limit;
2. build     every CUDA kernel of the port from the sources in this
             checkout (one nvcc per source, started together);
3. kernel    each kernel against its plain PyTorch version on the card, at
             the main path's shapes: K1 (render) to max |diff| <= 1e-5; K2
             (backward) and K3 (fused render + L2 + backward) on the
             flower@10k stream, their gradient rows to 1e-4 of each
             column's largest magnitude; K3 also against K1 -> L2
             cotangent -> K2 (1e-6), and twice on the same step (K3 and the
             scatter), which must give bit-identical gradients;
4. slice     the evaluation entry point ``gaussianimage_tpu_torch.train
             --iterations 0`` on the fitted flower@10k checkpoint
             (768x512): PSNR within 0.01 dB of 41.906, n_dropped == 0, K1
             launched;
5. fit       ``SimpleTrainer2d`` (the class the CLI runs) fits the flower
             photo at N = 10,000 for 5000 iterations with the CLI defaults
             (adaptive init, 6 reseed rounds), in a temp dir: test PSNR
             >= 38.5 dB, no NaN loss, n_dropped 0 in every chunk, and
             >= 5000 K3 launches; the training PSNR every 1000 iterations;
6. generic   50 steps of the model's train_step under a non-L2 loss
             (Fusion2 = 0.7 L1 + 0.3 (1 - SSIM)), which renders through
             the differentiable rasterizer: K1 forward, K2 backward;
7. timing    each kernel and its plain version, the render, a training
             step over a 250-step burst, with each kernel's bound from this
             run's pair counts; torch.profiler traces of 20 launches of
             each kernel give its device time per launch, and traces of
             one FPS-probe burst and of 50 training steps the device time
             by kernel, launches and host operator calls per frame or
             step, and the device busy share.

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
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLOWER_DIR = ROOT / "results/photos/GaussianImage_Cholesky_50000_10000"
FLOWER_PHOTO = ROOT / "data/flower_768x512.png"
FLOWER_PSNR = 41.906  # the JAX package's render of this checkpoint
K1_TOL = 1e-5      # max |diff| of the render, K1 against its plain version
ROW_TOL = 1e-4     # gradient rows: |diff| <= ROW_TOL x the column's max |.|
CHAIN_TOL = 1e-6   # K3 against K1 -> L2 cotangent -> K2, same relative form
MAX_FLIPS = 16     # pixels whose clip mask differs, K3 against plain
# K3 against plain: rows of a tile that holds a flipped pixel may miss by up
# to FLIP_ROW_TOL x the column max; every other row is held to ROW_TOL
FLIP_ROW_TOL = 1e-2
FIT_ITERS = 5000
FIT_PSNR = 38.5
GENERIC_STEPS = 50

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


def pair_work(rs, feat, gids, starts, H, W, q_cut):
    """(pairs, gated pairs) the kernels evaluate on this data: (instance,
    pixel) pairs of a window's slot and a pixel inside the image, and those
    that pass the q <= q_cut gate."""
    pairs = gated = 0
    for pr in rs.window_pairs(feat, gids, starts, H, W):
        pairs += int(pr.inside.sum())
        gated += int((pr.inside & (pr.q <= q_cut)).sum())
    return pairs, gated


def bound(instr: float, mufu: float, nbytes: float):
    """(bound ms, bound_by): the larger of the FP32 issue-slot and MUFU
    times at the card's peak and the byte time at its memory rate."""
    t_ops = max(instr / PEAK_F32_INSTR_S, mufu / PEAK_MUFU_S)
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def row_err(torch, got, want):
    """Per-row max of |got - want| / the column's max |want| (columns with
    a zero max compare absolutely)."""
    scale = want.abs().amax(dim=0).clamp(min=1e-30)
    return ((got - want).abs() / scale).amax(dim=1)


def _us_per_launch(kernels, name):
    hits = [e for e in kernels if name in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n if n else None


def profile_of(torch, fn, n: int, ported):
    """``fn`` (``n`` frames or steps, queued without synchronising) under
    torch.profiler, after one untraced run: device time, launches and host
    operator calls per frame or step, device busy share, device time by
    kernel, and each ported kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.key_averages()
    # device-side ranges of user annotations (the optimizer step's) span
    # kernels already counted: keep kernels only
    kernels = sorted((e for e in events if e.device_type == cuda
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")),
                     key=lambda e: -e.self_device_time_total)
    host_ops = [e for e in events
                if e.device_type == cpu and e.key.startswith("aten::")]
    dev_us = sum(e.self_device_time_total for e in kernels)
    wall_us = max(e.time_range.end for e in prof.events()) - min(
        e.time_range.start for e in prof.events())
    return {
        "count": n,
        "device_kernel_ms_per": dev_us / 1e3 / n,
        "wall_ms_per_profiled": wall_us / 1e3 / n,
        "device_busy_share_profiled": dev_us / max(wall_us, 1e-9),
        "kernel_launches_per": sum(e.count for e in kernels) / n,
        "host_op_calls_per": sum(e.count for e in host_ops) / n,
        "kernels_us_per": {e.key[:60]: e.self_device_time_total / n
                           for e in kernels[:10]},
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

    import numpy as np

    from gaussianimage_tpu_torch import train
    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import _build
    from gaussianimage_tpu_torch.ops import rasterize_sum as rs
    from gaussianimage_tpu_torch.ops import stream_common as sc
    from gaussianimage_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          params_from_numpy)
    from gaussianimage_tpu_torch.utils.image_io import image_path_to_array

    dev = torch.device("cuda", 0)
    counters = {"rasterize_sum_fwd": rs.sum_fwd,
                "rasterize_sum_bwd": rs.sum_bwd,
                "rasterize_sum_l2": rs.sum_l2}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}

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
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
    phase("build", seconds=round(time.time() - t, 3),
          libraries=[p.name for p in libs.values()], ptxas=ptxas)

    # -- kernel: each kernel against its plain version on the card -----------
    def stream_inputs(model):
        with torch.no_grad():
            xys, radii, conics, colors, opac = model.splat()
            cfg = model.cfg.raster
            rxy = rs._axis_radii(conics, radii.float(), cfg.q_cut)
            sp = sc.prepare_stream(xys, rxy, model.cfg.H, model.cfg.W, cfg)
            feat = sc.pack_feat(xys, conics, colors, opac, premultiply=True)
        return feat, sp

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
        if not (math.isfinite(err) and err <= K1_TOL):
            fail(f"K1 disagrees with its plain version on {name}: "
                 f"max |diff| {err} > {K1_TOL}")
        cases[name] = {"shape": list(out.shape), "max_abs_err": err,
                       "instances": int(sp.starts[sp.T]),
                       "n_dropped": int(sp.n_dropped)}
    k1_err = max(c["max_abs_err"] for c in cases.values())

    feat, sp = stream_inputs(flower)
    Hf, Wf = flower.cfg.H, flower.cfg.W
    q_cut = float(flower.cfg.raster.q_cut)
    n_live = int(sp.starts[sp.T])
    live = slice(0, n_live)
    gt_f = torch.as_tensor(image_path_to_array(FLOWER_PHOTO)[0],
                           device=dev).contiguous()  # [3, H, W]

    # K2 on a cotangent drawn from a fixed seed
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, Hf, Wf)).astype(np.float32) * 1e-5, device=dev)
    dg2 = rs.sum_bwd(feat, sp.gids, sp.starts, g, Hf, Wf)
    torch.cuda.synchronize()
    dg2_plain = rs.sum_bwd_plain(feat, sp.gids, sp.starts, g, Hf, Wf)
    e2 = row_err(torch, dg2[live], dg2_plain[live])
    k2_err = float((dg2[live] - dg2_plain[live]).abs().max())
    if not (torch.isfinite(dg2).all() and float(e2.max()) <= ROW_TOL):
        fail(f"K2 disagrees with its plain version: worst row "
             f"{float(e2.max())} > {ROW_TOL} of the column max")

    # K3 against its plain version, against K1 -> L2 -> K2, and twice
    sse3, dg3 = rs.sum_l2(feat, sp.gids, sp.starts, gt_f, Hf, Wf)
    torch.cuda.synchronize()
    sse3_plain, dg3_plain = rs.sum_l2_plain(feat, sp.gids, sp.starts, gt_f,
                                            Hf, Wf)
    img_k = rs.sum_fwd(feat, sp.gids, sp.starts, Hf, Wf)[:3]
    img_p = rs.sum_fwd_plain(feat, sp.gids, sp.starts, Hf, Wf)[:3]
    flipped = (((img_k > 0) & (img_k < 1)) != ((img_p > 0) & (img_p < 1))
               ).any(dim=0).nonzero()                         # [f, 2] (y, x)
    flips = int(flipped.shape[0])
    flip_tiles = torch.zeros(sp.T, dtype=torch.bool, device=dev)
    tp = flower.cfg.raster.tile_px
    flip_tiles[(flipped[:, 0] // tp) * sp.tiles_x + flipped[:, 1] // tp] = True
    slot_tile = torch.searchsorted(
        sp.starts.long(), torch.arange(n_live, device=dev), right=True) - 1
    in_flip_tile = flip_tiles[slot_tile]
    e3 = row_err(torch, dg3[live], dg3_plain[live])
    k3_err = float((dg3[live] - dg3_plain[live]).abs().max())
    bad_rows = int((e3 > ROW_TOL).sum())
    worst_clean = float(e3[~in_flip_tile].max())
    worst_flip = float(e3[in_flip_tile].max()) if flips else 0.0
    sse_rel = abs(float(sse3.sum()) / float(sse3_plain.sum()) - 1)
    if not torch.isfinite(dg3).all() or sse_rel > 1e-5:
        fail(f"K3's SSE is {float(sse3.sum())}, its plain version's "
             f"{float(sse3_plain.sum())}")
    if (flips > MAX_FLIPS or worst_clean > ROW_TOL
            or worst_flip > FLIP_ROW_TOL):
        fail(f"K3 disagrees with its plain version: {flips} clip-mask flips "
             f"(<= {MAX_FLIPS}); worst row {worst_clean} of the column max "
             f"outside the flipped pixels' tiles (<= {ROW_TOL}), "
             f"{worst_flip} inside them (<= {FLIP_ROW_TOL})")
    _, G = rs.l2_cotangent(img_k, gt_f, Hf, Wf)
    dg_chain = rs.sum_bwd(feat, sp.gids, sp.starts, G.contiguous(), Hf, Wf)
    e_chain = float(row_err(torch, dg3[live], dg_chain[live]).max())
    if e_chain > CHAIN_TOL:
        fail(f"K3 disagrees with K1 -> L2 -> K2: worst row {e_chain} > "
             f"{CHAIN_TOL} of the column max")
    dfeat = [sc.scatter_stream_grads(
        rs.sum_l2(feat, sp.gids, sp.starts, gt_f, Hf, Wf)[1], sp.gids,
        feat.shape[0], sp.m_span) for _ in range(2)]
    deterministic = bool(torch.equal(dfeat[0], dfeat[1]))
    if not deterministic:
        fail("two runs of K3 and the scatter on the same step differ")
    phase("kernel", k1={"tol": K1_TOL, "cases": cases},
          k2={"row_tol": ROW_TOL, "worst_row": float(e2.max()),
              "max_abs_err": k2_err, "instances": n_live},
          k3={"row_tol": ROW_TOL, "worst_row": float(e3.max()),
              "rows_past_tol": bad_rows, "clip_flips": flips,
              "worst_row_in_flip_tiles": worst_flip,
              "flip_row_tol": FLIP_ROW_TOL,
              "max_abs_err": k3_err, "sse": float(sse3.sum()),
              "sse_rel_err": sse_rel, "vs_k1_l2_k2_worst_row": e_chain,
              "chain_tol": CHAIN_TOL, "bit_identical_twice": deterministic})

    # -- slice: the evaluation entry point, counts read around it ------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        reset_counts()
        results = train.main([
            "--data_name", "photos", "--dataset", str(ROOT / "data"),
            "--model_path", str(FLOWER_DIR), "--iterations", "0",
            "--num_points", "10000", "--checkpoint_root", out_dir,
            "--save_imgs"])
        eval_counts = read_counts()
        log = (Path(out_dir) / "photos" / "GaussianImage_Cholesky_0_10000"
               / "flower" / "train.txt").read_text()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    by_image = {r["image"]: r for r in results}
    fl = by_image["flower"]
    if eval_counts["rasterize_sum_fwd"] == 0:
        fail("the evaluation run never launched K1")
    if any(r["n_dropped"] != 0 for r in results):
        fail(f"instances dropped: {[r['n_dropped'] for r in results]}")
    if abs(fl["psnr"] - FLOWER_PSNR) > 0.01:
        fail(f"flower PSNR {fl['psnr']} is not within 0.01 dB of "
             f"{FLOWER_PSNR}")
    if "MS_SSIM:" not in log or not math.isfinite(fl["ms_ssim"]):
        fail("no MS-SSIM in the flower train.txt")
    phase("slice", launches=eval_counts,
          images={k: {m: r[m] for m in ("psnr", "ms_ssim", "fps",
                                        "eval_time", "n_dropped")}
                  for k, r in by_image.items()},
          train_txt=log.strip().splitlines()[-2:])

    # -- fit: SimpleTrainer2d on the flower photo ----------------------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        reset_counts()
        trainer = train.SimpleTrainer2d(
            image_path_to_array(FLOWER_PHOTO), "flower", num_points=10000,
            iterations=FIT_ITERS, args=train.parse_args([]),
            log_dir=Path(out_dir) / "flower", device=dev)
        fit = trainer.train()
        fit_counts = read_counts()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = np.asarray(trainer._hist["loss"])
    hist_psnr = dict(zip(trainer._hist["iter"], trainer._hist["psnr"]))
    if fit_counts["rasterize_sum_l2"] < FIT_ITERS:
        fail(f"the fit launched K3 {fit_counts['rasterize_sum_l2']} times, "
             f"fewer than its {FIT_ITERS} steps")
    if not np.isfinite(losses).all() or len(losses) != FIT_ITERS:
        fail(f"{len(losses)} losses, {int((~np.isfinite(losses)).sum())} "
             "not finite")
    if any(trainer.chunk_dropped):
        fail(f"instances dropped during the fit: {trainer.chunk_dropped}")
    if fit["n_dropped"] != 0 or not fit["psnr"] >= FIT_PSNR:
        fail(f"fit test PSNR {fit['psnr']} (< {FIT_PSNR}?), n_dropped "
             f"{fit['n_dropped']}")
    phase("fit", iterations=FIT_ITERS, launches=fit_counts,
          reseed_iterations=list(trainer._reseed_iters),
          training_psnr_every_1000={i: hist_psnr[i] for i in
                                    range(1000, FIT_ITERS + 1, 1000)},
          test_psnr=fit["psnr"], ms_ssim=fit["ms_ssim"],
          training_s=fit["training_time"],
          ms_per_step_incl_reseed=1e3 * fit["training_time"] / FIT_ITERS,
          fps=fit["fps"], n_dropped_chunks_max=max(trainer.chunk_dropped))
    fitted = trainer.model

    # -- generic: a non-L2 loss through the differentiable rasterizer --------
    gt_nchw = torch.as_tensor(image_path_to_array(FLOWER_PHOTO), device=dev)
    generic = make_model("GaussianImage_Cholesky", device=dev,
                         num_points=10000, H=512, W=768,
                         loss_type="Fusion2", init_mode="adaptive")
    opt = generic.init_state(torch.Generator(device=dev).manual_seed(1),
                             gt_image=gt_nchw)
    reset_counts()
    gen_losses = [generic.train_step(opt, gt_nchw)["loss"]
                  for _ in range(GENERIC_STEPS)]
    generic_counts = read_counts()
    gen_losses = torch.stack(gen_losses).cpu().numpy()
    if (generic_counts["rasterize_sum_bwd"] < GENERIC_STEPS
            or generic_counts["rasterize_sum_fwd"] < GENERIC_STEPS):
        fail(f"the Fusion2 steps launched {generic_counts}")
    if not (np.isfinite(gen_losses).all()
            and gen_losses[-1] < gen_losses[0]):
        fail(f"the Fusion2 loss went {gen_losses[0]} -> {gen_losses[-1]}")
    phase("generic", loss_type="Fusion2", steps=GENERIC_STEPS,
          launches=generic_counts, loss_first=float(gen_losses[0]),
          loss_last=float(gen_losses[-1]))

    # -- timing ---------------------------------------------------------------
    ms, plain = {}, {}
    ms["rasterize_sum_fwd"] = burst_ms(
        torch, lambda: rs.sum_fwd(feat, sp.gids, sp.starts, Hf, Wf), reps=50)
    ms["rasterize_sum_bwd"] = burst_ms(
        torch, lambda: rs.sum_bwd(feat, sp.gids, sp.starts, g, Hf, Wf),
        reps=50)
    ms["rasterize_sum_l2"] = burst_ms(
        torch, lambda: rs.sum_l2(feat, sp.gids, sp.starts, gt_f, Hf, Wf),
        reps=50)
    plain["rasterize_sum_fwd"] = burst_ms(torch, lambda: rs.sum_fwd_plain(
        feat, sp.gids, sp.starts, Hf, Wf), reps=5, warmup=1)
    plain["rasterize_sum_bwd"] = burst_ms(torch, lambda: rs.sum_bwd_plain(
        feat, sp.gids, sp.starts, g, Hf, Wf), reps=5, warmup=1)
    plain["rasterize_sum_l2"] = burst_ms(torch, lambda: rs.sum_l2_plain(
        feat, sp.gids, sp.starts, gt_f, Hf, Wf), reps=5, warmup=1)
    with torch.no_grad():
        render_ms = burst_ms(torch, flower.render, reps=30)
    step_opt = fitted.make_optimizer()
    gt_fit = trainer.gt_image
    step_ms = burst_ms(torch, lambda: fitted.train_step(step_opt, gt_fit),
                       reps=250, warmup=10)
    ported = tuple(counters)
    with torch.no_grad():
        render_prof = profile_of(torch, lambda: train.render_burst(flower),
                                 train.FPS_FRAMES, ported)

    def steps50():
        for _ in range(50):
            fitted.train_step(step_opt, gt_fit)

    step_prof = profile_of(torch, steps50, 50, ported)
    launch = {
        "rasterize_sum_fwd": lambda: rs.sum_fwd(feat, sp.gids, sp.starts,
                                                Hf, Wf),
        "rasterize_sum_bwd": lambda: rs.sum_bwd(feat, sp.gids, sp.starts, g,
                                                Hf, Wf),
        "rasterize_sum_l2": lambda: rs.sum_l2(feat, sp.gids, sp.starts, gt_f,
                                              Hf, Wf)}
    device_ms = {}
    for k, fn in launch.items():
        us = profile_of(torch, lambda: [fn() for _ in range(20)], 20,
                        (k,))["ported_us_per_launch"][k]
        device_ms[k] = None if us is None else us / 1e3

    pairs, gated = pair_work(rs, feat, sp.gids, sp.starts, Hf, Wf, q_cut)
    plane = Hf * Wf
    stream_bytes = 4 * (feat.numel() + n_live + sp.starts.numel())
    # FP32 issue slots, an FMA counted as one. K1 per pair: dy, 3
    # multiplies, 2 adds, clamp, compare (8) and 1 for the per-column terms
    # shared by a thread's 4 pixels; per gated pair: -q/2, expf's 4 FP32
    # instructions around its MUFU ex2, 4 multiplies + 4 adds (13 + 1 ex2).
    # The backward walk per pair: the same 9 for q and the gate; per gated
    # pair: -q/2 and expf (5 + 1 ex2), dw (4 FMA), dq (2), dq dx and dq dy
    # (2), the five moments (5) and the four dcm sums (4 FMA): 22 + 1 ex2.
    work = {
        "rasterize_sum_fwd": (9 * pairs + 13 * gated, gated,
                              stream_bytes + 4 * 4 * plane),
        "rasterize_sum_bwd": (9 * pairs + 22 * gated, gated,
                              stream_bytes + 4 * 4 * plane
                              + 4 * 16 * n_live),
        "rasterize_sum_l2": (18 * pairs + 35 * gated, 2 * gated,
                             stream_bytes + 4 * 3 * plane
                             + 4 * sse3.numel() + 4 * 16 * n_live),
    }
    bounds = {k: bound(*v) for k, v in work.items()}
    phase("timing", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
          kernel_ms=ms, kernel_device_ms=device_ms, plain_ms=plain,
          bound_ms={k: b[0] for k, b in bounds.items()},
          bound_by={k: b[1] for k, b in bounds.items()},
          fp32_instr={k: v[0] for k, v in work.items()},
          mufu={k: v[1] for k, v in work.items()},
          bytes={k: v[2] for k, v in work.items()},
          pairs=pairs, gated_pairs=gated, instances=n_live,
          render_ms=render_ms, train_step_ms=step_ms,
          fps_probe={k: r["fps"] for k, r in by_image.items()},
          render_profile=render_prof, train_step_profile=step_prof)

    print(smi, flush=True)
    replaces = {"rasterize_sum_fwd": "gaussianimage_tpu/ops/rasterize_sum.py:205",
                "rasterize_sum_bwd": "gaussianimage_tpu/ops/rasterize_sum.py:280",
                "rasterize_sum_l2": "gaussianimage_tpu/ops/rasterize_sum.py:618"}
    sources = {"rasterize_sum_fwd": "rasterize_sum_fwd.cu",
               "rasterize_sum_bwd": "rasterize_sum_bwd.cu",
               "rasterize_sum_l2": "rasterize_sum_bwd.cu"}
    launches = {"rasterize_sum_fwd": eval_counts["rasterize_sum_fwd"],
                "rasterize_sum_bwd": generic_counts["rasterize_sum_bwd"],
                "rasterize_sum_l2": fit_counts["rasterize_sum_l2"]}
    errs = {"rasterize_sum_fwd": k1_err, "rasterize_sum_bwd": k2_err,
            "rasterize_sum_l2": k3_err}
    emit({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"gaussianimage_tpu_torch/ops/csrc/{sources[k]}",
        "replaces": replaces[k],
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": ms[k],
        "device_ms": device_ms[k],
        "plain_ms": plain[k],
        "bound_ms": bounds[k][0],
        "bound_by": bounds[k][1],
        "library_ms": None,
    } for k in counters]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
