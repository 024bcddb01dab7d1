"""Experiment summary and plotting tool (the port's copy of
gaussianimage_tpu/plotting.py; reference plot_script.py): globs the
per-image ``training.npy`` artifacts under a checkpoint root, parses the
experiment-name encodings, prints a text summary table, and renders PSNR /
MS-SSIM against the final Gaussian count as scatter plots with error bars.

The port's CLIs write ``training.npy`` in the JAX package's schema (the
reference's, train.py:251-253), so this reads the logs of either package
and of the reference code. It needs the standard library and NumPy;
matplotlib only for ``--out``.

Run:  python -m gaussianimage_tpu_torch.plotting --root ./checkpoints/kodak \
        [--out summary.png] [--filter substr ...] [--exclude substr ...]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from collections import defaultdict

import numpy as np


def parse_experiment_name(name: str) -> dict:
    """Decode experiment folder names, both the plain form
    ``<model>_<iters>_<points>[_flags]`` and the wMask form
    ``maskGI_Ch_<reg>_tgt<t>_lam<l>_init<i>_<iters>_<points>[_flags]``
    (reference name encodings: train.py:60-75)."""
    info = {"name": name, "mask": False}
    m = re.match(
        r"maskGI_Ch_(?P<reg>[a-z0-9_]+?)_tgt(?P<tgt>[\d.]+)_lam(?P<lam>[\d.]+)"
        r"_init(?P<init>[-\d.]+)_(?P<iters>\d+)_(?P<pts>\d+)(?P<flags>.*)",
        name)
    if m:
        info.update(mask=True, reg_type=m["reg"], target=float(m["tgt"]),
                    lam=float(m["lam"]), init_logit=float(m["init"]),
                    iterations=int(m["iters"]), num_points=int(m["pts"]),
                    flags=m["flags"])
        return info
    m = re.match(r"(?P<model>.+?)_(?P<iters>\d+)_(?P<pts>\d+)(?P<flags>.*)",
                 name)
    if m:
        info.update(model=m["model"], iterations=int(m["iters"]),
                    num_points=int(m["pts"]), flags=m["flags"])
    return info


def collect_runs(root: str, filters=(), excludes=()):
    """Returns {experiment_name: [per-image dicts]} from training.npy files."""
    runs = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(root, "*", "*",
                                              "training.npy"))):
        exp = os.path.basename(os.path.dirname(os.path.dirname(path)))
        if filters and not any(f in exp for f in filters):
            continue
        if any(e in exp for e in excludes):
            continue
        try:
            d = np.load(path, allow_pickle=True).item()
        except Exception:
            continue
        runs[exp].append(d)
    # also accept roots that point directly at an experiment dir
    for path in sorted(glob.glob(os.path.join(root, "*", "training.npy"))):
        exp = os.path.basename(root)
        d = np.load(path, allow_pickle=True).item()
        runs[exp].append(d)
    return dict(runs)


def summarize(runs) -> list:
    """Text table rows: (experiment, n_images, psnr, ms-ssim, final_points,
    params_K, fps)."""
    rows = []
    for exp, items in sorted(runs.items()):
        psnr = np.mean([d.get("psnr", np.nan) for d in items])
        ms = np.mean([d.get("ms-ssim", np.nan) for d in items])
        fpts = np.mean([d.get("final_points", np.nan) for d in items])
        fps = np.mean([d.get("rendering_fps", np.nan) for d in items])
        # params(K) = final_points * 8 attributes / 1000 (reference
        # plot_script.py:130-155 convention)
        rows.append((exp, len(items), psnr, ms, fpts, fpts * 8 / 1000, fps))
    return rows


def print_summary(rows):
    hdr = f"{'experiment':<60} {'imgs':>4} {'PSNR':>8} {'MS-SSIM':>8} " \
          f"{'points':>9} {'params(K)':>9} {'FPS':>9}"
    print(hdr)
    print("-" * len(hdr))
    for exp, n, psnr, ms, fpts, pk, fps in rows:
        print(f"{exp:<60} {n:>4} {psnr:>8.3f} {ms:>8.4f} {fpts:>9.0f} "
              f"{pk:>9.1f} {fps:>9.1f}")


def plot_comparison(runs, out_path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    for exp, items in sorted(runs.items()):
        pts = np.asarray([d.get("final_points", np.nan) for d in items], float)
        psnr = np.asarray([d.get("psnr", np.nan) for d in items], float)
        ms = np.asarray([d.get("ms-ssim", np.nan) for d in items], float)
        axes[0].errorbar(pts.mean(), psnr.mean(), yerr=psnr.std(),
                         xerr=pts.std(), fmt="o", capsize=3, label=exp)
        axes[1].errorbar(pts.mean(), ms.mean(), yerr=ms.std(),
                         xerr=pts.std(), fmt="o", capsize=3, label=exp)
    for ax, ylab in zip(axes, ["PSNR (dB)", "MS-SSIM"]):
        ax.set_xlabel("final #Gaussians")
        ax.set_ylabel(ylab)
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=7, loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print(f"wrote {out_path}")


def main(argv):
    p = argparse.ArgumentParser(description="summarize training.npy logs")
    p.add_argument("--root", type=str, required=True,
                   help="checkpoint root, e.g. ./checkpoints/kodak")
    p.add_argument("--out", type=str, default=None, help="plot output path")
    p.add_argument("--filter", nargs="*", default=[])
    p.add_argument("--exclude", nargs="*", default=[])
    args = p.parse_args(argv)
    runs = collect_runs(args.root, args.filter, args.exclude)
    if not runs:
        print(f"no training.npy artifacts under {args.root}")
        return
    print_summary(summarize(runs))
    if args.out:
        plot_comparison(runs, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
