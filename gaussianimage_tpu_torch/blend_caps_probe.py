"""3DGS fits of one photo under the blend stream's default caps and under
lifted ones, to see what the caps' dropped instances do to a growing fit.

The model's stream holds ``auto_max_instances`` slots (40,000 at N = 10,000)
and each Gaussian at most ``m_span`` tiles (12 there), the JAX package's
caps. A fit whose Gaussians grow past them loses (Gaussian, tile) instances:
those pixels neither see the Gaussian nor send it a gradient. Variants:

- ``default``: the model's caps;
- ``lifted``: ``max_instances`` at the flat stream's limit and the span
  widened to ``--span`` tiles;
- ``uncapped``: the span at ``--span`` tiles and a stream of N x span
  slots, which no fit can overflow (the aligned stream): only the span's
  truncation drops instances.

All start from the same seed and run the CLI's defaults (Fusion2, Adan, lr
1e-3, sh_degree 3).

Per variant it prints one JSON line: the worst ``n_dropped`` of every
250-step chunk, the training PSNR at each chunk's end, its peak and where,
and the test PSNR, MS-SSIM and ``n_dropped`` of the final render.

Run:  python -m gaussianimage_tpu_torch.blend_caps_probe \\
        [--image data/flower_768x512.png] [--num_points 10000] \\
        [--iterations 5000] [--span 96] [--variants default lifted uncapped] \\
        [--out result.jsonl] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gaussianimage_tpu_torch import resolve_device
from gaussianimage_tpu_torch import train
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.utils.image_io import image_path_to_array

VARIANTS = ("default", "lifted", "uncapped")


def fit(gt, name, num_points, iterations, variant, span, device, log_dir):
    """One fit under ``variant``'s caps (see the module docstring).
    Returns the variant's record."""
    trainer = train.SimpleTrainer2d(
        gt, name, num_points=num_points, model_name="3DGS",
        iterations=iterations,
        args=train.parse_args(["--model_name", "3DGS"]),
        log_dir=log_dir / variant, device=device)
    model = trainer.model
    if variant == "lifted":
        model.blend_cfg = model.blend_cfg._replace(
            max_instances=model.blend_cfg.flat_stream_limit,
            max_tiles_per_gauss=span)
    elif variant == "uncapped":
        model.blend_cfg = model.blend_cfg._replace(
            max_instances=num_points * span, max_tiles_per_gauss=span)
    caps = sc.stream_caps(num_points, model.blend_cfg)
    t0 = time.time()
    trainer.fit()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    wall = time.time() - t0
    psnr, msv, _, n_dropped = trainer.test()
    hist = trainer._hist
    cs = trainer.chunk_size
    ends = list(range(cs, iterations + 1, cs))
    psnr_at = [hist["psnr"][i - 1] for i in ends]
    peak = int(np.argmax(hist["psnr"]))
    return {"variant": variant, "num_points": num_points,
            "iterations": iterations, "stream_slots": caps[0],
            "tile_span": caps[1],
            "blend_cfg": {k: getattr(model.blend_cfg, k) for k in
                          ("tile_px", "max_instances",
                           "max_tiles_per_gauss")},
            "chunk_ends": ends, "chunk_n_dropped": trainer.chunk_dropped,
            "chunk_training_psnr": psnr_at,
            "peak_training_psnr": hist["psnr"][peak],
            "peak_iteration": hist["iter"][peak],
            "test_psnr": psnr, "ms_ssim": msv, "test_n_dropped": n_dropped,
            "fit_s": wall}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", type=str, default="data/flower_768x512.png")
    p.add_argument("--num_points", type=int, default=10000)
    p.add_argument("--iterations", type=int, default=5000)
    p.add_argument("--span", type=int, default=96,
                   help="tiles one Gaussian may cover in the lifted fit")
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=VARIANTS)
    p.add_argument("--out", type=str, default=None,
                   help="also append the JSON lines to this file")
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    gt = image_path_to_array(Path(args.image))
    name = Path(args.image).stem
    records = []
    with tempfile.TemporaryDirectory(prefix="blend_caps_") as tmp:
        for variant in args.variants:
            rec = fit(gt, name, args.num_points, args.iterations, variant,
                      args.span, device, Path(tmp))
            if device.type == "cuda":
                rec["device"] = torch.cuda.get_device_name(device)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
