"""Batched rendering and decoding: B frames in one rasterizer pass
(counterpart of gaussianimage_tpu/batched.py).

B frames of the same size are stacked vertically into one B*H x W canvas,
each frame's Gaussians shifted into its band of rows, and the whole stack
goes through one binning sort and one K1 launch. Per-frame containment is
exact: each Gaussian carries an inclusive tile-row ``band`` (ops/tiles.py),
so its instances bin only into its own frame's rows. The stacked image
equals the per-frame images up to the float32 rounding of frame f's
shifted y (y + f * H), which moves a few pixels' 3-sigma gate decisions in
frames f > 0, as in the JAX package.

The whole-dataset codec decode (``decode_many``) takes one of two
strategies:

- ``batched``: ``decompress_wo_ec_batch``, one stacked pass; with the
  fused prep the dequantization, projection, packing and keys of all B
  Cholesky frames are one K7 launch
  (``models/cholesky.py::fused_decode_batch``); a model without that
  method (RS) dequantizes and projects each frame on the generic path and
  rasterizes the stack once;
- ``scan``: a loop of single-frame decodes (the JAX package's ``lax.map``).

``prefer_batched`` picks one by the frame size, the number of frames and
the stacked stream's size (measured on the H100; see
``BATCHED_WIN_MAX_PIXELS``). The batched stream passes the flat layout's
limit above B*N = 65,536 Gaussians (3 instances each against 196,608); a
stacked decode there runs on the aligned stream (K11a, K1), but its speed
against the scan was not measured on the H100, so ``prefer_batched`` routes
such a batch to the scan, and only ``force="batched"`` takes the stacked
pass.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gaussianimage_tpu_torch.core import clip01
from gaussianimage_tpu_torch.ops import stream_common as sc
from gaussianimage_tpu_torch.ops.rasterize_sum import (
    RasterizeConfig, rasterize_gaussians_sum_chw)

STRATEGIES = ("batched", "scan")


def _stack_splats(model, splats):
    """B per-frame splat tuples (xys, radii, conics, colors, opacities) ->
    the stacked scene, y shifted by b * H, and the per-Gaussian tile-row
    band (lo, hi) of its frame."""
    cfg = model.cfg
    tp = cfg.raster.tile_px
    if cfg.H % tp:
        raise ValueError(f"batched stacking needs H % tile_px == 0, got "
                         f"H={cfg.H}, tile_px={tp}")
    B = len(splats)
    N = splats[0][0].shape[0]
    dev = splats[0][0].device
    xys, radii, conics, colors, opac = (torch.cat(parts)
                                        for parts in zip(*splats))
    frame = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(N)
    xys = torch.stack([xys[:, 0], xys[:, 1] + frame.float() * cfg.H], dim=1)
    rows = cfg.H // tp
    band = (frame * rows, frame * rows + rows - 1)
    return (xys, radii, conics, colors, opac), band


def _raster_stacked(model, flat_splat, band):
    cfg = model.cfg
    xys, radii, conics, colors, opac = flat_splat
    B = band[0].shape[0] // cfg.num_points
    img, alpha, aux = rasterize_gaussians_sum_chw(
        xys, conics, colors, opac, cfg.H * B, cfg.W, radii=radii,
        config=cfg.raster.stacked(cfg.num_points, B), band=band)
    img = clip01(img)
    img = img.reshape(3, B, cfg.H, cfg.W).permute(1, 0, 2, 3)
    return img, alpha.reshape(B, cfg.H, cfg.W), aux


def _frame(tree, b: int):
    """Frame b of a dict of [B, ...] leaves (a NamedTuple state too)."""
    if isinstance(tree, dict):
        return {k: _frame(v, b) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(*(v[b] for v in tree))
    return tree[b]


def render_batch(model, params_b: Dict[str, torch.Tensor]) -> Dict:
    """Render B parameter sets (the model's parameters, each stacked on
    dim 0: ``splat(params=...)`` reads one frame) in one rasterizer pass.
    Returns {"render":
    [B, 3, H, W], "alpha_map": [B, 1, H, W], "raster_aux": aux}."""
    B = params_b["_xyz"].shape[0]
    splats = [model.splat(params=_frame(params_b, b)) for b in range(B)]
    flat, band = _stack_splats(model, splats)
    img, alpha, aux = _raster_stacked(model, flat, band)
    return {"render": img, "alpha_map": alpha[:, None], "raster_aux": aux}


@torch.no_grad()
def decompress_wo_ec_batch(model, params_b, extra_b, enc_b) -> Dict:
    """Decode B encodings (leaves stacked on dim 0: the quantizers'
    ``params_b``, ``extra_b["vq"]`` a stacked ResidualVQState, the code
    arrays ``enc_b``) in one rasterizer pass -> {"render": [B, 3, H, W],
    "raster_aux": ...}. ``model`` is a quantize model; its
    ``fused_decode_batch`` (K7) runs where it is supported, else the
    generic per-frame dequantization and the stacked rasterize."""
    fused = getattr(model, "fused_decode_batch", None)
    if fused is not None:
        out = fused(params_b, extra_b, enc_b)
        if out is not None:
            return out
    B = enc_b["xyz"].shape[0]
    splats = []
    for b in range(B):
        means, geo, colors = model.dequantize_wo_ec(
            _frame(enc_b, b), _frame(params_b, b), _frame(extra_b["vq"], b))
        splats.append(model._quantized_splat(_frame(params_b, b), means, geo,
                                             colors))
    flat, band = _stack_splats(model, splats)
    img, _, aux = _raster_stacked(model, flat, band)
    return {"render": img, "raster_aux": aux}


# The largest frame at which the stacked pass is the faster strategy. The
# JAX package's value, 131072, was measured on a TPU, where stacking lost at
# 768x512. On an NVIDIA H100 80GB HBM3 at its 700 W power limit
# (chip_smoke.py's batched phase, china@10k codes) stacking wins at
# 768x512: 0.267 / 0.135 / 0.090 ms per frame at B = 2 / 4 / 6 against
# 0.587 / 0.570 / 0.574 ms for the loop of single-frame decodes, both
# host-bound. Larger frames and other batch sizes were not measured, so the
# gate stops at both.
BATCHED_WIN_MAX_PIXELS = 768 * 512
BATCHED_WIN_FRAMES = (2, 6)  # the measured range of B


def prefer_batched(H: int, W: int, B: int, N: int) -> bool:
    """True when the stacked one-pass decode of B frames of N Gaussians is
    the faster strategy: frames of at most BATCHED_WIN_MAX_PIXELS, B within
    BATCHED_WIN_FRAMES, and a stacked stream that fits the flat layout
    (a stacked pass on the aligned stream runs, but was not measured
    against the scan on the H100)."""
    lo, hi = BATCHED_WIN_FRAMES
    aligned = sc.stream_caps(B * N, RasterizeConfig().stacked(N, B))[2]
    return H * W <= BATCHED_WIN_MAX_PIXELS and lo <= B <= hi and not aligned


@torch.no_grad()
def decode_many(model, params_b, extra_b, enc_b, *,
                force: Optional[str] = None) -> Dict:
    """Decode B encodings (leaves stacked on dim 0) by the strategy
    ``prefer_batched`` picks for them, or by ``force`` ("batched"
    or "scan"; anything else raises ValueError). Returns {"render":
    [B, 3, H, W], "raster_aux": ...}; the scan's aux holds each frame's
    values stacked."""
    if force is not None and force not in STRATEGIES:
        raise ValueError(f"unknown decode strategy {force!r}; options: "
                         f"{STRATEGIES} or None")
    B, N = enc_b["xyz"].shape[:2]
    use_batched = (prefer_batched(model.cfg.H, model.cfg.W, B, N)
                   if force is None else force == "batched")
    if use_batched:
        return decompress_wo_ec_batch(model, params_b, extra_b, enc_b)
    outs = [model.decompress_wo_ec(_frame(enc_b, b), _frame(params_b, b),
                                   _frame(extra_b["vq"], b))
            for b in range(B)]
    aux = {k: torch.stack([o["raster_aux"][k] for o in outs])
           for k in outs[0]["raster_aux"]}
    return {"render": torch.cat([o["render"] for o in outs]),
            "raster_aux": aux}
