#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (gaussianimage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (with ``elapsed_s``):

1. env       torch, CUDA, nvcc, Triton / ninja presence, the card's name
             and power limit;
2. build     every CUDA kernel of the port from the sources in this
             checkout (one nvcc per source, started together);
3. kernel    each kernel against its plain PyTorch version on the card, at
             the main path's shapes: K1 (render) to max |diff| <= 1e-5 and
             bit for bit (NaN where it is NaN) to the plain version that
             adds each pixel's pairs in stream order (``in_order``), on
             every K1 case below too; K2 (backward) and K3 (fused render +
             L2 + backward) on the flower@10k stream, their gradient rows
             to 1e-4 of each column's largest magnitude; K3 also against
             K1 -> L2 cotangent -> K2 (1e-6); K2 twice on the same inputs
             and K3 twice on the same step (K3 and the scatter), which
             must give bit-identical rows and gradients; no pair that
             passes the gate outside the cull K1-K3 share
             (``sum_cull_plain``), with the pairs their patches keep and
             the (slot, warp) visits reported under each of K1-K3; case
             nan_form: the 300-point state's stream with
             rows of an infinite conic coefficient (a NaN form where the
             pixel offset is 0) and of indefinite conics (a negative form,
             q = 0), flat and aligned: K1, K2 and K3 against their plain
             versions (K1 per unit of max(1, |pixel|), rows NaN exactly
             where theirs are), K3 against K1 -> L2 -> K2, no gated pair
             culled; case k3_cull_edge: K1-K3 the same way on the cull's
             adversarial scene (``blend_cull_scene``, its NaN opacities
             set to 0.5; K3 under no clamp), flat and aligned; case
             masked: the flower@10k stream at seeded wMask opacities (30%
             exactly 0, the rest a sigmoid of seeded logits, 8 below
             1e-20) the same way, flat, with K1's and K2's device times
             beside the opacity-1 rows; the fused
             splat prep, K5 on the flower@10k fit and K4 on the china@10k
             QAT codes under ``RasterizeConfig.serving(10000)``: sorted
             keys, trunc and n_total integer-exact, feature rows to 1e-6,
             the keys in their slot-major [M, N+1] layout and the per-row
             counts equal (torch.equal), the rows bit for bit, and K5's
             stream (gids, starts) against the generic binning; both also
             on their first N = 1, 31, 33, 63, 65 and 1000 rows
             (EDGE_ROWS: a partial last CTA and warp), K5 on seeded
             adversarial rows (K5_EDGE_SEED: Cholesky factors at the
             determinant floor, means at the canvas's edges, bboxes
             wider than the span M, which truncate); K7, the batched
             decode prep, on the china and flower QAT codes stacked (B =
             2, and B = 6 with each three times) under the batched config
             and on those stacks cut to 65, 33 (B = 3) and 10 (B = 6)
             rows a frame (frame boundaries inside a 64-row CTA; frames
             under 64 rows take the variant that reads the frame tables
             through the cache), held to its plain version as K5 is, and
             at B = 1 equal to K4 (rows max |diff| 0, keys and counts
             equal); case tile16: K1-K3 built for 16-pixel tiles (the
             sharded fit's default) held as above (K1 bit for bit to the
             in-order plain version, K2 / K3 to ROW_TOL, K3 against K1 ->
             L2 -> K2 to CHAIN_TOL, K2 and K3 twice bit-identical, no
             gated pair culled), flat on the flower@10k state (whose
             stream at 16 fills the auto cap of 40,000 and drops the rest,
             reported) and aligned on flower@40k;
4. slice     the evaluation entry point ``gaussianimage_tpu_torch.train
             --iterations 0`` on the fitted flower@10k checkpoint
             (768x512): PSNR within 0.01 dB of 41.906, n_dropped == 0, K1
             launched;
5. serve     ``render_fast`` of the flower@10k fit under serving(10000)
             (K5, a sort, K1): the image against ``render()`` under the
             default config (atol 2e-5, at most 16 pixels above 1e-4), PSNR
             within 0.01 dB of 41.906, n_dropped 0 on every timed render;
             wall ms, host operator calls and launches per render beside
             ``render()``'s;
6. codec     the codec CLI ``gaussianimage_tpu_torch.test_quantize`` on the
             committed QAT checkpoints (results_quant, photos, 10k points):
             PSNR within 0.01 dB and MS-SSIM within 1e-4 of the JAX
             package's evaluation, bpp 1.4285, entropy-coded bpp 1.3920 /
             1.4000, the round trip below 1e-6, >= 300 K4 launches (china's
             decode probe; flower's serving twin drops instances, so its
             probe takes the default model), china's K4 image against its
             generic decode; the entropy-coded decode in three parts; the
             CLI's "Dataset decode" line, parsed;
6b. batched  ``batched.decode_many(force="batched")`` (K7, a sort, K1 on the
             stacked canvas) on china's codes stacked B = 2, 4 and 6 times
             and on china + flower, each stack against the generic stacked
             decode under the same batched config (IMG_TOL / MAX_EDGE_PX,
             n_dropped 0); china's frames against its single-frame K4
             decode: frame 0 bit for bit, every frame's PSNR within
             FRAME_PSNR_TOL (frame f's means sit at y + f * 512 on the tall
             canvas, rounded to float32 there, as in the JAX package); then
             the wall ms per frame of both strategies at each B and the one
             ``prefer_batched`` picks;
6c. qat      ``QuantizeTrainer2d`` (the class the QAT CLI runs) trains the
             china@10k fit for 5000 QAT iterations at lr 1e-3 in a temp
             dir: no NaN loss, n_dropped 0 in every chunk, >= 5000 K1 and
             K2 launches and no K3, the best training PSNR >= 26.9 dB; the
             best state's bpp 1.4285 and its K4 decode against its
             evaluation render; wall ms, host calls and launches per step;
7. fit       ``SimpleTrainer2d`` (the class the CLI runs) fits the flower
             photo at N = 10,000 for 5000 iterations with the CLI defaults
             (adaptive init, 6 reseed rounds), in a temp dir: test PSNR
             >= 38.5 dB, no NaN loss, n_dropped 0 in every chunk, and
             >= 5000 K3 launches; the training PSNR every 1000 iterations;
8. generic   50 steps of the model's train_step under a non-L2 loss
             (Fusion2 = 0.7 L1 + 0.3 (1 - SSIM)), which renders through
             the differentiable rasterizer: K1 forward, K2 backward;
8'. sharded the sharded fit CLI (``gaussianimage_tpu_torch.train_sharded``)
             at its defaults (tile 16, adaptive init) on the photos at N =
             10,000 on a 1 x 1 x 1 mesh, SHARD_ITERS iterations in chunks
             of SHARD_CHUNK, in a temp dir: the first SHARD_EQ_STEPS
             sharded steps bit-equal (loss, parameters, Adan's moments) to
             ``model.train_step`` from the same init; no NaN loss, each
             image's final state >= its initial state + SHARD_GAIN dB, at
             least as many K3 launches (all at 16) as steps, every
             artifact; n_dropped reported, not gated (the reference drops
             at tile 16 too). Then the 40k fit's render at tile 16 (the
             aligned K1), and two ranks on the one card over gloo (this
             script again, ``--two-rank-worker``): TWO_RANK_STEPS steps on
             (1, 2, 1) (K1 + K2 at 16), (1, 1, 2) (K3 on each half) and (1,
             2, 1) at 40k points (aligned K1 + K2) from the CLI's init,
             each within rtol 2e-4 / atol 2e-5 (params) and 1e-4 (loss)
             of 1 x 1 x 1 steps from the same state on the same path (the
             generic one for a gauss axis above 1; against the fused one
             reported, with the init's pixels at exactly 0 or 1), and from
             the committed 40k fit (reported); the scaling probe
             (``parallel.scaling_bench``) once on this one rank;
8a. wmask_fit ``SimpleTrainer2d`` with ``GaussianImage_Cholesky_wMask``
             fits the flower photo at N = 16,000 for 3000 iterations with
             the repo's sweep flags (ada_kl, target 0.7, lambda 0.005,
             initial logit 2.0) and its mask window 10k-40k of 50k scaled
             to 600-2400: no NaN loss, >= 3000 K2 launches and no K3,
             n_dropped 0 in every chunk, 0 < Final_points < 16,000 after
             the prune, the pruned model's evaluation render (at 1 << 30)
             within 1e-5 of the unpruned one's taken before the prune
             (bit-equality reported), test PSNR >= 30 dB (a sanity
             floor), scalars.jsonl with the sparsity keys, two ada_kl
             evaluations bit-identical; wall ms per step in each mask
             phase (a burst of steps of a copy of the fitted model) and a
             profiled burst of each;
8a'. wmask_ema 300 iterations with kl, the EMA, the score and the
             temperature 1.0 -> 0.1 over a 50-250 mask window in chunks of
             50: at the chunk boundary after 250 every logit is exactly
             +-10, its sign by mask_ema > 0.5;
8a''. wmask_qat ``QuantizeTrainer2d`` with the wMask model, 500 iterations
             on the pruned fit (``--num_points`` its kept count): >= 500 K1
             and K2 launches, no K3, K4 or K7, no NaN loss; the best state's
             codec decode within 1e-6 of its evaluation render through K1;
             a stacked decode of it and a copy with a tenth of its masks
             off: frame 0 bit for bit to its single-frame decode, frame 1's
             PSNR within FRAME_PSNR_TOL of its own (as in phase batched);
             the codec CLI on the state as a
             two-image dataset (generic decode: K1, no K4 or K7), its PSNR
             the QAT's best test PSNR within 1e-3 dB;
8b. rs_fit   ``SimpleTrainer2d`` with ``GaussianImage_RS`` fits the flower
             photo at N = 10,000 for 5000 iterations with the CLI defaults
             (the RS projection, then K3), its checkpoint in a temp dir:
             test PSNR >= 38.5 dB, no NaN loss, n_dropped 0 in every chunk,
             >= 5000 K3 launches;
8c. rs_serve ``render_fast`` of that fit under serving(10000) (K6b, a sort,
             K1): the image against the fit's ``render()`` under the default
             config (IMG_TOL / MAX_EDGE_PX), n_dropped 0 on every timed
             render (a twin that drops would be routed to the default model,
             as the codec CLI routes it, and the phase says so); wall ms,
             host operator calls and launches per frame;
8d. rs_qat   ``QuantizeTrainer2d`` with ``GaussianImage_RS`` from that
             checkpoint, 2000 QAT iterations at lr 1e-3: no NaN loss,
             n_dropped 0, >= 2000 K1 and K2 launches and no K3; the best
             state's K6a decode against its evaluation render;
8e. rs_kernel K6b on the RS fit's parameters and K6a on the RS QAT codes
             under serving(10000), each against its plain version (sorted
             keys, trunc and n_total integer-exact, feature rows bit for
             bit, keys [M, N+1] and per-row counts equal), there, on their
             first EDGE_ROWS rows and on seeded adversarial rows (K6b: raw
             rotations of +-30, angles near pi / 2 and pi, scales at the
             conic's determinant floor, sx = sy; K6a: codes at the 6-bit
             range's ends, VQ indices outside the codebook, held to the
             plain version on entry 0 there); K6b's stream (gids, starts)
             equal to the generic binning;
8e'. scan_decode ``batched.decode_many(force="scan")`` of two stacked frames
             at N = 9999 (SCAN_N: frame 1's code arrays start 4-12 bytes
             off a 16-byte boundary), china + flower's QAT states cut to
             9999 rows through K4 and the RS QAT state's first and last
             9999 rows through K6a: two fused launches each, each frame bit
             for bit equal to its single-frame decode;
8f. rs_codec the codec CLI ``test_quantize --model_name GaussianImage_RS`` on
             that QAT state, as a two-image dataset (the flower photo and
             state twice, so the dataset decode stacks two frames): decode
             probes on the serving twin, >= 300 K6a launches per image, the
             K6a image against the generic decode, the round trip below
             1e-6, bpp 1.4285 with its scaling_bpp + rotation_bpp =
             cholesky_bpp, the codec PSNR equal to the QAT's best test
             PSNR, the "Dataset decode" line (the generic stacked path: RS
             has no batch kernel) and the ms per frame of both strategies;
8g. gs3d_fit ``SimpleTrainer2d`` with ``3DGS`` (Fusion2, sh_degree 3, the
             CLI defaults) fits the flower photo at N = 10,000 for 2000
             iterations in a temp dir: no NaN loss, >= 2000 K8 and K9
             launches and no K1, K2 or K3, test PSNR >= GS_FIT_PSNR and
             >= the initial state's test PSNR + GS_FIT_GAIN; the
             training PSNR every 500 iterations and n_dropped per chunk
             (reported, not gated); then the CLI's evaluation
             (``--iterations 0 --model_name 3DGS``) of its checkpoint, as a
             two-image dataset of the flower photo: each PSNR equal to the
             fit's within 1e-4 dB, the FPS probes through K8, no K9;
8h. gs3d_kernel K8 and K9 on the 3DGS model's initial state and on the fit's,
             768x512, tile 32 (and on the fit, tile 16, the kernels' other
             build), and on the cull's adversarial scene
             (``blend_cull_scene.cull_edge_scene``: 2000 rows, 256x192,
             thin, near-singular, non-positive-definite and NaN conics,
             opacities at alpha_min) at tiles 32 and 16, flat and aligned:
             K8 bit-equal to its plain version (and within BLEND_TOL) with
             the chunks consumed equal in every tile, the aligned K8 equal
             to the flat one on the scene, with equal n_dropped; K9's
             gradient rows (a cotangent from a fixed seed) to ROW_TOL of
             each column's largest magnitude (on the scene, on the slots
             whose row is finite; elsewhere a row that is not finite
             fails), and bit-identical twice; per case the consumed slots,
             the pairs the kernels meet, those within the
             row's threshold, those that composite and those the cull
             keeps (``blend_cull_plain``: the warp patches that meet a
             slot's rectangle), and no pair that composites culled;
8i. gs3d_serve ``render_fast`` of the 3DGS initial state and of the fit under
             ``RasterizeConfig(fused_prep=True)`` (K10, a sort, K8): one K10
             and one K8 launch a frame and nothing else; on the initial
             state the image against ``render()`` within the JAX suite's
             envelope (max < 5e-4, a share < 1e-3 of pixels above 5e-5);
             on both states, reported: n_dropped of both paths, the rows
             whose keys differ from the generic binning's, the image error
             before the first tile the stream cap cuts; K10 against its
             plain version bit for bit (rows, keys [M, N+1] and per-row
             counts, torch.equal) on both states, on seeded models at
             sh_degree 0-4 and on each seeded model's first EDGE_ROWS
             rows;
8j. aligned_kernel on the committed flower@40k fit, whose stream (144,576
             slots) passes flat_stream_limit and takes the aligned layout:
             K11a (``blockize_stream``) and K11b (``unblockize_stream``)
             bit-equal to their plain versions and K11b(K11a(x)) ==
             feat[gids]; the aligned K1 to K1_TOL and bit for bit to the
             in-order plain version, K2 and K3 to ROW_TOL of
             the column max (K3 with the clip-flip allowance of phase 3),
             K2 twice and K3 + the scatter twice bit-identical, no gated
             pair outside the cull; the image, the SSE
             and the scattered K2 / K3 gradients bit-equal to the flat
             twin's (flat_stream_limit raised) with equal n_dropped;
8k. aligned_slice the evaluation entry point ``--iterations 0`` on the
             committed GaussianImage_Cholesky_50000_{20000,40000} fits of
             both photos: test PSNR within 0.01 dB of the JAX package's
             render of each checkpoint (ALIGNED_EVALS; the TPU runs' logs
             reported beside), n_dropped 0, K11a and the aligned K1
             launched; each render against ``render_fast`` under
             ``RasterizeConfig.serving(N)`` (flat, K5) within IMG_TOL /
             MAX_EDGE_PX, its n_dropped 0;
8k'. codec_rates the codec CLI on the committed QAT states of both photos
             at 20,000 and 40,000 points (CODEC_RATES_ROOT), each held to
             the JAX package's evaluation of the same state
             (CODEC_RATE_ANCHORS, pinned by
             tests/test_torch_codec_rates.py): PSNR +- 0.01 dB, MS-SSIM
             +- 1e-4, bpp and entropy-coded bpp to 4 decimals, round trip
             < 1e-6, the serving twin's n_dropped equal; >= MIN_K4 K4
             launches for each serving probe, K11a and the aligned K1
             launched; the probe's model and ms per decode frame, the
             "Dataset decode" line and the phase's seconds reported; on
             each 40k state K4 (40,001 rows under serving(40000)) held to
             its plain version as in phase 3, bit for bit, and the aligned
             K1 on the evaluation decode's stream to K1_TOL, bit for bit
             to the in-order plain version and, clipped, to the decode;
             both with device time, host burst, plain time and bound;
8l. aligned_fit 50 K3 steps from the flower@40k state on the aligned
             stream and on its flat twin: losses and parameters bit-equal;
             50 Fusion2 steps at 40k (K11a, K1, K2, K11b); then
             ``SimpleTrainer2d`` with the CLI's defaults at N = 50,000 (the
             CLI's own default) on flower for 1000 iterations: no NaN loss,
             >= 1000 aligned K3 and K11b launches, test PSNR >= the initial
             state's + 1 dB, n_dropped per chunk reported;
8m. gs3d_aligned the 3DGS baseline at 30,000 points (sh_degree 3, Fusion2):
             on its initial state the aligned K8 and K9 held as in
             gs3d_kernel (K8 bit-equal with its chunks, K9 to ROW_TOL and
             bit-identical twice, no composited pair culled); image,
             chunks and scattered K9 gradients bit-equal to the flat
             twin's, with equal n_dropped; then 200 fit steps with no
             NaN, >= 200
             aligned K9 launches; PSNR and n_dropped reported, not gated;
9. timing    each kernel and its plain version, the render, a training
             step over a 250-step burst, with each kernel's bound from this
             run's pair counts; torch.profiler traces of 20 launches of
             each kernel give its device time per launch, and traces of
             one FPS-probe burst and of 50 training steps the device time
             by kernel, launches and host operator calls per frame or
             step, and the device busy share; the same for the 3DGS step
             and its FPS-probe render (K8), and for 3DGS ``render_fast``
             (K10, K8) beside ``render()``; K11a and K11b on the flower@40k
             stream (and one PyTorch copy of K11b's relayout, its burst,
             and K11b's and its device times traced together, warm and
             with a 64 MB write before each launch to evict L2), and the
             aligned K1-K3 (flower@40k) and K8 / K9 (3DGS@30k) with their
             plain versions, device times and bounds, and the flat
             branch's device times on the flat twins of the same states;
             the training step of the 50,000-point fit (aligned) timed and
             traced. K1-K3's bounds count the gated pairs and a cull per
             slot and walk (``sum_ops``); the older count, which charges q
             to every pair of the windows, is ``sum_bound_ms_all_pairs``;
             the fused prep's floor (``prep_floor``): K5, K4, K6b, K6a,
             K7 (B = 2) and K10 at each sh_degree 0-4 traced beside zero_() of
             each of their three outputs and of one buffer of those bytes;
             K1-K3 at tile 16 (flat flower@10k, aligned flower@40k) with
             their device times, plain versions and bounds.

Then the raw ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
line (the 13 kernels; K1-K3, K8 and K9 with their aligned branch's numbers
under "aligned", K1-K3 with their 16-pixel builds' under "tile16"), and
last ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before that last line. It needs a CUDA card and a
checkout of the repository around it; without either it exits non-zero.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from copy import deepcopy
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
FLOWER_DIR = ROOT / "results/photos/GaussianImage_Cholesky_50000_10000"
FLOWER_PHOTO = ROOT / "data/flower_768x512.png"
FLOWER_PSNR = 41.906  # the JAX package's render of this checkpoint
FLOWER40_DIR = ROOT / "results/photos/GaussianImage_Cholesky_50000_40000"
QAT_DIR = ROOT / "results_quant/photos/GaussianImage_Cholesky_50000_10000"
# the JAX package's codec evaluation of those checkpoints (generic decode,
# default config, on the CPU); the TPU's test.txt agrees to ~1e-3 dB
CODEC_ANCHORS = {
    "china": {"psnr": 27.5687, "ms-ssim": 0.958868, "bpp": 1.4285,
              "bpp_ec": 1.3920},
    "flower": {"psnr": 38.8210, "ms-ssim": 0.992063, "bpp": 1.4285,
               "bpp_ec": 1.4000},
}
# the JAX package's codec evaluation of the committed 20k and 40k QAT
# states (generic decode on the aligned stream, default config; on the
# CPU, tests/test_torch_codec_rates.py, which holds these values), with
# its serving twin's n_dropped; phase codec_rates gates the port's codec
# CLI on them as the codec phase gates the 10k states. The TPU runs'
# results_quant/RD_TABLE.md is not used.
CODEC_RATES_ROOT = ROOT / "results_quant/photos"
CODEC_RATE_ANCHORS = {
    20000: {"china": {"psnr": 30.6350, "ms-ssim": 0.973221, "bpp": 2.8527,
                      "bpp_ec": 2.7784, "serving_n_dropped": 0},
            "flower": {"psnr": 41.0711, "ms-ssim": 0.993748, "bpp": 2.8527,
                       "bpp_ec": 2.7537, "serving_n_dropped": 0}},
    40000: {"china": {"psnr": 34.9142, "ms-ssim": 0.985585, "bpp": 5.7010,
                      "bpp_ec": 5.5390, "serving_n_dropped": 0},
            "flower": {"psnr": 43.1140, "ms-ssim": 0.996028, "bpp": 5.7010,
                       "bpp_ec": 5.4999, "serving_n_dropped": 0}},
}
SERVE_N = 10000
PREP_TOL = 1e-6    # feature rows, K4 / K5 against their plain versions
# row counts of the fused fronts' extra cases: a partial last CTA of 64
# rows and a partial last warp
EDGE_ROWS = (1, 31, 33, 63, 65, 1000)
# the scan decode of stacked frames at a row count that is not a multiple
# of 4: frame 1's [N, 1], [N, 2] and [N, 3] code arrays start 4, 8 and 12
# bytes past a 16-byte boundary
SCAN_N = 9999
RS_EDGE_SEED = 7   # K6a / K6b's adversarial rows
K5_EDGE_SEED = 5   # K5's adversarial rows
RS_CODE_MAX = 63   # the RS model's 6-bit quantizers' largest code
IMG_TOL = 2e-5     # fused against generic images, but for MAX_EDGE_PX
MAX_EDGE_PX = 16   # pixels above 1e-4 where an instance crosses a tile edge
MIN_K4 = 300       # K4 launches in the codec run: two timed decode bursts
BATCHES = (2, 4, 6)  # frames per batched decode; 6 x 10k is the flat limit
# a stacked frame's PSNR against its single-frame decode's: frame f's means
# are shifted by f * H in float32, moving a few pixels' gates
FRAME_PSNR_TOL = 1e-3
QAT_ITERS = 5000
QAT_BEST_PSNR = 26.9  # the TPU run's log: best 27.19 at iteration 5000
QAT_BPP = 1.4285   # both models: float16 means, 3 x 6-bit codes, 2 x 3-bit VQ
RS = "GaussianImage_RS"
RS_QAT_ITERS = 2000
# FP32 issue slots per row of the fused prep (an FMA as one): two tanhf
# (~20 each), three IEEE divisions (~10 each: the conic's and the two axis
# extents'), four square roots (~8 each) and ~74 adds, multiplies (the
# bbox's four by the tile's exact reciprocal), floors and compares; K4 adds
# its dequantization and codebook index (~10); and per key slot ~6 integer
# operations
# K7 adds its frame's index and band (~20)
# K6b and K6a swap the Cholesky covariance (~5) for the RS one: sincosf
# (~35: one range reduction for both), ~10 multiplies and adds, and in K6b
# the sigmoid's expf and IEEE division (~20); K6a its angle's
# dequantization (~3)
# The staged rows and tables add a few shared-memory reads a row, not
# counted
# K10 (3DGS, sh_degree 3): the quaternion's norm and four divisions (~55),
# the rotation (~35), three expf (~25), Sigma (~40), the view transform and
# projection (~45), the Jacobian and J W (~60), cov2d (~50), the conic and
# radius (~45), the view direction (~45), 16 SH bases over three channels
# (~140), the clamps and the opacity's sigmoid (~25), and the tail's bbox,
# floors and compares (~40)
PREP_ROW_SLOTS = {"splat_prep_raw": 176, "splat_prep_decode": 186,
                  "splat_prep_decode_batch": 206, "splat_prep_rs_raw": 236,
                  "splat_prep_rs_decode": 229, "splat_prep_blend3d": 605}
PREP_KEY_SLOTS = 6
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
GS = "3DGS"
GS_ITERS = 2000
# the 2000-iteration 3DGS flower fit's test PSNR floor: 1 dB under the
# first reading on the H100 (PERF.md); no TPU anchor exists
GS_FIT_PSNR = 1.769
# and it must gain this much on the test PSNR of its own initial state (on
# an H100: 2.0713 dB at the initial state, 2.7692 after 2000 steps)
GS_FIT_GAIN = 0.3
BLEND_TOL = 1e-5   # K8's rgb and T_fin against its plain version
# 3DGS render_fast (K10) against render(): the JAX suite's envelope
# (tests/test_gs3d.py:279-284), max |diff| and the share of pixels above
# ENV_PX
ENV_MAX = 5e-4
ENV_PX = 5e-5
ENV_SHARE = 1e-3

# the aligned stream (above flat_stream_limit instances): the JAX
# package's render of the committed 20k and 40k fits (on the CPU, through
# its aligned stream; tests/test_torch_aligned.py), held to 0.01 dB as
# FLOWER_PSNR is. The TPU runs' logs (each train.txt) read 0.003-0.029 dB
# above the JAX package's own render of the same checkpoints, so they are
# reported beside, not gated.
ALIGNED_EVALS = {20000: {"flower": 44.7811, "china": 33.2452},
                 40000: {"flower": 48.6119, "china": 39.5167}}
ALIGNED_TPU_LOGS = {20000: {"flower": 44.7886, "china": 33.2482},
                    40000: {"flower": 48.6414, "china": 39.5424}}
ALIGNED_PSNR_TOL = 0.01
TWIN_STEPS = 50          # K3 steps from the 40k state, aligned and flat twin
ALIGNED_FIT_N = 50000    # the fit CLI's own default --num_points
ALIGNED_FIT_ITERS = 1000
ALIGNED_FIT_GAIN = 1.0   # dB over the initial state's test PSNR
GS_ALIGNED_N = 30000     # the 3DGS sweep's smallest aligned point count
GS_ALIGNED_STEPS = 200
# the cull's adversarial scene (blend_cull_scene.cull_edge_scene): points,
# (H, W) and seed
# the masked case: flower@10k at seeded wMask opacities
MASK_SEED = 8
MASK_ZERO_SHARE = 0.3   # opacities exactly 0 (a deterministic mask's off)
MASK_TINY = 8           # opacities below 1e-20 (sigmoid of logits -50..-47)
# the wMask phases: the repo's sweep (scripts/gaussianimage_cholesky/
# kodak_wMask.sh, kodak at 16,000 points, mask 10k-40k of 50k) on flower,
# its schedule scaled to WMASK_ITERS
WMASK = "GaussianImage_Cholesky_wMask"
WMASK_N = 16000
WMASK_ITERS = 3000
WMASK_FLAGS = ["--lr", "1e-3", "--reg_type", "ada_kl", "--target_sparsity",
               "0.7", "--lambda_reg", "0.005", "--init_mask_logit", "2.0",
               "--start_mask_training", "600", "--stop_mask_training", "2400",
               "--viz_every", "0"]
WMASK_PSNR = 30.0       # a sanity floor of the fit's test PSNR, no claim
WMASK_PRUNE_TOL = 1e-5  # the pruned render against the unpruned one
WMASK_PHASE_ITERS = {"none": 300, "soft": 1500, "deterministic": 2700}
WMASK_EMA_ITERS = 300
WMASK_EMA_FLAGS = ["--reg_type", "kl", "--use_ema", "--use_score",
                   "--temp_init", "1.0", "--temp_final", "0.1",
                   "--start_mask_training", "50", "--stop_mask_training",
                   "250", "--chunk_size", "50", "--viz_every", "0"]
WMASK_EMA_STOP = 250
WMASK_QAT_ITERS = 500
WMASK_DECODE_TOL = 1e-6  # the QAT state's decode against its eval render
SHARD_N = 10000          # the sharded CLI's default --num_points
SHARD_ITERS = 2000
SHARD_CHUNK = 500
SHARD_EQ_STEPS = 20      # sharded steps held bit for bit to train_step
SHARD_GAIN = 1.0         # dB over each image's initial state
TWO_RANK_STEPS = 3
TWO_RANK_RTOL = 2e-4     # JAX's sharded-vs-single tolerance on the params
TWO_RANK_ATOL = 2e-5     # (tests/test_parallel.py)
TWO_RANK_LOSS_RTOL = 1e-4
TWO_RANK_TIMEOUT = 300
# (label, num_points, mesh data,gauss,tile, the 1 x 1 x 1 path it is held
# to) of the two-rank gloo runs, and the kernels each must launch on every
# rank. A gauss axis above 1 takes the generic step (K1, the clip, K2),
# held to the generic step on one rank: the fused K3 masks the clip's
# cotangent at exactly 0 and 1, the generic step passes half of it there
# (jnp.clip's tie, as in the JAX package), and Adan turns the few entries
# that differ into steps of up to lr
# (label, num_points, mesh, path, the state it starts from: the CLI's
# init at 10k or 40k points, or the committed 40k fit, whether the
# tolerance gates it). From the converged fit a gradient is rounding noise
# on many rows, whose sign Adan's first steps follow with steps of lr, so
# that run is reported, not gated.
TWO_RANK_MESHES = (("gauss2", 10000, "1,2,1", "generic", "init_10k", True),
                   ("tile2", 10000, "1,1,2", "fused", "init_10k", True),
                   ("gauss2_40k", 40000, "1,2,1", "generic", "init_40k",
                    True),
                   ("gauss2_40k_fit", 40000, "1,2,1", "generic", "fit_40k",
                    False))
TWO_RANK_KERNELS = {"gauss2": ("rasterize_sum_fwd", "rasterize_sum_bwd"),
                    "tile2": ("rasterize_sum_l2",),
                    "gauss2_40k": ("rasterize_sum_fwd_aligned",
                                   "rasterize_sum_bwd_aligned")}
CULL_N = 2000
CULL_HW = (192, 256)
CULL_SEED = 5

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


def pair_work(torch, rs, sc, feat, sp, H, W, q_cut, tp=32):
    """The work K1-K3 meet on the stream ``sp`` (flat or aligned, tiles of
    ``tp`` pixels) over the rows ``feat``: ``slots``, the windows' live slots (each staged once a
    walk); of their (slot, pixel) pairs with the pixel inside the image,
    ``pairs``, all of them; ``gated``, those that pass the q <= q_cut gate;
    ``nan_pairs``, those whose form is NaN (they fail it); ``cull_pairs``,
    those in a patch (``rs.PATCH``) that meets the slot's rectangle
    (``rs.sum_cull_plain``), the pairs each walk of K1-K3 evaluates;
    ``visits``, the (slot, warp) pairs each walk visits (a warp's 16 x 8
    block meets the rectangle); and ``culled_gated``, gated pairs outside
    the rectangle (must be 0)."""
    work = dict(slots=0, pairs=0, gated=0, nan_pairs=0, cull_pairs=0,
                visits=0, culled_gated=0)
    pidx = torch.arange(tp * tp, device=feat.device)
    X, Y = pidx % tp, torch.div(pidx, tp, rounding_mode="floor")
    bw, bh = rs.WARP_BLOCK
    for pr in rs.window_pairs(sc.gather_stream(sp.gids, feat), sp.starts,
                              sp.counts, H, W, tp):
        on = pr.inside & (pr.q <= q_cut)
        cl = rs.sum_cull_plain(
            pr.rows, ((pr.tile % sp.tiles_x) * tp).float(),
            (torch.div(pr.tile, sp.tiles_x, rounding_mode="floor")
             * tp).float(), q_cut, tile_px=tp)
        kept = ((X >= cl.x0[:, None]) & (X <= cl.x1[:, None])
                & (Y >= cl.y0[:, None]) & (Y <= cl.y1[:, None]))
        work["slots"] += pr.rows.shape[0]
        work["pairs"] += int(pr.inside.sum())
        work["gated"] += int(on.sum())
        work["nan_pairs"] += int((pr.inside & pr.q.isnan()).sum())
        work["cull_pairs"] += int(
            (pr.inside & rs.cull_patches(cl, tp, rs.PATCH)).sum())
        work["visits"] += int(
            rs.cull_patches(cl, tp, rs.WARP_BLOCK).sum()) // (bw * bh)
        work["culled_gated"] += int((on & ~kept).sum())
    return work


def blend_pair_work(torch, rs, sc, blend, feat, sp, nch, H, W, cfg):
    """The work of the chunks each tile consumed that K8 and K9 meet on
    this data: ``slots``, the consumed slots (each staged once, with its
    cull); of their (slot, pixel) pairs with the pixel inside the image,
    ``pairs``, all of them; ``near_pairs``, those within the row's q_cut = 2
    log(o / alpha_min) + blend.Q_MARGIN, the only pairs whose gate needs
    the exponential; ``on_pairs``, those whose o exp(-q/2) reaches
    alpha_min (the pairs that composite); ``cull_pairs``, those whose
    warp's patch meets the slot's rectangle (``rs.cull_patches``), the
    pairs the kernels evaluate; and ``culled_on``, pairs that composite but
    fall outside the cull (must be 0)."""
    tp = cfg.tile_px
    T = sp.tiles_x * (-(-H // tp))
    used = torch.minimum(sp.counts[:T], nch[:T] * cfg.block_inst)
    pidx = torch.arange(tp * tp, device=feat.device)
    X, Y = pidx % tp, torch.div(pidx, tp, rounding_mode="floor")
    work = dict(slots=int(used.sum()), pairs=0, near_pairs=0, on_pairs=0,
                cull_pairs=0, culled_on=0)
    for pr in rs.window_pairs(sc.gather_stream(sp.gids, feat), sp.starts,
                              used, H, W, tp):
        o = pr.rows[:, 8:9]
        raw = o * torch.exp(-0.5 * pr.q)
        on = pr.inside & (raw >= cfg.alpha_min)
        cl = blend.blend_cull_plain(
            pr.rows, ((pr.tile % sp.tiles_x) * tp).float(),
            (torch.div(pr.tile, sp.tiles_x, rounding_mode="floor")
             * tp).float(), cfg.alpha_min, tile_px=tp)
        meets = rs.cull_patches(cl, tp, blend.PATCH)
        kept = ((pr.q <= cl.q_cut[:, None])
                & (X >= cl.x0[:, None]) & (X <= cl.x1[:, None])
                & (Y >= cl.y0[:, None]) & (Y <= cl.y1[:, None]))
        work["pairs"] += int(pr.inside.sum())
        work["near_pairs"] += int(
            (pr.inside & (pr.q <= cl.q_cut[:, None])).sum())
        work["on_pairs"] += int(on.sum())
        work["cull_pairs"] += int((pr.inside & meets).sum())
        work["culled_on"] += int((on & ~kept).sum())
    return work


def bound(instr: float, mufu: float, nbytes: float):
    """(bound ms, bound_by): the larger of the FP32 issue-slot and MUFU
    times at the card's peak and the byte time at its memory rate."""
    t_ops = max(instr / PEAK_F32_INSTR_S, mufu / PEAK_MUFU_S)
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# K8 and K9's operations, counted as K1's are, in FP32 issue slots and
# MUFU ops. Per near pair (see blend_pair_work) the quadratic form and its
# compare with q_cut (9), then -q/2, expf's 4 FP32 instructions around its
# MUFU ex2, o w, the clip and the gate (8 + 1 ex2), then K8's exp(logT)
# (4 + 1 ex2), log1pf (~7 + 1 lg2), vis, three multiply-adds and the logT
# add (19 + 2), or K9's log1pf, its two exps (T_k and 1 / (1 - alpha)),
# G.c, dalpha, dq and the nine sums with their share of the warp
# reductions (~60 + 3): (slots beyond the form, MUFU) per near pair.
BLEND_NEAR = {"fwd": (27, 3), "bwd": (68, 4)}
# Per consumed slot its cull, once: q_cut (a division, log's lg2 and its 4
# FP32 instructions, a multiply-add), the rectangle (det, kappa, Q, two
# square roots with their scaling and pads, four roundings, eight clamps:
# ~30 + 2 MUFU), and a 4-compare test of each 8 x 4 warp patch of the tile
CULL_OPS = (36, 3)
BLEND_WORK = ("slots", "pairs", "near_pairs", "on_pairs", "cull_pairs")


def blend_ops(case, near):
    """(FP32 slots, MUFU ops) K8 or K9 needs on a case's consumed chunks
    (blend_pair_work's counts): the form and the pair's terms on the near
    pairs, the only pairs that can composite, and each consumed slot's cull
    with its test of the tile's warp patches. The pairs beyond q_cut need
    no work: the cull skips them."""
    patches = case["tile_px"] ** 2 // 32
    return ((9 + near[0]) * case["near_pairs"]
            + (CULL_OPS[0] + 4 * patches) * case["slots"],
            near[1] * case["near_pairs"] + CULL_OPS[1] * case["slots"])


def blend_all_pairs(case, near):
    """The earlier count of the same work, kept for comparison with earlier
    records: the form on every pair of the consumed chunks, the pair's
    terms on the near pairs, no cull."""
    return 9 * case["pairs"] + near[0] * case["near_pairs"], \
        near[1] * case["near_pairs"]


def same_bits(torch, got, want) -> bool:
    """Whether ``got`` is NaN exactly where ``want`` is and equal to it bit
    for bit elsewhere."""
    nan = want.isnan()
    return bool(torch.equal(nan, got.isnan())
                and torch.equal(got[~nan].view(torch.int32),
                                want[~nan].view(torch.int32)))


def finite_max(torch, d) -> float:
    """max |d| over its finite entries (0 if none)."""
    d = d[torch.isfinite(d)].abs()
    return float(d.max()) if d.numel() else 0.0


def row_err(torch, got, want):
    """Per-row max of |got - want| / the column's max |want| (columns with
    a zero max compare absolutely)."""
    scale = want.abs().amax(dim=0).clamp(min=1e-30)
    return ((got - want).abs() / scale).amax(dim=1)


def rows_err(torch, got, want):
    """(row_err over the finite entries of ``want``, whether ``got`` is
    NaN and infinite exactly where ``want`` is, with the same signs).
    Where ``want`` is finite this is row_err and the finiteness of
    ``got``."""
    fin = torch.isfinite(want)
    same = (torch.equal(fin, torch.isfinite(got))
            and torch.equal(want[~fin].nan_to_num(nan=7.0),
                            got[~fin].nan_to_num(nan=7.0)))
    zero = torch.zeros_like(want)
    return row_err(torch, torch.where(fin, got, zero),
                   torch.where(fin, want, zero)), same


# K1-K3's operations, counted on the pairs the function needs (pair_work):
# per gated pair q and the gate (9 FP32 slots, an FMA as one) and the
# pair's terms: K1 -q/2, expf's 4 FP32 instructions around its MUFU ex2
# and 4 multiply-adds (13 + 1 ex2); K2 the same 9 for q, then -q/2 and
# expf (5 + 1 ex2), dw (4), dq (2), dq dx and dq dy (2), the five moments
# (5) and the four dcm sums (4): 22 + 1 ex2; K3 both walks (18 + 35, 2
# ex2). Per slot and walk its cull: the rectangle of CULL_OPS without
# q_cut's division and log (~30 + 2 MUFU) and a 4-compare test of each of
# the tile's patches (32 at 32 pixels, 8 at 16). (FP32 slots, MUFU, walks)
# per kernel.
SUM_GATED = {"rasterize_sum_fwd": (22, 1, 1), "rasterize_sum_bwd": (31, 1, 1),
             "rasterize_sum_l2": (53, 2, 2)}
SUM_CULL_OPS = (30, 2)  # the rectangle; + 4 per patch of the tile


def sum_ops(kernel, work, tp=32):
    """(FP32 slots, MUFU ops) K1, K2 or K3 needs on a stream's pairs at
    tiles of ``tp`` pixels: the gated pairs' q and terms, and a cull per
    slot and walk. The pairs that fail the gate need no work: a cull skips
    them."""
    slots, mufu, walks = SUM_GATED[kernel]
    cull = SUM_CULL_OPS[0] + 4 * (tp * tp // 32)
    return (slots * work["gated"] + walks * cull * work["slots"],
            mufu * work["gated"] + walks * SUM_CULL_OPS[1] * work["slots"])


def sum_all_pairs(kernel, work):
    """The earlier count of the same work, kept for comparison with
    earlier records: q and the gate on every pair of the windows (9 slots,
    18 for K3's two walks), the pair's terms on the gated ones, no cull."""
    slots, mufu, walks = SUM_GATED[kernel]
    return (9 * walks * work["pairs"] + (slots - 9 * walks) * work["gated"],
            mufu * work["gated"])


def traced_us(torch, fn):
    """``fn`` under torch.profiler (as profile_of traces), after one
    untraced run: {kernel name: (device us in all, launches seen)}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _us_per_launch(kernels, name):
    # kernel ``<name>_kernel``, templated or not: K4's name is a prefix of
    # K7's
    hits = [e for e in kernels if f"{name}_kernel(" in e.key
            or f"{name}_kernel<" in e.key]
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

    from gaussianimage_tpu_torch import batched as bt
    from gaussianimage_tpu_torch import test_quantize, train, train_quantize
    from gaussianimage_tpu_torch.blend_cull_scene import cull_edge_scene
    from gaussianimage_tpu_torch.core import clip01
    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.models.cholesky import CHOLESKY_BOUND
    from gaussianimage_tpu_torch.models.rs import SCALING_BOUND
    from gaussianimage_tpu_torch.ops import RasterizeConfig, _build
    from gaussianimage_tpu_torch.ops import rasterize_blend as blend
    from gaussianimage_tpu_torch.ops import rasterize_sum as rs
    from gaussianimage_tpu_torch.ops import splat_prep as prep
    from gaussianimage_tpu_torch.ops import splat_prep3d as p3
    from gaussianimage_tpu_torch.ops import stream_common as sc
    from gaussianimage_tpu_torch.ops import tiles as tiles_mod
    from gaussianimage_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          merge_matching,
                                                          params_from_numpy)
    from gaussianimage_tpu_torch.utils.image_io import image_path_to_array

    dev = torch.device("cuda", 0)
    counters = {"rasterize_sum_fwd": rs.sum_fwd,
                "rasterize_sum_bwd": rs.sum_bwd,
                "rasterize_sum_l2": rs.sum_l2,
                "splat_prep_raw": prep.raw_prep,
                "splat_prep_decode": prep.decode_prep,
                "splat_prep_decode_batch": prep.batch_decode_prep,
                "splat_prep_rs_raw": prep.rs_raw_prep,
                "splat_prep_rs_decode": prep.rs_decode_prep,
                "rasterize_blend_fwd": blend.blend_fwd,
                "rasterize_blend_bwd": blend.blend_bwd,
                "splat_prep_blend3d": p3.blend3d_prep,
                "stream_blockize": sc.blockize_stream,
                "stream_unblockize": sc.unblockize_stream}
    # the aligned stream's launches of K1-K3, K8 and K9, which also count
    # in the kernel's own counter above
    aligned_counters = {"rasterize_sum_fwd": rs.sum_fwd_aligned,
                        "rasterize_sum_bwd": rs.sum_bwd_aligned,
                        "rasterize_sum_l2": rs.sum_l2_aligned,
                        "rasterize_blend_fwd": blend.blend_fwd_aligned,
                        "rasterize_blend_bwd": blend.blend_bwd_aligned}
    all_counters = {**counters, **{f"{k}_aligned": fn for k, fn in
                                   aligned_counters.items()}}
    sum_kernels = ("rasterize_sum_fwd", "rasterize_sum_bwd",
                   "rasterize_sum_l2")

    def reset_counts():
        for fn in all_counters.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in all_counters.items()}

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
        if not same_bits(torch, out, rs.sum_fwd_plain(
                feat, sp.gids, sp.starts, Hm, Wm, in_order=True)):
            fail(f"K1 differs from the in-order plain version on {name}")
        cases[name] = {"shape": list(out.shape), "max_abs_err": err,
                       "in_order_bit_equal": True,
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
    if not same_bits(torch, rs.sum_bwd(feat, sp.gids, sp.starts, g, Hf, Wf),
                     dg2):
        fail("two runs of K2 on flower@10k differ")

    def window_slots(sp_, H_, tp=32):
        """The live slots of the windows of ``sp_`` (flat or aligned, tiles
        of ``tp`` pixels) and the tile of each."""
        T_ = sp_.tiles_x * (-(-H_ // tp))
        cnt = sp_.counts[:T_].long()
        tile = torch.repeat_interleave(torch.arange(T_, device=dev), cnt)
        slot = (sp_.starts[:T_].long()[tile] - (torch.cumsum(cnt, 0)
                                                 - cnt)[tile]
                + torch.arange(tile.numel(), device=dev))
        return slot, tile

    def k3_check(label, dg, dg_p, sse, sse_p, img_k, img_p, tile_of, T_,
                 tiles_x, clamp=True, tp=32):
        """K3's rows ``dg`` [L, 16] and per-tile SSE against its plain
        version's: the SSE within 1e-5 relative, every row to ROW_TOL of
        the column max but in tiles that hold a pixel whose clip mask
        differs between K1's image ``img_k`` and the plain one ``img_p``
        (at most MAX_FLIPS such pixels, their tiles' rows to
        FLIP_ROW_TOL; none under no clamp, which has no mask); rows NaN
        or infinite exactly where the plain version's are."""
        flipped = (((img_k > 0) & (img_k < 1)) != ((img_p > 0) & (img_p < 1))
                   ).any(dim=0).nonzero()                     # [f, 2] (y, x)
        if not clamp:
            flipped = flipped[:0]
        flips = int(flipped.shape[0])
        flip_tiles = torch.zeros(T_, dtype=torch.bool, device=dev)
        flip_tiles[(flipped[:, 0] // tp) * tiles_x + flipped[:, 1] // tp] = True
        in_flip = flip_tiles[tile_of]
        e, same = rows_err(torch, dg, dg_p)
        worst_clean = float(e[~in_flip].max()) if bool((~in_flip).any()) \
            else 0.0
        worst_flip = float(e[in_flip].max()) if bool(in_flip.any()) else 0.0
        sse_rel = abs(float(sse.sum()) / float(sse_p.sum()) - 1)
        if not (same and sse_rel <= 1e-5):
            fail(f"{label}: K3's SSE is {float(sse.sum())}, its plain "
                 f"version's {float(sse_p.sum())}; rows not finite where "
                 f"the plain version's are: {not same}")
        if (flips > MAX_FLIPS or worst_clean > ROW_TOL
                or worst_flip > FLIP_ROW_TOL):
            fail(f"{label}: K3 disagrees with its plain version: {flips} "
                 f"clip-mask flips (<= {MAX_FLIPS}); worst row {worst_clean} "
                 f"of the column max outside the flipped pixels' tiles (<= "
                 f"{ROW_TOL}), {worst_flip} inside them (<= {FLIP_ROW_TOL})")
        fin = torch.isfinite(dg_p)
        return {"worst_row": float(e.max()),
                "rows_past_tol": int((e > ROW_TOL).sum()),
                "clip_flips": flips, "worst_row_in_flip_tiles": worst_flip,
                "max_abs_err": float((dg - dg_p)[fin].abs().max()),
                "sse": float(sse.sum()), "sse_rel_err": sse_rel}

    def chain_check(label, dg3_, dg_chain_):
        """K3's rows against K1 -> L2 -> K2's, to CHAIN_TOL (NaN where the
        chain's are)."""
        e, same = rows_err(torch, dg3_, dg_chain_)
        if not same or float(e.max()) > CHAIN_TOL:
            fail(f"{label}: K3 disagrees with K1 -> L2 -> K2: worst row "
                 f"{float(e.max())} > {CHAIN_TOL} of the column max, or "
                 f"NaN elsewhere ({not same})")
        return float(e.max())

    def cull_check(label, work):
        """No pair that passes the gate falls outside the cull that K1, K2
        and K3 share."""
        if work["culled_gated"]:
            fail(f"{label}: K1-K3's cull drops {work['culled_gated']} pairs "
                 "that pass the gate")
        return work

    # K3 against its plain version, against K1 -> L2 -> K2, and twice
    sse3, dg3 = rs.sum_l2(feat, sp.gids, sp.starts, gt_f, Hf, Wf)
    torch.cuda.synchronize()
    sse3_plain, dg3_plain = rs.sum_l2_plain(feat, sp.gids, sp.starts, gt_f,
                                            Hf, Wf)
    img_k = rs.sum_fwd(feat, sp.gids, sp.starts, Hf, Wf)[:3]
    img_p = rs.sum_fwd_plain(feat, sp.gids, sp.starts, Hf, Wf)[:3]
    slot10, tile10 = window_slots(sp, Hf)
    k3_case = k3_check("flower@10k", dg3[slot10], dg3_plain[slot10], sse3,
                       sse3_plain, img_k, img_p, tile10, sp.T, sp.tiles_x)
    k3_err = k3_case["max_abs_err"]
    if not torch.isfinite(dg3).all():
        fail("K3's gradient rows are not finite on flower@10k")
    _, G = rs.l2_cotangent(img_k, gt_f, Hf, Wf)
    dg_chain = rs.sum_bwd(feat, sp.gids, sp.starts, G.contiguous(), Hf, Wf)
    e_chain = chain_check("flower@10k", dg3[live], dg_chain[live])
    work10 = cull_check("flower@10k", pair_work(torch, rs, sc, feat, sp, Hf,
                                                Wf, q_cut))
    dfeat = [sc.scatter_stream_grads(
        rs.sum_l2(feat, sp.gids, sp.starts, gt_f, Hf, Wf)[1], sp.gids,
        feat.shape[0], sp.m_span) for _ in range(2)]
    deterministic = bool(torch.equal(dfeat[0], dfeat[1]))
    if not deterministic:
        fail("two runs of K3 and the scatter on the same step differ")

    def sum_case(label, feat_, sp_, H_, W_, g_, gt_, clamp=True, tp=32):
        """K1, K2 and K3 on the stream ``sp_`` (flat or aligned, tiles of
        ``tp`` pixels) over the rows ``feat_`` against their plain versions
        (K1 to K1_TOL and bit for bit to the in-order plain version, K2's
        rows to ROW_TOL and bit-identical twice, K3 by k3_check), K3
        against K1 -> L2 -> K2, and the cull's work (no gated pair culled);
        K3's L2 clipped or not."""
        slot_, tile_ = window_slots(sp_, H_, tp)
        kw = {"tile_px": tp}
        if sp_.aligned:
            src = (sc.blockize_stream(feat_, sp_.gids), sp_.starts,
                   sp_.counts)
            run = (rs.sum_fwd_aligned, rs.sum_bwd_aligned, rs.sum_l2_aligned)
            ref = (rs.sum_fwd_aligned_plain, rs.sum_bwd_aligned_plain,
                   rs.sum_l2_aligned_plain)
            rows = sc.unblockize_stream_plain
        else:
            src = (feat_, sp_.gids, sp_.starts)
            run = (rs.sum_fwd, rs.sum_bwd, rs.sum_l2)
            ref = (rs.sum_fwd_plain, rs.sum_bwd_plain, rs.sum_l2_plain)
            rows = lambda d: d  # noqa: E731
        img = run[0](*src, H_, W_, **kw)
        dg2_ = run[1](*src, g_, H_, W_, **kw)
        sse_, dg3_ = run[2](*src, gt_, H_, W_, clamp=clamp, **kw)
        torch.cuda.synchronize()
        img_p_ = ref[0](*src, H_, W_, **kw)
        dg2_p = ref[1](*src, g_, H_, W_, **kw)
        sse_p, dg3_p = ref[2](*src, gt_, H_, W_, clamp=clamp, **kw)
        # K1_TOL per unit of the pixel's magnitude: these scenes' indefinite
        # rows add w = 1 over whole regions, so pixels reach tens, and the
        # plain version's index_add_ sums in the atomics' order
        k1e = float(((img - img_p_).abs() / img_p_.abs().clamp(min=1.0)).max())
        if not (bool(torch.isfinite(img).all()) and k1e <= K1_TOL):
            fail(f"{label}: K1 disagrees with its plain version: max |diff| "
                 f"{k1e} of max(1, |pixel|) (<= {K1_TOL})")
        if not same_bits(torch, img, ref[0](*src, H_, W_, in_order=True,
                                            **kw)):
            fail(f"{label}: K1 differs from the in-order plain version")
        e2_, same2 = rows_err(torch, rows(dg2_)[slot_], rows(dg2_p)[slot_])
        if not (same2 and float(e2_.max()) <= ROW_TOL):
            fail(f"{label}: K2 disagrees with its plain version: worst row "
                 f"{float(e2_.max())} (<= {ROW_TOL}), NaN elsewhere "
                 f"{not same2}")
        if not same_bits(torch, run[1](*src, g_, H_, W_, **kw), dg2_):
            fail(f"{label}: two runs of K2 differ")
        k3 = k3_check(label, rows(dg3_)[slot_], rows(dg3_p)[slot_], sse_,
                      sse_p, img[:3], img_p_[:3], tile_, sp_.T, sp_.tiles_x,
                      clamp, tp)
        if not same_bits(torch, run[2](*src, gt_, H_, W_, clamp=clamp,
                                       **kw)[1], dg3_):
            fail(f"{label}: two runs of K3 differ")
        _, G_ = rs.l2_cotangent(img[:3], gt_, H_, W_, clamp)
        chain = chain_check(label, rows(dg3_)[slot_], rows(
            run[1](*src, G_.contiguous(), H_, W_, **kw))[slot_])
        return {"k1_max_rel_err": k1e, "k1_in_order_bit_equal": True,
                "img_max": float(img_p_.abs().max()),
                "k2_worst_row": float(e2_.max()),
                "k2_bit_identical_twice": True,
                "k3": k3, "k3_vs_k1_l2_k2_worst_row": chain,
                "nan_rows": int(rows(dg3_p)[slot_].isnan().any(dim=1).sum()),
                "k1_max_abs_err": finite_max(torch, img - img_p_),
                "k2_max_abs_err": finite_max(
                    torch, (rows(dg2_) - rows(dg2_p))[slot_]),
                "k3_max_abs_err": finite_max(
                    torch, (rows(dg3_) - rows(dg3_p))[slot_]),
                "k3_bit_identical_twice": True,
                "work": cull_check(label, pair_work(
                    torch, rs, sc, feat_, sp_, H_, W_, q_cut, tp))}

    # NaN and negative forms (the gate's repair): the 300-point random
    # state's rows 0-11 take an infinite conic coefficient at an integer
    # center (the form is NaN where the pixel offset is 0, and -inf on two
    # quadrants for an infinite b), rows 12-23 an indefinite dyadic conic
    # at a half-integer center (the form is negative on a cone: q = 0);
    # flat and aligned
    small_al = make_model("GaussianImage_Cholesky", device=dev, num_points=N,
                          H=H, W=W, raster=RasterizeConfig(flat_stream_limit=0))
    small_al.load_state_dict(small.state_dict())
    g_s = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, H, W)).astype(np.float32) * 1e-2, device=dev)
    gt_s = torch.as_tensor(np.random.default_rng(4).uniform(
        0, 1, (3, H, W)).astype(np.float32), device=dev)
    indefinite = torch.tensor([[1.0, 3.0, 1.0], [0.5, -1.0, 0.25],
                               [2.0, -3.0, 1.0], [0.25, 0.5, -0.5],
                               [-1.0, 0.0, 0.125], [0.0, 0.75, 0.0]],
                              device=dev)
    nan_form = {}
    for name, model in (("flat", small), ("aligned", small_al)):
        feat_s, sp_s = stream_inputs(model)
        feat_s[0:12, 0:2] = torch.round(feat_s[0:12, 0:2])
        feat_s[12:24, 0:2] = torch.round(feat_s[12:24, 0:2]) + 0.5
        for i in range(12):
            feat_s[i, 2 + i % 3] = -math.inf if i % 3 == 1 else math.inf
        feat_s[12:24, 2:5] = indefinite[torch.arange(12, device=dev) % 6]
        nan_form[name] = sum_case(f"nan_form {name}", feat_s, sp_s, H, W,
                                  g_s, gt_s)
        if not (nan_form[name]["work"]["nan_pairs"] and
                nan_form[name]["nan_rows"]):
            fail(f"nan_form {name}: the case holds no NaN form")

    # K1-K3 on the cull's adversarial scene (blend_cull_scene; its NaN
    # opacities set to 0.5: K3's cull reads the conic and the center), flat
    # and aligned, K3 under no clamp: the scene's indefinite rows saturate
    # the clipped image, whose cotangent would then be 0 almost everywhere
    ce = cull_edge_scene(CULL_N, *CULL_HW, seed=CULL_SEED)
    ce_op = np.nan_to_num(ce["opac"], nan=0.5)
    ce_xys, ce_radii = (torch.as_tensor(ce[k], device=dev)
                        for k in ("xys", "radii"))
    feat_ce = sc.pack_feat(ce_xys, torch.as_tensor(ce["conics"], device=dev),
                           torch.as_tensor(ce["colors"], device=dev),
                           torch.as_tensor(ce_op, device=dev),
                           premultiply=True)
    g_ce3 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4, *CULL_HW)).astype(np.float32) * 1e-2, device=dev)
    gt_ce = torch.as_tensor(np.random.default_rng(6).uniform(
        0, 1, (3, *CULL_HW)).astype(np.float32), device=dev)
    k3_edge = {}
    for name, limit in (("flat", 1 << 30), ("aligned", 0)):
        sp_ce = sc.prepare_stream(ce_xys, (ce_radii, ce_radii), *CULL_HW,
                                  RasterizeConfig(
                                      max_instances=1 << 17,
                                      max_tiles_per_gauss=1024,
                                      flat_stream_limit=limit))
        k3_edge[name] = sum_case(f"k3_cull_edge {name}", feat_ce, sp_ce,
                                 *CULL_HW, g_ce3, gt_ce, clamp=False)
        k3_edge[name]["n_dropped"] = int(sp_ce.n_dropped)
    # masked: the flower@10k stream at the wMask model's opacities (the
    # mask premultiplies the color rows): a share exactly 0, the rest a
    # sigmoid of seeded logits, a few below 1e-20; K1 bit for bit to the
    # in-order plain version, K2 / K3 as on the opacity-1 rows; then K1's
    # and K2's device times on both sets of rows
    rng_m = np.random.default_rng(MASK_SEED)
    n10 = feat.shape[0] - 1
    logit_m = rng_m.normal(0.0, 3.0, n10).astype(np.float32)
    logit_m[:MASK_TINY] = np.linspace(-50.0, -47.0, MASK_TINY)
    off_m = rng_m.random(n10) < MASK_ZERO_SHARE
    off_m[:MASK_TINY] = False
    opac_m = torch.sigmoid(torch.as_tensor(logit_m, device=dev))
    opac_m[torch.as_tensor(off_m, device=dev)] = 0.0
    with torch.no_grad():
        xys_f, _, conics_f, colors_f, _ = flower.splat()
        feat_m = sc.pack_feat(xys_f, conics_f, colors_f, opac_m[:, None],
                              premultiply=True)
    masked = sum_case("masked", feat_m, sp, Hf, Wf, g, gt_f)

    def k12_device_us(feat_):
        tr = traced_us(torch, lambda: [
            (rs.sum_fwd(feat_, sp.gids, sp.starts, Hf, Wf),
             rs.sum_bwd(feat_, sp.gids, sp.starts, g, Hf, Wf))
            for _ in range(20)])
        out = {}
        for k in ("rasterize_sum_fwd", "rasterize_sum_bwd"):
            hits = [v for key, v in tr.items() if f"{k}_kernel" in key]
            out[k] = (sum(us for us, _ in hits)
                      / max(sum(n for _, n in hits), 1))
        return out

    masked.update(
        opacity={"zero": int((opac_m == 0).sum()),
                 "below_1e-20": int(((opac_m > 0) & (opac_m < 1e-20)).sum()),
                 "in_0_1": int(((opac_m > 0) & (opac_m < 1)).sum()),
                 "rows": n10},
        device_us={"masked": k12_device_us(feat_m),
                   "opacity_1": k12_device_us(feat)})
    # K1-K3 at tile 16, the sharded fit's default tile: flat on the
    # flower@10k state, whose stream at 16 fills the auto cap of 40,000
    # instances and drops the rest (reported), aligned on flower@40k
    def stream16(params_np):
        m = make_model("GaussianImage_Cholesky", device=dev,
                       num_points=params_np["_xyz"].shape[0], H=Hf, W=Wf,
                       raster=RasterizeConfig(tile_px=16), block_h=16,
                       block_w=16)
        m.load_state_dict(params_from_numpy(params_np, dev))
        return stream_inputs(m)

    ck40 = load_checkpoint(FLOWER40_DIR / "flower" / "gaussian_model.npz")
    feat16, sp16 = stream16(ckpt["params"])
    featA16, spA16 = stream16(ck40["params"])
    if sp16.aligned or not spA16.aligned:
        fail(f"tile 16: flower@10k aligned {sp16.aligned}, flower@40k "
             f"aligned {spA16.aligned}")
    tile16 = {}
    for name, f_, s_ in (("flat_flower_10k", feat16, sp16),
                         ("aligned_flower_40k", featA16, spA16)):
        tile16[name] = sum_case(f"tile16 {name}", f_, s_, Hf, Wf, g, gt_f,
                                tp=16)
        tile16[name].update(n_dropped=int(s_.n_dropped), capacity=s_.I,
                            live=int(s_.counts[:s_.T].sum()))

    # K5 and K4, the fused splat prep, under serving(10000)
    serve_cfg = RasterizeConfig.serving(SERVE_N)
    I_s, m_s, _ = sc.stream_caps(SERVE_N, serve_cfg)
    q_s = float(serve_cfg.q_cut)

    def prep_check(name, out, ref, bits=False):
        """A fused prep's (feat, keys [M, N+1], stats [2, N+1]) against its
        plain version's: sorted keys, (trunc, n_total) and feature rows to
        PREP_TOL, the keys in their slot-major layout and the per-row
        counts equal (torch.equal); with ``bits`` (every front: K4-K7
        and K10) also the rows bit for bit."""
        (feat_k, keys_k, stats_k), (feat_p, keys_p, stats_p) = out, ref
        err = float((feat_k - feat_p).abs().max())
        keys_equal = bool(torch.equal(torch.sort(keys_k.flatten()).values,
                                      torch.sort(keys_p.flatten()).values))
        tot, tot_p = stats_k.sum(dim=1).tolist(), stats_p.sum(dim=1).tolist()
        res = {"max_abs_err": err, "tol": PREP_TOL,
               "bit_equal": bool(torch.equal(feat_k, feat_p)),
               "sorted_keys_equal": keys_equal,
               "keys_equal": bool(torch.equal(keys_k, keys_p)),
               "row_counts_equal": bool(torch.equal(stats_k, stats_p)),
               "trunc": tot[0], "n_total": tot[1], "span": keys_k.shape[0]}
        if not (keys_equal and tot == tot_p and math.isfinite(err)
                and err <= PREP_TOL and res["keys_equal"]
                and res["row_counts_equal"]
                and (res["bit_equal"] or not bits)):
            fail(f"{name} disagrees with its plain version: sorted keys "
                 f"equal {keys_equal}, (trunc, n_total) {tot} against "
                 f"{tot_p}, feature rows max |diff| {err} (<= {PREP_TOL}), "
                 f"keys [M, N+1] equal {res['keys_equal']}, row counts "
                 f"equal {res['row_counts_equal']}, rows bit-equal "
                 f"{res['bit_equal']} (required: {bits})")
        return res

    flower_s = make_model("GaussianImage_Cholesky", device=dev,
                          num_points=SERVE_N, H=512, W=768, raster=serve_cfg)
    flower_s.load_state_dict(flower.state_dict())
    k5_args = (flower_s._xyz.detach(), flower_s._cholesky.detach(),
               flower_s._features_dc.detach(), CHOLESKY_BOUND, Hf, Wf,
               serve_cfg.tile_px, m_s, q_s)
    out5 = prep.raw_prep(*k5_args)
    torch.cuda.synchronize()
    k5 = prep_check("K5", out5, prep.raw_prep_plain(*k5_args), bits=True)
    # K5's stream against the generic binning of the same parameters
    gids5, starts5, _ = rs.stream_from_keys(out5[1].reshape(-1), SERVE_N,
                                            Hf, Wf, serve_cfg, I_s)
    _, sp_gen = stream_inputs(flower_s)
    k5["stream_vs_generic"] = {
        "instances": int(sp_gen.starts[sp_gen.T]),
        "instances_differ": int((gids5 != sp_gen.gids).sum()),
        "starts_equal": bool(torch.equal(starts5, sp_gen.starts))}
    # K5 on its first n rows: a partial last CTA (64 rows) and warp
    for n in EDGE_ROWS:
        args = (*(a[:n] for a in k5_args[:3]), *k5_args[3:])
        out = prep.raw_prep(*args)
        torch.cuda.synchronize()
        k5[f"n{n}"] = prep_check(f"K5 (N = {n})", out,
                                 prep.raw_prep_plain(*args), bits=True)
    # K5 on seeded adversarial rows of the fit, a kind a row (row % 4;
    # kind 0 as it is): Cholesky factors at the conic's 1e-6 determinant
    # floor (L within 1e-4 of zero after the bound), means at the canvas's
    # edges (tanh saturated: bboxes past the canvas, clipped to it), and
    # factors of 8-30 px whose bboxes span more tiles than M (truncated)
    er5 = np.random.default_rng(K5_EDGE_SEED)
    kind5 = torch.arange(SERVE_N, device=dev) % 4
    n_k5 = [int((kind5 == k).sum()) for k in range(4)]

    def uniform5(k, lo, hi, cols):
        return torch.as_tensor(er5.uniform(lo, hi, (n_k5[k], cols)),
                               device=dev, dtype=torch.float32)

    xyz_e5, chol_e5 = (a.clone() for a in k5_args[:2])
    chol_e5[kind5 == 1] = (uniform5(1, -1e-4, 1e-4, 3) - torch.as_tensor(
        CHOLESKY_BOUND, device=dev))
    xyz_e5[kind5 == 2] = uniform5(2, 3.0, 10.0, 2) * torch.as_tensor(
        er5.choice([-1.0, 1.0], (n_k5[2], 2)), device=dev,
        dtype=torch.float32)
    chol_e5[kind5 == 3] = uniform5(3, 8.0, 30.0, 3)
    k5_edge = (xyz_e5, chol_e5, *k5_args[2:])
    out = prep.raw_prep(*k5_edge)
    torch.cuda.synchronize()
    k5["adversarial"] = prep_check("K5 (adversarial rows)", out,
                                   prep.raw_prep_plain(*k5_edge), bits=True)
    if k5["adversarial"]["trunc"] == 0:
        fail("K5's adversarial rows truncated no bbox")
    china_s = make_model("GaussianImage_Cholesky", device=dev,
                         num_points=SERVE_N, H=512, W=768, quantize=True,
                         raster=serve_cfg)
    ckq = load_checkpoint(QAT_DIR / "china" / "gaussian_model.best.npz")
    merge_matching(china_s, ckq["params"], ckq["extra"])
    enc_c = china_s.compress_wo_ec()
    k4_args = (torch.as_tensor(enc_c["xyz"], device=dev).float(),
               torch.as_tensor(enc_c["quant_cholesky"], device=dev),
               torch.as_tensor(enc_c["feature_dc_index"], device=dev),
               china_s.cholesky_quant_scale.detach(),
               china_s.cholesky_quant_beta.detach(),
               china_s.features_vq.combined_codebook(
                   china_s.vq_state()).contiguous(),
               CHOLESKY_BOUND, 512, 768, serve_cfg.tile_px, m_s, q_s)
    out4 = prep.decode_prep(*k4_args)
    torch.cuda.synchronize()
    k4 = prep_check("K4", out4, prep.decode_prep_plain(*k4_args), bits=True)
    # K4 on the first n code rows: a partial last CTA (64 rows) and warp
    for n in EDGE_ROWS:
        args = (*(a[:n] for a in k4_args[:3]), *k4_args[3:])
        out = prep.decode_prep(*args)
        torch.cuda.synchronize()
        k4[f"n{n}"] = prep_check(f"K4 (N = {n})", out,
                                 prep.decode_prep_plain(*args), bits=True)
    # K7 on the QAT codes stacked, under the batched decode's config
    flower_q = make_model("GaussianImage_Cholesky", device=dev,
                          num_points=SERVE_N, H=512, W=768, quantize=True,
                          raster=serve_cfg)
    ckf = load_checkpoint(QAT_DIR / "flower" / "gaussian_model.best.npz")
    merge_matching(flower_q, ckf["params"], ckf["extra"])
    enc_f = flower_q.compress_wo_ec()

    def k7_args(frames):
        """K7's arguments for the (model, code arrays) frames stacked."""
        B = len(frames)
        _, m7, _ = sc.stream_caps(
            B * SERVE_N, china_s.cfg.raster.stacked(SERVE_N, B))

        def cat(key, dtype):
            return torch.as_tensor(np.concatenate([e[key] for _, e in frames]),
                                   device=dev).to(dtype).contiguous()

        return (cat("xyz", torch.float32), cat("quant_cholesky", torch.int32),
                cat("feature_dc_index", torch.int32),
                torch.stack([m.cholesky_quant_scale.detach()
                             for m, _ in frames]),
                torch.stack([m.cholesky_quant_beta.detach()
                             for m, _ in frames]),
                torch.cat([m.features_vq.combined_codebook(m.vq_state())
                           for m, _ in frames]).contiguous(),
                CHOLESKY_BOUND, B, 512 * B, 768, serve_cfg.tile_px, m7, q_s)

    def k7_cut(args, n):
        """``args`` (K7's, of B frames of SERVE_N rows) cut to the first n
        rows of each frame."""
        B = args[7]
        return (*(torch.cat([a[f * SERVE_N:f * SERVE_N + n]
                             for f in range(B)]).contiguous()
                  for a in args[:3]), *args[3:])

    k7 = {}
    k7_main = k7_args([(china_s, enc_c), (flower_q, enc_f)])
    k7_b6 = k7_args([(china_s, enc_c), (flower_q, enc_f)] * 3)
    # B = 2 at 10,000 rows a frame: frame 1 begins 16 rows into CTA 156;
    # B = 2 of 65 rows: a boundary inside a CTA, the tables in shared
    # memory; frames under 64 rows (B = 3 of 33, B = 6 of 10) take the
    # variant that reads them through the cache
    for name, args in (
            ("B2", k7_main), ("B6", k7_b6),
            ("B2_n65", k7_cut(k7_main, 65)),
            ("B3_n33", k7_cut(k7_args([(china_s, enc_c), (flower_q, enc_f),
                                       (china_s, enc_c)]), 33)),
            ("B6_n10", k7_cut(k7_b6, 10))):
        out7 = prep.batch_decode_prep(*args)
        torch.cuda.synchronize()
        k7[name] = prep_check(f"K7 ({name})", out7,
                              prep.batch_decode_prep_plain(*args), bits=True)
    out7 = prep.batch_decode_prep(*k7_args([(china_s, enc_c)]))
    torch.cuda.synchronize()
    k7_vs_k4 = float((out7[0] - out4[0]).abs().max())
    if not (k7_vs_k4 == 0.0 and torch.equal(out7[1], out4[1])
            and torch.equal(out7[2], out4[2])):
        fail(f"K7 at B=1 differs from K4: rows max |diff| {k7_vs_k4}, keys "
             f"equal {torch.equal(out7[1], out4[1])}, counts equal "
             f"{torch.equal(out7[2], out4[2])}")
    k7["B1_vs_k4"] = {"max_abs_diff": k7_vs_k4, "keys_equal": True,
                      "counts_equal": True}
    k7_err = max(v["max_abs_err"] for k, v in k7.items() if k != "B1_vs_k4")

    phase("kernel", k5=k5, k4=k4, k7=k7, k1={"tol": K1_TOL, "cases": cases,
                                             "work": work10},
          k2={"row_tol": ROW_TOL, "worst_row": float(e2.max()),
              "max_abs_err": k2_err, "instances": n_live,
              "bit_identical_twice": True, "work": work10},
          k3={"row_tol": ROW_TOL, **k3_case, "flip_row_tol": FLIP_ROW_TOL,
              "vs_k1_l2_k2_worst_row": e_chain, "chain_tol": CHAIN_TOL,
              "bit_identical_twice": deterministic, "work": work10},
          nan_form=nan_form, k3_cull_edge=k3_edge, masked=masked,
          tile16=tile16)

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

    # -- serve: render_fast under serving(10000), counts read around it ------
    ported = tuple(counters)
    nd_timed = []

    def serve_one():
        img, aux = flower_s.render_fast(with_aux=True)
        nd_timed.append(aux["n_dropped"])
        return img

    reset_counts()
    img_s = serve_one()
    serve_ms = burst_ms(torch, serve_one, reps=30)
    serve_counts = read_counts()
    nd_timed = torch.stack(nd_timed).cpu()
    with torch.no_grad():
        img_ref = flower.render()["render"]
    diff = (img_s - img_ref).abs()
    edge_px = int((diff > 1e-4).sum())
    off_edge = float(diff[diff <= 1e-4].max())
    serve_psnr = 10 * math.log10(1.0 / float(torch.mean((img_s - gt_f[None])
                                                         ** 2)))
    if serve_counts["splat_prep_raw"] == 0 or serve_counts[
            "rasterize_sum_fwd"] == 0:
        fail(f"render_fast launched {serve_counts}")
    if int(nd_timed.max()) != 0:
        fail(f"render_fast dropped instances on a timed render: "
             f"{nd_timed.tolist()}")
    if edge_px > MAX_EDGE_PX or off_edge > IMG_TOL:
        fail(f"render_fast differs from render(): {edge_px} pixels above "
             f"1e-4 (<= {MAX_EDGE_PX}), the rest up to {off_edge} "
             f"(<= {IMG_TOL})")
    if abs(serve_psnr - FLOWER_PSNR) > 0.01:
        fail(f"render_fast PSNR {serve_psnr} is not within 0.01 dB of "
             f"{FLOWER_PSNR}")
    with torch.no_grad():
        default_ms = burst_ms(torch, flower.render, reps=30)
        serve_prof = profile_of(
            torch, lambda: [flower_s.render_fast()
                            for _ in range(train.FPS_FRAMES)],
            train.FPS_FRAMES, ported)
    phase("serve", config="RasterizeConfig.serving(10000)",
          stream_cap=I_s, span=m_s, launches=serve_counts,
          renders=len(nd_timed), n_dropped_timed_max=int(nd_timed.max()),
          max_abs_diff_vs_render=float(diff.max()),
          pixels_above_1e4=edge_px, psnr=serve_psnr,
          render_fast_ms=serve_ms, render_default_ms=default_ms,
          render_fast_profile=serve_prof)

    # -- codec: the codec CLI on the QAT checkpoints, counts read around it --
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_codec_")
    try:
        reset_counts()
        codec = test_quantize.main([
            "--data_name", "photos", "--dataset", str(ROOT / "data"),
            "--model_path", str(QAT_DIR), "--num_points", "10000",
            "--checkpoint_root", out_dir])
        codec_counts = read_counts()
        codec_txt = {r["image"]: (
            Path(out_dir) / "photos" / "GaussianImage_Cholesky_50000_10000"
            / r["image"] / "test.txt").read_text().strip().splitlines()[-5:]
            for r in codec}
        root_txt = (Path(out_dir) / "photos" /
                    "GaussianImage_Cholesky_50000_10000" / "test.txt"
                    ).read_text()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    by_codec = {r["image"]: r for r in codec}
    dd = re.search(r"Dataset decode \((\d+) frames/pass, (\w+) strategy\): "
                   r"([0-9.]+) FPS", root_txt)
    if dd is None:
        fail("the codec CLI printed no Dataset decode line")
    dataset_decode = {"line": dd.group(0), "frames_per_pass": int(dd.group(1)),
                      "strategy": dd.group(2), "fps": float(dd.group(3))}
    for name, want in CODEC_ANCHORS.items():
        r = by_codec[name]
        if (abs(r["psnr"] - want["psnr"]) > 0.01
                or abs(r["ms-ssim"] - want["ms-ssim"]) > 1e-4
                or round(r["bpp"], 4) != want["bpp"]
                or round(r["bpp_ec"], 4) != want["bpp_ec"]
                or not r["ec_roundtrip_err"] < 1e-6):
            fail(f"codec {name}: psnr {r['psnr']}, ms-ssim {r['ms-ssim']}, "
                 f"bpp {r['bpp']}, bpp_ec {r['bpp_ec']}, round trip "
                 f"{r['ec_roundtrip_err']}; want {want}, round trip < 1e-6")
    if codec_counts["splat_prep_decode"] < MIN_K4:
        fail(f"the codec run launched K4 {codec_counts['splat_prep_decode']}"
             f" times, fewer than {MIN_K4}")
    if by_codec["china"]["probe_model"] != "serving":
        fail("china's decode probe did not take the serving twin")
    if not (by_codec["flower"]["serving_n_dropped"] > 0
            and by_codec["flower"]["probe_model"] == "default"):
        fail("flower's serving twin should drop instances and its probe "
             "take the default model")
    # china's K4 image against its generic decode (outside the counted run)
    ev = test_quantize.CodecEvaluator2d(
        image_path_to_array(ROOT / "data/china_768x512.png"), "china",
        num_points=10000, model_path=QAT_DIR / "china" /
        "gaussian_model.best.npz", log_dir=tempfile.mkdtemp(
            prefix="chip_smoke_codec_"), device=dev)
    enc_dev = {k: torch.as_tensor(v, device=dev)
               for k, v in ev.model.compress_wo_ec().items()}
    dec_k4 = ev.model_s.decompress_wo_ec(enc_dev)
    dec_gen = ev.model.decompress_wo_ec(enc_dev)["render"]
    shutil.rmtree(ev.log_dir, ignore_errors=True)
    diff = (dec_k4["render"] - dec_gen).abs()
    k4_edge = int((diff > 1e-4).sum())
    k4_off = float(diff[diff <= 1e-4].max())
    if k4_edge > MAX_EDGE_PX or k4_off > IMG_TOL:
        fail(f"china's K4 decode differs from its generic decode: {k4_edge} "
             f"pixels above 1e-4, the rest up to {k4_off}")
    keys = ("psnr", "ms-ssim", "bpp", "bpp_ec", "ec_roundtrip_err",
            "rendering_fps", "rendering_time", "rendering_fps_ec",
            "rendering_time_ec", "rendering_time_ec_rans",
            "rendering_time_ec_h2d", "rendering_time_ec_device",
            "serving_n_dropped", "probe_model")
    phase("codec", launches=codec_counts,
          images={k: {m: r[m] for m in keys} for k, r in by_codec.items()},
          china_k4_vs_generic={"max_abs_diff": float(diff.max()),
                               "pixels_above_1e4": k4_edge,
                               "n_dropped": int(dec_k4["raster_aux"]
                                                ["n_dropped"])},
          dataset_decode=dataset_decode, test_txt=codec_txt)

    # -- batched: decode_many through K7, counts read around it --------------
    model_f = make_model("GaussianImage_Cholesky", device=dev,
                         num_points=SERVE_N, H=512, W=768, quantize=True,
                         raster=RasterizeConfig(fused_prep=True))
    model_g = make_model("GaussianImage_Cholesky", device=dev,
                         num_points=SERVE_N, H=512, W=768, quantize=True)
    china_ref = china_s.decompress_wo_ec(enc_c)["render"]  # K4, one frame

    def stack(frames):
        return test_quantize.stack_frames([m for m, _ in frames],
                                          [e for _, e in frames], dev)

    def img_check(name, got, want):
        diff = (got - want).abs()
        edge = int((diff > 1e-4).sum())
        off = float(diff[diff <= 1e-4].max())
        if edge > MAX_EDGE_PX or off > IMG_TOL:
            fail(f"{name}: {edge} pixels above 1e-4 (<= {MAX_EDGE_PX}), the "
                 f"rest up to {off} (<= {IMG_TOL})")
        return {"max_abs_diff": float(diff.max()), "pixels_above_1e4": edge}

    stacks = {B: stack([(china_s, enc_c)] * B) for B in BATCHES}
    pair = stack([(china_s, enc_c), (flower_q, enc_f)])
    gt_china_t = torch.as_tensor(image_path_to_array(
        ROOT / "data/china_768x512.png"), device=dev)

    def psnr_of(img):
        return 10 * math.log10(1.0 / float(torch.mean((img - gt_china_t[0])
                                                      ** 2)))

    reset_counts()
    outs = {B: bt.decode_many(model_f, *stacks[B], force="batched")
            for B in BATCHES}
    out_pair = bt.decode_many(model_f, *pair, force="batched")
    batched_counts = read_counts()
    china_psnr = psnr_of(china_ref[0])
    batched_out = {}
    for B in BATCHES:
        out = outs[B]
        gen = bt.decompress_wo_ec_batch(model_g, *stacks[B])
        nd = int(out["raster_aux"]["n_dropped"])
        if nd != 0 or int(gen["raster_aux"]["n_dropped"]) != 0:
            fail(f"the batched decodes of china x {B} dropped instances: "
                 f"{nd} (K7), {int(gen['raster_aux']['n_dropped'])} "
                 "(generic)")
        frames = []
        for f in range(B):
            diff = (out["render"][f] - china_ref[0]).abs()
            frames.append({"max_abs_diff": float(diff.max()),
                           "pixels_above_1e4": int((diff > 1e-4).sum()),
                           "psnr": psnr_of(out["render"][f])})
        if frames[0]["max_abs_diff"] != 0.0:
            fail(f"frame 0 of china x {B} differs from its single-frame K4 "
                 f"decode: {frames[0]}")
        worst = max(abs(fr["psnr"] - china_psnr) for fr in frames)
        if worst > FRAME_PSNR_TOL:
            fail(f"a frame of china x {B} is {worst} dB off its single-frame "
                 f"decode's {china_psnr} dB (<= {FRAME_PSNR_TOL})")
        batched_out[f"china_x{B}"] = {
            "n_dropped": nd, "frames_vs_k4": frames,
            "vs_generic_stacked": img_check(
                f"china x {B} against the generic stacked decode",
                out["render"], gen["render"])}
    gen_pair = bt.decompress_wo_ec_batch(model_g, *pair)
    batched_out["china_flower"] = {
        "n_dropped": int(out_pair["raster_aux"]["n_dropped"]),
        "n_dropped_generic": int(gen_pair["raster_aux"]["n_dropped"]),
        "vs_generic_stacked": img_check(
            "china + flower against the generic stacked decode",
            out_pair["render"], gen_pair["render"])}
    if batched_counts["splat_prep_decode_batch"] == 0:
        fail(f"the batched decodes launched {batched_counts}")
    strategy_ms = {}
    for B in BATCHES:
        strategy_ms[B] = {
            s: burst_ms(torch, lambda: bt.decode_many(
                model_f, *stacks[B], force=s), reps=20) / B
            for s in bt.STRATEGIES}
    phase("batched", launches=batched_counts, decodes=batched_out,
          ms_per_frame=strategy_ms,
          prefer_batched_768x512={
              B: "batched" if bt.prefer_batched(512, 768, B, SERVE_N)
              else "scan" for B in BATCHES},
          batched_win_max_pixels=bt.BATCHED_WIN_MAX_PIXELS,
          batched_win_frames=bt.BATCHED_WIN_FRAMES)

    # -- qat: QuantizeTrainer2d on china, counts read around it --------------
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_qat_")
    gt_china = image_path_to_array(ROOT / "data/china_768x512.png")
    try:
        reset_counts()
        qt = train_quantize.QuantizeTrainer2d(
            gt_china, "china", num_points=SERVE_N, iterations=QAT_ITERS,
            model_path=FLOWER_DIR / "china" / "gaussian_model.npz",
            args=train_quantize.parse_args(["--lr", "1e-3"]),
            log_dir=Path(out_dir) / "china", device=dev)
        qat = qt.train()
        qat_counts = read_counts()
        qat_txt = (Path(out_dir) / "china" / "train.txt").read_text()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    qlosses = np.asarray(qt.losses)
    if not np.isfinite(qlosses).all() or len(qlosses) != QAT_ITERS:
        fail(f"QAT: {len(qlosses)} losses, "
             f"{int((~np.isfinite(qlosses)).sum())} not finite")
    if any(qt.chunk_dropped):
        fail(f"instances dropped during QAT: {qt.chunk_dropped}")
    if (qat_counts["rasterize_sum_fwd"] < QAT_ITERS
            or qat_counts["rasterize_sum_bwd"] < QAT_ITERS
            or qat_counts["rasterize_sum_l2"] != 0):
        fail(f"QAT launched {qat_counts}: want >= {QAT_ITERS} K1 and K2, "
             "no K3")
    if not qat["best_training_psnr"] >= QAT_BEST_PSNR:
        fail(f"QAT best training PSNR {qat['best_training_psnr']} < "
             f"{QAT_BEST_PSNR}")
    # the best state (the trainer's model now holds it): bpp and K4 decode
    enc_q = qt.model.compress_wo_ec()
    bpp_q = qt.model.analysis_wo_ec(enc_q)["bpp"]
    if round(bpp_q, 4) != QAT_BPP:
        fail(f"QAT best state's bpp {bpp_q}, want {QAT_BPP}")
    twin = make_model("GaussianImage_Cholesky", device=dev,
                      num_points=SERVE_N, H=512, W=768, quantize=True,
                      raster=RasterizeConfig(fused_prep=True))
    twin.load_state_dict(qt.model.state_dict())
    k4_before = prep.decode_prep.launches
    with torch.no_grad():
        dec_q = twin.decompress_wo_ec(
            {k: torch.as_tensor(v, device=dev) for k, v in enc_q.items()})
        eval_q = qt.model.render_quantize(training=False)["render"]
    if prep.decode_prep.launches == k4_before:
        fail("the QAT state's decode did not take K4")
    qat_decode = img_check("the QAT state's K4 decode against its "
                           "evaluation render", dec_q["render"], eval_q)
    qat_prof = profile_of(
        torch, lambda: [qt.model.train_step(qt.optimizer, qt.gt_image)
                        for _ in range(20)], 20, ported)
    phase("qat", iterations=QAT_ITERS, launches=qat_counts,
          best_training_psnr=qat["best_training_psnr"],
          test_psnr=qat["psnr"], best_test_psnr=qat["best_psnr"],
          best_ms_ssim=qat["best_ms_ssim"], bpp_measured=qat["best_bpp"],
          bpp_wo_ec=bpp_q, decode_vs_eval_render=qat_decode,
          n_dropped_chunks_max=max(qt.chunk_dropped),
          training_s=qat["training_time"],
          ms_per_step=1e3 * qat["training_time"] / QAT_ITERS,
          fps=qat["fps"], train_txt=qat_txt.strip().splitlines()[-4:],
          step_profile=qat_prof)

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
    # pixel-channels of the init's render at exactly 0 (colors of 0 on
    # black pixels): where the clip's tie gradient splits, as jnp.clip's
    with torch.no_grad():
        init_zeros = int((generic.render()["render"] == 0).sum())
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
          loss_last=float(gen_losses[-1]),
          init_pixel_channels_at_zero=init_zeros)

    # -- sharded: the sharded fit CLI at its defaults, 1 x 1 x 1 -------------
    def sharded_model(n):
        """The sharded CLI's model at ``n`` points on flower's 768x512."""
        return make_model("GaussianImage_Cholesky", device=dev, num_points=n,
                          H=Hf, W=Wf, raster=RasterizeConfig(tile_px=16),
                          block_h=16, block_w=16, init_mode="adaptive")

    from gaussianimage_tpu_torch import train_sharded
    from gaussianimage_tpu_torch.datasets import iterate_dataset
    from gaussianimage_tpu_torch.parallel import (
        init_sharded_fit, make_mesh, make_sharded_train_step)
    from gaussianimage_tpu_torch.parallel import scaling_bench
    from gaussianimage_tpu_torch.parallel.fit import load_fit as load_shards

    mesh1 = make_mesh()
    photos = dict(iterate_dataset("photos", str(ROOT / "data")))

    def psnr_of(img, gt):
        mse = torch.mean((img - torch.as_tensor(gt, device=dev)[0]) ** 2)
        return float(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))

    # each image's initial state, as the CLI draws it (seed 1), and its PSNR
    init_psnr = {}
    for name, im in photos.items():
        st = init_sharded_fit(sharded_model(SHARD_N), mesh1, im, seed=1)
        with torch.no_grad():
            init_psnr[name] = psnr_of(st.model.render()["render"][0], im)
    # the first SHARD_EQ_STEPS sharded steps against model.train_step from
    # the same init (flower), bit for bit: loss, parameters, Adan's moments
    st = init_sharded_fit(sharded_model(SHARD_N), mesh1, photos["flower"],
                          seed=1)
    ref = sharded_model(SHARD_N)
    ref.load_state_dict(st.model.state_dict())
    opt_ref = ref.make_optimizer()
    gt_ref = torch.as_tensor(photos["flower"], device=dev)
    step1 = make_sharded_train_step(st.model, mesh1, n_steps=1)
    eq_losses = True
    for i in range(SHARD_EQ_STEPS):
        loss_s, _, _ = step1(st)
        m_ref = ref.train_step(opt_ref, gt_ref, iteration=i + 1)
        eq_losses &= same_bits(torch, loss_s, m_ref["loss"])
    eq_params = all(torch.equal(p, getattr(ref, k))
                    for k, p in st.model.named_parameters())
    eq_moments = all(
        torch.equal(st.optimizer.state[p][mom], opt_ref.state[q][mom])
        for p, q in zip(st.model.parameters(), ref.parameters())
        for mom in ("exp_avg", "exp_avg_sq", "exp_avg_diff", "prev_grad"))
    if not (eq_losses and eq_params and eq_moments):
        fail(f"{SHARD_EQ_STEPS} sharded steps on 1 x 1 x 1 differ from "
             f"model.train_step: losses equal {eq_losses}, parameters "
             f"{eq_params}, moments {eq_moments}")
    # the CLI at its defaults (tile 16, adaptive init, chunks of 500)
    sh_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        reset_counts()
        t_sh = time.time()
        train_sharded.main([
            "-d", str(ROOT / "data"), "--data_name", "photos",
            "--num_points", str(SHARD_N), "--iterations", str(SHARD_ITERS),
            "--chunk_size", str(SHARD_CHUNK), "--checkpoint_root",
            str(sh_dir)])
        sharded_counts = read_counts()
        sh_seconds = time.time() - t_sh
        run_dir = sh_dir / "photos" / f"sharded_{SHARD_ITERS}_{SHARD_N}"
        sh_log = (run_dir / "train.txt").read_text()
        sharded_imgs = {}
        for name in photos:
            missing = [f for f in ("gaussian_model.npz", "training.npy")
                       if not (run_dir / name / f).is_file()]
            if missing:
                fail(f"the sharded CLI left no {missing} for {name}")
            rec = np.load(run_dir / name / "training.npy",
                          allow_pickle=True).item()
            final = float(re.search(rf"{name}: final state PSNR:(\S+)",
                                    sh_log).group(1))
            ck = load_checkpoint(run_dir / name / "gaussian_model.npz")
            _, sp_fin = stream16(ck["params"])
            sharded_imgs[name] = {
                "training_psnr": float(rec["psnr"]), "final_psnr": final,
                "initial_psnr": init_psnr[name],
                "training_time": float(rec["training_time"]),
                "final_state_n_dropped": int(sp_fin.n_dropped)}
    finally:
        shutil.rmtree(sh_dir, ignore_errors=True)
    warn = re.search(r"dropped up to (\d+)", sh_log)
    for name, r in sharded_imgs.items():
        if not (math.isfinite(r["training_psnr"])
                and math.isfinite(r["final_psnr"])):
            fail(f"sharded {name}: a NaN loss ({r})")
        if not r["final_psnr"] >= r["initial_psnr"] + SHARD_GAIN:
            fail(f"sharded {name}: final PSNR {r['final_psnr']} is not "
                 f"{SHARD_GAIN} dB above the initial {r['initial_psnr']}")
    if sharded_counts["rasterize_sum_l2"] < SHARD_ITERS * len(photos):
        fail(f"the sharded fit launched K3 "
             f"{sharded_counts['rasterize_sum_l2']} times at tile 16, fewer "
             f"than its {SHARD_ITERS * len(photos)} steps")
    # the 40k fit's evaluation render at tile 16 (aligned K1, the CLI's
    # final render) and 3 sharded steps from it on 1 x 1 x 1 (aligned K3)
    flower_t = torch.as_tensor(photos["flower"], device=dev)
    p40 = {k: np.asarray(v)[None] for k, v in ck40["params"].items()}
    reset_counts()
    eval40_psnr = train_sharded.final_psnr(
        "GaussianImage_Cholesky", {k: torch.as_tensor(v, device=dev)
                                   for k, v in p40.items()},
        photos["flower"], dict(num_points=40000, H=Hf, W=Wf,
                               raster=RasterizeConfig(tile_px=16),
                               block_h=16, block_w=16), dev)[0]
    eval40_counts = read_counts()

    def one_rank_steps(n, params_np, path):
        """TWO_RANK_STEPS sharded steps on 1 x 1 x 1 from ``params_np``
        ([1, N, ...], Adan fresh), through the fused K3 step or the
        generic one (the model's ``fused_l2`` off): (params, loss,
        counts)."""
        st_ = init_sharded_fit(sharded_model(n), mesh1, photos["flower"],
                               seed=1)
        load_shards(st_, mesh1, params_np)
        st_.model.fused_l2 = path == "fused"
        reset_counts()
        loss_, _, _ = make_sharded_train_step(
            st_.model, mesh1, n_steps=TWO_RANK_STEPS)(st_)
        cnt = read_counts()
        return ({k: p.detach().cpu().numpy()
                 for k, p in st_.model.named_parameters()}, float(loss_), cnt)

    # two ranks on the card over gloo, from the CLI's init of flower: (1,
    # 2, 1) through K1 + K2 at 16, (1, 1, 2) through K3 on each half, and
    # (1, 2, 1) at 40k points (each shard's 20,000 rows past the flat
    # limit: aligned K1 + K2) from the CLI's init and from the 40k fit,
    # each against 1 x 1 x 1 from the same state
    states = {}
    for key, n in (("init_10k", SHARD_N), ("init_40k", 40000)):
        st = init_sharded_fit(sharded_model(n), mesh1, photos["flower"],
                              seed=1)
        states[key] = {k: p.detach().cpu().numpy()[None]
                       for k, p in st.model.named_parameters()}
    states["fit_40k"] = p40
    st = init_sharded_fit(sharded_model(SHARD_N), mesh1, photos["flower"],
                          seed=1)
    two_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_two_rank_"))
    try:
        for key, arrays in states.items():
            np.savez(two_dir / f"{key}.npz", **arrays)
        t_two = time.time()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--two-rank-worker", str(r), str(two_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p_ in procs:
                logs.append(p_.communicate(timeout=TWO_RANK_TIMEOUT)[0])
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.communicate()
        for r, (p_, lg) in enumerate(zip(procs, logs)):
            if p_.returncode != 0:
                fail(f"two-rank gloo run: rank {r} exited {p_.returncode}:"
                     f"\n{lg[-3000:]}")
        two_seconds = time.time() - t_two
        two_out = {lab: dict(np.load(two_dir / f"out_{lab}.npz"))
                   for lab, *_ in TWO_RANK_MESHES}
        two_counts = [json.loads((two_dir / f"counts_{r}.json").read_text())
                      for r in range(2)]
    finally:
        shutil.rmtree(two_dir, ignore_errors=True)
    refs = {(key, path): one_rank_steps(n, states[key], path)
            for key, n in (("init_10k", SHARD_N), ("init_40k", 40000),
                           ("fit_40k", 40000))
            for path in ("fused", "generic")}

    def of_tolerance(got, want):
        """Per parameter max |got - want| / (atol + rtol |want|)."""
        return {k: float(np.max(np.abs(got[k][0] - v) / (
            TWO_RANK_ATOL + TWO_RANK_RTOL * np.abs(v))))
            for k, v in want.items()}

    # the init's pixel-channels at exactly 0 or 1, where the two steps'
    # clip cotangents differ
    with torch.no_grad():
        img0 = st.model.render()["render"][0]
    ties = int(((img0 == 0) | (img0 == 1)).sum())
    two_rank = {}
    for lab, n, mesh_s, path, key, gated in TWO_RANK_MESHES:
        want, want_loss, _ = refs[(key, path)]
        got = two_out[lab]
        errs = of_tolerance(got, want)
        loss_rel = abs(float(got["loss"][0]) / want_loss - 1)
        two_rank[lab] = {"mesh": mesh_s, "num_points": n,
                         "steps": TWO_RANK_STEPS, "held_to": path,
                         "from": key, "gated": gated,
                         "worst_of_tolerance": errs, "loss_rel_err": loss_rel,
                         "loss": float(got["loss"][0]),
                         "loss_one_rank": want_loss,
                         "n_dropped": int(got["n_dropped"][0]),
                         "launches_rank0": two_counts[0][lab]}
        if gated and (max(errs.values()) > 1.0
                      or loss_rel > TWO_RANK_LOSS_RTOL):
            fail(f"two-rank {lab} {mesh_s} differs from 1 x 1 x 1: "
                 f"|diff| / (atol + rtol |ref|) {errs} (<= 1), loss rel "
                 f"{loss_rel} (<= {TWO_RANK_LOSS_RTOL})")
    for lab, kernels in TWO_RANK_KERNELS.items():
        for k in kernels:
            if any(c[lab][k] < TWO_RANK_STEPS for c in two_counts):
                fail(f"two-rank {lab}: {k} launched "
                     f"{[c[lab][k] for c in two_counts]} times, fewer than "
                     f"{TWO_RANK_STEPS} a rank")
    two_rank["gauss2"]["vs_fused_worst_of_tolerance"] = of_tolerance(
        two_out["gauss2"], refs[("init_10k", "fused")][0])
    two_rank["gauss2"]["init_pixel_channels_at_0_or_1"] = ties
    aligned16_k3 = refs[("init_40k", "fused")][2][
        "rasterize_sum_l2_aligned"]
    if aligned16_k3 < TWO_RANK_STEPS or eval40_counts[
            "rasterize_sum_fwd_aligned"] < 1:
        fail(f"the 40k steps at tile 16 launched the aligned K3 "
             f"{aligned16_k3} times, its render the aligned K1 "
             f"{eval40_counts['rasterize_sum_fwd_aligned']}")
    # the scaling probe once on this one rank (its baseline rows)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scale = scaling_bench.run(device=dev)
    phase("sharded", mesh=mesh1.shape, num_points=SHARD_N,
          iterations=SHARD_ITERS, chunk_size=SHARD_CHUNK, tile_px=16,
          launches=sharded_counts, seconds=sh_seconds,
          ms_per_step=1e3 * sh_seconds / (SHARD_ITERS * len(photos)),
          images=sharded_imgs,
          n_dropped_warning=int(warn.group(1)) if warn else 0,
          first_steps_bit_equal_to_train_step=SHARD_EQ_STEPS,
          eval_40k_tile16={"psnr": eval40_psnr, "launches": eval40_counts},
          one_rank_40k_launches={p_: refs[("init_40k", p_)][2]
                                 for p_ in ("fused", "generic")},
          two_rank_gloo={"seconds": two_seconds, "rtol": TWO_RANK_RTOL,
                         "atol": TWO_RANK_ATOL, "runs": two_rank},
          scaling_bench_world_1=scale)

    # -- the wMask phases: fit + prune, the EMA's finalization, QAT, codec --
    wm_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_wmask_"))
    try:
        gt_flower = image_path_to_array(FLOWER_PHOTO)
        gt_fl = torch.as_tensor(gt_flower, device=dev)
        # wmask_fit: SimpleTrainer2d, the sweep's flags scaled to 3000
        # iterations; fit(), the evaluation render, then the rest of train()
        reset_counts()
        wm = train.SimpleTrainer2d(
            gt_flower, "flower", num_points=WMASK_N, model_name=WMASK,
            iterations=WMASK_ITERS, args=train.parse_args(WMASK_FLAGS),
            log_dir=wm_dir / "fit" / "flower", device=dev)
        t_fit = time.time()
        wm.fit()
        torch.cuda.synchronize()
        t_fit = time.time() - t_fit
        with torch.no_grad():
            pre_prune = wm.model.render(iteration=train.EVAL_ITERATION)[
                "render"].clone()
        probe = deepcopy(wm.model)
        wm_fit = wm.finish(t_fit)
        wmask_counts = read_counts()
        with torch.no_grad():
            post_prune = wm.model.render(iteration=train.EVAL_ITERATION)[
                "render"]
        kept = int(wm.model._xyz.shape[0])
        wm_losses = np.asarray(wm._hist["loss"])
        scalars = [json.loads(ln) for ln in (wm_dir / "fit" / "flower" /
                                             "scalars.jsonl").read_text()
                   .splitlines()]
        prune_diff = float((post_prune - pre_prune).abs().max())
        if not np.isfinite(wm_losses).all() or len(wm_losses) != WMASK_ITERS:
            fail(f"wMask fit: {len(wm_losses)} losses, "
                 f"{int((~np.isfinite(wm_losses)).sum())} not finite")
        if (wmask_counts["rasterize_sum_bwd"] < WMASK_ITERS
                or wmask_counts["rasterize_sum_l2"] != 0):
            fail(f"the wMask fit launched {wmask_counts}: want >= "
                 f"{WMASK_ITERS} K2, no K3")
        if any(wm.chunk_dropped) or wm_fit["n_dropped"] != 0:
            fail(f"instances dropped during the wMask fit: "
                 f"{wm.chunk_dropped}, test {wm_fit['n_dropped']}")
        if not 0 < kept < WMASK_N:
            fail(f"the wMask fit kept {kept} of {WMASK_N} points")
        if not prune_diff <= WMASK_PRUNE_TOL:
            fail(f"the pruned render differs from the unpruned one by "
                 f"{prune_diff} (> {WMASK_PRUNE_TOL})")
        if not wm_fit["psnr"] >= WMASK_PSNR:
            fail(f"wMask fit test PSNR {wm_fit['psnr']} < {WMASK_PSNR}")
        want_keys = {"sparsity_hard", "sparsity_soft", "num_points_active"}
        if not all(want_keys <= set(r) for r in scalars):
            fail(f"scalars.jsonl lacks {want_keys}: {scalars[:1]}")
        # wall ms per step in each mask phase: steps of a copy of the
        # fitted model, timed in a burst and traced
        probe_opt = probe.make_optimizer()
        probe_gen = torch.Generator(device=dev).manual_seed(2)
        wm_phases = {}
        for label, it in WMASK_PHASE_ITERS.items():
            def steps(n, it=it):
                return [probe.train_step(probe_opt, gt_fl, iteration=it,
                                         generator=probe_gen)
                        for _ in range(n)]
            wm_phases[label] = {
                "iteration": it,
                "ms_per_step": burst_ms(torch, lambda: steps(1), reps=50),
                "step_profile": profile_of(torch, lambda: steps(20), 20,
                                           ported)}
        # two evaluations of ada_kl on the same render give the same bits
        with torch.no_grad():
            probs = torch.sigmoid(probe._mask_logits)
            aux_p = {"pkg": {"xys": probe.render(iteration=1)["xys"]}}
            reg_bits = same_bits(torch, probe.regularizer(probs, gt_fl, aux_p),
                                 probe.regularizer(probs, gt_fl, aux_p))
        if not reg_bits:
            fail("two evaluations of the ada_kl regularizer differ")
        del probe, probe_opt
        phase("wmask_fit", model=WMASK, num_points=WMASK_N,
              iterations=WMASK_ITERS, flags=WMASK_FLAGS,
              launches=wmask_counts, final_points=kept,
              test_psnr=wm_fit["psnr"], ms_ssim=wm_fit["ms_ssim"],
              training_s=wm_fit["training_time"],
              ms_per_step=1e3 * wm_fit["training_time"] / WMASK_ITERS,
              fps=wm_fit["fps"], pruned_vs_unpruned_max_abs=prune_diff,
              pruned_bit_equal=same_bits(torch, post_prune, pre_prune),
              ada_kl_bit_identical_twice=reg_bits,
              n_dropped_chunks_max=max(wm.chunk_dropped),
              scalars_every_500=[r for r in scalars
                                 if r["iteration"] % 500 == 0],
              phases=wm_phases)

        # wmask_ema: kl, the EMA and the score, temperature 1.0 -> 0.1, the
        # mask over 50-250, chunks of 50; at the chunk boundary after 250
        # every logit is +-10 by the EMA
        ema_tr = train.SimpleTrainer2d(
            gt_flower, "flower", num_points=WMASK_N, model_name=WMASK,
            iterations=WMASK_EMA_ITERS,
            args=train.parse_args(WMASK_EMA_FLAGS),
            log_dir=wm_dir / "ema" / "flower", device=dev)
        ema_tr.iterations = WMASK_EMA_STOP
        ema_tr.fit()
        logits = ema_tr.model._mask_logits.detach()
        ema_on = ema_tr.model.mask_ema > 0.5
        final_ok = bool(torch.equal(logits, torch.where(ema_on, 10.0,
                                                        -10.0)))
        if not final_ok:
            fail(f"after iteration {WMASK_EMA_STOP} the logits are not +-10 "
                 f"by the EMA: {torch.unique(logits)[:8].tolist()}")
        ema_tr.start_iter, ema_tr.iterations = WMASK_EMA_STOP, WMASK_EMA_ITERS
        ema_tr.fit()
        ema_res = ema_tr.finish(0.0)
        phase("wmask_ema", iterations=WMASK_EMA_ITERS, flags=WMASK_EMA_FLAGS,
              finalized_at=WMASK_EMA_STOP, logits_pm10_by_ema=final_ok,
              kept_by_ema=int(ema_on.sum()),
              final_points=int(ema_tr.model._xyz.shape[0]),
              test_psnr=ema_res["psnr"])

        # wmask_qat: QAT of the pruned fit (--num_points its kept count)
        reset_counts()
        wq = train_quantize.QuantizeTrainer2d(
            gt_flower, "flower", num_points=kept, model_name=WMASK,
            iterations=WMASK_QAT_ITERS,
            model_path=wm_dir / "fit" / "flower" / "gaussian_model.npz",
            args=train_quantize.parse_args(["--lr", "1e-3"]),
            log_dir=wm_dir / "qat" / "flower", device=dev)
        wq_res = wq.train()
        wq_counts = read_counts()
        wq_losses = np.asarray(wq.losses)
        if not np.isfinite(wq_losses).all():
            fail("wMask QAT: a loss is not finite")
        if (wq_counts["rasterize_sum_fwd"] < WMASK_QAT_ITERS
                or wq_counts["rasterize_sum_bwd"] < WMASK_QAT_ITERS
                or any(wq_counts[k] for k in (
                    "rasterize_sum_l2", "splat_prep_decode",
                    "splat_prep_decode_batch"))):
            fail(f"wMask QAT launched {wq_counts}: want >= "
                 f"{WMASK_QAT_ITERS} K1 and K2, no K3, K4 or K7")
        if any(wq.chunk_dropped):
            fail(f"instances dropped during the wMask QAT: "
                 f"{wq.chunk_dropped}")
        qm = wq.model  # the best state
        enc_w = qm.compress_wo_ec()
        enc_w_dev = {k: torch.as_tensor(v, device=dev)
                     for k, v in enc_w.items()}
        reset_counts()
        with torch.no_grad():
            dec_w = qm.decompress_wo_ec(enc_w_dev)["render"]
            eval_w = qm.render_quantize(training=False)["render"]
        dec_counts = read_counts()
        dec_err = float((dec_w - eval_w).abs().max())
        if not dec_err <= WMASK_DECODE_TOL:
            fail(f"the wMask QAT state's decode differs from its evaluation "
                 f"render by {dec_err} (> {WMASK_DECODE_TOL})")
        if dec_counts["splat_prep_decode"] or not dec_counts[
                "rasterize_sum_fwd"]:
            fail(f"the wMask decode launched {dec_counts}: want K1, no K4")
        # two frames whose masks differ: the state, and the state with a
        # seeded tenth of its masks turned off
        twin_w = make_model(WMASK, device=dev, num_points=kept,
                            H=qm.cfg.H, W=qm.cfg.W, quantize=True)
        twin_w.load_state_dict(qm.state_dict())
        off = torch.as_tensor(np.random.default_rng(9).random(kept) < 0.1,
                              device=dev)
        with torch.no_grad():
            twin_w._mask_logits[off] = -10.0
            dec_twin = twin_w.decompress_wo_ec(enc_w_dev)["render"]
        pair_w = test_quantize.stack_frames([qm, twin_w], [enc_w, enc_w], dev)
        reset_counts()
        stacked_w = bt.decompress_wo_ec_batch(qm, *pair_w)
        stacked_counts = read_counts()
        if not same_bits(torch, stacked_w["render"][0], dec_w[0]):
            fail("the stacked wMask decode's frame 0 differs from its "
                 "single-frame decode")
        # frame 1's means sit at y + 512 in float32 on the tall canvas (the
        # batched phase's allowance): its PSNR within FRAME_PSNR_TOL
        f1 = stacked_w["render"][1]
        f1_psnr = [10 * math.log10(1.0 / float(torch.mean((x - gt_fl[0])
                                                          ** 2)))
                   for x in (f1, dec_twin[0])]
        frame1 = {"max_abs_diff": float((f1 - dec_twin[0]).abs().max()),
                  "pixels_above_1e4": int(((f1 - dec_twin[0]).abs()
                                           > 1e-4).sum()),
                  "psnr": f1_psnr}
        if abs(f1_psnr[0] - f1_psnr[1]) > FRAME_PSNR_TOL:
            fail(f"the stacked wMask decode's frame 1 reads {f1_psnr[0]} dB,"
                 f" its single-frame decode {f1_psnr[1]} (<= "
                 f"{FRAME_PSNR_TOL})")
        if stacked_counts["splat_prep_decode_batch"] or float(
                (dec_twin - dec_w).abs().max()) == 0.0:
            fail(f"the stacked decode launched {stacked_counts}, or the "
                 "two frames' masks gave the same image")
        # the codec CLI on that state as a two-image dataset (the flower
        # photo twice): the generic decode (K1), never K4 or K7
        data_w, q_w = wm_dir / "data", wm_dir / "qat2"
        data_w.mkdir()
        for name in ("test01", "test02"):
            shutil.copy(FLOWER_PHOTO, data_w / f"{name}.png")
            (q_w / name).mkdir(parents=True)
            shutil.copy(wm_dir / "qat" / "flower" / "gaussian_model.best.npz",
                        q_w / name / "gaussian_model.best.npz")
        reset_counts()
        wm_codec = test_quantize.main([
            "--data_name", "test", "--dataset", str(data_w), "--model_name",
            WMASK, "--model_path", str(q_w), "--num_points", str(kept),
            "--iterations", str(WMASK_QAT_ITERS), "--checkpoint_root",
            str(wm_dir / "codec")])
        wm_codec_counts = read_counts()
        for r in wm_codec:
            if (abs(r["psnr"] - wq_res["best_psnr"]) > 1e-3
                    or not r["ec_roundtrip_err"] < 1e-6):
                fail(f"wMask codec {r['image']}: psnr {r['psnr']} vs the "
                     f"QAT's {wq_res['best_psnr']}, round trip "
                     f"{r['ec_roundtrip_err']}")
        if (any(wm_codec_counts[k] for k in ("splat_prep_decode",
                                             "splat_prep_decode_batch"))
                or not wm_codec_counts["rasterize_sum_fwd"]):
            fail(f"the wMask codec run launched {wm_codec_counts}: want "
                 "K1, no K4 or K7")
        phase("wmask_qat", iterations=WMASK_QAT_ITERS, num_points=kept,
              launches=wq_counts, best_training_psnr=wq_res[
                  "best_training_psnr"],
              test_psnr=wq_res["psnr"], best_test_psnr=wq_res["best_psnr"],
              best_ms_ssim=wq_res["best_ms_ssim"], bpp=wq_res["best_bpp"],
              ms_per_step=1e3 * wq_res["training_time"] / WMASK_QAT_ITERS,
              decode_vs_eval_render=dec_err, decode_launches=dec_counts,
              stacked={"frame0_bit_equal": True, "frame1": frame1,
                       "frames_differ": float((dec_twin - dec_w).abs().max()),
                       "launches": stacked_counts},
              codec={"launches": wm_codec_counts,
                     "images": {r["image"]: {m: r[m] for m in (
                         "psnr", "bpp", "bpp_ec", "rendering_fps",
                         "probe_model", "serving_n_dropped")}
                         for r in wm_codec}})
    finally:
        shutil.rmtree(wm_dir, ignore_errors=True)

    # -- the RS phases: fit, serve, QAT, the RS fronts, the codec CLI -------
    rs_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_rs_"))
    try:
        # rs_fit: SimpleTrainer2d with GaussianImage_RS on the flower photo
        gt_flower = image_path_to_array(FLOWER_PHOTO)
        reset_counts()
        rs_trainer = train.SimpleTrainer2d(
            gt_flower, "flower", num_points=SERVE_N, model_name=RS,
            iterations=FIT_ITERS, args=train.parse_args([]),
            log_dir=rs_dir / "fit" / "flower", device=dev)
        rs_fit = rs_trainer.train()
        rs_fit_counts = read_counts()
        rs_losses = np.asarray(rs_trainer._hist["loss"])
        rs_hist = dict(zip(rs_trainer._hist["iter"],
                           rs_trainer._hist["psnr"]))
        if rs_fit_counts["rasterize_sum_l2"] < FIT_ITERS:
            fail(f"the RS fit launched K3 {rs_fit_counts['rasterize_sum_l2']}"
                 f" times, fewer than its {FIT_ITERS} steps")
        if not np.isfinite(rs_losses).all() or len(rs_losses) != FIT_ITERS:
            fail(f"RS fit: {len(rs_losses)} losses, "
                 f"{int((~np.isfinite(rs_losses)).sum())} not finite")
        if any(rs_trainer.chunk_dropped) or rs_fit["n_dropped"] != 0:
            fail(f"instances dropped during the RS fit: "
                 f"{rs_trainer.chunk_dropped}, test {rs_fit['n_dropped']}")
        if not rs_fit["psnr"] >= FIT_PSNR:
            fail(f"RS fit test PSNR {rs_fit['psnr']} < {FIT_PSNR}")
        phase("rs_fit", model=RS, iterations=FIT_ITERS,
              launches=rs_fit_counts,
              training_psnr_every_1000={i: rs_hist[i] for i in
                                        range(1000, FIT_ITERS + 1, 1000)},
              test_psnr=rs_fit["psnr"], ms_ssim=rs_fit["ms_ssim"],
              training_s=rs_fit["training_time"],
              ms_per_step_incl_reseed=1e3 * rs_fit["training_time"]
              / FIT_ITERS, fps=rs_fit["fps"],
              n_dropped_chunks_max=max(rs_trainer.chunk_dropped))
        rs_fitted = rs_trainer.model

        # rs_serve: render_fast under serving(10000), counts read around it
        rs_s = make_model(RS, device=dev, num_points=SERVE_N, H=512, W=768,
                          raster=serve_cfg)
        rs_s.load_state_dict(rs_fitted.state_dict())
        rs_nd = []

        def rs_serve_one():
            img, aux = rs_serving.render_fast(with_aux=True)
            rs_nd.append(aux["n_dropped"])
            return img

        reset_counts()
        # the codec CLI's routing: the serving twin unless it drops
        rs_serving = rs_s
        rs_img = rs_serve_one()
        if int(rs_nd[0]) != 0:
            rs_serving = rs_fitted
            rs_img = rs_serve_one()
        rs_serve_ms = burst_ms(torch, rs_serve_one, reps=30)
        rs_serve_counts = read_counts()
        rs_nd_timed = torch.stack(rs_nd[1:]).cpu()
        with torch.no_grad():
            rs_ref = rs_fitted.render()["render"]
        rs_serve_img = img_check("RS render_fast against render()", rs_img,
                                 rs_ref)
        if rs_serve_counts["splat_prep_rs_raw"] == 0 or rs_serve_counts[
                "rasterize_sum_fwd"] == 0:
            fail(f"RS render_fast launched {rs_serve_counts}")
        if int(rs_nd_timed.max()) != 0:
            fail(f"RS render_fast dropped instances on a timed render: "
                 f"{rs_nd_timed.tolist()}")
        with torch.no_grad():
            rs_render_ms = burst_ms(torch, rs_fitted.render, reps=30)
            rs_serve_prof = profile_of(
                torch, lambda: [rs_serving.render_fast()
                                for _ in range(train.FPS_FRAMES)],
                train.FPS_FRAMES, ported)
        phase("rs_serve", config="RasterizeConfig.serving(10000)",
              route="serving" if rs_serving is rs_s else "default",
              serving_twin_n_dropped=int(rs_nd[0]),
              launches=rs_serve_counts, renders=len(rs_nd) - 1,
              n_dropped_timed_max=int(rs_nd_timed.max()),
              vs_render=rs_serve_img,
              psnr=10 * math.log10(1.0 / float(torch.mean(
                  (rs_img - gt_f[None]) ** 2))),
              render_fast_ms=rs_serve_ms, render_default_ms=rs_render_ms,
              render_fast_profile=rs_serve_prof)

        # rs_qat: QuantizeTrainer2d with GaussianImage_RS from that fit
        reset_counts()
        rs_qt = train_quantize.QuantizeTrainer2d(
            gt_flower, "flower", num_points=SERVE_N, model_name=RS,
            iterations=RS_QAT_ITERS,
            model_path=rs_dir / "fit" / "flower" / "gaussian_model.npz",
            args=train_quantize.parse_args(["--lr", "1e-3"]),
            log_dir=rs_dir / "qat" / "flower", device=dev)
        rs_qat = rs_qt.train()
        rs_qat_counts = read_counts()
        rs_qlosses = np.asarray(rs_qt.losses)
        if (not np.isfinite(rs_qlosses).all()
                or len(rs_qlosses) != RS_QAT_ITERS):
            fail(f"RS QAT: {len(rs_qlosses)} losses, "
                 f"{int((~np.isfinite(rs_qlosses)).sum())} not finite")
        if any(rs_qt.chunk_dropped):
            fail(f"instances dropped during RS QAT: {rs_qt.chunk_dropped}")
        if (rs_qat_counts["rasterize_sum_fwd"] < RS_QAT_ITERS
                or rs_qat_counts["rasterize_sum_bwd"] < RS_QAT_ITERS
                or rs_qat_counts["rasterize_sum_l2"] != 0):
            fail(f"RS QAT launched {rs_qat_counts}: want >= {RS_QAT_ITERS} "
                 "K1 and K2, no K3")
        # the best state (the trainer's model holds it): its K6a decode
        enc_rs = rs_qt.model.compress_wo_ec()
        rs_twin = make_model(RS, device=dev, num_points=SERVE_N, H=512,
                             W=768, quantize=True,
                             raster=RasterizeConfig(fused_prep=True))
        rs_twin.load_state_dict(rs_qt.model.state_dict())
        k6a_before = prep.rs_decode_prep.launches
        with torch.no_grad():
            rs_dec_q = rs_twin.decompress_wo_ec(
                {k: torch.as_tensor(v, device=dev) for k, v in enc_rs.items()})
            rs_eval_q = rs_qt.model.render_quantize(training=False)["render"]
        if prep.rs_decode_prep.launches == k6a_before:
            fail("the RS QAT state's decode did not take K6a")
        rs_qat_decode = img_check("the RS QAT state's K6a decode against its "
                                  "evaluation render", rs_dec_q["render"],
                                  rs_eval_q)
        rs_qat_prof = profile_of(
            torch, lambda: [rs_qt.model.train_step(rs_qt.optimizer,
                                                   rs_qt.gt_image)
                            for _ in range(20)], 20, ported)
        phase("rs_qat", iterations=RS_QAT_ITERS, launches=rs_qat_counts,
              best_training_psnr=rs_qat["best_training_psnr"],
              test_psnr=rs_qat["psnr"], best_test_psnr=rs_qat["best_psnr"],
              best_ms_ssim=rs_qat["best_ms_ssim"],
              bpp_measured=rs_qat["best_bpp"],
              decode_vs_eval_render=rs_qat_decode,
              n_dropped_chunks_max=max(rs_qt.chunk_dropped),
              training_s=rs_qat["training_time"],
              ms_per_step=1e3 * rs_qat["training_time"] / RS_QAT_ITERS,
              fps=rs_qat["fps"], step_profile=rs_qat_prof)

        # rs_kernel: K6b on the fit's parameters, K6a on the QAT codes
        k6b_args = (rs_s._xyz.detach(), rs_s._scaling.detach(),
                    rs_s._rotation.detach(), rs_s._features_dc.detach(),
                    SCALING_BOUND, Hf, Wf, serve_cfg.tile_px, m_s, q_s)
        out6b = prep.rs_raw_prep(*k6b_args)
        torch.cuda.synchronize()
        k6b = prep_check("K6b", out6b, prep.rs_raw_prep_plain(*k6b_args),
                         bits=True)
        gids6, starts6, _ = rs.stream_from_keys(out6b[1].reshape(-1),
                                                SERVE_N, Hf, Wf, serve_cfg,
                                                I_s)
        _, sp_rs = stream_inputs(rs_s)
        k6b["stream_vs_generic"] = {
            "instances": int(sp_rs.starts[sp_rs.T]),
            "instances_differ": int((gids6 != sp_rs.gids).sum()),
            "starts_equal": bool(torch.equal(starts6, sp_rs.starts))}
        if (k6b["stream_vs_generic"]["instances_differ"]
                or not k6b["stream_vs_generic"]["starts_equal"]):
            fail(f"K6b's stream differs from the generic binning: "
                 f"{k6b['stream_vs_generic']}")
        rq = rs_qt.model
        k6a_args = (torch.as_tensor(enc_rs["xyz"], device=dev).float(),
                    torch.as_tensor(enc_rs["quant_scaling"], device=dev),
                    torch.as_tensor(enc_rs["quant_rotation"], device=dev),
                    torch.as_tensor(enc_rs["feature_dc_index"], device=dev),
                    rq.scaling_quant_scale.detach(),
                    rq.scaling_quant_beta.detach(),
                    rq.rotation_quant_scale.detach(),
                    rq.rotation_quant_beta.detach(),
                    rq.features_vq.combined_codebook(
                        rq.vq_state()).contiguous(),
                    SCALING_BOUND, 512, 768, serve_cfg.tile_px, m_s, q_s)
        out6a = prep.rs_decode_prep(*k6a_args)
        torch.cuda.synchronize()
        k6a = prep_check("K6a", out6a, prep.rs_decode_prep_plain(*k6a_args),
                         bits=True)

        def rs_case(name, kernel, plain, args, ref_args=None):
            out = kernel(*args)
            torch.cuda.synchronize()
            return prep_check(name, out, plain(*(ref_args or args)),
                              bits=True)

        # both on their first n rows: a partial last CTA (64 rows) and warp
        for n in EDGE_ROWS:
            k6b[f"n{n}"] = rs_case(
                f"K6b (N = {n})", prep.rs_raw_prep, prep.rs_raw_prep_plain,
                (*(a[:n] for a in k6b_args[:4]), *k6b_args[4:]))
            k6a[f"n{n}"] = rs_case(
                f"K6a (N = {n})", prep.rs_decode_prep,
                prep.rs_decode_prep_plain,
                (*(a[:n] for a in k6a_args[:4]), *k6a_args[4:]))
        # seeded adversarial rows, a kind a row (row % 6; kind 0 as it is).
        # K6b on the fit's rows: raw rotations of +-30 (the sigmoid
        # saturates: theta 2 pi or ~0), theta near pi / 2 and near pi,
        # scales at the conic's 1e-6 determinant floor, sx = sy
        er = np.random.default_rng(RS_EDGE_SEED)
        kind = torch.arange(SERVE_N, device=dev) % 6
        n_k = [int((kind == k).sum()) for k in range(6)]

        def noise(k, scale, cols=1):
            return torch.as_tensor(er.normal(0.0, scale, (n_k[k], cols)),
                                   device=dev, dtype=torch.float32)

        rot_e = k6b_args[2].clone()
        rot_e[kind == 1] = 30.0 * torch.as_tensor(
            er.choice([-1.0, 1.0], (n_k[1], 1)), device=dev,
            dtype=torch.float32)
        rot_e[kind == 2] = -math.log(3.0) + noise(2, 1e-6)  # sigmoid 1/4
        rot_e[kind == 3] = noise(3, 1e-6)                   # sigmoid 1/2
        scl_e = k6b_args[1].clone()
        scl_e[kind == 4] = -torch.as_tensor(
            SCALING_BOUND, device=dev) + torch.as_tensor(
            er.uniform(-0.05, 0.05, (n_k[4], 2)), device=dev,
            dtype=torch.float32)
        scl_e[kind == 5, 1] = (scl_e[kind == 5, 0] + SCALING_BOUND[0]
                               - SCALING_BOUND[1])
        k6b["adversarial"] = rs_case(
            "K6b (adversarial rows)", prep.rs_raw_prep,
            prep.rs_raw_prep_plain,
            (k6b_args[0], scl_e, rot_e, *k6b_args[3:]))
        # K6a on the QAT codes: scaling codes at the range's ends (kinds 1,
        # 4), rotation codes there (2, 5), and combined VQ indices outside
        # the codebook (3), which K6a reads as entry 0 (K4's clamp; JAX's
        # one-hot lookup gives a zero color there, and the codec writes no
        # such index): held to the plain version on indices (0, 0) there
        sc_e, rc_e, ix_e = (a.clone() for a in k6a_args[1:4])
        for k, codes in ((1, sc_e), (4, sc_e), (2, rc_e), (5, rc_e)):
            codes[kind == k] = torch.as_tensor(
                er.choice([0, RS_CODE_MAX], (n_k[k], codes.shape[1])),
                device=dev, dtype=torch.int32)
        ix_e[kind == 3] = torch.as_tensor(
            er.choice(np.array([[8, 0], [-1, 3], [7, 9], [100, 100],
                                [-9, 0]]), n_k[3]), device=dev,
            dtype=torch.int32)
        comb_e = ix_e[:, 0] * 8 + ix_e[:, 1]
        outside = (comb_e < 0) | (comb_e >= 64)
        ix_ref = torch.where(outside[:, None], torch.zeros_like(ix_e), ix_e)
        k6a["adversarial"] = rs_case(
            "K6a (adversarial rows)", prep.rs_decode_prep,
            prep.rs_decode_prep_plain,
            (k6a_args[0], sc_e, rc_e, ix_e, *k6a_args[4:]),
            (k6a_args[0], sc_e, rc_e, ix_ref, *k6a_args[4:]))
        k6a["adversarial"]["rows_outside_codebook"] = int(outside.sum())
        phase("rs_kernel", k6b=k6b, k6a=k6a)

        # scan_decode: batched.decode_many(force="scan") of two stacked
        # frames of SCAN_N rows, not a multiple of 4, so that frame 1's code
        # arrays start off a 16-byte boundary: china's and flower's QAT
        # states through K4, the RS QAT state's first and last SCAN_N rows
        # through K6a; each frame bit-equal to its single-frame decode
        def cut(model, lo):
            """A fused-prep quantize twin of ``model`` on its rows lo ..
            lo + SCAN_N."""
            twin = make_model(model.name, device=dev, num_points=SCAN_N,
                              H=512, W=768, quantize=True,
                              raster=RasterizeConfig(fused_prep=True))
            twin.load_state_dict({
                k: v[lo:lo + SCAN_N] if v.ndim and v.shape[0] == SERVE_N
                else v for k, v in model.state_dict().items()})
            return twin

        scan = {}
        for name, frames, counter in (
                ("cholesky_k4", (cut(china_s, 0), cut(flower_q, 0)),
                 prep.decode_prep),
                ("rs_k6a", (cut(rq, 0), cut(rq, SERVE_N - SCAN_N)),
                 prep.rs_decode_prep)):
            encs = [m.compress_wo_ec() for m in frames]
            stacked = test_quantize.stack_frames(frames, encs, dev)
            before = counter.launches
            out = bt.decode_many(frames[0], *stacked, force="scan")
            torch.cuda.synchronize()
            launched = counter.launches - before
            single = [m.decompress_wo_ec({k: torch.as_tensor(v, device=dev)
                                          for k, v in e.items()})["render"][0]
                      for m, e in zip(frames, encs)]
            equal = [bool(torch.equal(out["render"][b], single[b]))
                     for b in range(2)]
            offsets = {k: v[1].data_ptr() % 16 for k, v in stacked[2].items()
                       if k != "xyz"}
            scan[name] = {"frames_bit_equal": equal, "launches": launched,
                          "frame1_offsets_mod16": offsets,
                          "n_dropped": out["raster_aux"]["n_dropped"]
                          .tolist()}
            if not all(equal) or launched != 2 or not any(offsets.values()):
                fail(f"the scan decode at N = {SCAN_N} ({name}): frames "
                     f"bit-equal to their single-frame decodes {equal}, "
                     f"{launched} fused launches (want 2), frame 1's code "
                     f"arrays at {offsets} bytes past 16")
        phase("scan_decode", n=SCAN_N, **scan)

        # rs_codec: the codec CLI on that state, the flower photo and its
        # state twice as a two-image dataset, counts read around it
        data2, q2 = rs_dir / "data", rs_dir / "qat2"
        data2.mkdir()
        for name in ("test01", "test02"):
            shutil.copy(FLOWER_PHOTO, data2 / f"{name}.png")
            (q2 / name).mkdir(parents=True)
            shutil.copy(rs_dir / "qat" / "flower" / "gaussian_model.best.npz",
                        q2 / name / "gaussian_model.best.npz")
        reset_counts()
        rs_codec = test_quantize.main([
            "--data_name", "test", "--dataset", str(data2), "--model_name",
            RS, "--model_path", str(q2), "--num_points", str(SERVE_N),
            "--iterations", str(RS_QAT_ITERS), "--checkpoint_root",
            str(rs_dir / "codec")])
        rs_codec_counts = read_counts()
        rs_root_txt = (rs_dir / "codec" / "test" /
                       f"{RS}_{RS_QAT_ITERS}_{SERVE_N}" / "test.txt"
                       ).read_text()
        rdd = re.search(r"Dataset decode \((\d+) frames/pass, (\w+) "
                        r"strategy\): ([0-9.]+) FPS", rs_root_txt)
        if rdd is None:
            fail("the RS codec CLI printed no Dataset decode line")
        for r in rs_codec:
            if (r["probe_model"] != "serving"
                    or not r["ec_roundtrip_err"] < 1e-6
                    or round(r["bpp"], 4) != QAT_BPP
                    or abs(r["scaling_bpp"] + r["rotation_bpp"]
                           - r["cholesky_bpp"]) > 1e-9
                    or abs(r["psnr"] - rs_qat["best_psnr"]) > 1e-3):
                fail(f"RS codec {r['image']}: probe on the "
                     f"{r['probe_model']} model (serving twin n_dropped "
                     f"{r['serving_n_dropped']}), round trip "
                     f"{r['ec_roundtrip_err']}, bpp {r['bpp']} (want "
                     f"{QAT_BPP}), scaling {r['scaling_bpp']} + rotation "
                     f"{r['rotation_bpp']} vs {r['cholesky_bpp']}, psnr "
                     f"{r['psnr']} vs the QAT's {rs_qat['best_psnr']}")
        if rs_codec_counts["splat_prep_rs_decode"] < MIN_K4 * len(rs_codec):
            fail(f"the RS codec run launched K6a "
                 f"{rs_codec_counts['splat_prep_rs_decode']} times, fewer "
                 f"than {MIN_K4} per image")
        # the K6a image against the generic decode (outside the counted run)
        ev_rs = test_quantize.CodecEvaluator2d(
            gt_flower, "flower", num_points=SERVE_N, model_name=RS,
            model_path=q2 / "test01" / "gaussian_model.best.npz",
            log_dir=rs_dir / "codec_check", device=dev)
        enc_rs_np = ev_rs.model.compress_wo_ec()
        enc_rs_dev = {k: torch.as_tensor(v, device=dev)
                      for k, v in enc_rs_np.items()}
        rs_k6a_img = ev_rs.model_s.decompress_wo_ec(enc_rs_dev)
        rs_gen_img = ev_rs.model.decompress_wo_ec(enc_rs_dev)["render"]
        rs_k6a_vs_gen = img_check("the RS K6a decode against the generic "
                                  "decode", rs_k6a_img["render"], rs_gen_img)
        rs_k6a_vs_gen["n_dropped"] = int(rs_k6a_img["raster_aux"]["n_dropped"])
        # the dataset decode's two strategies on the two frames
        model_rs_f = make_model(RS, device=dev, num_points=SERVE_N, H=512,
                                W=768, quantize=True,
                                raster=RasterizeConfig(fused_prep=True))
        rs_stack = test_quantize.stack_frames(
            [ev_rs.model, ev_rs.model], [enc_rs_np, enc_rs_np], dev)
        rs_strategy_ms = {
            st: burst_ms(torch, lambda: bt.decode_many(
                model_rs_f, *rs_stack, force=st), reps=20) / 2
            for st in bt.STRATEGIES}
        keys = ("psnr", "ms-ssim", "bpp", "bpp_ec", "position_bpp",
                "scaling_bpp", "rotation_bpp", "cholesky_bpp",
                "feature_dc_bpp", "ec_roundtrip_err", "rendering_fps",
                "rendering_fps_ec", "rendering_time_ec_rans",
                "rendering_time_ec_h2d", "rendering_time_ec_device",
                "serving_n_dropped", "probe_model")
        phase("rs_codec", launches=rs_codec_counts,
              images={r["image"]: {m: r[m] for m in keys} for r in rs_codec},
              k6a_vs_generic=rs_k6a_vs_gen,
              dataset_decode={"line": rdd.group(0),
                              "frames_per_pass": int(rdd.group(1)),
                              "strategy": rdd.group(2),
                              "fps": float(rdd.group(3))},
              ms_per_frame_b2=rs_strategy_ms)
    finally:
        shutil.rmtree(rs_dir, ignore_errors=True)

    # -- the 3DGS phases: a fit, its evaluation, K8 and K9 --------------------
    gs_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_3dgs_"))
    try:
        # gs3d_fit: SimpleTrainer2d with 3DGS on the flower photo
        gs_trainer = train.SimpleTrainer2d(
            gt_flower, "flower", num_points=SERVE_N, model_name=GS,
            iterations=GS_ITERS, args=train.parse_args(["--model_name", GS]),
            log_dir=gs_dir / "fit" / "flower", device=dev)
        gs_init_psnr = gs_trainer.test()[0]
        reset_counts()
        gs_fit = gs_trainer.train()
        gs_fit_counts = read_counts()
        gs_losses = np.asarray(gs_trainer._hist["loss"])
        gs_hist = dict(zip(gs_trainer._hist["iter"],
                           gs_trainer._hist["psnr"]))
        if not np.isfinite(gs_losses).all() or len(gs_losses) != GS_ITERS:
            fail(f"3DGS fit: {len(gs_losses)} losses, "
                 f"{int((~np.isfinite(gs_losses)).sum())} not finite")
        if (gs_fit_counts["rasterize_blend_fwd"] < GS_ITERS
                or gs_fit_counts["rasterize_blend_bwd"] < GS_ITERS
                or any(gs_fit_counts[k] for k in sum_kernels)):
            fail(f"the 3DGS fit launched {gs_fit_counts}: want >= {GS_ITERS} "
                 "K8 and K9, no K1, K2 or K3")
        if not (gs_fit["psnr"] >= GS_FIT_PSNR
                and gs_fit["psnr"] >= gs_init_psnr + GS_FIT_GAIN):
            fail(f"3DGS fit test PSNR {gs_fit['psnr']}: want >= "
                 f"{GS_FIT_PSNR} and >= the initial state's {gs_init_psnr} "
                 f"+ {GS_FIT_GAIN}")
        # its evaluation through the CLI, the flower photo twice
        data3 = gs_dir / "data"
        data3.mkdir()
        for name in ("test01", "test02"):
            shutil.copy(FLOWER_PHOTO, data3 / f"{name}.png")
        reset_counts()
        gs_eval = train.main([
            "--data_name", "test", "--dataset", str(data3), "--model_name",
            GS, "--iterations", "0", "--model_path",
            str(gs_dir / "fit" / "flower"), "--num_points", str(SERVE_N),
            "--checkpoint_root", str(gs_dir / "eval")])
        gs_eval_counts = read_counts()
        gs_eval_txt = (gs_dir / "eval" / "test" / f"{GS}_0_{SERVE_N}" /
                       "test01" / "train.txt").read_text()
        if any(abs(r["psnr"] - gs_fit["psnr"]) > 1e-4 for r in gs_eval):
            fail(f"the 3DGS evaluation read {[r['psnr'] for r in gs_eval]}, "
                 f"the fit {gs_fit['psnr']} (within 1e-4 dB)")
        probe_frames = (1 + train.TIMED_BURSTS) * train.FPS_FRAMES
        if (gs_eval_counts["rasterize_blend_fwd"] < len(gs_eval) * probe_frames
                or gs_eval_counts["rasterize_blend_bwd"]
                or any(gs_eval_counts[k] for k in sum_kernels)):
            fail(f"the 3DGS evaluation launched {gs_eval_counts}: want >= "
                 f"{probe_frames} K8 per image, no K9, K1, K2 or K3")
        phase("gs3d_fit", model=GS, sh_degree=gs_trainer.model.cfg.sh_degree,
              loss_type=gs_trainer.model.cfg.loss_type, iterations=GS_ITERS,
              launches=gs_fit_counts,
              training_psnr_every_500={i: gs_hist[i] for i in
                                       range(500, GS_ITERS + 1, 500)},
              test_psnr=gs_fit["psnr"], psnr_floor=GS_FIT_PSNR,
              init_test_psnr=gs_init_psnr, psnr_gain_floor=GS_FIT_GAIN,
              ms_ssim=gs_fit["ms_ssim"], training_s=gs_fit["training_time"],
              ms_per_step=1e3 * gs_fit["training_time"] / GS_ITERS,
              fps=gs_fit["fps"], n_dropped_chunks=gs_trainer.chunk_dropped,
              n_dropped_test=gs_fit["n_dropped"],
              evaluation={"launches": gs_eval_counts,
                          "psnr": [r["psnr"] for r in gs_eval],
                          "fps": [r["fps"] for r in gs_eval],
                          "train_txt": gs_eval_txt.strip().splitlines()[-2:]})

        # gs3d_kernel: K8 and K9 on the initial state, the fit's, and the
        # cull's adversarial scene
        gs_init = make_model(GS, device=dev, num_points=SERVE_N, H=512,
                             W=768)
        gs_init.init_params(torch.Generator(device=dev).manual_seed(1))
        gs_fitted = gs_trainer.model
        ls8 = blend.log_stop(gs_fitted.blend_cfg)
        g9 = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (4, Hf, Wf)).astype(np.float32), device=dev)

        def blend_case(name, proj, bcfg, Hc, Wc, g):
            """K8 and K9 on one state's stream (flat or aligned, as bcfg
            makes it) against their plain versions: K8 bit-equal with equal
            chunk counts, K9's rows to ROW_TOL and bit-identical twice; no
            pair that composites outside the cull. Only the cull_edge
            scene holds rows that are not finite (a NaN row's plain
            gradient is NaN, 0 x NaN): there K9 is compared on the slots
            whose row is finite, and any other case fails on such a row.
            Returns the case's record and its (feat, stream, log T_fin,
            chunks, K8's source, K8's output, K9's output) for the timing
            and the aligned-vs-flat checks."""
            bkw = dict(tile_px=bcfg.tile_px, block_inst=bcfg.block_inst,
                       alpha_clip=bcfg.alpha_clip, alpha_min=bcfg.alpha_min)
            ls = blend.log_stop(bcfg)
            with torch.no_grad():
                xys, depths, radii, conics, rgbs, opac = proj
                order, sp8 = blend.blend_stream(xys, depths, radii, Hc, Wc,
                                                bcfg)
                feat8 = blend.blend_feat(xys, conics, rgbs, opac, order)
            if sp8.aligned:
                src = sc.blockize_stream(feat8, sp8.gids)
                win = (src, sp8.starts, sp8.counts)
                fwd, fwd_p = blend.blend_fwd_aligned, \
                    blend.blend_fwd_aligned_plain
                bwd, bwd_p = blend.blend_bwd_aligned, \
                    blend.blend_bwd_aligned_plain
            else:
                src = feat8
                win = (feat8, sp8.gids, sp8.starts)
                fwd, fwd_p = blend.blend_fwd, blend.blend_fwd_plain
                bwd, bwd_p = blend.blend_bwd, blend.blend_bwd_plain
            out8, nch8 = fwd(*win, Hc, Wc, log_stop=ls, **bkw)
            torch.cuda.synchronize()
            out8p, nch8p = fwd_p(*win, Hc, Wc, log_stop=ls, **bkw)
            e8 = float((out8[:4] - out8p[:4]).abs().max())
            bad = (nch8 != nch8p).nonzero()[:, 0].tolist()
            k8_equal = bool(torch.equal(out8, out8p))
            if not (math.isfinite(e8) and e8 <= BLEND_TOL) or bad \
                    or not k8_equal:
                fail(f"K8 disagrees with its plain version on the {name} "
                     f"state: rgb and T_fin max |diff| {e8} (<= {BLEND_TOL}),"
                     f" bit-equal {k8_equal}; {len(bad)} tiles consumed "
                     f"other chunk counts: {bad[:20]}")
            logt8 = out8[4].contiguous()
            dg9 = bwd(*win, logt8, nch8, g, Hc, Wc, **bkw)
            dg9_again = bwd(*win, logt8, nch8, g, Hc, Wc, **bkw)
            torch.cuda.synchronize()
            dg9p = bwd_p(*win, logt8, nch8, g, Hc, Wc, **bkw)
            T8 = sp8.tiles_x * (-(-Hc // bcfg.tile_px))
            cnt = sp8.counts[:T8].long()
            tile_of = torch.repeat_interleave(torch.arange(T8, device=dev),
                                              cnt)
            slots = (sp8.starts[:T8].long()[tile_of]
                     - (torch.cumsum(cnt, 0) - cnt)[tile_of]
                     + torch.arange(tile_of.numel(), device=dev))
            rows9, rows9p = dg9, dg9p
            if sp8.aligned:
                rows9 = sc.unblockize_stream_plain(dg9)
                rows9p = sc.unblockize_stream_plain(dg9p)
            rows9, rows9p = rows9[slots], rows9p[slots]
            finite = torch.isfinite(
                sc.gather_stream(sp8.gids, feat8)[slots]).all(dim=1)
            if not (finite.all() or name.startswith("cull_edge")):
                fail(f"the {name} state streams {int((~finite).sum())} "
                     "rows that are not finite")
            e9 = float(row_err(torch, rows9[finite], rows9p[finite]).max())
            if not (torch.isfinite(rows9[finite]).all() and e9 <= ROW_TOL):
                fail(f"K9 disagrees with its plain version on the {name} "
                     f"state: worst row {e9} > {ROW_TOL} of the column max")
            if not torch.equal(dg9.view(torch.int32),
                               dg9_again.view(torch.int32)):
                fail(f"two runs of K9 on the {name} state differ")
            work = blend_pair_work(torch, rs, sc, blend, feat8, sp8, nch8,
                                   Hc, Wc, bcfg)
            if work["culled_on"]:
                fail(f"the cull skips {work['culled_on']} pairs that "
                     f"composite on the {name} state")
            case = {
                "tile_px": bcfg.tile_px, "aligned": bool(sp8.aligned),
                "k8_max_abs_err": e8, "k8_bit_equal": k8_equal,
                "chunks_equal": True,
                "chunks": int(nch8.sum()), "chunks_max": int(nch8.max()),
                "tiles_walked": int((nch8 > 0).sum()),
                "k9_worst_row": e9,
                "k9_max_abs_err": float(
                    (rows9[finite] - rows9p[finite]).abs().max()),
                "k9_rows_not_compared": int((~finite).sum()),
                "k9_bit_identical_twice": True, "instances": slots.numel(),
                "max_count": int(sp8.counts.max()),
                "n_dropped": int(sp8.n_dropped), **work}
            return case, (feat8, sp8, logt8, nch8, src, out8, dg9)

        gs_cases = {}
        # the model's 32-pixel tiles, and the kernels' 16-pixel variant (the
        # BlendConfig default) on the fit; the cull's scene at both tiles,
        # flat and aligned; the fit case is timed below
        with torch.no_grad():
            proj_init, proj_fit = gs_init.project(), gs_fitted.project()
        ce = cull_edge_scene(CULL_N, *CULL_HW, seed=CULL_SEED)
        proj_ce = tuple(torch.as_tensor(ce[k], device=dev) for k in (
            "xys", "depths", "radii", "conics", "colors", "opac"))
        g_ce = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (4, *CULL_HW)).astype(np.float32), device=dev)
        ce_out = {}
        for tp in (32, 16):
            for aligned in (False, True):
                name = "cull_edge" + ("_aligned" if aligned else "") + (
                    "" if tp == 32 else "_tile16")
                bcfg = blend.BlendConfig(
                    tile_px=tp, max_instances=1 << 17,
                    max_tiles_per_gauss=1024,
                    flat_stream_limit=0 if aligned else 1 << 30)
                gs_cases[name], ce_out[name] = blend_case(
                    name, proj_ce, bcfg, *CULL_HW, g_ce)
            flat, al = (ce_out["cull_edge" + sfx + ("" if tp == 32
                                                    else "_tile16")]
                        for sfx in ("", "_aligned"))
            if flat[1].n_dropped != al[1].n_dropped:
                fail(f"the cull_edge scene at tile {tp}: the aligned stream "
                     f"drops {int(al[1].n_dropped)} instances, the flat "
                     f"one {int(flat[1].n_dropped)}")
            if not (torch.equal(flat[5], al[5])
                    and torch.equal(flat[3], al[3])):
                fail(f"the cull_edge scene at tile {tp}: the aligned K8 "
                     "differs from the flat one on the same instances")
        gs_cases["init"], _ = blend_case("init", proj_init,
                                         gs_fitted.blend_cfg, Hf, Wf, g9)
        gs_cases["fit_tile16"], _ = blend_case(
            "fit_tile16", proj_fit,
            gs_fitted.blend_cfg._replace(tile_px=16), Hf, Wf, g9)
        gs_cases["fit"], (feat8, sp8, logt8, nch8, *_) = blend_case(
            "fit", proj_fit, gs_fitted.blend_cfg, Hf, Wf, g9)
        bcfg = gs_fitted.blend_cfg
        bkw = dict(tile_px=bcfg.tile_px, block_inst=bcfg.block_inst,
                   alpha_clip=bcfg.alpha_clip, alpha_min=bcfg.alpha_min)
        n8 = int(sp8.starts[sp8.T])
        phase("gs3d_kernel", blend_tol=BLEND_TOL, row_tol=ROW_TOL,
              cases=gs_cases)

        # gs3d_serve: render_fast under fused_prep (K10, a sort, K8) on the
        # initial state and on the fit's, counts read around it
        gs_raster = RasterizeConfig(fused_prep=True)
        gs_twins = {}
        for name, model in (("init", gs_init), ("fit", gs_fitted)):
            twin = make_model(GS, device=dev, num_points=SERVE_N, H=Hf, W=Wf,
                              raster=gs_raster)
            twin.load_state_dict(model.state_dict())
            gs_twins[name] = twin
        gs_bcfg = gs_twins["fit"].blend_cfg
        if not p3.fused_blend_supported(SERVE_N, Hf, Wf, gs_bcfg):
            fail("the 3DGS fused prep's gate refuses 768x512 at N = 10,000")
        gs_nd = []

        def gs_serve_one(name):
            img, aux = gs_twins[name].render_fast(with_aux=True)
            gs_nd.append(aux["n_dropped"])
            return img, aux

        reset_counts()
        gs_fast = {name: gs_serve_one(name) for name in gs_twins}
        gs_serve_ms = burst_ms(torch, lambda: gs_serve_one("fit"), reps=30)
        gs_serve_counts = read_counts()
        gs_frames = len(gs_nd)
        want = {k: 0 for k in all_counters}
        want["splat_prep_blend3d"] = want["rasterize_blend_fwd"] = gs_frames
        if gs_serve_counts != want:
            fail(f"3DGS render_fast launched {gs_serve_counts} over "
                 f"{gs_frames} frames: want one K10 and one K8 a frame, "
                 "nothing else")
        I_g, m_g, _ = sc.stream_caps(SERVE_N, gs_bcfg)
        id_bits_g = max(int(SERVE_N - 1).bit_length(), 1)
        tiles_xg = -(-Wf // gs_bcfg.tile_px)

        def cut_tile(keys):
            """The first tile the stream cap cuts (its window loses slots,
            every later tile all of them), or None if nothing is cut."""
            skey = torch.sort(keys.flatten()).values
            n_live = int((skey != 2 ** 31 - 1).sum())
            return int(skey[I_g]) >> id_bits_g if n_live > I_g else None

        gs_serve = {}
        for name, model in (("init", gs_init), ("fit", gs_fitted)):
            img_f, aux_f = gs_fast[name]
            with torch.no_grad():
                pkg = model.render()
                xys, depths, radii, _, _, _ = model.project()
            order, rows10 = gs_twins[name].prep_rows()
            keys10 = p3.blend3d_prep(
                *(r.contiguous() for r in rows10), gs_twins[name].cam,
                model.cfg.sh_degree, Hf, Wf, gs_bcfg.tile_px, m_g)[1]
            # the generic binning's keys per row in render()'s depth order
            ol = blend._depth_order(depths).long()
            tile_g, live_g, _ = tiles_mod._expand_instances(
                xys.float()[ol], radii.float()[ol], tiles_xg,
                -(-Hf // gs_bcfg.tile_px), gs_bcfg.tile_px, m_g)
            rank = torch.arange(SERVE_N, dtype=torch.int32, device=dev)
            keys_g = torch.where(live_g, (tile_g << id_bits_g) | rank,
                                 torch.full_like(tile_g, 2 ** 31 - 1))
            diff = (img_f - pkg["render"]).abs()[0]          # [3, H, W]
            cuts = [c for c in (cut_tile(keys10), cut_tile(keys_g))
                    if c is not None]
            keep = torch.ones(Hf, Wf, dtype=torch.bool, device=dev)
            if cuts:
                tp = gs_bcfg.tile_px
                ty = torch.arange(Hf, device=dev)[:, None] // tp
                tx = torch.arange(Wf, device=dev)[None, :] // tp
                keep = ty * tiles_xg + tx < min(cuts)
            d_keep = diff.amax(dim=0)[keep]
            case = {
                "n_dropped": int(aux_f["n_dropped"]),
                "n_dropped_render": int(pkg["raster_aux"]["n_dropped"]),
                "max_count": int(aux_f["max_count"]),
                "max_count_render": int(pkg["raster_aux"]["max_count"]),
                "order_equal": bool(torch.equal(order, ol)),
                "rows_keys_differ": int((keys10[:, :SERVE_N] != keys_g)
                                        .any(dim=0).sum()),
                "instances": int((keys10 != 2 ** 31 - 1).sum()),
                "max_abs_diff": float(diff.max()),
                "share_above_5e5": float((diff > ENV_PX).float().mean()),
                "first_cut_tile": min(cuts) if cuts else None,
                "pixels_before_cut": int(keep.sum()),
                "max_abs_diff_before_cut": float(d_keep.max())
                if d_keep.numel() else None,
                "share_above_5e5_before_cut": float(
                    (d_keep > ENV_PX).float().mean())
                if d_keep.numel() else None}
            if not torch.isfinite(img_f).all():
                fail(f"3DGS render_fast on the {name} state is not finite")
            if name == "init" and not (case["max_abs_diff"] < ENV_MAX and
                                       case["share_above_5e5"] < ENV_SHARE):
                fail(f"3DGS render_fast differs from render() on the "
                     f"initial state: {case}; want max < {ENV_MAX} and a "
                     f"share above {ENV_PX} < {ENV_SHARE}")
            gs_serve[name] = case

        # K10 against its plain version: the two states at sh_degree 3, and
        # seeded models at 0, 1, 2 and 4 (SH bands, opacities and scales
        # drawn from a seed: the init's bands are zero, its scales
        # isotropic)
        k10_cases = {"init": gs_twins["init"], "fit": gs_twins["fit"]}
        k10 = {}
        for deg in (3, 0, 1, 2, 4):
            gm = make_model(GS, device=dev, num_points=SERVE_N, H=Hf, W=Wf,
                            sh_degree=deg, raster=gs_raster)
            gen = torch.Generator(device=dev).manual_seed(20 + deg)
            gm.init_params(gen)
            with torch.no_grad():
                gm._features_rest.normal_(0.0, 0.3, generator=gen)
                gm._opacity.normal_(-1.0, 1.5, generator=gen)
                gm._scaling.add_(torch.randn(SERVE_N, 3, device=dev,
                                             generator=gen), alpha=0.4)
            k10_cases[f"seeded_sh{deg}"] = gm
        # and each seeded model's first n depth-ordered rows: a partial last
        # CTA (64 rows) and warp
        k10_deg_args = {}
        for name, gm in k10_cases.items():
            _, rows10 = gm.prep_rows()
            args = (*(r.contiguous() for r in rows10), gm.cam,
                    gm.cfg.sh_degree, Hf, Wf, gs_bcfg.tile_px, m_g)
            cases10 = [(name, args)]
            if name.startswith("seeded"):
                k10_deg_args[gm.cfg.sh_degree] = args
                cases10 += [(f"{name}_n{n}", (*(r[:n] for r in args[:5]),
                                              *args[5:]))
                            for n in EDGE_ROWS]
            for case, a in cases10:
                out10 = p3.blend3d_prep(*a)
                torch.cuda.synchronize()
                k10[case] = prep_check(f"K10 ({case})", out10,
                                       p3.blend3d_prep_plain(*a),
                                       bits=True)
                k10[case]["sh_degree"] = gm.cfg.sh_degree
            if name == "fit":
                k10_args = args
        phase("gs3d_serve", config="RasterizeConfig(fused_prep=True)",
              stream_cap=I_g, span=m_g, launches=gs_serve_counts,
              frames=gs_frames,
              n_dropped_timed_max=int(torch.stack(gs_nd[2:]).max()),
              envelope={"max": ENV_MAX, "px": ENV_PX, "share": ENV_SHARE},
              vs_render=gs_serve, k10=k10, render_fast_burst_ms=gs_serve_ms)
    finally:
        shutil.rmtree(gs_dir, ignore_errors=True)

    # -- the aligned stream (above flat_stream_limit instances) ---------------
    def flat_twin_cfg(cfg):
        """``cfg`` with the flat stream at any size: the aligned path's twin
        on the same instances."""
        return cfg._replace(flat_stream_limit=1 << 30)

    def load_fit(n, image, **kw):
        """The committed fit at ``n`` points of ``image`` (flower, china),
        ``kw`` passed to make_model."""
        ck_dir = ROOT / f"results/photos/GaussianImage_Cholesky_50000_{n}"
        ck = load_checkpoint(ck_dir / image / "gaussian_model.npz")
        m = make_model("GaussianImage_Cholesky", device=dev, num_points=n,
                       H=Hf, W=Wf, **kw)
        m.load_state_dict(params_from_numpy(ck["params"], dev))
        return m

    def scattered(dg, sp_, n_rows):
        """Gradient rows (flat) or blocks (aligned) onto the packed rows."""
        if sp_.aligned:
            return sc.scatter_block_grads(dg, sp_.gids, n_rows, sp_.m_span)
        return sc.scatter_stream_grads(dg, sp_.gids, n_rows, sp_.m_span)

    # aligned_kernel: K11a, K11b and the aligned K1-K3 on flower@40k
    f40 = load_fit(40000, "flower")
    featA, spA = stream_inputs(f40)
    f40_flat = load_fit(40000, "flower",
                        raster=flat_twin_cfg(f40.cfg.raster))
    featF, spF = stream_inputs(f40_flat)
    if not spA.aligned or spF.aligned:
        fail(f"flower@40k: aligned {spA.aligned}, its twin {spF.aligned}")
    nA = featA.shape[0]
    tpA = f40.cfg.raster.tile_px
    blocksA = sc.blockize_stream(featA, spA.gids)
    torch.cuda.synchronize()
    blocksA_p = sc.blockize_stream_plain(featA, spA.gids)
    k11a_equal = bool(torch.equal(blocksA, blocksA_p))
    k11a_err = float((blocksA - blocksA_p).abs().max())
    imgA = rs.sum_fwd_aligned(blocksA, spA.starts, spA.counts, Hf, Wf)
    torch.cuda.synchronize()
    imgA_p = rs.sum_fwd_aligned_plain(blocksA, spA.starts, spA.counts, Hf, Wf)
    k1a_err = float((imgA - imgA_p).abs().max())
    if not same_bits(torch, imgA, rs.sum_fwd_aligned_plain(
            blocksA, spA.starts, spA.counts, Hf, Wf, in_order=True)):
        fail("aligned flower@40k: K1 differs from the in-order plain "
             "version")
    gA = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, Hf, Wf)).astype(np.float32) * 1e-5, device=dev)
    dg2A = rs.sum_bwd_aligned(blocksA, spA.starts, spA.counts, gA, Hf, Wf)
    torch.cuda.synchronize()
    dg2A_p = rs.sum_bwd_aligned_plain(blocksA, spA.starts, spA.counts, gA,
                                      Hf, Wf)
    if not same_bits(torch, rs.sum_bwd_aligned(
            blocksA, spA.starts, spA.counts, gA, Hf, Wf), dg2A):
        fail("two runs of the aligned K2 on flower@40k differ")
    sse3A, dg3A = rs.sum_l2_aligned(blocksA, spA.starts, spA.counts, gt_f, Hf,
                                    Wf)
    torch.cuda.synchronize()
    sse3A_p, dg3A_p = rs.sum_l2_aligned_plain(blocksA, spA.starts, spA.counts,
                                              gt_f, Hf, Wf)
    rowsK11b = sc.unblockize_stream(dg3A)
    torch.cuda.synchronize()
    k11b_equal = bool(torch.equal(rowsK11b,
                                  sc.unblockize_stream_plain(dg3A)))
    roundtrip = bool(torch.equal(sc.unblockize_stream(blocksA),
                                 featA[spA.gids.long()]))
    if not (k11a_equal and k11b_equal and roundtrip):
        fail(f"K11a equal {k11a_equal}, K11b equal {k11b_equal}, "
             f"K11b(K11a(x)) == feat[gids] {roundtrip}")
    # the live slots' rows: slot -> its tile, for the clip-flip allowance
    slotA, tileA = window_slots(spA, Hf)
    T40 = spA.tiles_x * (-(-Hf // tpA))
    e2A = float(row_err(torch, sc.unblockize_stream_plain(dg2A)[slotA],
                        sc.unblockize_stream_plain(dg2A_p)[slotA]).max())
    if not (math.isfinite(k1a_err) and k1a_err <= K1_TOL and e2A <= ROW_TOL):
        fail(f"the aligned K1 / K2 disagree with their plain versions: "
             f"max |diff| {k1a_err} (<= {K1_TOL}), worst row {e2A} "
             f"(<= {ROW_TOL})")
    k3A = k3_check("aligned flower@40k",
                   sc.unblockize_stream_plain(dg3A)[slotA],
                   sc.unblockize_stream_plain(dg3A_p)[slotA], sse3A, sse3A_p,
                   imgA[:3], imgA_p[:3], tileA, spA.T, spA.tiles_x)
    work40 = cull_check("aligned flower@40k", pair_work(
        torch, rs, sc, featA, spA, Hf, Wf, q_cut))
    dfeat3A = [scattered(rs.sum_l2_aligned(
        sc.blockize_stream(featA, spA.gids), spA.starts, spA.counts, gt_f,
        Hf, Wf)[1], spA, nA) for _ in range(2)]
    if not torch.equal(dfeat3A[0], dfeat3A[1]):
        fail("two runs of the aligned K3 and the scatter on one step differ")
    # against the flat twin on the same state: bit for bit
    imgF = rs.sum_fwd(featF, spF.gids, spF.starts, Hf, Wf)
    dfeat2F = scattered(rs.sum_bwd(featF, spF.gids, spF.starts, gA, Hf, Wf),
                        spF, nA)
    sse3F, dg3F = rs.sum_l2(featF, spF.gids, spF.starts, gt_f, Hf, Wf)
    vs_flat = {
        "n_dropped": int(spA.n_dropped), "n_dropped_flat": int(spF.n_dropped),
        "image_equal": bool(torch.equal(imgA, imgF)),
        "k2_grads_equal": bool(torch.equal(scattered(dg2A, spA, nA),
                                           dfeat2F)),
        "k3_sse_equal": bool(torch.equal(sse3A, sse3F)),
        "k3_grads_equal": bool(torch.equal(dfeat3A[0],
                                           scattered(dg3F, spF, nA)))}
    if not (all(v for k, v in vs_flat.items() if k.endswith("equal"))
            and vs_flat["n_dropped"] == vs_flat["n_dropped_flat"]):
        fail(f"the aligned path differs from the flat twin: {vs_flat}")
    phase("aligned_kernel", state="flower@40k", slots=spA.I,
          live=int(spA.counts.sum()), blocks=blocksA.shape[0],
          k11a_bit_equal=k11a_equal, k11b_bit_equal=k11b_equal,
          k11b_of_k11a_is_gather=roundtrip,
          k1={"max_abs_err": k1a_err, "tol": K1_TOL,
              "in_order_bit_equal": True, "work": work40},
          k2={"worst_row": e2A, "row_tol": ROW_TOL, "max_abs_err": float(
              (dg2A - dg2A_p).abs().max()), "bit_identical_twice": True,
              "work": work40},
          k3={**k3A, "bit_identical_twice": True, "work": work40},
          vs_flat_twin=vs_flat)

    # aligned_slice: the evaluation CLI on the committed 20k and 40k fits
    aligned_eval, aligned_eval_counts, twin_checks = {}, {}, {}
    for n, anchors in ALIGNED_EVALS.items():
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_aligned_")
        try:
            reset_counts()
            res = train.main([
                "--data_name", "photos", "--dataset", str(ROOT / "data"),
                "--model_path", str(ROOT / "results/photos" /
                                    f"GaussianImage_Cholesky_50000_{n}"),
                "--iterations", "0", "--num_points", str(n),
                "--checkpoint_root", out_dir])
            cnt = read_counts()
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        aligned_eval_counts[n] = cnt
        if not (cnt["stream_blockize"] and cnt["rasterize_sum_fwd_aligned"]):
            fail(f"the {n}-point evaluation launched {cnt}: no K11a or "
                 "aligned K1")
        for r in res:
            want = anchors[r["image"]]
            if abs(r["psnr"] - want) > ALIGNED_PSNR_TOL or r["n_dropped"]:
                fail(f"{r['image']}@{n}: PSNR {r['psnr']} (the JAX "
                     f"package's render {want} +- {ALIGNED_PSNR_TOL}), "
                     f"n_dropped {r['n_dropped']}")
            tpu = ALIGNED_TPU_LOGS[n][r["image"]]
            aligned_eval[f"{r['image']}@{n}"] = dict(
                {k: r[k] for k in ("psnr", "ms_ssim", "fps", "n_dropped")},
                jax_psnr=want, tpu_log_psnr=tpu,
                below_tpu_log_db=tpu - r["psnr"])
            # the second check: render_fast under serving(n), flat, K5
            m_a = load_fit(n, r["image"])
            twin = load_fit(n, r["image"], raster=RasterizeConfig.serving(n))
            with torch.no_grad():
                img_a = m_a.render()["render"]
                img_t, aux_t = twin.render_fast(with_aux=True)
            diff = (img_t - img_a).abs()
            edge = int((diff > 1e-4).sum())
            off = float(diff[diff <= 1e-4].max())
            twin_checks[f"{r['image']}@{n}"] = {
                "serving_n_dropped": int(aux_t["n_dropped"]),
                "max_abs_diff": float(diff.max()), "pixels_above_1e4": edge}
            if int(aux_t["n_dropped"]) or edge > MAX_EDGE_PX or off > IMG_TOL:
                fail(f"{r['image']}@{n}: render_fast under serving({n}) "
                     f"against the aligned render(): "
                     f"{twin_checks[r['image'] + '@' + str(n)]}, the rest up "
                     f"to {off}")
    phase("aligned_slice", tol_db=ALIGNED_PSNR_TOL, images=aligned_eval,
          launches=aligned_eval_counts, serving_twin=twin_checks)

    # codec_rates: the codec CLI on the committed 20k and 40k QAT states,
    # gated on the JAX package's evaluation of each (CODEC_RATE_ANCHORS):
    # the evaluation's decode takes the aligned stream (K11a, the aligned
    # K1), the decode probe the serving twin (K4, the flat K1 on up to 3N
    # instances); then K4 on each 40k state's codes and the aligned K1 on
    # its decode, against their plain versions and timed
    t_rates = time.time()
    rates, rates_counts, rates_dataset = {}, {}, {}
    rate_keys = ("psnr", "ms-ssim", "bpp", "bpp_ec", "ec_roundtrip_err",
                 "position_bpp", "cholesky_bpp", "feature_dc_bpp",
                 "serving_n_dropped", "probe_model", "rendering_fps")
    for n, anchors in CODEC_RATE_ANCHORS.items():
        folder = f"GaussianImage_Cholesky_50000_{n}"
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_codec_rates_")
        try:
            reset_counts()
            res = test_quantize.main([
                "--data_name", "photos", "--dataset", str(ROOT / "data"),
                "--model_path", str(CODEC_RATES_ROOT / folder),
                "--num_points", str(n), "--checkpoint_root", out_dir])
            cnt = read_counts()
            root_txt = (Path(out_dir) / "photos" / folder / "test.txt"
                        ).read_text()
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        rates_counts[n] = cnt
        dd = re.search(r"Dataset decode \(.*", root_txt)
        rates_dataset[n] = dd.group(0) if dd else None
        for r in res:
            want = anchors[r["image"]]
            if (abs(r["psnr"] - want["psnr"]) > 0.01
                    or abs(r["ms-ssim"] - want["ms-ssim"]) > 1e-4
                    or round(r["bpp"], 4) != want["bpp"]
                    or round(r["bpp_ec"], 4) != want["bpp_ec"]
                    or not r["ec_roundtrip_err"] < 1e-6
                    or r["serving_n_dropped"] != want["serving_n_dropped"]):
                fail(f"codec {r['image']}@{n}: "
                     f"{ {k: r[k] for k in rate_keys} }; want {want}, "
                     "round trip < 1e-6")
            rates[f"{r['image']}@{n}"] = {
                **{k: r[k] for k in rate_keys},
                "ms_per_decode_frame": 1e3 * r["rendering_time"],
                "jax": want}
        n_serving = sum(r["probe_model"] == "serving" for r in res)
        if (cnt["splat_prep_decode"] < MIN_K4 * n_serving
                or not cnt["stream_blockize"]
                or not cnt["rasterize_sum_fwd_aligned"]):
            fail(f"the {n}-point codec run launched {cnt}: K4 fewer than "
                 f"{MIN_K4} a serving probe, or no K11a or aligned K1")

    def device_us(fn, name, n=20):
        """(device us per launch, launches seen) of kernel
        ``<name>_kernel`` in a trace of ``n`` calls of ``fn``, over the
        launches the trace saw, as ``profile_of`` counts them; the profiler
        can miss launches, so up to five traces until one sees any."""
        for _ in range(5):
            hits = [v for k, v in traced_us(
                torch, lambda: [fn() for _ in range(n)]).items()
                if f"{name}_kernel" in k]
            seen = sum(c for _, c in hits)
            if seen:
                return sum(us for us, _ in hits) / seen, seen
        return None, 0

    n40, plane = 40000, Hf * Wf
    cfg40 = RasterizeConfig.serving(n40)
    I40, m40, aligned40 = sc.stream_caps(n40, cfg40)
    if aligned40:
        fail(f"serving({n40}) takes the aligned stream")
    k4_40k, k1_40k, k1s_40k = {}, {}, {}
    for image in ("china", "flower"):
        qm = make_model("GaussianImage_Cholesky", device=dev, num_points=n40,
                        H=Hf, W=Wf, quantize=True)
        ckn = load_checkpoint(CODEC_RATES_ROOT
                              / f"GaussianImage_Cholesky_50000_{n40}" / image
                              / "gaussian_model.best.npz")
        merge_matching(qm, ckn["params"], ckn["extra"])
        enc_n = {k: torch.as_tensor(v, device=dev)
                 for k, v in qm.compress_wo_ec().items()}
        a4 = (enc_n["xyz"].float(), enc_n["quant_cholesky"],
              enc_n["feature_dc_index"], qm.cholesky_quant_scale.detach(),
              qm.cholesky_quant_beta.detach(),
              qm.features_vq.combined_codebook(qm.vq_state()).contiguous(),
              CHOLESKY_BOUND, Hf, Wf, cfg40.tile_px, m40, float(cfg40.q_cut))
        out4n = prep.decode_prep(*a4)
        torch.cuda.synchronize()
        res4 = prep_check(f"K4 ({image}@40k)", out4n,
                          prep.decode_prep_plain(*a4), bits=True)
        rows = n40 + 1
        b4 = bound(rows * (PREP_ROW_SLOTS["splat_prep_decode"]
                           + PREP_KEY_SLOTS * m40), 0,
                   28 * n40 + 4 * (6 + 192)
                   + rows * (4 * sc.FW + 4 * m40 + 8))
        us4, seen4 = device_us(lambda: prep.decode_prep(*a4),
                               "splat_prep_decode")
        res4.update(
            rows=int(out4n[0].shape[0]), device_us=us4,
            device_launches_seen=seen4,
            ms=burst_ms(torch, lambda: prep.decode_prep(*a4), reps=20),
            plain_ms=burst_ms(torch, lambda: prep.decode_prep_plain(*a4),
                              reps=5),
            bound_ms=b4[0], bound_by=b4[1])
        k4_40k[image] = res4
        # the serving twin's decode: K4's keys, one sort, the flat K1 on a
        # stream past the default config's flat limit; against its plain
        # versions, and its image against the aligned decode's below
        feat4, keys4, trunc4, ntot4 = prep._finish(out4n)
        gids4, starts4, counts4 = rs.stream_from_keys(keys4, n40, Hf, Wf,
                                                      cfg40, I40)
        fwd_s = (feat4, gids4, starts4, Hf, Wf, cfg40.tile_px,
                 float(cfg40.q_cut))
        img_s = rs.sum_fwd(*fwd_s)
        torch.cuda.synchronize()
        err_s = float((img_s - rs.sum_fwd_plain(*fwd_s)).abs().max())
        nd_s = int(trunc4 + torch.clamp(ntot4 - I40, min=0))
        qm_s = make_model("GaussianImage_Cholesky", device=dev,
                          num_points=n40, H=Hf, W=Wf, quantize=True,
                          raster=cfg40)
        qm_s.load_state_dict(qm.state_dict())
        dec_s = qm_s.decompress_wo_ec(enc_n)
        if not (same_bits(torch, img_s, rs.sum_fwd_plain(
                *fwd_s, in_order=True))
                and math.isfinite(err_s) and err_s <= K1_TOL
                and torch.equal(clip01(img_s[:3]), dec_s["render"][0])
                and nd_s == 0 and int(dec_s["raster_aux"]["n_dropped"]) == 0):
            fail(f"{image}@40k QAT serving: the flat K1 on K4's stream "
                 f"against its plain versions (max |diff| {err_s} <= "
                 f"{K1_TOL}, in order bit for bit), the serving decode, or "
                 f"n_dropped {nd_s}")
        sp_s = SimpleNamespace(gids=gids4, starts=starts4, counts=counts4,
                               tiles_x=-(-Wf // cfg40.tile_px))
        work_s = cull_check(f"{image}@40k QAT serving", pair_work(
            torch, rs, sc, feat4, sp_s, Hf, Wf, float(cfg40.q_cut)))
        b1s = bound(*sum_ops("rasterize_sum_fwd", work_s),
                    4 * (feat4.numel() + gids4.numel() + starts4.numel())
                    + 4 * 4 * plane)
        us1s, seen1s = device_us(lambda: rs.sum_fwd(*fwd_s),
                                 "rasterize_sum_fwd")
        k1s_40k[image] = {
            "max_abs_err": err_s, "tol": K1_TOL, "in_order_bit_equal": True,
            "equals_serving_decode": True, "instances": int(starts4[-1]),
            "cap": I40, "n_dropped": nd_s, "work": work_s,
            "device_us": us1s, "device_launches_seen": seen1s,
            "ms": burst_ms(torch, lambda: rs.sum_fwd(*fwd_s), reps=20),
            "plain_ms": burst_ms(torch, lambda: rs.sum_fwd_plain(*fwd_s),
                                 reps=3),
            "bound_ms": b1s[0], "bound_by": b1s[1]}
        # the evaluation's decode: its stream, the aligned K1 on it
        with torch.no_grad():
            means, geo, colors = qm.dequantize_wo_ec(enc_n)
            xys, radii, conics, colors, opac = qm._quantized_splat(
                None, means, geo, colors)
            rxy = rs._axis_radii(conics, radii.float(), q_cut)
            spq = sc.prepare_stream(xys, rxy, Hf, Wf, qm.cfg.raster)
            featq = sc.pack_feat(xys, conics, colors, opac, premultiply=True)
            dec = qm.decompress_wo_ec(enc_n)["render"][0]
        if not spq.aligned or int(spq.n_dropped):
            fail(f"{image}@40k QAT: aligned {spq.aligned}, n_dropped "
                 f"{int(spq.n_dropped)}")
        blocksq = sc.blockize_stream(featq, spq.gids)
        img_q = rs.sum_fwd_aligned(blocksq, spq.starts, spq.counts, Hf, Wf)
        torch.cuda.synchronize()
        img_qp = rs.sum_fwd_aligned_plain(blocksq, spq.starts, spq.counts,
                                          Hf, Wf)
        err = float((img_q - img_qp).abs().max())
        if not (same_bits(torch, img_q, rs.sum_fwd_aligned_plain(
                blocksq, spq.starts, spq.counts, Hf, Wf, in_order=True))
                and math.isfinite(err) and err <= K1_TOL
                and torch.equal(img_q[:3].clamp(0, 1), dec)):
            fail(f"{image}@40k QAT: the aligned K1 against its plain "
                 f"versions (max |diff| {err} <= {K1_TOL}, in order bit for "
                 "bit) or the codec's decode")
        # the serving decode against the evaluation's (aligned) one
        diff_s = (dec_s["render"][0] - dec).abs()
        edge_s = int((diff_s > 1e-4).sum())
        off_s = float(diff_s[diff_s <= 1e-4].max())
        k1s_40k[image].update(vs_aligned_decode={
            "max_abs_diff": float(diff_s.max()), "pixels_above_1e4": edge_s,
            "rest_max_abs_diff": off_s})
        if edge_s > MAX_EDGE_PX or off_s > IMG_TOL:
            fail(f"{image}@40k QAT: the serving decode against the aligned "
                 f"decode: {k1s_40k[image]['vs_aligned_decode']} (at most "
                 f"{MAX_EDGE_PX} pixels above 1e-4, the rest <= {IMG_TOL})")
        work_q = cull_check(f"{image}@40k QAT", pair_work(
            torch, rs, sc, featq, spq, Hf, Wf, q_cut))
        b1 = bound(*sum_ops("rasterize_sum_fwd", work_q),
                   4 * (blocksq.numel() + spq.starts.numel()
                        + spq.counts.numel()) + 4 * 4 * plane)
        us1, seen1 = device_us(lambda: rs.sum_fwd_aligned(
            blocksq, spq.starts, spq.counts, Hf, Wf), "rasterize_sum_fwd")
        k1_40k[image] = {
            "max_abs_err": err, "tol": K1_TOL, "in_order_bit_equal": True,
            "equals_decode": True, "live": int(spq.counts.sum()),
            "work": work_q, "device_us": us1, "device_launches_seen": seen1,
            "ms": burst_ms(torch, lambda: rs.sum_fwd_aligned(
                blocksq, spq.starts, spq.counts, Hf, Wf), reps=20),
            "plain_ms": burst_ms(torch, lambda: rs.sum_fwd_aligned_plain(
                blocksq, spq.starts, spq.counts, Hf, Wf), reps=3),
            "bound_ms": b1[0], "bound_by": b1[1]}
    phase("codec_rates", seconds=round(time.time() - t_rates, 3),
          images=rates, launches=rates_counts, dataset_decode=rates_dataset,
          k4_40k=k4_40k, k1_flat_serving_40k=k1s_40k,
          k1_aligned_40k=k1_40k)

    # aligned_fit: TWIN_STEPS K3 steps from the 40k state, aligned and
    # flat; Fusion2 steps (K1 + K2) on it; then the CLI's fit at N = 50,000
    gt_nchw_f = gt_f[None]
    twins = {"aligned": load_fit(40000, "flower"),
             "flat": load_fit(40000, "flower",
                              raster=flat_twin_cfg(f40.cfg.raster))}
    twin_losses = {}
    for name, m in twins.items():
        opt_t = m.make_optimizer()
        twin_losses[name] = torch.stack(
            [m.train_step(opt_t, gt_nchw_f)["loss"]
             for _ in range(TWIN_STEPS)]).cpu()
    params_equal = all(torch.equal(a, b) for a, b in zip(
        twins["aligned"].parameters(), twins["flat"].parameters()))
    if not (torch.equal(twin_losses["aligned"], twin_losses["flat"])
            and params_equal):
        fail(f"{TWIN_STEPS} K3 steps: the aligned losses "
             f"{twin_losses['aligned'][-3:].tolist()} and the flat twin's "
             f"{twin_losses['flat'][-3:].tolist()}, parameters equal "
             f"{params_equal}")
    fusion = load_fit(40000, "flower", loss_type="Fusion2")
    opt_t = fusion.make_optimizer()
    reset_counts()
    fusion_losses = torch.stack([fusion.train_step(opt_t, gt_nchw_f)["loss"]
                                 for _ in range(GENERIC_STEPS)]).cpu()
    fusion_counts = read_counts()
    if (fusion_counts["rasterize_sum_bwd_aligned"] < GENERIC_STEPS
            or not torch.isfinite(fusion_losses).all()):
        fail(f"Fusion2 steps at 40k launched {fusion_counts}, losses "
             f"{fusion_losses[-3:].tolist()}")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_aligned_fit_")
    try:
        tr50 = train.SimpleTrainer2d(
            image_path_to_array(FLOWER_PHOTO), "flower",
            num_points=ALIGNED_FIT_N, iterations=ALIGNED_FIT_ITERS,
            args=train.parse_args([]), log_dir=Path(out_dir) / "flower",
            device=dev)
        init50 = tr50.test()[0]
        reset_counts()
        fit50 = tr50.train()
        fit50_counts = read_counts()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses50 = np.asarray(tr50._hist["loss"])
    if (not np.isfinite(losses50).all()
            or fit50_counts["rasterize_sum_l2_aligned"] < ALIGNED_FIT_ITERS
            or fit50_counts["stream_unblockize"] < ALIGNED_FIT_ITERS):
        fail(f"the {ALIGNED_FIT_N}-point fit: {len(losses50)} losses, "
             f"{int((~np.isfinite(losses50)).sum())} not finite; launches "
             f"{fit50_counts}")
    if not fit50["psnr"] >= init50 + ALIGNED_FIT_GAIN:
        fail(f"the {ALIGNED_FIT_N}-point fit reads {fit50['psnr']} dB from "
             f"{init50} at its initial state (want + {ALIGNED_FIT_GAIN})")
    phase("aligned_fit", twin_steps=TWIN_STEPS,
          twin_losses_equal=True, twin_params_equal=True,
          twin_loss_last=float(twin_losses["aligned"][-1]),
          fusion2={"steps": GENERIC_STEPS, "launches": fusion_counts,
                   "loss_first": float(fusion_losses[0]),
                   "loss_last": float(fusion_losses[-1])},
          num_points=ALIGNED_FIT_N, iterations=ALIGNED_FIT_ITERS,
          slots=sc.stream_caps(ALIGNED_FIT_N, tr50.model.cfg.raster)[0]
          + T40 * sc.BK,
          launches=fit50_counts, init_test_psnr=init50,
          test_psnr=fit50["psnr"], psnr_gain_floor=ALIGNED_FIT_GAIN,
          n_dropped_chunks=tr50.chunk_dropped,
          n_dropped_test=fit50["n_dropped"],
          training_s=fit50["training_time"],
          ms_per_step=1e3 * fit50["training_time"] / ALIGNED_FIT_ITERS,
          fps=fit50["fps"])

    # gs3d_aligned: the 3DGS baseline at 30,000 points, sh_degree 3
    gs_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_3dgs_aligned_"))
    try:
        gs30 = train.SimpleTrainer2d(
            gt_flower, "flower", num_points=GS_ALIGNED_N, model_name=GS,
            iterations=GS_ALIGNED_STEPS,
            args=train.parse_args(["--model_name", GS]),
            log_dir=gs_dir / "flower", device=dev)
        gm = gs30.model
        bcfg30 = gm.blend_cfg
        bkw30 = dict(tile_px=bcfg30.tile_px, block_inst=bcfg30.block_inst,
                     alpha_clip=bcfg30.alpha_clip,
                     alpha_min=bcfg30.alpha_min)
        ls30 = blend.log_stop(bcfg30)
        with torch.no_grad():
            proj30 = gm.project()
            _, sp30F = blend.blend_stream(*proj30[:3], Hf, Wf,
                                          flat_twin_cfg(bcfg30))
        g30 = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (4, Hf, Wf)).astype(np.float32), device=dev)
        # the aligned K8 / K9 against their plain versions
        case30, (feat30, sp30, logt30, nch30, blocks30, out30,
                 dgb30) = blend_case(f"3DGS@{GS_ALIGNED_N}", proj30, bcfg30,
                                     Hf, Wf, g30)
        if not sp30.aligned or sp30F.aligned:
            fail(f"3DGS@{GS_ALIGNED_N}: aligned {sp30.aligned}, its twin "
                 f"{sp30F.aligned}")
        out30F, nch30F = blend.blend_fwd(feat30, sp30F.gids, sp30F.starts,
                                         Hf, Wf, log_stop=ls30, **bkw30)
        dg30F = blend.blend_bwd(feat30, sp30F.gids, sp30F.starts,
                                out30F[4].contiguous(), nch30F, g30, Hf, Wf,
                                **bkw30)
        gs_vs_flat = {
            "n_dropped": int(sp30.n_dropped),
            "n_dropped_flat": int(sp30F.n_dropped),
            "image_equal": bool(torch.equal(out30, out30F)),
            "nch_equal": bool(torch.equal(nch30, nch30F)),
            "grads_equal": bool(torch.equal(
                scattered(dgb30, sp30, feat30.shape[0]),
                scattered(dg30F, sp30F, feat30.shape[0])))}
        if gs_vs_flat["n_dropped"] != gs_vs_flat["n_dropped_flat"] or not (
                gs_vs_flat["image_equal"] and gs_vs_flat["nch_equal"]
                and gs_vs_flat["grads_equal"]):
            fail(f"3DGS@{GS_ALIGNED_N}: the aligned blend differs from the "
                 f"flat twin: {gs_vs_flat}")
        reset_counts()
        fit30 = gs30.train()
        fit30_counts = read_counts()
        losses30 = np.asarray(gs30._hist["loss"])
        if (not np.isfinite(losses30).all()
                or len(losses30) != GS_ALIGNED_STEPS
                or fit30_counts["rasterize_blend_bwd_aligned"]
                < GS_ALIGNED_STEPS):
            fail(f"the 3DGS fit at {GS_ALIGNED_N}: {len(losses30)} losses, "
                 f"{int((~np.isfinite(losses30)).sum())} not finite; "
                 f"launches {fit30_counts}")
        phase("gs3d_aligned", num_points=GS_ALIGNED_N,
              sh_degree=gm.cfg.sh_degree, loss_type=gm.cfg.loss_type,
              slots=sp30.I, span=sp30.m_span, live=int(sp30.counts.sum()),
              row_tol=ROW_TOL, kernels=case30, vs_flat_twin=gs_vs_flat,
              steps=GS_ALIGNED_STEPS, launches=fit30_counts,
              test_psnr=fit30["psnr"], n_dropped_chunks=gs30.chunk_dropped,
              n_dropped_test=fit30["n_dropped"],
              ms_per_step=1e3 * fit30["training_time"] / GS_ALIGNED_STEPS)
    finally:
        shutil.rmtree(gs_dir, ignore_errors=True)

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
    ms["splat_prep_raw"] = burst_ms(torch, lambda: prep.raw_prep(*k5_args),
                                    reps=50)
    ms["splat_prep_decode"] = burst_ms(
        torch, lambda: prep.decode_prep(*k4_args), reps=50)
    plain["splat_prep_raw"] = burst_ms(
        torch, lambda: prep.raw_prep_plain(*k5_args), reps=20)
    plain["splat_prep_decode"] = burst_ms(
        torch, lambda: prep.decode_prep_plain(*k4_args), reps=20)
    ms["splat_prep_decode_batch"] = burst_ms(
        torch, lambda: prep.batch_decode_prep(*k7_main), reps=50)
    plain["splat_prep_decode_batch"] = burst_ms(
        torch, lambda: prep.batch_decode_prep_plain(*k7_main), reps=20)
    ms["splat_prep_rs_raw"] = burst_ms(
        torch, lambda: prep.rs_raw_prep(*k6b_args), reps=50)
    ms["splat_prep_rs_decode"] = burst_ms(
        torch, lambda: prep.rs_decode_prep(*k6a_args), reps=50)
    plain["splat_prep_rs_raw"] = burst_ms(
        torch, lambda: prep.rs_raw_prep_plain(*k6b_args), reps=20)
    plain["splat_prep_rs_decode"] = burst_ms(
        torch, lambda: prep.rs_decode_prep_plain(*k6a_args), reps=20)
    # K8 and K9 on the 3DGS fit's stream, 32-pixel tiles (the last
    # gs3d_kernel case)
    k8_args = (feat8, sp8.gids, sp8.starts, Hf, Wf)
    k9_args = (feat8, sp8.gids, sp8.starts, logt8, nch8, g9, Hf, Wf)
    ms["rasterize_blend_fwd"] = burst_ms(
        torch, lambda: blend.blend_fwd(*k8_args, log_stop=ls8, **bkw),
        reps=50)
    ms["rasterize_blend_bwd"] = burst_ms(
        torch, lambda: blend.blend_bwd(*k9_args, **bkw), reps=50)
    plain["rasterize_blend_fwd"] = burst_ms(
        torch, lambda: blend.blend_fwd_plain(*k8_args, log_stop=ls8, **bkw),
        reps=3, warmup=1)
    plain["rasterize_blend_bwd"] = burst_ms(
        torch, lambda: blend.blend_bwd_plain(*k9_args, **bkw), reps=3,
        warmup=1)
    # K11a and K11b on the flower@40k aligned stream
    ms["stream_blockize"] = burst_ms(
        torch, lambda: sc.blockize_stream(featA, spA.gids), reps=50)
    ms["stream_unblockize"] = burst_ms(
        torch, lambda: sc.unblockize_stream(dg3A), reps=50)
    plain["stream_blockize"] = burst_ms(
        torch, lambda: sc.blockize_stream_plain(featA, spA.gids), reps=20)
    plain["stream_unblockize"] = burst_ms(
        torch, lambda: sc.unblockize_stream_plain(dg3A), reps=20)
    # one PyTorch call of K11b's function: the transposed view's copy
    library = {k: None for k in counters}
    library["stream_unblockize"] = burst_ms(
        torch, lambda: dg3A.transpose(1, 2).contiguous(), reps=50)
    # and K11b's and the copy's device times, traced together: warm (back
    # to back, the input in L2 as it is after K3 in the fit step) and cold
    # (a 64 MB write, more than the 50 MB L2, before each launch)
    def copy_k11b():
        return dg3A.transpose(1, 2).contiguous()

    flush = torch.empty(1 << 24, dtype=torch.float32, device=dev)
    k11b_l2 = {}
    for cond, fn in (
            ("warm", lambda: [(sc.unblockize_stream(dg3A), copy_k11b())
                              for _ in range(20)]),
            ("cold", lambda: [(flush.zero_(), sc.unblockize_stream(dg3A),
                               flush.zero_(), copy_k11b())
                              for _ in range(20)])):
        # the profiler can miss a kernel of a short trace: traced again
        for _ in range(3):
            us = traced_us(torch, fn)
            # K11b by name; the copy is every other kernel but the flush's
            # fill
            k11b = [v for key, v in us.items()
                    if "stream_unblockize_kernel" in key]
            copy = {key: v for key, v in us.items()
                    if "stream_unblockize_kernel" not in key
                    and "Fill" not in key and "Memset" not in key}
            if k11b and copy:
                break
        k_us, k_n = (sum(v[i] for v in k11b) for i in (0, 1))
        c_us, c_n = (sum(v[i] for v in copy.values()) for i in (0, 1))
        if not (k_n and c_n):
            fail(f"K11b against its copy, {cond}: the profiler saw "
                 f"{k_n} K11b and {c_n} copy launches")
        k11b_l2[cond] = {"k11b_device_ms": k_us / k_n / 1e3,
                         "copy_device_ms": c_us / c_n / 1e3,
                         "launches_seen": [k_n, c_n],
                         "copy_kernels": sorted(k[:60] for k in copy)}
        k11b_l2[cond]["ratio"] = (k11b_l2[cond]["k11b_device_ms"]
                                  / k11b_l2[cond]["copy_device_ms"])
    del flush
    library_device = {k: None for k in counters}
    library_device["stream_unblockize"] = k11b_l2["warm"]["copy_device_ms"]
    # the aligned K1-K3 on flower@40k, K8 and K9 on the 3DGS@30k state
    a_args = (blocksA, spA.starts, spA.counts)
    b_args = (blocks30, sp30.starts, sp30.counts)
    aligned_launch = {
        "rasterize_sum_fwd": lambda: rs.sum_fwd_aligned(*a_args, Hf, Wf),
        "rasterize_sum_bwd": lambda: rs.sum_bwd_aligned(*a_args, gA, Hf, Wf),
        "rasterize_sum_l2": lambda: rs.sum_l2_aligned(*a_args, gt_f, Hf, Wf),
        "rasterize_blend_fwd": lambda: blend.blend_fwd_aligned(
            *b_args, Hf, Wf, log_stop=ls30, **bkw30),
        "rasterize_blend_bwd": lambda: blend.blend_bwd_aligned(
            *b_args, logt30, nch30, g30, Hf, Wf, **bkw30)}
    aligned_plain = {
        "rasterize_sum_fwd": lambda: rs.sum_fwd_aligned_plain(*a_args, Hf,
                                                              Wf),
        "rasterize_sum_bwd": lambda: rs.sum_bwd_aligned_plain(*a_args, gA,
                                                              Hf, Wf),
        "rasterize_sum_l2": lambda: rs.sum_l2_aligned_plain(*a_args, gt_f,
                                                            Hf, Wf),
        "rasterize_blend_fwd": lambda: blend.blend_fwd_aligned_plain(
            *b_args, Hf, Wf, log_stop=ls30, **bkw30),
        "rasterize_blend_bwd": lambda: blend.blend_bwd_aligned_plain(
            *b_args, logt30, nch30, g30, Hf, Wf, **bkw30)}
    # the same kernels' flat branch on the flat twins of the same states
    flat_twin_launch = {
        "rasterize_sum_fwd": lambda: rs.sum_fwd(featF, spF.gids, spF.starts,
                                                Hf, Wf),
        "rasterize_sum_bwd": lambda: rs.sum_bwd(featF, spF.gids, spF.starts,
                                                gA, Hf, Wf),
        "rasterize_sum_l2": lambda: rs.sum_l2(featF, spF.gids, spF.starts,
                                              gt_f, Hf, Wf),
        "rasterize_blend_fwd": lambda: blend.blend_fwd(
            feat30, sp30F.gids, sp30F.starts, Hf, Wf, log_stop=ls30,
            **bkw30),
        "rasterize_blend_bwd": lambda: blend.blend_bwd(
            feat30, sp30F.gids, sp30F.starts, out30F[4].contiguous(),
            nch30F, g30, Hf, Wf, **bkw30)}
    aligned_ms = {k: burst_ms(torch, fn, reps=20)
                  for k, fn in aligned_launch.items()}
    aligned_plain_ms = {k: burst_ms(torch, fn, reps=2, warmup=1)
                        for k, fn in aligned_plain.items()}
    # K10 on the 3DGS fit's depth-ordered rows, sh_degree 3
    ms["splat_prep_blend3d"] = burst_ms(
        torch, lambda: p3.blend3d_prep(*k10_args), reps=50)
    plain["splat_prep_blend3d"] = burst_ms(
        torch, lambda: p3.blend3d_prep_plain(*k10_args), reps=20)
    with torch.no_grad():
        render_ms = burst_ms(torch, flower.render, reps=30)
    step_opt = fitted.make_optimizer()
    gt_fit = trainer.gt_image
    step_ms = burst_ms(torch, lambda: fitted.train_step(step_opt, gt_fit),
                       reps=250, warmup=10)
    with torch.no_grad():
        render_prof = profile_of(torch, lambda: train.render_burst(flower),
                                 train.FPS_FRAMES, ported)

    def steps50():
        for _ in range(50):
            fitted.train_step(step_opt, gt_fit)

    step_prof = profile_of(torch, steps50, 50, ported)
    # the 3DGS step (Fusion2 through K8 and K9) and its FPS-probe render
    gs_opt = gs_fitted.make_optimizer()
    gs_gt = gs_trainer.gt_image
    gs_step_ms = burst_ms(torch, lambda: gs_fitted.train_step(gs_opt, gs_gt),
                          reps=100, warmup=5)

    def gs_steps50():
        for _ in range(50):
            gs_fitted.train_step(gs_opt, gs_gt)

    gs_step_prof = profile_of(torch, gs_steps50, 50, ported)
    # the fit step on the aligned stream: the 50,000-point fit's state
    opt50 = tr50.model.make_optimizer()
    step50_ms = burst_ms(torch, lambda: tr50.model.train_step(
        opt50, tr50.gt_image), reps=100, warmup=5)

    def steps50_aligned():
        for _ in range(50):
            tr50.model.train_step(opt50, tr50.gt_image)

    step50_prof = profile_of(torch, steps50_aligned, 50, ported)
    with torch.no_grad():
        gs_render_prof = profile_of(
            torch, lambda: train.render_burst(gs_fitted), train.FPS_FRAMES,
            ported)
        # the 3DGS serving render (K10, a sort, K8) beside render()
        gs_fast_ms = burst_ms(torch, gs_twins["fit"].render_fast, reps=30)
        gs_generic_ms = burst_ms(torch, gs_fitted.render, reps=30)
        gs_fast_prof = profile_of(
            torch, lambda: [gs_twins["fit"].render_fast()
                            for _ in range(train.FPS_FRAMES)],
            train.FPS_FRAMES, ported)
        gs_generic_prof = profile_of(
            torch, lambda: [gs_fitted.render()
                            for _ in range(train.FPS_FRAMES)],
            train.FPS_FRAMES, ported)
    launch = {
        "rasterize_sum_fwd": lambda: rs.sum_fwd(feat, sp.gids, sp.starts,
                                                Hf, Wf),
        "rasterize_sum_bwd": lambda: rs.sum_bwd(feat, sp.gids, sp.starts, g,
                                                Hf, Wf),
        "rasterize_sum_l2": lambda: rs.sum_l2(feat, sp.gids, sp.starts, gt_f,
                                              Hf, Wf),
        "splat_prep_raw": lambda: prep.raw_prep(*k5_args),
        "splat_prep_decode": lambda: prep.decode_prep(*k4_args),
        "splat_prep_decode_batch": lambda: prep.batch_decode_prep(*k7_main),
        "splat_prep_rs_raw": lambda: prep.rs_raw_prep(*k6b_args),
        "splat_prep_rs_decode": lambda: prep.rs_decode_prep(*k6a_args),
        "rasterize_blend_fwd": lambda: blend.blend_fwd(*k8_args, log_stop=ls8,
                                                       **bkw),
        "rasterize_blend_bwd": lambda: blend.blend_bwd(*k9_args, **bkw),
        "splat_prep_blend3d": lambda: p3.blend3d_prep(*k10_args),
        "stream_blockize": lambda: sc.blockize_stream(featA, spA.gids),
        "stream_unblockize": lambda: sc.unblockize_stream(dg3A)}
    # one trace of 20 launches of each kernel, all kernels twice over (the
    # profiler can miss the first launches of a trace; the time per launch
    # averages the launches it saw); traced again if it missed a kernel
    for _ in range(2):
        us = profile_of(torch, lambda: [fn() for _ in range(2)
                                        for fn in launch.values()
                                        for _ in range(20)], 40,
                        tuple(launch))["ported_us_per_launch"]
        device_ms = {k: None if v is None else v / 1e3 for k, v in us.items()}
        if None not in device_ms.values():
            break
    # and one of the aligned branches alone (their kernels share the flat
    # ones' names, as template instances)
    for _ in range(2):
        us = profile_of(torch, lambda: [fn() for _ in range(2)
                                        for fn in aligned_launch.values()
                                        for _ in range(20)], 40,
                        tuple(aligned_launch))["ported_us_per_launch"]
        aligned_device_ms = {k: None if v is None else v / 1e3
                             for k, v in us.items()}
        if None not in aligned_device_ms.values():
            break
    for _ in range(2):
        us = profile_of(torch, lambda: [fn() for _ in range(2)
                                        for fn in flat_twin_launch.values()
                                        for _ in range(20)], 40,
                        tuple(flat_twin_launch))["ported_us_per_launch"]
        flat_twin_device_ms = {k: None if v is None else v / 1e3
                               for k, v in us.items()}
        if None not in flat_twin_device_ms.values():
            break

    # K1-K3 at tile 16: flat on flower@10k, aligned on flower@40k; time,
    # device time (one trace of each layout's launches alone: the tile-16
    # kernels share the 32-pixel ones' names, as template instances), the
    # plain version's time and the bound from this run's pairs
    def tile16_timing(layout, src, H_, W_):
        if layout == "flat":
            run, ref = ((rs.sum_fwd, rs.sum_bwd, rs.sum_l2),
                        (rs.sum_fwd_plain, rs.sum_bwd_plain,
                         rs.sum_l2_plain))
        else:
            run, ref = ((rs.sum_fwd_aligned, rs.sum_bwd_aligned,
                         rs.sum_l2_aligned),
                        (rs.sum_fwd_aligned_plain, rs.sum_bwd_aligned_plain,
                         rs.sum_l2_aligned_plain))

        def calls(fns):
            return {"rasterize_sum_fwd": lambda: fns[0](*src, H_, W_,
                                                        tile_px=16),
                    "rasterize_sum_bwd": lambda: fns[1](*src, g, H_, W_,
                                                        tile_px=16),
                    "rasterize_sum_l2": lambda: fns[2](*src, gt_f, H_, W_,
                                                       tile_px=16)}

        out = {"ms": {k: burst_ms(torch, fn, reps=20)
                      for k, fn in calls(run).items()},
               "plain_ms": {k: burst_ms(torch, fn, reps=2, warmup=1)
                            for k, fn in calls(ref).items()}}
        launch = calls(run)
        for _ in range(2):
            us = profile_of(torch, lambda: [fn() for _ in range(2)
                                            for fn in launch.values()
                                            for _ in range(20)], 40,
                            tuple(launch))["ported_us_per_launch"]
            out["device_ms"] = {k: None if v is None else v / 1e3
                                for k, v in us.items()}
            if None not in out["device_ms"].values():
                break
        return out

    blocksA16 = sc.blockize_stream(featA16, spA16.gids)
    t16 = {"flat": tile16_timing("flat", (feat16, sp16.gids, sp16.starts),
                                 Hf, Wf),
           "aligned": tile16_timing("aligned", (blocksA16, spA16.starts,
                                                spA16.counts), Hf, Wf)}
    for layout, case, stream_b, live16 in (
            ("flat", tile16["flat_flower_10k"],
             4 * (feat16.numel() + tile16["flat_flower_10k"]["live"]
                  + sp16.starts.numel()),
             tile16["flat_flower_10k"]["live"]),
            ("aligned", tile16["aligned_flower_40k"],
             4 * (blocksA16.numel() + spA16.starts.numel()
                  + spA16.counts.numel()),
             tile16["aligned_flower_40k"]["live"])):
        px16, n_t16 = Hf * Wf, (Hf // 16) * (-(-Wf // 16))
        b16 = {"rasterize_sum_fwd": stream_b + 4 * 4 * px16,
               "rasterize_sum_bwd": stream_b + 4 * 4 * px16 + 4 * 16 * live16,
               "rasterize_sum_l2": stream_b + 4 * 3 * px16 + 4 * n_t16
               + 4 * 16 * live16}
        w16 = {k: (*sum_ops(k, case["work"], tp=16), b)
               for k, b in b16.items()}
        bd16 = {k: bound(*v) for k, v in w16.items()}
        t16[layout].update(
            bound_ms={k: v[0] for k, v in bd16.items()},
            bound_by={k: v[1] for k, v in bd16.items()},
            fp32_instr={k: v[0] for k, v in w16.items()},
            mufu={k: v[1] for k, v in w16.items()},
            bytes={k: v[2] for k, v in w16.items()}, work=case["work"])

    # the fused prep's floor: one trace of 20 x (a launch of the kernel, a
    # zero_() of each of its three outputs: PyTorch's fill writing the same
    # bytes, and one zero_() of a float64 buffer of their total size, whose
    # fill kernel has a name of its own); traced again until the profiler
    # saw every launch. K5, K4, K6b and K6a, K7 at B = 2, and K10 at each
    # sh_degree on the seeded models' rows.
    def prep_floor(launch_fn, kernel_key):
        outs = launch_fn()
        nbytes = sum(o.numel() * o.element_size() for o in outs)
        flat = torch.empty(-(-nbytes // 8), dtype=torch.float64, device=dev)

        def reps():
            for _ in range(20):
                launch_fn()
                for o in (*outs, flat):
                    o.zero_()

        for _ in range(5):
            us = traced_us(torch, reps)
            kind = {"kernel": [], "fills": [], "one_buffer": []}
            for key, v in us.items():
                kind["kernel" if kernel_key in key else "one_buffer"
                     if "double" in key else "fills"].append(v)
            seen = {k: sum(n for _, n in v) for k, v in kind.items()}
            if seen == {"kernel": 20, "fills": 60, "one_buffer": 20}:
                break
        per = {k: sum(u for u, _ in v) / seen[k] / 1e3 if seen[k] else None
               for k, v in kind.items()}
        return {"device_ms": per["kernel"],
                "fills_ms": None if per["fills"] is None
                else per["fills"] * len(outs),
                "fill_launch_ms": per["fills"],
                "one_buffer_fill_ms": per["one_buffer"], "bytes": nbytes,
                "launches_seen": seen}

    floors = {"splat_prep_raw": prep_floor(
                  lambda: prep.raw_prep(*k5_args), "splat_prep_raw_kernel"),
              "splat_prep_decode": prep_floor(
                  lambda: prep.decode_prep(*k4_args),
                  "splat_prep_decode_kernel("),
              "splat_prep_rs_raw": prep_floor(
                  lambda: prep.rs_raw_prep(*k6b_args),
                  "splat_prep_rs_raw_kernel"),
              "splat_prep_rs_decode": prep_floor(
                  lambda: prep.rs_decode_prep(*k6a_args),
                  "splat_prep_rs_decode_kernel"),
              "splat_prep_decode_batch": prep_floor(
                  lambda: prep.batch_decode_prep(*k7_main),
                  "splat_prep_decode_batch_kernel"),
              **{f"splat_prep_blend3d_sh{d}": prep_floor(
                  lambda a=a: p3.blend3d_prep(*a),
                  f"splat_prep_blend3d_kernel<{d}>")
                 for d, a in sorted(k10_deg_args.items())}}

    plane = Hf * Wf
    stream_bytes = 4 * (feat.numel() + n_live + sp.starts.numel())
    # K1-K3 on the gated pairs and a cull per slot and walk (sum_ops); the
    # bytes: the stream and its windows once, the images, K2 / K3's rows
    sum_bytes = {"rasterize_sum_fwd": stream_bytes + 4 * 4 * plane,
                 "rasterize_sum_bwd": stream_bytes + 4 * 4 * plane
                 + 4 * 16 * n_live,
                 "rasterize_sum_l2": stream_bytes + 4 * 3 * plane
                 + 4 * sse3.numel() + 4 * 16 * n_live}
    work = {k: (*sum_ops(k, work10), b) for k, b in sum_bytes.items()}
    # the fused prep: per row its inputs (K5 xyz, chol, colors: 32 B; K4
    # xyz, codes, idx: 28 B, plus the scale, beta and codebook once), a
    # 64 B feature row, M keys and two counts; bytes-bound (no MUFU count:
    # tanhf's two MUFU ops a row are folded into the row's slots)
    rows = SERVE_N + 1
    out_bytes = rows * (4 * sc.FW + 4 * m_s + 8)
    # K6b reads xyz, scaling, rotation and colors (32 B a row), K6a xyz,
    # two scaling codes, a rotation code and two indices (28 B) plus its
    # four quantizer floats and the codebook once
    for k, in_bytes in (("splat_prep_raw", 32 * SERVE_N),
                        ("splat_prep_decode", 28 * SERVE_N + 4 * (6 + 192)),
                        ("splat_prep_rs_raw", 32 * SERVE_N),
                        ("splat_prep_rs_decode",
                         28 * SERVE_N + 4 * (6 + 192))):
        work[k] = (rows * (PREP_ROW_SLOTS[k] + PREP_KEY_SLOTS * m_s), 0,
                   in_bytes + out_bytes)
    # K7 on the china + flower stack (the photos dataset's batch): 2N rows
    # of K4's inputs, two frames' tables, the same outputs per row
    rows7 = 2 * SERVE_N + 1
    work["splat_prep_decode_batch"] = (
        rows7 * (PREP_ROW_SLOTS["splat_prep_decode_batch"]
                 + PREP_KEY_SLOTS * m_s), 0,
        28 * 2 * SERVE_N + 4 * 2 * (6 + 192)
        + rows7 * (4 * sc.FW + 4 * m_s + 8))
    # K8 and K9 on the fit's consumed chunks, as this run's data needs
    # them (blend_ops); bytes: the stream and its windows once, the output
    # planes once, K9's gradient rows
    blend_bytes = 4 * (feat8.numel() + n8 + sp8.starts.numel()
                       + nch8.numel())
    work["rasterize_blend_fwd"] = (
        *blend_ops(gs_cases["fit"], BLEND_NEAR["fwd"]),
        blend_bytes + 4 * 5 * plane)
    work["rasterize_blend_bwd"] = (
        *blend_ops(gs_cases["fit"], BLEND_NEAR["bwd"]),
        blend_bytes + 4 * 5 * plane + 4 * 16 * n8)
    # K10 on the fit's rows at sh_degree 3: xyz, log scales, quaternion,
    # opacity logit and 3K SH coefficients in (4 B each), the same outputs
    # per row as K4-K7
    k10_in = 4 * (3 + 3 + 4 + 1 + 3 * (gs_fitted.cfg.sh_degree + 1) ** 2)
    work["splat_prep_blend3d"] = (
        rows * (PREP_ROW_SLOTS["splat_prep_blend3d"]
                + PREP_KEY_SLOTS * m_g), 0,
        k10_in * SERVE_N + rows * (4 * sc.FW + 4 * m_g + 8))
    # K11a reads the rows once (the gather repeats rows that L2 holds) and
    # a 4-byte id per slot, and writes 64 bytes per slot; K11b reads and
    # writes 64 bytes per slot. Pure copies: bytes-bound.
    work["stream_blockize"] = (0, 0, 4 * featA.numel()
                               + spA.I * (4 + 4 * sc.FW))
    work["stream_unblockize"] = (0, 0, spA.I * 2 * 4 * sc.FW)
    # the aligned branches, counted as the flat ones over the aligned
    # stream's live slots; the stream bytes are its blocks
    a_bytes = 4 * (blocksA.numel() + spA.starts.numel() + spA.counts.numel())
    liveA = int(spA.counts.sum())
    b_bytes = 4 * (blocks30.numel() + sp30.starts.numel()
                   + sp30.counts.numel() + nch30.numel())
    sum_bytesA = {"rasterize_sum_fwd": a_bytes + 4 * 4 * plane,
                  "rasterize_sum_bwd": a_bytes + 4 * 4 * plane
                  + 4 * 16 * liveA,
                  "rasterize_sum_l2": a_bytes + 4 * 3 * plane
                  + 4 * sse3A.numel() + 4 * 16 * liveA}
    aligned_work = {
        **{k: (*sum_ops(k, work40), b) for k, b in sum_bytesA.items()},
        "rasterize_blend_fwd": (
            *blend_ops(case30, BLEND_NEAR["fwd"]),
            b_bytes + 4 * 5 * plane),
        "rasterize_blend_bwd": (
            *blend_ops(case30, BLEND_NEAR["bwd"]),
            b_bytes + 4 * 5 * plane + 4 * 16 * int(sp30.counts.sum()))}
    bounds = {k: bound(*v) for k, v in work.items()}
    aligned_bounds = {k: bound(*v) for k, v in aligned_work.items()}
    # the earlier count of K8 and K9's work (blend_all_pairs), reported
    # beside the bound so that their rows compare with earlier records
    bounds_all_pairs = {}
    for sfx, case, wk in (("", gs_cases["fit"], work),
                          ("_aligned", case30, aligned_work)):
        for d in ("fwd", "bwd"):
            k = f"rasterize_blend_{d}"
            bounds_all_pairs[k + sfx] = bound(
                *blend_all_pairs(case, BLEND_NEAR[d]), wk[k][2])[0]
    # and K1-K3's (sum_all_pairs), every pair of the windows charged q
    sum_bounds_all_pairs = {}
    for sfx, w, wk in (("", work10, work), ("_aligned", work40, aligned_work)):
        for k in sum_bytes:
            sum_bounds_all_pairs[k + sfx] = bound(*sum_all_pairs(k, w),
                                                  wk[k][2])[0]
    k11b_l2["cold_bound_ms"] = bounds["stream_unblockize"][0]
    phase("timing", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
          kernel_ms=ms, kernel_device_ms=device_ms, plain_ms=plain,
          bound_ms={k: b[0] for k, b in bounds.items()},
          bound_by={k: b[1] for k, b in bounds.items()},
          fp32_instr={k: v[0] for k, v in work.items()},
          mufu={k: v[1] for k, v in work.items()},
          bytes={k: v[2] for k, v in work.items()},
          sum_work=work10, instances=n_live,
          sum_bound_ms_all_pairs=sum_bounds_all_pairs,
          k11b_vs_copy=k11b_l2, prep_floor=floors,
          render_ms=render_ms, train_step_ms=step_ms,
          fps_probe={k: r["fps"] for k, r in by_image.items()},
          render_profile=render_prof, train_step_profile=step_prof,
          blend_bound_ms_all_pairs=bounds_all_pairs,
          gs3d_work={k: gs_cases["fit"][k] for k in BLEND_WORK},
          gs3d_train_step_ms=gs_step_ms,
          gs3d_train_step_profile=gs_step_prof,
          aligned_train_step_ms=step50_ms,
          aligned_train_step_profile=step50_prof,
          gs3d_fps_probe_render_profile=gs_render_prof,
          gs3d_render_fast_ms=gs_fast_ms, gs3d_render_ms=gs_generic_ms,
          gs3d_render_fast_profile=gs_fast_prof,
          gs3d_render_profile=gs_generic_prof, library_ms=library,
          library_device_ms=library_device,
          aligned={"kernel_ms": aligned_ms,
                   "kernel_device_ms": aligned_device_ms,
                   "flat_twin_device_ms": flat_twin_device_ms,
                   "plain_ms": aligned_plain_ms,
                   "bound_ms": {k: b[0] for k, b in aligned_bounds.items()},
                   "bound_by": {k: b[1] for k, b in aligned_bounds.items()},
                   "fp32_instr": {k: v[0] for k, v in aligned_work.items()},
                   "bytes": {k: v[2] for k, v in aligned_work.items()},
                   "sum_work": work40,
                   "gs3d_work": {k: case30[k] for k in BLEND_WORK}},
          tile16=t16)

    print(smi, flush=True)
    replaces = {"rasterize_sum_fwd": "gaussianimage_tpu/ops/rasterize_sum.py:205",
                "rasterize_sum_bwd": "gaussianimage_tpu/ops/rasterize_sum.py:280",
                "rasterize_sum_l2": "gaussianimage_tpu/ops/rasterize_sum.py:618",
                "splat_prep_raw": "gaussianimage_tpu/ops/splat_prep.py:249",
                "splat_prep_decode": "gaussianimage_tpu/ops/splat_prep.py:157",
                "splat_prep_decode_batch":
                    "gaussianimage_tpu/ops/splat_prep.py:195",
                "splat_prep_rs_raw": "gaussianimage_tpu/ops/splat_prep.py:471",
                "splat_prep_rs_decode":
                    "gaussianimage_tpu/ops/splat_prep.py:434",
                "rasterize_blend_fwd":
                    "gaussianimage_tpu/ops/rasterize_blend.py:129",
                "rasterize_blend_bwd":
                    "gaussianimage_tpu/ops/rasterize_blend.py:191",
                "splat_prep_blend3d":
                    "gaussianimage_tpu/ops/splat_prep3d.py:89",
                "stream_blockize":
                    "gaussianimage_tpu/ops/stream_common.py:180",
                "stream_unblockize":
                    "gaussianimage_tpu/ops/stream_common.py:205"}
    sources = {"rasterize_sum_fwd": "rasterize_sum_fwd.cu",
               "rasterize_sum_bwd": "rasterize_sum_bwd.cu",
               "rasterize_sum_l2": "rasterize_sum_bwd.cu",
               "splat_prep_raw": "splat_prep.cu",
               "splat_prep_decode": "splat_prep.cu",
               "splat_prep_decode_batch": "splat_prep.cu",
               "splat_prep_rs_raw": "splat_prep.cu",
               "splat_prep_rs_decode": "splat_prep.cu",
               "rasterize_blend_fwd": "rasterize_blend.cu",
               "rasterize_blend_bwd": "rasterize_blend.cu",
               "splat_prep_blend3d": "splat_prep3d.cu",
               "stream_blockize": "stream_blocks.cu",
               "stream_unblockize": "stream_blocks.cu"}
    # each kernel's launches in the run of the path that drives it (K1 and
    # K2: the QAT run, which trains through them; K1's in the evaluation
    # beside it)
    launches = {"rasterize_sum_fwd": qat_counts["rasterize_sum_fwd"],
                "rasterize_sum_bwd": qat_counts["rasterize_sum_bwd"],
                "rasterize_sum_l2": fit_counts["rasterize_sum_l2"],
                "splat_prep_raw": serve_counts["splat_prep_raw"],
                "splat_prep_decode": codec_counts["splat_prep_decode"],
                "splat_prep_decode_batch":
                    batched_counts["splat_prep_decode_batch"],
                "splat_prep_rs_raw": rs_serve_counts["splat_prep_rs_raw"],
                "splat_prep_rs_decode":
                    rs_codec_counts["splat_prep_rs_decode"],
                "rasterize_blend_fwd": gs_fit_counts["rasterize_blend_fwd"],
                "rasterize_blend_bwd": gs_fit_counts["rasterize_blend_bwd"],
                "splat_prep_blend3d": gs_serve_counts["splat_prep_blend3d"],
                "stream_blockize": aligned_eval_counts[40000][
                    "stream_blockize"],
                "stream_unblockize": fit50_counts["stream_unblockize"]}
    # the aligned branches' launches in the runs of the paths that drive
    # them: the 40k evaluation (K1), Fusion2 steps at 40k (K2), the 50k fit
    # (K3), the 3DGS fit at 30k (K8, K9)
    aligned_launches = {
        "rasterize_sum_fwd": aligned_eval_counts[40000][
            "rasterize_sum_fwd_aligned"],
        "rasterize_sum_bwd": fusion_counts["rasterize_sum_bwd_aligned"],
        "rasterize_sum_l2": fit50_counts["rasterize_sum_l2_aligned"],
        "rasterize_blend_fwd": fit30_counts["rasterize_blend_fwd_aligned"],
        "rasterize_blend_bwd": fit30_counts["rasterize_blend_bwd_aligned"]}
    aligned_errs = {
        "rasterize_sum_fwd": k1a_err,
        "rasterize_sum_bwd": float((dg2A - dg2A_p).abs().max()),
        "rasterize_sum_l2": float((dg3A - dg3A_p).abs().max()),
        "rasterize_blend_fwd": case30["k8_max_abs_err"],
        "rasterize_blend_bwd": case30["k9_max_abs_err"]}
    errs = {"rasterize_sum_fwd": k1_err, "rasterize_sum_bwd": k2_err,
            "rasterize_sum_l2": k3_err,
            "splat_prep_raw": k5["max_abs_err"],
            "splat_prep_decode": k4["max_abs_err"],
            "splat_prep_decode_batch": k7_err,
            "splat_prep_rs_raw": k6b["max_abs_err"],
            "splat_prep_rs_decode": k6a["max_abs_err"],
            "rasterize_blend_fwd": max(c["k8_max_abs_err"]
                                       for c in gs_cases.values()),
            "rasterize_blend_bwd": max(c["k9_max_abs_err"]
                                       for c in gs_cases.values()),
            "splat_prep_blend3d": max(c["max_abs_err"]
                                      for c in k10.values()),
            "stream_blockize": k11a_err,
            "stream_unblockize": float(
                (rowsK11b - sc.unblockize_stream_plain(dg3A)).abs().max())}

    # K1-K3 at tile 16: launches on the paths that drive each (flat: the
    # sharded CLI's fit, K1 its final renders, K2 the two-rank gauss axis;
    # aligned: the 40k render, 1 x 1 x 1 steps and the two-rank gauss axis
    # at 40k)
    tile16_launches = {
        "flat": {"rasterize_sum_fwd": sharded_counts["rasterize_sum_fwd"],
                 "rasterize_sum_bwd":
                     two_rank["gauss2"]["launches_rank0"]["rasterize_sum_bwd"],
                 "rasterize_sum_l2": sharded_counts["rasterize_sum_l2"]},
        "aligned": {
            "rasterize_sum_fwd": eval40_counts["rasterize_sum_fwd_aligned"],
            "rasterize_sum_bwd": two_rank["gauss2_40k"]["launches_rank0"][
                "rasterize_sum_bwd_aligned"],
            "rasterize_sum_l2": refs[("init_40k", "fused")][2][
                "rasterize_sum_l2_aligned"]}}
    tile16_case = {"flat": tile16["flat_flower_10k"],
                   "aligned": tile16["aligned_flower_40k"]}
    tile16_err = {"rasterize_sum_fwd": "k1_max_abs_err",
                  "rasterize_sum_bwd": "k2_max_abs_err",
                  "rasterize_sum_l2": "k3_max_abs_err"}

    def tile16_entry(k):
        """K1-K3's numbers at tile 16, flat and aligned."""
        if k not in tile16_err:
            return {}
        return {"tile16": {lay: {
            "launches": tile16_launches[lay][k],
            "max_abs_err": tile16_case[lay][tile16_err[k]],
            "ms": t16[lay]["ms"][k], "device_ms": t16[lay]["device_ms"][k],
            "plain_ms": t16[lay]["plain_ms"][k],
            "bound_ms": t16[lay]["bound_ms"][k],
            "bound_by": t16[lay]["bound_by"][k], "library_ms": None}
            for lay in ("flat", "aligned")}}

    def aligned_entry(k):
        """The aligned branch's numbers of a kernel that has one."""
        if k not in aligned_launches:
            return {}
        return {"aligned": {
            "launches": aligned_launches[k], "max_abs_err": aligned_errs[k],
            "ms": aligned_ms[k], "device_ms": aligned_device_ms[k],
            "plain_ms": aligned_plain_ms[k],
            "bound_ms": aligned_bounds[k][0],
            "bound_by": aligned_bounds[k][1]}}
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
        "library_ms": library[k],
        "library_device_ms": library_device[k],
        **({"launches_evaluation": eval_counts[k]}
           if k == "rasterize_sum_fwd" else {}),
        **({"launches_wmask_fit": wmask_counts[k]}
           if k in ("rasterize_sum_fwd", "rasterize_sum_bwd") else {}),
        **aligned_entry(k),
        **tile16_entry(k),
    } for k in counters]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def two_rank_worker(rank: int, work_dir: str) -> None:
    """One of the two ranks of phase ``sharded``'s gloo run on the one
    card (``chip_smoke.py --two-rank-worker <rank> <dir>``): for each of
    TWO_RANK_MESHES, the state saved in ``<dir>`` onto its shards, then
    TWO_RANK_STEPS sharded steps; rank 0 saves the gathered parameters and
    loss, and each rank its launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussianimage_tpu_torch.models import make_model
    from gaussianimage_tpu_torch.ops import RasterizeConfig
    from gaussianimage_tpu_torch.ops import rasterize_sum as rs
    from gaussianimage_tpu_torch.parallel import (
        init_sharded_fit, make_mesh, make_sharded_train_step)
    from gaussianimage_tpu_torch.parallel.fit import (gather_fit,
                                                      image_metrics, load_fit)
    from gaussianimage_tpu_torch.utils.image_io import image_path_to_array

    counters = {"rasterize_sum_fwd": rs.sum_fwd,
                "rasterize_sum_bwd": rs.sum_bwd,
                "rasterize_sum_l2": rs.sum_l2,
                "rasterize_sum_fwd_aligned": rs.sum_fwd_aligned,
                "rasterize_sum_bwd_aligned": rs.sum_bwd_aligned,
                "rasterize_sum_l2_aligned": rs.sum_l2_aligned}
    work = Path(work_dir)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{work / 'rdv'}",
                            rank=rank, world_size=2)
    image = image_path_to_array(FLOWER_PHOTO)  # [1, 3, H, W]
    counts = {}
    for label, n, mesh_s, _, key, _ in TWO_RANK_MESHES:
        mesh = make_mesh(dict(zip(("data", "gauss", "tile"),
                                  (int(x) for x in mesh_s.split(",")))))
        model = make_model("GaussianImage_Cholesky", device=dev,
                           num_points=n, H=image.shape[2], W=image.shape[3],
                           raster=RasterizeConfig(tile_px=16), block_h=16,
                           block_w=16, init_mode="adaptive")
        state = init_sharded_fit(model, mesh, image, seed=1)
        init = np.load(work / f"{key}.npz")
        load_fit(state, mesh, {k: init[k] for k in init.files})
        for fn in counters.values():
            fn.launches = 0
        loss, _, nd = make_sharded_train_step(
            model, mesh, n_steps=TWO_RANK_STEPS)(state)
        torch.cuda.synchronize()
        counts[label] = {k: fn.launches for k, fn in counters.items()}
        params, _ = gather_fit(state, mesh)
        loss, nd = image_metrics(mesh, loss, nd)
        if rank == 0:
            np.savez(work / f"out_{label}.npz", loss=loss, n_dropped=nd,
                     **{k: v.cpu().numpy() for k, v in params.items()})
    (work / f"counts_{rank}.json").write_text(json.dumps(counts))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--two-rank-worker":
        two_rank_worker(int(sys.argv[2]), sys.argv[3])
    else:
        main()
