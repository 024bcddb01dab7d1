"""Build and load the port's CUDA kernels: plain ``nvcc`` into a shared
library with a C interface, loaded with ``ctypes``.

No source includes PyTorch's headers and nothing goes through
``torch.utils.cpp_extension``: a file with a plain C interface compiles in
seconds, where one that includes ``torch/extension.h`` takes minutes.

Each library is built on first use into ``gaussianimage_tpu_torch/_build/``
under a name keyed by a hash of its source and the compiler flags, so an
unchanged source is not rebuilt. ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them all. A failed build raises with
the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

# library name -> (source under csrc/, {C function: (argtypes, restype)})
KERNELS = {
    "rasterize_sum_fwd": (
        "rasterize_sum_fwd.cu",
        # feat, n_rows, gids, starts, out, H, W, tiles_x, tiles_y, tile_px,
        # q_cut, stream
        {"rasterize_sum_fwd": ([_p, _i, _p, _p, _p] + [_i] * 5 + [_f, _p],
                               _i),
         # aligned: blocks, starts, counts, out, H, W, tiles_x, tiles_y,
         # tile_px, q_cut, stream
         "rasterize_sum_fwd_aligned": ([_p] * 4 + [_i] * 5 + [_f, _p], _i)},
    ),
    "rasterize_sum_bwd": (
        "rasterize_sum_bwd.cu",
        {
            # K2: feat, n_rows, gids, starts, g, dgfeat, H, W, tiles_x,
            # tiles_y, tile_px, q_cut, stream
            "rasterize_sum_bwd": ([_p, _i, _p, _p, _p, _p] + [_i] * 5
                                  + [_f, _p], _i),
            # K3: feat, n_rows, gids, starts, gt, sse, dgfeat, H, W,
            # tiles_x, tiles_y, tile_px, q_cut, gscale, clamp, stream
            "rasterize_sum_l2": ([_p, _i, _p, _p, _p, _p, _p] + [_i] * 5
                                 + [_f, _f, _i, _p], _i),
            # aligned K2: blocks, starts, counts, g, dgb, H, W, tiles_x,
            # tiles_y, tile_px, q_cut, stream
            "rasterize_sum_bwd_aligned": ([_p] * 5 + [_i] * 5 + [_f, _p],
                                          _i),
            # aligned K3: blocks, starts, counts, gt, sse, dgb, H, W,
            # tiles_x, tiles_y, tile_px, q_cut, gscale, clamp, stream
            "rasterize_sum_l2_aligned": ([_p] * 6 + [_i] * 5
                                         + [_f, _f, _i, _p], _i),
        },
    ),
    "rasterize_blend": (
        "rasterize_blend.cu",
        {
            # K8: feat, n_rows, gids, starts, out, nch_used, H, W, tiles_x,
            # tiles_y, tile_px, alpha_clip, alpha_min, log_stop, stream
            "rasterize_blend_fwd": ([_p, _i, _p, _p, _p, _p] + [_i] * 5
                                    + [_f] * 3 + [_p], _i),
            # K9: feat, n_rows, gids, starts, logt, nch_used, g, dgfeat, H,
            # W, tiles_x, tiles_y, tile_px, alpha_clip, alpha_min, stream
            "rasterize_blend_bwd": ([_p, _i, _p, _p, _p, _p, _p, _p]
                                    + [_i] * 5 + [_f] * 2 + [_p], _i),
            # aligned K8: blocks, starts, counts, out, nch_used, then as K8
            # from H on
            "rasterize_blend_fwd_aligned": ([_p] * 5 + [_i] * 5 + [_f] * 3
                                            + [_p], _i),
            # aligned K9: blocks, starts, counts, logt, nch_used, g, dgb,
            # then as K9 from H on
            "rasterize_blend_bwd_aligned": ([_p] * 7 + [_i] * 5 + [_f] * 2
                                            + [_p], _i),
        },
    ),
    "stream_blocks": (
        "stream_blocks.cu",
        {
            # K11a: feat, n_rows, gids, blocks, n_blocks, stream
            "stream_blockize": ([_p, _i, _p, _p, _i, _p], _i),
            # K11b: blocks, rows, n_blocks, stream
            "stream_unblockize": ([_p, _p, _i, _p], _i),
        },
    ),
    "splat_prep": (
        "splat_prep.cu",
        {
            # K5: xyz, chol, colors, N, H, W, tile_px, tiles_x, tiles_y, M,
            # id_bits, q_cut, b0, b1, b2, feat, keys, stats, stream
            "splat_prep_raw": ([_p, _p, _p] + [_i] * 8 + [_f] * 4
                               + [_p, _p, _p, _p], _i),
            # K4: xyz, codes, idx, scale, beta, embed, then as K5 from N on
            "splat_prep_decode": ([_p] * 6 + [_i] * 8 + [_f] * 4
                                  + [_p, _p, _p, _p], _i),
            # K7: as K4, with n_per after N
            "splat_prep_decode_batch": ([_p] * 6 + [_i] * 9 + [_f] * 4
                                        + [_p, _p, _p, _p], _i),
            # K6b: xyz, scaling, rotation, colors, then as K5 from N on
            # with two bound floats (b0, b1)
            "splat_prep_rs_raw": ([_p] * 4 + [_i] * 8 + [_f] * 3
                                  + [_p, _p, _p, _p], _i),
            # K6a: xyz, scodes, rcodes, idx, s_scale, s_beta, r_scale,
            # r_beta, embed, then as K6b from N on
            "splat_prep_rs_decode": ([_p] * 9 + [_i] * 8 + [_f] * 3
                                     + [_p, _p, _p, _p], _i),
        },
    ),
    "splat_prep3d": (
        "splat_prep3d.cu",
        # K10: xyz, scaling, quat, opac, coeffs, N, H, W, tile_px, tiles_x,
        # tiles_y, M, id_bits, sh_degree, the 20 camera floats, feat, keys,
        # stats, stream
        {"splat_prep_blend3d": ([_p] * 5 + [_i] * 9 + [_f] * 20
                                + [_p, _p, _p, _p], _i)},
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, "
            "/usr/local/cuda/bin and PATH): the CUDA kernels of "
            "gaussianimage_tpu_torch cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers under
    ``csrc/`` and the compiler flags."""
    h = hashlib.sha256((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, Path]:
    """Build every named library that is not built yet, one ``nvcc`` each,
    all started together. Returns name -> library path. The compiler's
    output (with ptxas' register and shared-memory report) is kept beside
    each library as ``<library>.log``."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNELS[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {KERNELS[n][0]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        Path(str(paths[n]) + ".log").write_text(log)
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes and
    restype declared for each of its C functions."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
