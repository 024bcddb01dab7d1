"""rANS entropy coder (counterpart of gaussianimage_tpu/codec/rans.py): stack
ANS over a categorical model, 16-bit quantized frequencies, 16-bit
renormalisation words, the native replacement for the reference's
constriction wheel (reference usage at quantize.py:152-180).

The coder is ``csrc/rans.cpp``, built on first use with ``g++ -O2 -shared
-fPIC`` into ``gaussianimage_tpu_torch/_build/`` under a name keyed by a
hash of the source and the flags, and loaded with ``ctypes``. A failed build
raises. The NumPy coder beside it is its plain version: the tests check
that the two write the same words and decode each other's streams, and
the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SCALE_BITS = 16
_M = 1 << _SCALE_BITS
SOURCE = Path(__file__).resolve().parent / "csrc" / "rans.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librans-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The native coder, built first if needed; raises if it cannot be."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the rANS coder "
                               f"{SOURCE.name} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        p = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                               f"{p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u16, u32, i32 = (ctypes.POINTER(ctypes.c_uint16),
                     ctypes.POINTER(ctypes.c_uint32),
                     ctypes.POINTER(ctypes.c_int32))
    lib.rans_encode.argtypes = [i32, ctypes.c_int, u32, u32, ctypes.c_int,
                                u16, ctypes.c_int]
    lib.rans_encode.restype = ctypes.c_int
    lib.rans_decode.argtypes = [u16, ctypes.c_int, u32, u32, ctypes.c_int,
                                i32, ctypes.c_int]
    lib.rans_decode.restype = ctypes.c_int
    _LIB = lib
    return lib


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Quantize symbol counts to frequencies summing to exactly 2^16, every
    occurring symbol >= 1. Deterministic (shared by encoder and decoder)."""
    counts = np.asarray(counts, np.float64)
    assert counts.ndim == 1 and (counts > 0).all(), "drop zero-count symbols first"
    probs = counts / counts.sum()
    freqs = np.maximum(1, np.round(probs * _M)).astype(np.int64)
    # repair the sum by walking the largest entries
    diff = int(_M - freqs.sum())
    order = np.argsort(-freqs)
    i = 0
    while diff != 0:
        j = order[i % len(order)]
        step = 1 if diff > 0 else -1
        if freqs[j] + step >= 1:
            freqs[j] += step
            diff -= step
        i += 1
    return freqs.astype(np.uint32)


def _tables(freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    freqs = np.ascontiguousarray(freqs, np.uint32)
    cum = np.zeros_like(freqs)
    cum[1:] = np.cumsum(freqs)[:-1].astype(np.uint32)
    return freqs, cum


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def encode_plain(symbols, freqs, cum) -> np.ndarray:
    """Plain version of ``rans_encode``: symbols already reversed."""
    out = []
    x = 1 << 16
    for s in symbols:
        f = int(freqs[s])
        c = int(cum[s])
        while x >= (f << 16):
            out.append(x & 0xFFFF)
            x >>= 16
        x = ((x // f) << 16) + (x % f) + c
    out.append(x & 0xFFFF)
    out.append(x >> 16)
    return np.asarray(out, np.uint16)


def decode_plain(words, freqs, cum, n) -> np.ndarray:
    """Plain version of ``rans_decode``."""
    lookup = np.zeros(_M, np.int32)
    for s, (c, f) in enumerate(zip(cum, freqs)):
        lookup[int(c):int(c) + int(f)] = s
    pos = len(words)
    x = int(words[pos - 1]) << 16 | int(words[pos - 2])
    pos -= 2
    out = np.empty(n, np.int32)
    for i in range(n):
        slot = x & 0xFFFF
        s = int(lookup[slot])
        out[i] = s
        x = int(freqs[s]) * (x >> 16) + slot - int(cum[s])
        while x < (1 << 16):
            pos -= 1
            x = (x << 16) | int(words[pos])
    return out


def encode(symbols: np.ndarray, freqs: np.ndarray,
           native: bool = True) -> np.ndarray:
    """Encode int32 symbol indices with the given quantized frequency table.
    Symbols are encoded in reverse (stack semantics) so ``decode`` returns
    them in forward order. Returns uint16 words. ``native=False`` runs the
    NumPy version."""
    symbols = np.ascontiguousarray(symbols, np.int32)[::-1].copy()
    freqs, cum = _tables(freqs)
    n = len(symbols)
    if n == 0:
        return np.zeros(0, np.uint16)
    if not native:
        return encode_plain(symbols, freqs, cum)
    cap = 2 * n + 64
    out = np.empty(cap, np.uint16)
    written = load().rans_encode(
        _ptr(symbols, ctypes.c_int32), n, _ptr(freqs, ctypes.c_uint32),
        _ptr(cum, ctypes.c_uint32), len(freqs), _ptr(out, ctypes.c_uint16),
        cap)
    if written <= 0:
        raise RuntimeError(f"rans_encode failed with code {written}")
    return out[:written].copy()


def decode(words: np.ndarray, freqs: np.ndarray, n: int,
           native: bool = True) -> np.ndarray:
    """Decode n symbols (forward order). ``native=False`` runs the NumPy
    version."""
    if n == 0:
        return np.zeros(0, np.int32)
    words = np.ascontiguousarray(words, np.uint16)
    freqs, cum = _tables(freqs)
    if not native:
        return decode_plain(words, freqs, cum, n)
    out = np.empty(n, np.int32)
    rc = load().rans_decode(
        _ptr(words, ctypes.c_uint16), len(words),
        _ptr(freqs, ctypes.c_uint32), _ptr(cum, ctypes.c_uint32), len(freqs),
        _ptr(out, ctypes.c_int32), n)
    if rc != 0:
        raise RuntimeError(f"rans_decode failed with code {rc}: malformed "
                           "stream")
    return out
