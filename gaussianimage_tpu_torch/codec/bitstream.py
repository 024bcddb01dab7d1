"""Categorical bitstream helpers (counterpart of
gaussianimage_tpu/codec/bitstream.py): the reference's
compress/decompress_matrix_flatten_categorical (quantize.py:152-180) on the
port's rANS coder, plus dtype minimization and size accounting
(quantize.py:183-200, with the reference's uint8 boundary off-by-one fixed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gaussianimage_tpu_torch.codec import rans


def minimal_int_dtype(min_v: int, max_v: int):
    if min_v >= 0:
        if max_v <= 255:
            return np.uint8
        if max_v <= 65535:
            return np.uint16
        return np.uint32
    if -128 <= min_v and max_v < 128:
        return np.int8
    if -32768 <= min_v and max_v < 32768:
        return np.int16
    return np.int32


def compress_categorical(values: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Entropy-code an integer array with its empirical categorical model.

    Returns (words uint16, counts int64, unique) — unique in the smallest
    integer dtype. decompress_categorical(words, counts, unique, n, shape)
    inverts it exactly.
    """
    flat = np.asarray(values).reshape(-1)
    unique, inverse, counts = np.unique(flat, return_inverse=True,
                                        return_counts=True)
    unique = unique.astype(minimal_int_dtype(int(unique.min()),
                                             int(unique.max())))
    # store the histogram in the smallest dtype: it is bitstream side info
    # (the reference ships np.unique's int64 counts — 8 bytes per symbol)
    counts = counts.astype(minimal_int_dtype(0, int(counts.max())))
    if len(unique) == 1:
        return np.zeros(0, np.uint16), counts, unique
    freqs = rans.quantize_freqs(counts)
    words = rans.encode(inverse.astype(np.int32), freqs)
    return words, counts, unique


def decompress_categorical(words: np.ndarray, counts: np.ndarray,
                           unique: np.ndarray, n: int, shape) -> np.ndarray:
    if len(unique) == 1:
        return np.full(shape, unique[0])
    freqs = rans.quantize_freqs(counts)
    idx = rans.decode(words, freqs, n)
    return unique[idx].reshape(shape)


def np_bits(x: np.ndarray) -> int:
    """Size of an array's raw buffer in bits."""
    x = np.asarray(x)
    return int(x.size * x.itemsize * 8)
