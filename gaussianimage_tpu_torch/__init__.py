"""PyTorch + CUDA port of ``gaussianimage_tpu`` for NVIDIA Hopper (sm_90a).

Module names mirror the JAX package so each counterpart is easy to find.
The port imports ``torch`` only: nothing of JAX and nothing of
``gaussianimage_tpu``. Hand-written kernels live under ``ops/csrc`` and are
built by ``ops/_build.py`` with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch

# torch computes exp, log, sin, cos, tanh and sqrt of float CPU tensors with
# MKL's vector math, which sets itself up on first use without a lock. When
# that first use is a call torch splits across threads (above 2048
# elements), one thread can compute its chunk on a wrong path: cos off by
# up to 2534 ulps on half of 4096 angles, in a few percent of fresh
# processes. One call on one element runs on the calling thread alone and
# sets it up before the port makes any split call on the CPU.
torch.exp(torch.zeros(1))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    but unavailable. The CPU is used only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gaussianimage_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


__all__ = ["resolve_device"]
