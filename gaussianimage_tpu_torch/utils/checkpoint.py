"""Checkpoints in the JAX package's format (gaussianimage_tpu/utils/
checkpoint.py:31-46): one flat .npz with ``params/<name>`` and
``extra/<name>`` keys, so every checkpoint the JAX package wrote loads
unchanged, and a checkpoint written here loads there."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif v is None:
            continue
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def save_checkpoint(path, params: Dict, extra: Dict | None = None) -> None:
    """params / extra: name -> tensor or array."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    np.savez(str(path), **_flatten({"params": params, "extra": extra or {}}))


def load_checkpoint(path) -> Dict[str, Dict[str, np.ndarray]]:
    """{"params": {...}, "extra": {...}} with '/'-joined flat keys re-nested
    one level under params/extra (numpy arrays)."""
    out: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "extra": {}}
    with np.load(str(path), allow_pickle=False) as data:
        for k in data.files:
            top, rest = k.split("/", 1)
            out[top][rest] = data[k]
    return out


def params_from_numpy(params: Dict[str, np.ndarray], device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """JAX parameters (numpy arrays, as ``load_checkpoint`` returns them) ->
    a float32 state dict on ``device`` for ``nn.Module.load_state_dict``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                               device=device)
            for k, v in params.items()}
