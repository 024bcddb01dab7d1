"""Checkpoints (counterpart of gaussianimage_tpu/utils/checkpoint.py).

- ``save_checkpoint`` / ``load_checkpoint``: the JAX package's format
  (:31-46), one flat .npz with ``params/<name>`` and ``extra/<name>`` keys,
  so every checkpoint the JAX package wrote loads unchanged, and a
  checkpoint written here loads there. ``checkpoint_trees`` splits a
  model into those two trees: its parameters, and its carried state
  (persistent buffers): the VQ state as ``extra/vq/<name>`` (a QAT
  checkpoint), any other buffer by its name (wMask's ``extra/mask_ema``).
- ``save_train_state`` / ``load_train_state``: the mid-fit resume snapshot.
  Its format is the port's own, not the JAX package's leaf-indexed npz:
  one ``torch.save`` file with the model's and the optimizer's
  ``state_dict``s, the iteration, host arrays (the metric history) and a
  random generator's state, written atomically (tmp + rename) so a crash
  mid-save keeps the previous snapshot.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

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


def checkpoint_trees(model: torch.nn.Module):
    """(params, extra) of ``model`` in the JAX package's checkpoint schema:
    its parameters by name; its persistent buffers as extra, the VQ
    buffers ``vq.<name>`` as ``{"vq": {<name>: ...}}`` (the JAX package's
    ``extra["vq"]`` ResidualVQState) and any other by its name."""
    params = dict(model.named_parameters())
    extra, vq = {}, {}
    for k, v in model.state_dict().items():
        if k.startswith("vq."):
            vq[k.split(".", 1)[1]] = v
        elif k not in params:
            extra[k] = v
    if vq:
        extra["vq"] = vq
    return params, extra


def load_checkpoint(path) -> Dict[str, Dict[str, np.ndarray]]:
    """{"params": {...}, "extra": {...}} with '/'-joined flat keys re-nested
    one level under params/extra (numpy arrays)."""
    out: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "extra": {}}
    with np.load(str(path), allow_pickle=False) as data:
        for k in data.files:
            top, rest = k.split("/", 1)
            out[top][rest] = data[k]
    return out


def params_from_numpy(params: Dict[str, np.ndarray], device="cpu",
                      extra: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict[str, torch.Tensor]:
    """JAX parameters (numpy arrays, as ``load_checkpoint`` returns them),
    the quantizers' scale and beta among them, -> a state dict on
    ``device`` for ``nn.Module.load_state_dict``. From ``extra`` it takes
    the carried state as buffers: the residual VQ's ``vq/<name>`` as
    ``vq.<name>``, the rest by name (wMask's ``mask_ema``). Arrays become
    float32, except boolean ones (the VQ's init flag)."""
    flat = dict(params)
    flat.update({k.replace("/", "."): v for k, v in (extra or {}).items()})
    # np.array(order="C"): ascontiguousarray would make a 0-d array 1-d
    return {k: torch.as_tensor(np.array(
                v, order="C",
                dtype=bool if np.asarray(v).dtype == bool else np.float32),
                device=device)
            for k, v in flat.items()}


def merge_matching(model: torch.nn.Module, loaded: Dict[str, np.ndarray],
                   extra: Optional[Dict[str, np.ndarray]] = None) -> list:
    """Partial load (the reference's filtered state_dict update): copy the
    entries of ``loaded`` (and the VQ state of ``extra``, as
    ``params_from_numpy`` names it) whose name and shape match the model's
    into it in place. Returns the names copied."""
    own = model.state_dict()
    state = params_from_numpy(loaded, next(iter(own.values())).device, extra)
    hit = {k: v for k, v in state.items()
           if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(hit, strict=False)
    return sorted(hit)


def save_train_state(path, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, iteration: int,
                     aux: Optional[Dict[str, np.ndarray]] = None,
                     generator: Optional[torch.Generator] = None) -> None:
    """Write the resume snapshot of a fit at ``iteration``."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    snap = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "iteration": int(iteration),
            "aux": {k: np.asarray(v) for k, v in (aux or {}).items()},
            "generator": None if generator is None else generator.get_state()}
    tmp = str(path) + ".tmp"
    torch.save(snap, tmp)
    os.replace(tmp, str(path))


def load_train_state(path, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     generator: Optional[torch.Generator] = None):
    """Restore a ``save_train_state`` snapshot into ``model``, ``optimizer``
    (and ``generator``) in place. Returns (iteration, aux dict)."""
    # onto the CPU: a generator's state is a CPU tensor; load_state_dict
    # copies the rest onto the parameters' device
    snap = torch.load(str(path), map_location="cpu", weights_only=False)
    model.load_state_dict(snap["model"])
    optimizer.load_state_dict(snap["optimizer"])
    if generator is not None and snap["generator"] is not None:
        generator.set_state(snap["generator"])
    return snap["iteration"], snap["aux"]
