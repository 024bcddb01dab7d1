"""Sharded training over the (data, gauss, tile) mesh (counterpart of
gaussianimage_tpu/parallel/fit.py). One process a shard; each holds:

- ``data``:  its image, and its own fit of it (params, optimizer);
- ``gauss``: the N/g rows of the Gaussians of its gauss shard, rendered
             over its row slice; the partial images combine with ONE
             all-reduce a render (``sharded_render``), exact up to order
             because accumulated-sum blending is commutative;
- ``tile``:  the H/t rows of the image starting at ``tile_idx * h_loc``,
             rendered and compared with its rows of the target; the
             per-parameter gradients combine with ONE all-reduce a step
             (or, under ``shard_opt``, a reduce-scatter and an all-gather).

When the gauss axis is 1, the loss and its backward run through the fused
render + L2 kernel K3 on the row slice, as the single-card trainer does;
with gauss > 1 the partial images must be summed before the (nonlinear)
clamp and L2, so the step renders through K1 and takes K2's backward.
Loss is L2 only (windowed SSIM would need a halo exchange across the tile
shards; L2 is the canonical GaussianImage loss).

Stream caps come from each shard's own N/g rows, as in JAX's
``shard_map``. The step does not reseed. On a 1 x 1 x 1 mesh it runs no
collective, and a step is the single-card ``model.train_step`` op for op.

Collectives on the hot path are ``all_reduce`` (and ``reduce_scatter`` /
``all_gather`` under ``shard_opt``); the gathers of a checkpoint and of the
per-image metrics are int32 all-reduces of zero-padded buffers, exact bit
for bit and carried by every backend (gloo carries all-reduce on CUDA
tensors, not reduce-scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gaussianimage_tpu_torch.core import clip01
from gaussianimage_tpu_torch.ops import (rasterize_gaussians_sum,
                                         rasterize_gaussians_sum_l2)
from gaussianimage_tpu_torch.opt import Adan
from gaussianimage_tpu_torch.opt.adan import MOMENTS
from gaussianimage_tpu_torch.parallel.mesh import Mesh

# an image's init draws from a generator seeded seed + IMAGE_SEED_STRIDE * d
# (d the image's index in its group): image 0 starts where the single-card
# trainer at the same seed starts
IMAGE_SEED_STRIDE = 7919


def image_seed(seed: int, d: int) -> int:
    """The seed of the init generator of image ``d`` of a group."""
    return seed + IMAGE_SEED_STRIDE * d


@dataclasses.dataclass
class ShardedState:
    """One rank's part of a sharded fit.

    ``model`` holds the N/g rows of its gauss shard (a model of N/g points
    whose config keeps the image's H x W); ``optimizer`` steps the model's
    parameters, or under ``shard_opt`` the ``slices``: this tile shard's
    N/(g t) rows of each parameter, whose moments only it holds. ``gt`` is
    its [3, H/t, W] rows of its image ``image``."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    gt: torch.Tensor
    image: int
    slices: Optional[Dict[str, nn.Parameter]] = None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _ranked(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` all-reduced in place over ``group`` (nothing for None)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
    """[size * x.shape[0], ...]: the ``size`` members' ``x`` stacked along
    dim 0 in the order of their ``index``, bit for bit: an int32 sum of
    zero-padded copies of the bits (so -0.0 and NaN payloads survive)."""
    if group is None:
        return x.clone()
    bits = x.contiguous().view(torch.int32)
    buf = torch.zeros((size,) + tuple(bits.shape), dtype=torch.int32,
                      device=x.device)
    buf[index] = bits
    dist.all_reduce(buf, group=group)
    return buf.view(x.dtype).reshape((size * x.shape[0],) + x.shape[1:])


def _rs_tensor(out, x, group):
    fn = getattr(dist, "reduce_scatter_single", None)
    (fn or dist.reduce_scatter_tensor)(out, x, group=group)


def _ag_tensor(out, x, group):
    fn = getattr(dist, "all_gather_single", None)
    (fn or dist.all_gather_into_tensor)(out, x, group=group)


class _GaussSum(torch.autograd.Function):
    """All-reduce over the gauss axis whose backward is the identity (JAX:
    ``_psum_replicated_cotangent``). The loss is computed the same way on
    every gauss shard from the summed image, so the incoming cotangent is
    already the same on all of them, and its transpose is the identity:
    not a second all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gauss_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    group = mesh.group("gauss")
    return x if group is None else _GaussSum.apply(x, group)


# ---------------------------------------------------------------------------
# the render and the step
# ---------------------------------------------------------------------------


def _row_slice(model, mesh: Mesh):
    """(h_loc, offset): the tile shard's row count and the [2] shift of its
    first row, after checking that H splits into whole raster tiles."""
    cfg = model.cfg
    t = mesh.size("tile")
    if cfg.H % (t * cfg.raster.tile_px):
        raise ValueError(
            f"H must split into whole raster tiles across the tile axis: "
            f"H={cfg.H}, tile axis {t}, tile_px={cfg.raster.tile_px}")
    h_loc = cfg.H // t
    return h_loc, float(mesh.index("tile") * h_loc)


def _shift(xys: torch.Tensor, dy: float, mesh: Mesh) -> torch.Tensor:
    """The centers in the tile shard's row-slice coordinates (untouched
    on a tile axis of 1)."""
    if mesh.size("tile") == 1:
        return xys
    return xys - torch.tensor([0.0, dy], dtype=xys.dtype, device=xys.device)


def sharded_render(model, mesh: Mesh):
    """The render of this shard: the model's N/g rows over its H/t row
    slice, the partial images summed over the gauss axis, clamped (unless
    ``no_clamp``). Returns ([H/t, W, 3], n_dropped)."""
    cfg = model.cfg
    h_loc, dy = _row_slice(model, mesh)
    xys, radii, conics, colors, opac = model.splat()
    img, _, aux = rasterize_gaussians_sum(
        _shift(xys, dy, mesh), conics, colors, opac, h_loc, cfg.W,
        radii=radii, config=cfg.raster)
    img = gauss_sum(img, mesh)
    if not cfg.no_clamp:
        img = clip01(img)
    return img, aux["n_dropped"]


def _uses_fused(model, mesh: Mesh) -> bool:
    return (mesh.size("gauss") == 1 and getattr(model, "fused_l2", False)
            and not model.cfg.quantize and hasattr(model, "splat"))


def make_sharded_train_step(model, mesh: Mesh, n_steps: int = 1,
                            shard_opt: bool = False):
    """The sharded train function ``step(state)``: runs ``n_steps``
    steps on ``state`` (a ``ShardedState``; ``shard_opt`` as it was built
    with) in place and returns (loss, psnr, n_dropped) of
    this rank's image as device scalars: the last step's loss (summed over
    the tile axis, divided by t) and PSNR, and the worst instance-stream
    overflow of the chunk over the tile and gauss axes.

    Per step: the fused K3 pass on the row slice when the gauss axis is 1
    (and the model has ``splat``, does not quantize), else ``sharded_render``
    (K1, the gauss all-reduce) and the L2 through K2; then the gradients
    over the tile axis divided by t: one all-reduce of all of them and the
    optimizer on the replicated rows, or under ``shard_opt`` (ZeRO-1) a
    reduce-scatter of each, Adan on this shard's slice of rows and
    moments, and an all-gather of the updated slices. Under ``shard_opt``
    Adan's ``max_grad_norm`` clip sees the slice's norm, as JAX's update
    on the slice does."""
    cfg = model.cfg
    if cfg.loss_type != "L2":
        raise ValueError("the sharded step trains the L2 loss only, got "
                         f"{cfg.loss_type}")
    t = mesh.size("tile")
    tile_group, gauss_group = mesh.group("tile"), mesh.group("gauss")
    use_fused = _uses_fused(model, mesh)

    def loss_of(state: ShardedState):
        m = state.model
        if use_fused:
            h_loc, dy = _row_slice(m, mesh)
            xys, radii, conics, colors, opac = m.splat()
            mse, raux = rasterize_gaussians_sum_l2(
                _shift(xys, dy, mesh), conics, colors, opac, state.gt,
                h_loc, cfg.W, radii=radii, config=cfg.raster,
                clamp=not cfg.no_clamp)
            return mse, raux["n_dropped"]
        img, nd = sharded_render(m, mesh)
        return torch.mean((img.permute(2, 0, 1) - state.gt) ** 2), nd

    def sync_and_update(state: ShardedState):
        m, opt = state.model, state.optimizer
        params = [p for p in m.parameters() if p.grad is not None]
        if not shard_opt:
            if t > 1:
                flat = torch.cat([p.grad.reshape(-1) for p in params])
                dist.all_reduce(flat, group=tile_group)
                flat /= t
                for p, g in zip(params, flat.split(
                        [p.numel() for p in params])):
                    p.grad.copy_(g.view_as(p))
            opt.step()
            return
        for name, p in m.named_parameters():
            s = state.slices[name]
            if t > 1:
                g = torch.empty_like(s)
                _rs_tensor(g, p.grad.contiguous(), tile_group)
                s.grad = g / t
            else:
                s.grad = p.grad.clone()
        opt.step()
        with torch.no_grad():
            for name, p in m.named_parameters():
                s = state.slices[name]
                if t > 1:
                    _ag_tensor(p.data, s.data, tile_group)
                else:
                    p.data.copy_(s.data)

    def step(state: ShardedState):
        m = state.model
        nd_max = None
        loss = psnr = None
        for _ in range(n_steps):
            state.optimizer.zero_grad(set_to_none=True)
            for p in m.parameters():
                p.grad = None
            loss, nd = loss_of(state)
            loss.backward()
            for name in getattr(m, "zero_grad_params", ()):
                p = getattr(m, name)
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss = loss.detach()
            if t > 1:
                dist.all_reduce(loss, group=tile_group)
                loss = loss / t
            sync_and_update(state)
            psnr = 10.0 * torch.log10(1.0 / torch.clamp(loss, min=1e-12))
            nd = nd.to(torch.int32)
            nd_max = nd if nd_max is None else torch.maximum(nd_max, nd)
        nd_max = nd_max.clone()
        _ranked(nd_max, tile_group, dist.ReduceOp.MAX)
        _ranked(nd_max, gauss_group, dist.ReduceOp.MAX)
        return loss, psnr, nd_max

    return step


# ---------------------------------------------------------------------------
# init, and the state in and out of its shards
# ---------------------------------------------------------------------------


def _rows(mesh: Mesh, n: int):
    """(gauss shard's first row, its row count) of n Gaussians."""
    g = mesh.size("gauss")
    if n % g:
        raise ValueError(f"num_points={n} does not split over a gauss axis "
                         f"of {g}")
    n_loc = n // g
    return mesh.index("gauss") * n_loc, n_loc


def _local_model(model, mesh: Mesh) -> nn.Module:
    """A model of the same class holding the gauss shard's rows of
    ``model``'s state (every entry whose leading size is N); the rest of
    its state as it is."""
    n = model.cfg.num_points
    r0, n_loc = _rows(mesh, n)
    dev = next(model.parameters()).device
    local = type(model)(dataclasses.replace(model.cfg, num_points=n_loc),
                        device=dev)
    state = {k: (v[r0:r0 + n_loc] if v.dim() and v.shape[0] == n else v)
             for k, v in model.state_dict().items()}
    local.load_state_dict(state)
    return local


def _slice_rows(mesh: Mesh, n_loc: int):
    t = mesh.size("tile")
    if n_loc % t:
        raise ValueError("shard_opt needs num_points divisible by gauss*tile "
                         f"axis sizes ({n_loc} rows over a tile axis of {t})")
    ns = n_loc // t
    return mesh.index("tile") * ns, ns


def _optimizer(local: nn.Module, mesh: Mesh, shard_opt: bool):
    """(optimizer, slices): the model's own optimizer, or under
    ``shard_opt`` Adan over this tile shard's slice of each parameter,
    with the model's parameter groups and schedules."""
    if not shard_opt:
        return local.make_optimizer(), None
    if local.cfg.opt_type != "adan":
        raise ValueError("shard_opt shards Adan's moments; the model's "
                         f"opt_type is {local.cfg.opt_type}")
    n_loc = local.cfg.num_points
    s0, ns = _slice_rows(mesh, n_loc)
    slices = {}
    for name, p in local.named_parameters():
        if p.dim() == 0 or p.shape[0] != n_loc:
            raise ValueError(f"shard_opt shards parameters by row; {name} "
                             f"has shape {tuple(p.shape)}")
        slices[name] = nn.Parameter(p.detach()[s0:s0 + ns].clone())
    name_of = {id(p): n for n, p in local.named_parameters()}
    opt = Adan([{"params": [slices[name_of[id(p)]] for p in ps], "lr": fn}
                for ps, fn in local._param_groups()])
    return opt, slices


def init_sharded_fit(model, mesh: Mesh, images, seed: int = 1,
                     shard_opt: bool = False) -> ShardedState:
    """This rank's part of a sharded fit of ``images`` ([D, 3, H, W], D the
    data axis size; numpy or a tensor). Image d = this rank's data index
    initialises ``model`` (the full N-point model, on the rank's device) in
    place with its own generator (``image_seed(seed, d)``): adaptive from
    the image under ``init_mode`` "adaptive", else uniform, as the
    single-card trainer does. The rank keeps its gauss shard's rows, its
    tile shard's rows of the image, and an optimizer whose moments are
    replicated over the tile axis, or under ``shard_opt`` sharded over
    (gauss, tile)."""
    D = int(images.shape[0])
    if D != mesh.size("data"):
        raise ValueError(f"{D} images for a data axis of {mesh.size('data')}")
    dev = next(model.parameters()).device
    d = mesh.index("data")
    gt = torch.as_tensor(np.asarray(images[d]) if not torch.is_tensor(images)
                         else images[d], dtype=torch.float32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(image_seed(seed, d))
    model.init_params(gen, gt_image=gt[None])
    local = _local_model(model, mesh)
    h_loc, dy = _row_slice(local, mesh)
    gt_loc = gt[:, int(dy):int(dy) + h_loc].contiguous()
    opt, slices = _optimizer(local, mesh, shard_opt)
    return ShardedState(local, opt, gt_loc, d, slices)


def _opt_holders(state: ShardedState):
    """name -> the tensor whose optimizer state holds that parameter's
    moments (the parameter, or its slice)."""
    m = state.model
    return dict(m.named_parameters()) if state.slices is None else \
        state.slices


def gather_fit(state: ShardedState, mesh: Mesh):
    """The whole fit, on every rank: (params {name: [D, N, ...]}, optimizer
    {"counts": [per group], moment: {name: [D, N, ...]}}), gathered over
    the tile (moments under ``shard_opt``), gauss and data axes. Every rank
    must call it."""
    def up(x, axes):
        for axis in axes:
            x = _gather(x, mesh.group(axis), mesh.index(axis),
                        mesh.size(axis))
        return x

    with torch.no_grad():
        params = {k: up(up(p.detach(), ("gauss",))[None], ("data",))
                  for k, p in state.model.named_parameters()}
        axes = ("tile", "gauss") if state.slices is not None else ("gauss",)
        opt = {"counts": [g["count"] for g in state.optimizer.param_groups]}
        holders = _opt_holders(state)
        for mom in MOMENTS:
            opt[mom] = {k: up(up(state.optimizer.state[h][mom], axes)[None],
                              ("data",)) for k, h in holders.items()}
    return params, opt


def load_fit(state: ShardedState, mesh: Mesh, params: Dict,
             opt: Optional[Dict] = None) -> None:
    """Carry a whole fit onto this rank's shards: ``params`` {name: [D, N,
    ...]} and, if given, the optimizer's ``opt`` {"counts": [per group] (or
    "count": one for all), moment: {name: [D, N, ...]}} (numpy or
    tensors; JAX's ScaleByAdanState fields by name), each rank taking its
    image's rows of its gauss shard (and of its tile slice for the
    moments under ``shard_opt``)."""
    m = state.model
    d = state.image
    n_loc = m.cfg.num_points
    r0 = mesh.index("gauss") * n_loc
    dev = next(m.parameters()).device

    def rows(x, lo, n):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return x[d, lo:lo + n].to(dev, torch.float32)

    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(rows(params[k], r0, n_loc))
        if state.slices is not None:
            s0, ns = _slice_rows(mesh, n_loc)
            for k, s in state.slices.items():
                s.copy_(rows(params[k], r0 + s0, ns))
        if opt is None:
            return
        counts = opt.get("counts")
        if counts is None:
            counts = [int(np.asarray(opt["count"]))] * len(
                state.optimizer.param_groups)
        for group, c in zip(state.optimizer.param_groups, counts):
            group["count"] = int(c)
        lo, n = r0, n_loc
        if state.slices is not None:
            s0, ns = _slice_rows(mesh, n_loc)
            lo, n = r0 + s0, ns
        for k, h in _opt_holders(state).items():
            for mom in MOMENTS:
                state.optimizer.state[h][mom].copy_(rows(opt[mom][k], lo, n))


def image_metrics(mesh: Mesh, *values: torch.Tensor) -> Sequence[np.ndarray]:
    """Each per-image device scalar of this rank, as a [D] host array over
    the data axis (every rank must call it)."""
    out = []
    for v in values:
        v = v.detach().reshape(1)
        out.append(_gather(v, mesh.group("data"), mesh.index("data"),
                           mesh.size("data")).cpu().numpy())
    return out
