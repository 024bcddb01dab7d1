"""Shared glue for the instance-stream rasterizer (counterpart of
gaussianimage_tpu/ops/stream_common.py): stream capacity, packed feature
rows, the stream gather, the binning products and the scatter of
per-instance gradient rows back onto the Gaussians.

Only the flat stream layout is ported. The JAX package switches to a
BK-aligned block layout above ``flat_stream_limit`` instances because of
the TPU's VMEM lane padding; that layout goes through the relayout kernels
K11 (``blockize_stream`` / ``unblockize_stream``), which are not ported
yet, so ``prepare_stream`` raises there instead of switching silently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianimage_tpu_torch.ops import tiles as _tiles

FW = 16  # packed per-gaussian feature width (9 used + 7 pad)


def auto_max_instances(n: int, cfg) -> int:
    """Instance-stream capacity: explicit cfg.max_instances, or 4N headroom
    tapering to 2N + 40k above 20k Gaussians (fitted scenes occupy ~2.5
    tiles per Gaussian at 10k points, fewer at larger N). Rounded up to the
    chunk size."""
    if cfg.max_instances is not None:
        cap = cfg.max_instances
    else:
        cap = max(16384, min(4 * n, 2 * n + 40000))
    cap = min(cap, n * cfg.max_tiles_per_gauss)
    return -(-cap // cfg.block_inst) * cfg.block_inst


def stream_caps(n: int, cfg):
    """(I0, m_span, aligned): the instance-stream capacity, the per-Gaussian
    tile-span cap, and whether the JAX package would use its aligned
    layout."""
    I0 = auto_max_instances(n, cfg)
    if cfg.max_instances is not None:
        m_span = cfg.max_tiles_per_gauss
    else:
        m_span = min(cfg.max_tiles_per_gauss, max(8, -(-3 * I0 // max(n, 1))))
    return I0, m_span, I0 > cfg.flat_stream_limit


def pack_feat(xys, conics, colors, opac, premultiply: bool = False
              ) -> torch.Tensor:
    """[N+1, 16] float32 rows (xy, conic a b c, rgb, opacity, pad); the zero
    row at index N absorbs dead-slot reads. ``premultiply`` stores
    opacity-premultiplied colors, so rows 5..8 are the sum kernel's
    (o*r, o*g, o*b, o) color matrix."""
    N = xys.shape[0]
    op = opac.reshape(N, 1).float()
    cols = colors.float()
    if premultiply:
        cols = cols * op
    feat = torch.zeros(N + 1, FW, dtype=torch.float32, device=xys.device)
    feat[:N, 0:2] = xys.float()
    feat[:N, 2:5] = conics.float()
    feat[:N, 5:8] = cols
    feat[:N, 8:9] = op
    return feat


def gather_stream(gids, feat) -> torch.Tensor:
    """[I, 16] feature rows in stream order; dead slots read the zero row.
    The JAX package pads BK more sentinel rows for the TPU's chunked reads;
    nothing here reads past I. The kernels gather the rows themselves; the
    plain versions use this."""
    return feat[gids.long()]


def scatter_stream_grads(dgfeat: torch.Tensor, gids: torch.Tensor,
                         n_rows: int, m_span: int) -> torch.Tensor:
    """Per-instance gradient rows dgfeat [>= I, 16] -> the cotangent of the
    packed rows feat [n_rows, 16]: each Gaussian's rows summed, row N (the
    dead-slot sink) zero.

    Deterministic on every device, with no float atomics: a stable sort of
    ``gids`` groups each Gaussian's slots in stream order, they are laid
    into an [N, m_span] table of slot indices (a Gaussian has at most
    ``m_span`` instances; empty cells point at a zero row), and the gathered
    rows are summed over the table's second axis, a reduction whose order is
    fixed by the table.
    """
    N = n_rows - 1
    I = gids.shape[0]
    dev = gids.device
    gs, order = torch.sort(gids.long(), stable=True)
    first = torch.searchsorted(gs, torch.arange(N, device=dev))
    pos = torch.arange(I, device=dev) - first[gs.clamp(max=N - 1)]
    ok = (gs < N) & (pos < m_span)
    # cells of dead slots all land on one extra cell, which is cut off
    cell = torch.where(ok, gs * m_span + pos, N * m_span)
    table = torch.full((N * m_span + 1,), I, dtype=torch.long, device=dev)
    table[cell] = order
    rows = torch.cat([dgfeat[:I], dgfeat.new_zeros(1, FW)])
    dfeat = rows[table[:N * m_span]].view(N, m_span, FW).sum(dim=1)
    return torch.cat([dfeat, dgfeat.new_zeros(1, FW)])


class StreamPrep(NamedTuple):
    """Binning products + static stream geometry."""
    gids: torch.Tensor      # [I] int32
    starts: torch.Tensor    # [T + 1] int32
    counts: torch.Tensor    # [T] int32
    n_dropped: torch.Tensor  # [] int32
    tiles_x: int
    T: int                  # tiles, padded to a multiple of tiles_per_step
    I: int
    m_span: int             # most instances of one Gaussian


def prepare_stream(xys, radii, H: int, W: int, cfg, band=None,
                   force_pair: bool = False) -> StreamPrep:
    """Flat-stream binning of float32 ``xys`` and ``radii`` (an [N] tensor or
    an (rx, ry) pair), detached by the caller."""
    N = xys.shape[0]
    tp = cfg.tile_px
    TB = cfg.tiles_per_step
    tiles_x = -(-W // tp)
    tiles_y = -(-H // tp)
    T_real = tiles_x * tiles_y
    T = T_real + ((-T_real) % TB)
    I0, m_span, aligned = stream_caps(N, cfg)
    if aligned:
        raise NotImplementedError(
            f"K11: a stream of {I0} instances exceeds flat_stream_limit="
            f"{cfg.flat_stream_limit}; the aligned block layout "
            "(stream_common.blockize_stream) is not ported yet")
    st = _tiles.bin_gaussian_instances(
        xys, radii, tiles_x, tiles_y, tp, I0, T,
        max_tiles_per_gauss=m_span, band=band, force_pair=force_pair)
    counts = st.starts[1:] - st.starts[:-1]
    return StreamPrep(gids=st.gids, starts=st.starts, counts=counts,
                      n_dropped=st.n_dropped, tiles_x=tiles_x, T=T, I=I0,
                      m_span=m_span)
