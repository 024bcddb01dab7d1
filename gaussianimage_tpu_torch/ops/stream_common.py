"""Shared glue for the instance-stream rasterizers (counterpart of
gaussianimage_tpu/ops/stream_common.py): stream capacity, packed feature
rows, the stream gather, the binning products and the scatter of
per-instance gradient rows back onto the Gaussians.

Two stream layouts, chosen as the JAX package chooses them
(``stream_caps``): up to ``flat_stream_limit`` instances the flat stream,
whose windows the kernels walk through ``gids``; above it the aligned
stream (ops/tiles.py ``bin_instances_aligned``), whose windows start on
whole chunks of BK = 64 slots. The kernels read the aligned stream as
[NB, 16, BK] transposed feature blocks, which K11a ``blockize_stream``
writes from the rows and ids (the JAX package's ``gather_stream_blocks``,
with the gather fused into the relayout); their backward writes whole
gradient blocks, which K11b ``unblockize_stream`` turns back into rows for
the scatter (``scatter_block_grads``). Both kernels are in
``csrc/stream_blocks.cu``; each wrapper takes its plain version for CPU
tensors only, and a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianimage_tpu_torch.ops import _build
from gaussianimage_tpu_torch.ops import tiles as _tiles

FW = 16  # packed per-gaussian feature width (9 used + 7 pad)
BK = 64  # slots per block of the aligned stream (the kernels' chunk)


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


# ---------------------------------------------------------------------------
# the aligned stream's blocks: K11a, K11b and their plain versions
# ---------------------------------------------------------------------------


def blocks_of_rows(rows: torch.Tensor) -> torch.Tensor:
    """[NB * BK, 16] rows by slot -> [NB, 16, BK] blocks, slot s down lane
    s % BK of block s / BK."""
    return rows.reshape(-1, BK, FW).transpose(1, 2).contiguous()


def blockize_stream_plain(feat: torch.Tensor, gids: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of K11a -> blocks [NB, 16, BK] float32 with
    blocks[b, f, k] = feat[gids[b * BK + k], f]; ids outside [0, N] read
    the sentinel row N. ``gids`` [NB * BK] int32."""
    n_rows = feat.shape[0]
    g = gids.long()
    g = torch.where((g < 0) | (g >= n_rows), torch.full_like(g, n_rows - 1),
                    g)
    return blocks_of_rows(feat[g])


def unblockize_stream_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11b -> rows [NB * BK, 16] float32 with
    rows[b * BK + k, f] = blocks[b, f, k]."""
    return blocks.transpose(1, 2).reshape(-1, FW).contiguous()


def _check_blocks(kernel: str, blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.float32 or not blocks.is_contiguous():
        raise TypeError(f"{kernel}: blocks must be contiguous float32")
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (FW, BK) \
            or blocks.shape[0] < 1:
        raise ValueError(f"{kernel}: blocks must be [NB, {FW}, {BK}] with "
                         f"NB >= 1, got {tuple(blocks.shape)}")


def _cuda_only(kernel: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {dev}")
    for x in tensors[1:]:
        if x.device != dev:
            raise ValueError(f"{kernel}: tensors on {x.device} and {dev}")


def _raise_on(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def blockize_stream(feat: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """K11a -> the aligned stream's feature blocks [NB, 16, BK] from the
    packed rows ``feat`` [N+1, 16] and the stream ``gids`` [NB * BK].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``blockize_stream.launches`` counts the kernel's launches.
    """
    if feat.device.type == "cpu":
        return blockize_stream_plain(feat, gids)
    _cuda_only("K11a", feat, gids)
    if feat.dtype != torch.float32 or feat.dim() != 2 \
            or feat.shape[1] != FW or not feat.is_contiguous():
        raise TypeError(f"K11a: feat must be contiguous float32 [N+1, {FW}]")
    if gids.dtype != torch.int32 or gids.dim() != 1 \
            or not gids.is_contiguous():
        raise TypeError("K11a: gids must be contiguous 1-D int32")
    if feat.data_ptr() % 16:
        raise ValueError("K11a: feat's rows must be 16-byte aligned")
    if gids.shape[0] == 0 or gids.shape[0] % BK:
        raise ValueError(f"K11a: the stream's {gids.shape[0]} slots are not "
                         f"a positive multiple of {BK}")
    NB = gids.shape[0] // BK
    blocks = torch.empty(NB, FW, BK, dtype=torch.float32, device=feat.device)
    _raise_on("K11a stream_blockize", _build.load("stream_blocks")
              .stream_blockize(feat.data_ptr(), feat.shape[0],
                               gids.data_ptr(), blocks.data_ptr(), NB,
                               _stream_ptr(feat)))
    blockize_stream.launches += 1
    return blocks


def unblockize_stream(blocks: torch.Tensor) -> torch.Tensor:
    """K11b -> rows [NB * BK, 16] from gradient blocks [NB, 16, BK], the
    inverse relayout of K11a.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``unblockize_stream.launches`` counts the kernel's launches.
    """
    if blocks.device.type == "cpu":
        return unblockize_stream_plain(blocks)
    _cuda_only("K11b", blocks)
    _check_blocks("K11b", blocks)
    if blocks.data_ptr() % 16:
        raise ValueError("K11b: blocks must be 16-byte aligned")
    NB = blocks.shape[0]
    rows = torch.empty(NB * BK, FW, dtype=torch.float32, device=blocks.device)
    _raise_on("K11b stream_unblockize", _build.load("stream_blocks")
              .stream_unblockize(blocks.data_ptr(), rows.data_ptr(), NB,
                                 _stream_ptr(blocks)))
    unblockize_stream.launches += 1
    return rows


blockize_stream.launches = 0
unblockize_stream.launches = 0


def scatter_block_grads(dgb: torch.Tensor, gids: torch.Tensor, n_rows: int,
                        m_span: int) -> torch.Tensor:
    """Gradient blocks [NB, 16, BK] of the aligned stream -> the cotangent
    of feat [n_rows, 16]: K11b, then ``scatter_stream_grads``, which sums
    each Gaussian's slots in stream order."""
    return scatter_stream_grads(unblockize_stream(dgb), gids, n_rows, m_span)


class StreamPrep(NamedTuple):
    """Binning products + static stream geometry. A tile's live slots are
    [starts[t], starts[t] + counts[t]); on the flat stream that is
    [starts[t], starts[t+1]), on the aligned one starts[t] is a multiple of
    BK and the window is padded to whole blocks."""
    gids: torch.Tensor      # [I] int32
    starts: torch.Tensor    # [T + 1] int32
    counts: torch.Tensor    # [T] int32 real counts
    n_dropped: torch.Tensor  # [] int32
    tiles_x: int
    T: int                  # tiles, padded to a multiple of tiles_per_step
    I: int
    m_span: int             # most instances of one Gaussian
    aligned: bool           # the aligned stream's layout


def prepare_stream(xys, radii, H: int, W: int, cfg, band=None,
                   force_pair: bool = False) -> StreamPrep:
    """Binning of float32 ``xys`` and ``radii`` (an [N] tensor or an
    (rx, ry) pair), detached by the caller: the flat stream up to
    ``cfg.flat_stream_limit`` instances, the aligned one above it, with a
    capacity of I0 + T_real * BK for the per-tile padding."""
    N = xys.shape[0]
    tp = cfg.tile_px
    TB = cfg.tiles_per_step
    tiles_x = -(-W // tp)
    tiles_y = -(-H // tp)
    T_real = tiles_x * tiles_y
    T = T_real + ((-T_real) % TB)
    I0, m_span, aligned = stream_caps(N, cfg)
    if aligned:
        if cfg.block_inst != BK:
            raise NotImplementedError(
                f"the aligned stream is built for block_inst={BK}, got "
                f"{cfg.block_inst}")
        I = I0 + T_real * BK
        st = _tiles.bin_instances_aligned(
            xys, radii, tiles_x, tiles_y, tp, I, T, BK,
            max_tiles_per_gauss=m_span, band=band, force_pair=force_pair)
        return StreamPrep(gids=st.gids, starts=st.starts, counts=st.counts,
                          n_dropped=st.n_dropped, tiles_x=tiles_x, T=T, I=I,
                          m_span=m_span, aligned=True)
    st = _tiles.bin_gaussian_instances(
        xys, radii, tiles_x, tiles_y, tp, I0, T,
        max_tiles_per_gauss=m_span, band=band, force_pair=force_pair)
    counts = st.starts[1:] - st.starts[:-1]
    return StreamPrep(gids=st.gids, starts=st.starts, counts=counts,
                      n_dropped=st.n_dropped, tiles_x=tiles_x, T=T, I=I0,
                      m_span=m_span, aligned=False)
