"""Residual vector quantization with EMA codebooks (counterpart of
gaussianimage_tpu/codec/vq.py; reference contract quantize.py:89-150, model
config dim=3, codebook_size=8, num_quantizers=2, k-means init with 5
iterations, EMA decay 0.8, commitment weight 1.0).

Per layer: indices = argmin_s ||r - e_s||^2 over the residual r, the
quantized value e[indices], and r <- r - e[indices]; the output is the sum
of the layers' values, with a straight-through gradient. The distance is
computed as |r|^2 - 2 r.e + |e|^2, in the JAX package's order, so that the
indices match its indices; ``torch.argmin`` takes the first minimum, as
``jnp.argmin`` does.

Training (``training=True``) also returns the state after one EMA step:
n_s <- d n_s + (1 - d) count_s, m_s <- d m_s + (1 - d) sum_{i: idx=s} r_i,
e_s = m_s / the Laplace-smoothed n_s. It takes an initialised state: the
JAX package k-means-initialises one whose ``initted`` is false inside the
call, the port's model does so before it (``QuantizeMixin``), so that the
call needs no host read of the flag. The state is passed in and returned; the model holds it as buffers and installs the returned state
after its optimizer step. The sums are float32 matrix products: TF32 must
stay off (PyTorch's default), or near-ties would pick other codes.

The k-means draw takes a ``torch.Generator`` where the JAX package takes a
``jax.random`` key; the two draw different centers, so a comparison passes
both packages the same starting indices (``init_idx``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class ResidualVQState(NamedTuple):
    embed: torch.Tensor         # [Q, S, D] codebooks
    cluster_size: torch.Tensor  # [Q, S] EMA counts
    embed_avg: torch.Tensor     # [Q, S, D] EMA sums
    initted: torch.Tensor       # [] bool


def _draw(n: int, k: int, generator: Optional[torch.Generator], device):
    """k distinct indices of [0, n), uniformly (jax.random.choice without
    replacement)."""
    gen_dev = generator.device if generator is not None else device
    return torch.randperm(n, generator=generator, device=gen_dev)[:k].to(
        device)


def _kmeans(x: torch.Tensor, num_clusters: int, iters: int,
            init_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain k-means on [N, D] from the centers x[init_idx]; returns
    (centers [S, D], counts [S] of the last assignment). A center without
    points keeps its place."""
    centers = x[init_idx.long()]
    counts = None
    for _ in range(iters):
        d = torch.sum((x[:, None, :] - centers[None]) ** 2, dim=-1)  # [N, S]
        one_hot = F.one_hot(torch.argmin(d, dim=1), num_clusters).to(x.dtype)
        counts = one_hot.sum(dim=0)
        sums = one_hot.T @ x
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1),
                              centers)
    return centers, counts


class ResidualVQ:
    def __init__(self, dim: int = 3, codebook_size: int = 8,
                 num_quantizers: int = 2, kmeans_iters: int = 5,
                 decay: float = 0.8, commitment_weight: float = 1.0,
                 eps: float = 1e-5):
        self.dim = dim
        self.codebook_size = codebook_size
        self.num_quantizers = num_quantizers
        self.kmeans_iters = kmeans_iters
        self.decay = decay
        self.commitment_weight = commitment_weight
        self.eps = eps

    def init_state(self, device=None) -> ResidualVQState:
        Q, S, D = self.num_quantizers, self.codebook_size, self.dim
        z = dict(dtype=torch.float32, device=device)
        return ResidualVQState(
            embed=torch.zeros(Q, S, D, **z),
            cluster_size=torch.zeros(Q, S, **z),
            embed_avg=torch.zeros(Q, S, D, **z),
            initted=torch.zeros((), dtype=torch.bool, device=device))

    def _kmeans_init(self, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     init_idx: Optional[Sequence[torch.Tensor]] = None
                     ) -> ResidualVQState:
        """Sequential residual k-means across the layers: layer q clusters
        the residual the layers before it leave. ``init_idx[q]`` gives
        layer q's starting centers; else they are drawn from
        ``generator``."""
        x = x.detach()
        embeds, counts_all = [], []
        resid = x
        for qi in range(self.num_quantizers):
            idx0 = (init_idx[qi] if init_idx is not None else
                    _draw(x.shape[0], self.codebook_size, generator,
                          x.device))
            centers, counts = _kmeans(resid, self.codebook_size,
                                      self.kmeans_iters, idx0.to(x.device))
            embeds.append(centers)
            counts_all.append(counts)
            d = torch.sum((resid[:, None] - centers[None]) ** 2, dim=-1)
            resid = resid - centers[torch.argmin(d, dim=1)]
        embed = torch.stack(embeds)
        cs = torch.stack(counts_all)
        return ResidualVQState(embed=embed, cluster_size=cs,
                               embed_avg=embed * cs[..., None],
                               initted=torch.ones((), dtype=torch.bool,
                                                  device=x.device))

    @staticmethod
    def _layer(embed: torch.Tensor, resid: torch.Tensor):
        d = (torch.sum(resid ** 2, dim=1, keepdim=True)
             - 2.0 * resid @ embed.T
             + torch.sum(embed ** 2, dim=1)[None])
        idx = torch.argmin(d, dim=1)
        return idx, embed[idx]

    def __call__(self, state: ResidualVQState, x: torch.Tensor,
                 training: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            ResidualVQState]:
        """Quantize [N, D] -> (out, indices [N, Q], commit_loss, state),
        with the straight-through estimator: d out / d x = num_quantizers.

        With ``training`` the returned state has taken one EMA step from
        ``state``, which must be initialised (``_kmeans_init``)."""
        resid = x
        out = torch.zeros_like(x)
        indices = []
        commit = torch.zeros((), dtype=torch.float32, device=x.device)
        new_embed, new_cs, new_avg = [], [], []
        for qi in range(self.num_quantizers):
            idx, quant = self._layer(state.embed[qi], resid.detach())
            indices.append(idx)
            commit = commit + self.commitment_weight * torch.mean(
                (quant.detach() - resid) ** 2)
            out = out + resid + (quant - resid).detach()
            if training:
                one_hot = F.one_hot(idx, self.codebook_size).to(x.dtype)
                counts = one_hot.sum(dim=0)
                sums = one_hot.T @ resid.detach()
                cs = (state.cluster_size[qi] * self.decay
                      + counts * (1 - self.decay))
                avg = (state.embed_avg[qi] * self.decay
                       + sums * (1 - self.decay))
                n = cs.sum()
                smoothed = ((cs + self.eps)
                            / (n + self.codebook_size * self.eps) * n)
                new_embed.append(avg / torch.clamp(smoothed[:, None],
                                                   min=1e-12))
                new_cs.append(cs)
                new_avg.append(avg)
            resid = resid - quant.detach()
        if training:
            state = ResidualVQState(
                embed=torch.stack(new_embed), cluster_size=torch.stack(new_cs),
                embed_avg=torch.stack(new_avg),
                initted=torch.ones((), dtype=torch.bool, device=x.device))
        return out, torch.stack(indices, dim=1), commit, state

    def compress(self, state: ResidualVQState, x: torch.Tensor):
        """(dequantized, indices [N, Q]) without a state update."""
        out, idx, _, _ = self(state, x, training=False)
        return out, idx

    def combined_codebook(self, state: ResidualVQState) -> torch.Tensor:
        """[K^Q, D]: every sum of one entry per layer, at the flat index
        idx_0 * K^(Q-1) + ... + idx_(Q-1)."""
        combined = state.embed[0]
        for qi in range(1, self.num_quantizers):
            combined = (combined[:, None, :]
                        + state.embed[qi][None, :, :]).reshape(-1, self.dim)
        return combined

    def decompress(self, state: ResidualVQState, indices: torch.Tensor):
        """Sum of the layers' codebook entries (reference
        quantize.py:146-150). Small codebooks decode through the combined
        product table: one gather per point."""
        K, nq = self.codebook_size, self.num_quantizers
        indices = indices.long()
        if K ** nq <= 4096:
            flat = indices[:, 0]
            for qi in range(1, nq):
                flat = flat * K + indices[:, qi]
            return self.combined_codebook(state)[flat]
        recon = torch.zeros(indices.shape[0], self.dim, dtype=torch.float32,
                            device=indices.device)
        for qi in range(nq):
            recon = recon + state.embed[qi][indices[:, qi]]
        return recon
