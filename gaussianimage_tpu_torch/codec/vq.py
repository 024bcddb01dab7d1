"""Residual vector quantization, the inference half (counterpart of
gaussianimage_tpu/codec/vq.py; reference contract quantize.py:89-150, model
config dim=3, codebook_size=8, num_quantizers=2).

Per layer: indices = argmin_s ||r - e_s||^2 over the residual r, the
quantized value e[indices], and r <- r - e[indices]; the output is the sum
of the layers' values. The distance is computed as |r|^2 - 2 r.e + |e|^2,
in the JAX package's order, so that the indices match its indices.

The state (codebooks, EMA cluster sizes and sums, the init flag) is passed
in; the model holds it as buffers. The EMA and k-means training branch is
not ported yet (ROADMAP.md, the QAT slice): ``training=True`` raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

QAT_NOT_PORTED = (
    "the residual VQ's training branch (k-means init and EMA codebook "
    "updates) is not ported yet: it comes with the QAT slice (ROADMAP.md)")


class ResidualVQState(NamedTuple):
    embed: torch.Tensor         # [Q, S, D] codebooks
    cluster_size: torch.Tensor  # [Q, S] EMA counts
    embed_avg: torch.Tensor     # [Q, S, D] EMA sums
    initted: torch.Tensor       # [] bool


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

    @staticmethod
    def _layer(embed: torch.Tensor, resid: torch.Tensor):
        d = (torch.sum(resid ** 2, dim=1, keepdim=True)
             - 2.0 * resid @ embed.T
             + torch.sum(embed ** 2, dim=1)[None])
        idx = torch.argmin(d, dim=1)
        return idx, embed[idx]

    def __call__(self, state: ResidualVQState, x: torch.Tensor,
                 training: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            ResidualVQState]:
        """Quantize [N, D] -> (out, indices [N, Q], commit_loss, state),
        with the straight-through estimator: d out / d x = num_quantizers."""
        if training:
            raise NotImplementedError(QAT_NOT_PORTED)
        resid = x
        out = torch.zeros_like(x)
        indices = []
        commit = torch.zeros((), dtype=torch.float32, device=x.device)
        for qi in range(self.num_quantizers):
            idx, quant = self._layer(state.embed[qi], resid.detach())
            indices.append(idx)
            commit = commit + self.commitment_weight * torch.mean(
                (quant.detach() - resid) ** 2)
            out = out + resid + (quant - resid).detach()
            resid = resid - quant.detach()
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
