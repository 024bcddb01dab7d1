"""Quantization-aware training and the codec for the 2D models (counterpart
of gaussianimage_tpu/models/quantize_mixin.py; reference
gaussianimage_cholesky.py:126-283):

- the quantizers: float16 means (a straight-through round trip), a learned
  6-bit uniform quantizer on the covariance parameters (its scale and beta
  are parameters of the model), residual VQ (8 codes x 2 layers) on the
  colors (its state is buffers of the model, ``vq.<name>``);
- QAT: the warm start from a fitted checkpoint (``init_quantizer_data``),
  the quantized forward (``render_quantize``), its loss (the render's loss
  plus the VQ's commitment loss) and the VQ's EMA state, computed in the
  forward and installed after the optimizer step (``update_extra``);
- compress / decompress with and without rANS entropy coding;
- the bit accounting and the bpp breakdown of ``analysis_wo_ec`` /
  ``analysis`` (keys bpp, position_bpp, cholesky_bpp, feature_dc_bpp).

The decode takes the model's own quantizer and VQ state, or a frame's
(``params`` / ``vq``), as batched.py's per-frame decodes do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from gaussianimage_tpu_torch.codec import (ResidualVQ, ResidualVQState,
                                           UniformQuantizer,
                                           UniformQuantizerState,
                                           fake_quantize_half)
from gaussianimage_tpu_torch.codec.bitstream import (compress_categorical,
                                                     decompress_categorical,
                                                     np_bits)
from gaussianimage_tpu_torch.core import clip01
from gaussianimage_tpu_torch.ops import rasterize_gaussians_sum
from gaussianimage_tpu_torch.utils.losses import loss_fn

VQ_SPEC = dict(dim=3, codebook_size=8, num_quantizers=2, kmeans_iters=5,
               decay=0.8, commitment_weight=1.0)
KMEANS_SEED = 0  # the k-means draw of init_quantizer_data (JAX: PRNGKey(0))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _VQBuffers(nn.Module):
    """The VQ state as the buffers ``embed``, ``cluster_size``,
    ``embed_avg`` and ``initted``. ``known_initted`` caches a true
    ``initted`` on the host, so that the training forward reads the device
    flag once rather than every step; loading a state clears it."""

    def __init__(self, state: ResidualVQState):
        super().__init__()
        for k, v in state._asdict().items():
            self.register_buffer(k, v)
        self.known_initted = False

    def _load_from_state_dict(self, *args, **kwargs):
        self.known_initted = False
        super()._load_from_state_dict(*args, **kwargs)


class QuantizeMixin:
    """Requires: ``self.cfg``, ``self._xyz``, ``get_features()`` and the
    hooks ``_uq_channels()``, ``_uq_raw_values()`` and
    ``_quantized_splat(params, means, geo, colors)``, where ``params`` is
    a frame's parameters by name, or None for the model's own."""

    @property
    def features_vq(self) -> ResidualVQ:
        return ResidualVQ(**VQ_SPEC)

    def _uq(self, name: str) -> UniformQuantizer:
        return UniformQuantizer(bits=6, num_channels=self._uq_channels()[name])

    def _uq_state(self, name: str, params=None) -> UniformQuantizerState:
        """The model's quantizer state, or the one in ``params`` (a dict
        with ``<name>_quant_{scale,beta}``)."""
        keys = (f"{name}_quant_scale", f"{name}_quant_beta")
        if params is None:
            return UniformQuantizerState(*(getattr(self, k) for k in keys))
        return UniformQuantizerState(*(params[k] for k in keys))

    def vq_state(self) -> ResidualVQState:
        return ResidualVQState(self.vq.embed, self.vq.cluster_size,
                               self.vq.embed_avg, self.vq.initted)

    def quantize_param_init(self, device) -> None:
        """Register the quantizers' scale and beta (1/qmax, the JAX init) as
        parameters ``<name>_quant_{scale,beta}`` and the VQ state as the
        buffers ``vq.{embed,cluster_size,embed_avg,initted}``, the names of
        the JAX checkpoint's ``params/`` and ``extra/vq/`` keys."""
        for name, ch in self._uq_channels().items():
            st = UniformQuantizer(bits=6, num_channels=ch).init_state(device)
            setattr(self, f"{name}_quant_scale", nn.Parameter(st.scale))
            setattr(self, f"{name}_quant_beta", nn.Parameter(st.beta))
        self.vq = _VQBuffers(self.features_vq.init_state(device))

    # ---- QAT ---------------------------------------------------------------
    @torch.no_grad()
    def init_quantizer_data(self, init_idx=None) -> None:
        """The two-stage warm start, in place (reference model._init_data,
        train_quantize.py:59): each uniform quantizer's range from the
        loaded weights (per channel min and max), and the VQ codebooks
        k-means-initialised from the loaded colors. The k-means draw comes
        from a generator seeded ``KMEANS_SEED``; ``init_idx`` (one index
        tensor per layer) gives the starting centers instead."""
        for name, raw in self._uq_raw_values().items():
            st = self._uq(name).init_from_data(raw.detach())
            getattr(self, f"{name}_quant_scale").copy_(st.scale)
            getattr(self, f"{name}_quant_beta").copy_(st.beta)
        self._init_vq(init_idx)

    @torch.no_grad()
    def _init_vq(self, init_idx=None) -> None:
        """Install the residual k-means codebooks of the current colors."""
        gen = torch.Generator(device=self._xyz.device).manual_seed(
            KMEANS_SEED)
        self._install_vq(self.features_vq._kmeans_init(
            self.get_features(), gen, init_idx))

    def _install_vq(self, state: ResidualVQState) -> None:
        """Copy an initialised VQ state into the buffers."""
        for k, v in state._asdict().items():
            getattr(self.vq, k).copy_(v.detach())
        self.vq.known_initted = True

    def quantized_splat_inputs(self, training: bool = True):
        """(means, geometry dict, colors, vq_loss, new VQ state) of the
        quantized forward: float16 means through tanh, the covariance
        through its uniform quantizer, the colors through the residual VQ
        (with ``training`` its EMA step, the state not yet installed). A
        training forward on a VQ state that is not initialised installs
        the k-means codebooks of the colors first; the JAX package does
        that inside the VQ call, on the state it returns."""
        geo = {name: self._uq(name)(self._uq_state(name), raw)
               for name, raw in self._uq_raw_values().items()}
        means = torch.tanh(fake_quantize_half(self._xyz))
        if training:
            if not self.vq.known_initted:
                self.vq.known_initted = bool(self.vq.initted)
            if not self.vq.known_initted:
                self._init_vq()
        colors, _, vq_loss, vq_state = self.features_vq(
            self.vq_state(), self.get_features(), training=training)
        return means, geo, colors, vq_loss, vq_state

    def _rasterize_quantized(self, params, means, geo, colors):
        """The QAT forward's and the generic decode's render of the model's
        own parameters (``params`` None) or a frame's: the generic
        differentiable rasterizer (K1 forward, K2 backward)."""
        cfg = self.cfg
        xys, radii, conics, colors, opac = self._quantized_splat(
            params, means, geo, colors)
        return rasterize_gaussians_sum(xys, conics, colors, opac, cfg.H,
                                       cfg.W, radii=radii, config=cfg.raster)

    def render_quantize(self, training: bool = True) -> Dict:
        """The quantized render [1, 3, H, W], clipped to [0, 1], with the
        alpha map, the VQ loss and new state, the rasterizer's aux and the
        train-time bit terms (reference :127-131: only the means' 32 bits a
        Gaussian). ``training=False`` is the evaluation render."""
        means, geo, colors, vq_loss, vq_state = self.quantized_splat_inputs(
            training=training)
        img, alpha, aux = self._rasterize_quantized(None, means, geo, colors)
        img = clip01(img)
        N = self._xyz.shape[0]
        return {"render": img.permute(2, 0, 1)[None],
                "alpha_map": alpha[None, None], "vq_loss": vq_loss,
                "vq_state": vq_state, "raster_aux": aux,
                "unit_bit": [16 * N * 2, 0, 0, 0]}

    def loss(self, gt_image, *, iteration=0, generator=None):
        """The plain model's loss without ``quantize``; with it the QAT
        loss (train_iter_quantize, gaussianimage_cholesky.py:141-152): the
        quantized render's loss plus the VQ's commitment loss."""
        if not self.cfg.quantize:
            return super().loss(gt_image, iteration=iteration,
                                generator=generator)
        pkg = self.render_quantize(training=True)
        img = pkg["render"]
        loss = loss_fn(img, gt_image, self.cfg.loss_type,
                       self.cfg.lambda_value) + pkg["vq_loss"]
        mse = torch.mean((img.float() - gt_image.float()) ** 2)
        return loss, {"mse": mse, "render": img, "pkg": pkg}

    @torch.no_grad()
    def update_extra(self, aux: Dict, iteration: int = 0) -> None:
        """After the optimizer step: install the VQ state the step's
        forward computed from the parameters before the update."""
        if self.cfg.quantize and "vq_state" in aux.get("pkg", {}):
            self._install_vq(aux["pkg"]["vq_state"])

    # ---- the codec -----------------------------------------------------------
    @torch.no_grad()
    def compress_wo_ec(self) -> Dict[str, np.ndarray]:
        """The code arrays, without a bitstream (reference :154-159): float16
        means, int32 quantizer codes, int32 VQ indices."""
        out = {"xyz": _np(self._xyz).astype(np.float16)}
        for name, raw in self._uq_raw_values().items():
            codes, _ = self._uq(name).compress(self._uq_state(name), raw)
            out[f"quant_{name}"] = _np(codes).astype(np.int32)
        _, idx = self.features_vq.compress(self.vq_state(),
                                           self.get_features())
        out["feature_dc_index"] = _np(idx).astype(np.int32)
        return out

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self._xyz.device)

    @torch.no_grad()
    def dequantize_wo_ec(self, enc: Dict, params=None, vq=None):
        """Code arrays (numpy, or tensors on the model's device) ->
        (means, geo dict, colors): the generic decode's front half, with
        the model's quantizer and VQ state or a frame's (``params``,
        ``vq``)."""
        means = torch.tanh(self._on_device(enc["xyz"]).float())
        geo = {name: self._uq(name).decompress(
                   self._uq_state(name, params),
                   self._on_device(enc[f"quant_{name}"]).float())
               for name in self._uq_channels()}
        colors = self.features_vq.decompress(
            self.vq_state() if vq is None else vq,
            self._on_device(enc["feature_dc_index"]))
        return means, geo, colors

    @torch.no_grad()
    def decompress_wo_ec(self, enc: Dict, params=None, vq=None) -> Dict:
        """The generic decode: dequantize, project, rasterize, clamp.
        Returns {"render": [1, 3, H, W], "raster_aux": ...}."""
        means, geo, colors = self.dequantize_wo_ec(enc, params, vq)
        img, _, aux = self._rasterize_quantized(params, means, geo, colors)
        img = clip01(img)
        return {"render": img.permute(2, 0, 1)[None], "raster_aux": aux}

    def compress(self) -> Dict:
        """The code arrays and their rANS bitstreams (reference :210-219)."""
        enc = self.compress_wo_ec()
        for name in self._uq_channels():
            enc[f"{name}_bitstream"] = compress_categorical(
                enc[f"quant_{name}"])
        enc["feature_dc_bitstream"] = compress_categorical(
            enc["feature_dc_index"])
        return enc

    def entropy_decode(self, enc: Dict) -> Dict:
        """The host half of the entropy-coded decode: the bitstreams back
        to code arrays (numpy). ``decompress_wo_ec`` is the device half."""
        N = enc["xyz"].shape[0]
        dec = {"xyz": enc["xyz"]}
        for name, ch in self._uq_channels().items():
            words, counts, uniq = enc[f"{name}_bitstream"]
            dec[f"quant_{name}"] = decompress_categorical(
                words, counts, uniq, N * ch, (N, ch))
        nq = self.features_vq.num_quantizers
        words, counts, uniq = enc["feature_dc_bitstream"]
        dec["feature_dc_index"] = decompress_categorical(
            words, counts, uniq, N * nq, (N, nq))
        return dec

    def decompress(self, enc: Dict) -> Dict:
        return self.decompress_wo_ec(self.entropy_decode(enc))

    # ---- bit accounting ------------------------------------------------------
    def _codebook_bits(self) -> int:
        return np_bits(_np(self.vq.embed))

    def _uq_side_bits(self, name: str) -> int:
        st = self._uq_state(name)
        return np_bits(_np(st.scale)) + np_bits(_np(st.beta))

    @torch.no_grad()
    def measure_unit_bits(self) -> Tuple[int, int, int, int]:
        """Eval-time [m_bit, s_bit, r_bit, c_bit] with a real rANS probe
        (reference UniformQuantizer.size / VectorQuantizer.size)."""
        N = self._xyz.shape[0]
        m_bit = 16 * N * 2
        s_bit = r_bit = 0
        for name, raw in self._uq_raw_values().items():
            codes, _ = self._uq(name).compress(self._uq_state(name), raw)
            words, counts, uniq = compress_categorical(
                _np(codes).astype(np.int32))
            bits = (np_bits(words) + np_bits(counts) + np_bits(uniq)
                    + self._uq_side_bits(name))
            if name == "rotation":
                r_bit += bits
            else:
                s_bit += bits
        _, idx = self.features_vq.compress(self.vq_state(),
                                           self.get_features())
        words, counts, uniq = compress_categorical(_np(idx).astype(np.int32))
        c_bit = (self._codebook_bits() + np_bits(words) + np_bits(counts)
                 + np_bits(uniq))
        return m_bit, s_bit, r_bit, c_bit

    def _bpp(self, position_bits, per_name, feature_bits) -> Dict[str, float]:
        H, W = self.cfg.H, self.cfg.W
        total = position_bits + sum(per_name.values()) + feature_bits
        out = {"bpp": total / H / W,
               "position_bpp": position_bits / H / W,
               "cholesky_bpp": sum(per_name.values()) / H / W,
               "feature_dc_bpp": feature_bits / H / W}
        # per-component covariance keys (the RS reference reports
        # scaling_bpp / rotation_bpp, gaussianimage_rs.py:186-192)
        for name, bits in per_name.items():
            out.setdefault(f"{name}_bpp", bits / H / W)
        return out

    def analysis_wo_ec(self, enc: Dict) -> Dict[str, float]:
        """bpp with the codes at a fixed 6 bits and the VQ index at
        ceil(log2(max)) bits (reference :174-208). Where every index is 0
        the reference gives 0 bits; this floors at 1 bit, as the JAX
        package does."""
        N = self._xyz.shape[0]
        per_name = {name: self._uq_side_bits(name)
                    + np.asarray(enc[f"quant_{name}"]).size * 6
                    for name in self._uq_channels()}
        idx = np.asarray(enc["feature_dc_index"])
        max_bit = max(int(np.ceil(np.log2(max(idx.max(), 1) + 1e-9))), 1)
        feature_bits = self._codebook_bits() + idx.size * max_bit
        return self._bpp(N * 2 * 16, per_name, feature_bits)

    def analysis(self, enc: Dict) -> Dict[str, float]:
        """bpp with the real entropy-coded stream sizes (reference
        :242-283)."""
        N = self._xyz.shape[0]
        per_name = {}
        for name in self._uq_channels():
            words, counts, uniq = compress_categorical(
                np.asarray(enc[f"quant_{name}"], np.int32))
            per_name[name] = (self._uq_side_bits(name) + np_bits(words)
                              + np_bits(counts) + np_bits(uniq))
        words, counts, uniq = compress_categorical(
            np.asarray(enc["feature_dc_index"], np.int32))
        feature_bits = (self._codebook_bits() + np_bits(words)
                        + np_bits(counts) + np_bits(uniq))
        return self._bpp(N * 2 * 16, per_name, feature_bits)
