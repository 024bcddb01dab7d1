"""The 8 loss types of the reference (counterpart of gaussianimage_tpu/
utils/losses.py:16-43). Models default to L2 with lambda 0.7; the 3DGS
baseline uses Fusion2 = 0.7 L1 + 0.3 (1 - SSIM)."""

from __future__ import annotations

import torch

from gaussianimage_tpu_torch.utils.metrics import ms_ssim, ssim


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "L2",
            lambda_value: float = 0.7) -> torch.Tensor:
    """pred / target: NCHW float images in [0, 1]; target is detached."""
    target = target.detach().float()
    pred = pred.float()
    lam = lambda_value

    if loss_type == "L2":
        return torch.mean((pred - target) ** 2)
    if loss_type == "L1":
        return torch.mean(torch.abs(pred - target))
    if loss_type == "SSIM":
        return 1.0 - ssim(pred, target, data_range=1.0)
    if loss_type == "Fusion1":
        return lam * torch.mean((pred - target) ** 2) + (1 - lam) * (
            1.0 - ssim(pred, target, data_range=1.0))
    if loss_type == "Fusion2":
        return lam * torch.mean(torch.abs(pred - target)) + (1 - lam) * (
            1.0 - ssim(pred, target, data_range=1.0))
    if loss_type == "Fusion3":
        return lam * torch.mean((pred - target) ** 2) + (1 - lam) * torch.mean(
            torch.abs(pred - target))
    if loss_type == "Fusion4":
        return lam * torch.mean(torch.abs(pred - target)) + (1 - lam) * (
            1.0 - ms_ssim(pred, target, data_range=1.0))
    if loss_type == "Fusion_hinerv":
        return lam * torch.mean(torch.abs(pred - target)) + (1 - lam) * (
            1.0 - ms_ssim(pred, target, data_range=1.0, win_size=5))
    raise ValueError(f"unknown loss_type: {loss_type}")
