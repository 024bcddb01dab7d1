"""PSNR, SSIM and MS-SSIM on NCHW tensors (counterpart of gaussianimage_tpu/
utils/metrics.py:17-115, the pytorch-msssim semantics the reference
evaluates with): separable 11-tap Gaussian window with sigma 1.5,
valid-mode convolution, K = (0.01, 0.03); MS-SSIM uses the standard five
level weights with 2x average-pool downsampling.

The convolutions run in full float32: cuDNN would otherwise use TF32, which
keeps about three decimal digits, too coarse for SSIM-grade evaluation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _full_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(win_size: int, sigma: float, device) -> torch.Tensor:
    coords = (torch.arange(win_size, dtype=torch.float32, device=device)
              - (win_size - 1) / 2.0)
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid-mode Gaussian filter on NCHW."""
    _full_f32()
    c = x.shape[1]
    k = win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)


def _ssim_per_channel(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _blur(x * x, win) - mu_xx
    sigma_yy = _blur(y * y, win) - mu_yy
    sigma_xy = _blur(x * y, win) - mu_xy
    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))  # [B, C]


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5,
         size_average: bool = True) -> torch.Tensor:
    x, y = pred.float(), target.float()
    win = _gaussian_window(win_size, win_sigma, x.device)
    s, _ = _ssim_per_channel(x, y, win, data_range)
    return s.mean() if size_average else s.mean(dim=1)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5,
            size_average: bool = True, weights=_MSSSIM_WEIGHTS
            ) -> torch.Tensor:
    x, y = pred.float(), target.float()
    win = _gaussian_window(win_size, win_sigma, x.device)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    levels = weights.shape[0]
    mcs = []
    s = None
    for i in range(levels):
        s, cs = _ssim_per_channel(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            pad = (0, x.shape[3] % 2, 0, x.shape[2] % 2)
            x = F.avg_pool2d(F.pad(x, pad), 2)
            y = F.avg_pool2d(F.pad(y, pad), 2)
    stack = torch.stack(mcs + [torch.relu(s)], dim=0)  # [levels, B, C]
    val = torch.prod(stack ** weights[:, None, None], dim=0)  # [B, C]
    return val.mean() if size_average else val.mean(dim=1)
