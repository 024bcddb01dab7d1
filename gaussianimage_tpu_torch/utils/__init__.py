from gaussianimage_tpu_torch.utils.logwriter import LogWriter
from gaussianimage_tpu_torch.utils.metrics import ms_ssim, psnr, ssim

__all__ = ["psnr", "ssim", "ms_ssim", "LogWriter"]
