from gaussianimage_tpu_torch.opt.adan import Adan
from gaussianimage_tpu_torch.opt.schedules import step_lr

__all__ = ["Adan", "step_lr"]
