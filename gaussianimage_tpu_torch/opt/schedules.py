"""Learning-rate schedules (counterpart of gaussianimage_tpu/opt/
schedules.py:9-16). ``step_lr`` is torch's StepLR as the reference models
use it (StepLR(step_size=20000, gamma=0.5)), written as a function of the
optimizer's update count."""

from __future__ import annotations


def step_lr(init_value: float, step_size: int = 20000, gamma: float = 0.5):
    """Piecewise-constant decay: lr(t) = init * gamma ** floor(t / step_size)."""

    def schedule(count: int) -> float:
        return init_value * gamma ** (count // step_size)

    return schedule
