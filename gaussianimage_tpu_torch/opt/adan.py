"""Adan, Adaptive Nesterov Momentum (arXiv 2208.06677), as a
``torch.optim.Optimizer`` (counterpart of gaussianimage_tpu/opt/adan.py:
45-130, itself the reference's single-tensor update rule).

Update rule, step t >= 1 (g_0 := g_1, so diff_1 = 0):

    diff_t = g_t - g_{t-1}
    m_t = b1 m_{t-1} + (1-b1) g_t
    d_t = b2 d_{t-1} + (1-b2) diff_t
    n_t = b3 n_{t-1} + (1-b3) (g_t + b2 diff_t)^2
    denom = sqrt(n_t) / sqrt(1-b3^t) + eps
    p <- (p - lr/(1-b1^t) m_t/denom - lr b2/(1-b2^t) d_t/denom) / (1 + lr wd)

(``no_prox`` decays first instead: p (1 - lr wd) - ...). The learning rate
is a number or a schedule of the update count, read at the count before
this update; each parameter group may carry its own (JAX:
``optax.multi_transform``, one optimizer and one count per label). An
optional gradient-norm clip scales every gradient of a group by
min(max_grad_norm / (|g| + eps), 1), |g| the norm of that group's
gradients, as each label's optimizer clips its own under
``multi_transform``. A parameter whose gradient is a tensor of zeros
steps (its moments decay); one whose gradient is None does not.

Per-parameter state is created with the optimizer, so it can be reached
by name before the first step: ``state[p]["exp_avg"]`` (m),
``"exp_avg_sq"`` (n), ``"exp_avg_diff"`` (d) and ``"prev_grad"``; reseeding
zeroes rows of them in place. Each group counts its updates in
``group["count"]``. The update runs as multi-tensor (``_foreach``) ops, so
it launches a few kernels for all parameters at once.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple, Union

import torch

MOMENTS = ("exp_avg", "exp_avg_sq", "exp_avg_diff", "prev_grad")


class Adan(torch.optim.Optimizer):

    def __init__(self, params: Iterable, lr: Union[float, Callable] = 1e-3,
                 betas: Tuple[float, float, float] = (0.98, 0.92, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0, no_prox: bool = False):
        # lr_fns[i]: group i's schedule, or None for a number; a schedule
        # stays off the param groups so that state_dict() pickles
        self.lr_fns = []
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay, no_prox=no_prox, count=0)
        super().__init__(params, defaults)
        self.max_grad_norm = max_grad_norm

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        fn = group["lr"] if callable(group["lr"]) else None
        group["lr"] = None if fn is not None else float(group["lr"])
        self.lr_fns.append(fn)
        for p in group["params"]:
            self.state[p] = {k: torch.zeros_like(p, memory_format=torch.
                                                 preserve_format)
                             for k in MOMENTS}

    def _clip_scale(self, grads, eps):
        if self.max_grad_norm <= 0.0:
            return None
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        return torch.clamp(self.max_grad_norm / (gnorm + eps), max=1.0)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group, lr_fn in zip(self.param_groups, self.lr_fns):
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            count = group["count"]
            t = count + 1
            lr = lr_fn(count) if lr_fn is not None else group["lr"]
            b1, b2, b3 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            grads = [p.grad for p in ps]
            clip = self._clip_scale(grads, eps)
            if clip is not None:
                grads = torch._foreach_mul(grads, clip)
            st = [self.state[p] for p in ps]
            m, n, d, prev = ([s[k] for s in st] for k in MOMENTS)
            if count == 0:
                torch._foreach_copy_(prev, grads)
            diff = torch._foreach_sub(grads, prev)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(d, b2)
            torch._foreach_add_(d, diff, alpha=1 - b2)
            u = torch._foreach_add(grads, diff, alpha=b2)
            torch._foreach_mul_(n, b3)
            torch._foreach_addcmul_(n, u, u, value=1 - b3)

            step_m = lr / (1.0 - b1 ** t)
            step_d = lr * b2 / (1.0 - b2 ** t)
            denom = torch._foreach_sqrt(n)
            torch._foreach_div_(denom, math.sqrt(1.0 - b3 ** t))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_mul(m, step_m)
            torch._foreach_add_(upd, d, alpha=step_d)
            torch._foreach_div_(upd, denom)
            if wd != 0.0 and group["no_prox"]:
                torch._foreach_mul_(ps, 1.0 - lr * wd)
            torch._foreach_sub_(ps, upd)
            if wd != 0.0 and not group["no_prox"]:
                torch._foreach_div_(ps, 1.0 + lr * wd)
            torch._foreach_copy_(prev, grads)
            group["count"] = t
        return loss
