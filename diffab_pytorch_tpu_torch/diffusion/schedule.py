"""Cosine variance schedule (`diffab_pytorch_tpu/diffusion/schedule.py`).

Tables of shape (T+1,), computed in float64 on host and stored as float32
tensors; index 0 is the data distribution (beta_0 = 0, alpha_bar_0 = 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    alpha: torch.Tensor
    alpha_bar: torch.Tensor
    alpha_bar_sqrt: torch.Tensor
    one_minus_alpha_bar_sqrt: torch.Tensor
    beta: torch.Tensor

    @property
    def T(self) -> int:
        return self.beta.shape[0] - 1

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(t.to(device) for t in self))


def cosine_variance_schedule(
    T: int, s: float = 8e-3, beta_max: float = 0.999, device="cpu"
) -> DiffusionSchedule:
    """Nichol & Dhariwal: f(t) = cos^2(((t/T + s)/(1 + s)) pi/2),
    alpha_bar_t = f(t)/f(0), beta_t = clip(1 - alpha_bar_t/alpha_bar_{t-1},
    1e-5, beta_max), beta_0 = 0."""
    t = np.arange(T + 1, dtype=np.float64)
    f_t = np.cos((t / T + s) / (1.0 + s) * np.pi / 2.0) ** 2
    alpha_bar = f_t / f_t[0]
    beta = np.concatenate(
        [np.zeros(1), np.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 1e-5, beta_max)]
    )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return DiffusionSchedule(
        alpha=f32(1.0 - beta),
        alpha_bar=f32(alpha_bar),
        alpha_bar_sqrt=f32(np.sqrt(alpha_bar)),
        one_minus_alpha_bar_sqrt=f32(np.sqrt(1.0 - alpha_bar)),
        beta=f32(beta),
    )
