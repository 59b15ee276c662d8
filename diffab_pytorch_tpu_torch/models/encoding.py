"""Angular encoding of dihedrals and the beta-timestep encoding
(`diffab_pytorch_tpu/models/encoding.py`)."""

from __future__ import annotations

import numpy as np
import torch


def angular_encoding_dim(d_in: int, num_funcs: int = 3) -> int:
    return d_in * (num_funcs * 4 + 1)


def angular_encode(x: torch.Tensor, num_funcs: int = 3) -> torch.Tensor:
    """(..., d_in) -> (..., d_in * (4 num_funcs + 1)):
    concat([x, sin(f x), cos(f x)]) over bands f in [1..n] ∪ [1, 1/2, .., 1/n]."""
    freqs = np.concatenate(
        [np.arange(1, num_funcs + 1), 1.0 / np.arange(1, num_funcs + 1)]
    ).astype(np.float32)
    freqs = torch.as_tensor(freqs, device=x.device).to(x.dtype)
    fx = x[..., None] * freqs
    enc = torch.cat([x[..., None], torch.sin(fx), torch.cos(fx)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)


def beta_encode(beta: torch.Tensor) -> torch.Tensor:
    """[beta, sin beta, cos beta]."""
    return torch.stack([beta, torch.sin(beta), torch.cos(beta)], dim=-1)
