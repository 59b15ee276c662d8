"""Gaussian (DDPM) diffusion on C-alpha translations
(`diffab_pytorch_tpu/diffusion/coordinate.py`).

Forward: x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps.  Reverse step in the posterior-mean parameterization, with optional static
thresholding of the implied x0 (`x0_clip`) and a noise temperature
(`noise_scale`); the Gaussian noise can be injected.  Context residues
pass through unchanged.
"""

from __future__ import annotations

import torch

from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule


def _per_sample(x0_clip):
    """A (b,) clip bound broadcasts over residues and coordinates."""
    if isinstance(x0_clip, torch.Tensor) and x0_clip.ndim == 1:
        return x0_clip[..., None, None]
    return x0_clip


def diffuse_from_t0(
    sched: DiffusionSchedule,
    translations_t0: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
):
    """(x_t, eps): x_t ~ q(x_t | x_0) on generated positions, eps ~ N(0, I)
    the noise (the training target); `noise` injects eps."""
    a = sched.alpha_bar_sqrt[t][..., None, None]
    b = sched.one_minus_alpha_bar_sqrt[t][..., None, None]
    if noise is None:
        noise = torch.randn(translations_t0.shape, generator=generator,
                            dtype=translations_t0.dtype, device=translations_t0.device)
    x_t = a * translations_t0 + b * noise
    return torch.where(generation_mask[..., None], x_t, translations_t0), noise


def posterior_mean_std(
    sched: DiffusionSchedule,
    translations_t: torch.Tensor,
    eps_hat: torch.Tensor,
    t: torch.Tensor,
    x0_clip=None,
    s: torch.Tensor | None = None,
):
    """Mean and standard deviation (noise_scale 1) of q(x_s | x_t, x0_hat),
    s defaulting to t - 1.  Without a clip bound the mean is the eps form;
    with one, the implied x0_hat is clamped first."""
    x0_clip = _per_sample(x0_clip)
    if s is None:
        s = t - 1
    one_minus_abar = sched.one_minus_alpha_bar_sqrt[t][..., None, None] ** 2
    abar = sched.alpha_bar[t][..., None, None]
    abar_prev = sched.alpha_bar[s][..., None, None]
    alpha = abar / abar_prev
    beta = 1.0 - alpha
    beta_tilde = (1.0 - abar_prev) / one_minus_abar * beta
    if x0_clip is None:
        mean = (translations_t - beta / torch.sqrt(one_minus_abar) * eps_hat) / torch.sqrt(alpha)
    else:
        x0_hat = (translations_t - torch.sqrt(one_minus_abar) * eps_hat) / torch.sqrt(abar)
        x0_hat = torch.clamp(x0_hat, -x0_clip, x0_clip)
        mean = (torch.sqrt(abar_prev) * beta * x0_hat
                + torch.sqrt(alpha) * (1.0 - abar_prev) * translations_t) / one_minus_abar
    return mean, torch.sqrt(torch.clamp(beta_tilde, min=0.0))


def reverse_step(
    sched: DiffusionSchedule,
    translations_t: torch.Tensor,
    eps_hat: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    x0_clip=None,
    noise_scale: float = 1.0,
    s: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One DDPM posterior step x_t -> x_s using the predicted noise;
    x_s = mean + noise_scale * std * z, z ~ N(0, I) (drawn, or `noise`)."""
    mean, std = posterior_mean_std(sched, translations_t, eps_hat, t,
                                   x0_clip=x0_clip, s=s)
    if noise is None:
        noise = torch.randn(translations_t.shape, generator=generator,
                            dtype=translations_t.dtype,
                            device=translations_t.device)
    x_prev = mean + noise_scale * std * noise
    return torch.where(generation_mask[..., None], x_prev, translations_t)


def predicted_x0(sched, translations_t, eps_hat, t) -> torch.Tensor:
    """Implied clean coordinates from (x_t, eps_hat)."""
    a = sched.alpha_bar_sqrt[t][..., None, None]
    b = sched.one_minus_alpha_bar_sqrt[t][..., None, None]
    return (translations_t - b * eps_hat) / a


def sample_prior(
    translations_context: torch.Tensor,
    generation_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """x_T ~ N(0, I) on generated positions; context keeps its coordinates."""
    if noise is None:
        noise = torch.randn(translations_context.shape, generator=generator,
                            dtype=translations_context.dtype,
                            device=translations_context.device)
    return torch.where(generation_mask[..., None], noise, translations_context)
