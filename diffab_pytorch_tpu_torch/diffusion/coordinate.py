"""Gaussian (DDPM) diffusion on C-alpha translations
(`diffab_pytorch_tpu/diffusion/coordinate.py`).

Forward: x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps.  Reverse step in
the posterior-mean parameterization (or the DDIM direction, `mode="ddim"`),
respaced to any s < t, with optional static thresholding of the implied
x0 (`x0_clip`) and a noise temperature (`noise_scale`); the step from an
explicit x0 estimate serves the sampler's solvers.  The Gaussian noise can
be injected.  Context residues pass through unchanged.
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


def _coefficients(sched: DiffusionSchedule, t, s):
    """1 - abar_t, abar_t, abar_s, alpha_ts = abar_t / abar_s, beta_ts and
    beta_tilde = (1 - abar_s) / (1 - abar_t) beta_ts, as (b, 1, 1)."""
    one_minus_abar = sched.one_minus_alpha_bar_sqrt[t][..., None, None] ** 2
    abar = sched.alpha_bar[t][..., None, None]
    abar_prev = sched.alpha_bar[s][..., None, None]
    alpha = abar / abar_prev
    beta = 1.0 - alpha
    beta_tilde = (1.0 - abar_prev) / one_minus_abar * beta
    return one_minus_abar, abar, abar_prev, alpha, beta, beta_tilde


def _posterior_mean_from_x0(sched, translations_t, x0_hat, t, s):
    one_minus_abar, _, abar_prev, alpha, beta, _ = _coefficients(sched, t, s)
    return (torch.sqrt(abar_prev) * beta * x0_hat
            + torch.sqrt(alpha) * (1.0 - abar_prev) * translations_t) / one_minus_abar


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
    one_minus_abar, abar, _, alpha, beta, beta_tilde = _coefficients(sched, t, s)
    if x0_clip is None:
        mean = (translations_t - beta / torch.sqrt(one_minus_abar) * eps_hat) / torch.sqrt(alpha)
    else:
        x0_hat = (translations_t - torch.sqrt(one_minus_abar) * eps_hat) / torch.sqrt(abar)
        x0_hat = torch.clamp(x0_hat, -x0_clip, x0_clip)
        mean = _posterior_mean_from_x0(sched, translations_t, x0_hat, t, s)
    return mean, torch.sqrt(torch.clamp(beta_tilde, min=0.0))


def _draw(translations_t, generator, noise):
    if noise is None:
        noise = torch.randn(translations_t.shape, generator=generator,
                            dtype=translations_t.dtype, device=translations_t.device)
    return noise


def reverse_step(
    sched: DiffusionSchedule,
    translations_t: torch.Tensor,
    eps_hat: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    x0_clip=None,
    noise_scale=1.0,
    s: torch.Tensor | None = None,
    mode: str = "posterior",
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One reverse step x_t -> x_s (s defaults to t - 1; any s < t is the
    respaced posterior) using the predicted noise; z ~ N(0, I) drawn, or
    `noise`.  mode "posterior": x_s = mean + noise_scale std z, the
    posterior mean contracting the carried residual.  mode "ddim": the
    residual direction (x_t - sqrt(abar_t) x0_hat) / sqrt(1 - abar_t)
    rescaled to sqrt(1 - abar_s - sigma^2), sigma = noise_scale std, plus
    sigma z.  The two are equal at noise_scale 1."""
    if mode not in ("posterior", "ddim"):
        raise ValueError(f"mode must be 'posterior' or 'ddim', got {mode!r}")
    if s is None:
        s = t - 1
    if mode == "posterior":
        mean, std = posterior_mean_std(sched, translations_t, eps_hat, t,
                                       x0_clip=x0_clip, s=s)
        sigma = noise_scale * std
    else:
        clip = _per_sample(x0_clip)
        one_minus_abar, abar, abar_prev, _, _, beta_tilde = _coefficients(sched, t, s)
        sigma = noise_scale * torch.sqrt(torch.clamp(beta_tilde, min=0.0))
        x0_hat = (translations_t - torch.sqrt(one_minus_abar) * eps_hat) / torch.sqrt(abar)
        if clip is not None:
            x0_hat = torch.clamp(x0_hat, -clip, clip)
        direction = (translations_t - torch.sqrt(abar) * x0_hat) / torch.sqrt(one_minus_abar)
        mean = (torch.sqrt(abar_prev) * x0_hat
                + torch.sqrt(torch.clamp((1.0 - abar_prev) - sigma ** 2, min=0.0)) * direction)
    x_prev = mean + sigma * _draw(translations_t, generator, noise)
    return torch.where(generation_mask[..., None], x_prev, translations_t)


def reverse_step_from_x0(
    sched: DiffusionSchedule,
    translations_t: torch.Tensor,
    x0_hat: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    x0_clip=None,
    noise_scale=1.0,
    s: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The posterior step q(x_s | x_t, x0_hat) given an explicit clean-state
    estimate (clipped to x0_clip first): the entry of the sampler's
    higher-order coordinate solvers.  With x0_hat = predicted_x0(x_t,
    eps_hat, t) it is `reverse_step(mode="posterior")`."""
    clip = _per_sample(x0_clip)
    if s is None:
        s = t - 1
    if clip is not None:
        x0_hat = torch.clamp(x0_hat, -clip, clip)
    mean = _posterior_mean_from_x0(sched, translations_t, x0_hat, t, s)
    beta_tilde = _coefficients(sched, t, s)[-1]
    sigma = noise_scale * torch.sqrt(torch.clamp(beta_tilde, min=0.0))
    x_prev = mean + sigma * _draw(translations_t, generator, noise)
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


class CoordinateDiffuser:
    """The reference's class API over the functions above, holding a
    schedule (cosine with s and beta_max, on `device`: the card unless
    named, or `sched` as given).  Each draw comes from `generator`, or is
    injected as `noise`."""

    def __init__(self, T: int, s: float = 0.01, beta_max: float = 0.999,
                 sched: DiffusionSchedule | None = None, device=None):
        from diffab_pytorch_tpu_torch.config import resolve_device
        from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule

        self.sched = sched if sched is not None else cosine_variance_schedule(
            T, s=s, beta_max=beta_max, device=resolve_device(device))

    def diffuse_from_t0(self, translations_t0, t, generation_mask, return_eps: bool = True,
                        generator=None, noise=None):
        x_t, eps = diffuse_from_t0(self.sched, translations_t0, t, generation_mask,
                                   generator=generator, noise=noise)
        return (x_t, eps) if return_eps else x_t

    def reverse_step(self, translations_t, eps_hat, t, generation_mask, generator=None,
                     noise=None):
        return reverse_step(self.sched, translations_t, eps_hat, t, generation_mask,
                            generator=generator, noise=noise)
