"""Multinomial (D3PM uniform-noise) sequence diffusion
(`diffab_pytorch_tpu/diffusion/sequence.py`): the forward process with its
true posterior (the training target), the single-step forward kernel and
the reverse step.

Positions outside `generation_mask` are clamped to the input sequence.
The categorical draw is Gumbel-max; the Gumbel tensor can be injected.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffab_pytorch_tpu_torch.constants import AA_VOCAB_SIZE
from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule


def _clamp_context(probs, seq_idx, generation_mask):
    """Outside the generation mask the distribution is a point mass on the
    input sequence."""
    onehot = F.one_hot(seq_idx, probs.shape[-1]).to(probs.dtype)
    return torch.where(generation_mask[..., None], probs, onehot)


def categorical_from_probs(
    probs: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Category indices from (..., K) probabilities by Gumbel-max:
    argmax(log(max(p, 1e-20)) + G), G ~ Gumbel(0, 1) (drawn, or `gumbel`)."""
    if gumbel is None:
        u = torch.rand(probs.shape, generator=generator, dtype=probs.dtype,
                       device=probs.device)
        tiny = torch.finfo(probs.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    logits = torch.log(torch.clamp(probs, min=1e-20))
    return torch.argmax(logits + gumbel, dim=-1)


def forward_prob_single_step(
    sched: DiffusionSchedule,
    seq_idx: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
) -> torch.Tensor:
    """q(s_t | s_{t-1} = seq_idx) = (1 - beta_t) onehot + beta_t / K:
    (b, L) -> (b, L, K), context clamped."""
    beta = sched.beta[t][..., None, None]
    onehot = F.one_hot(seq_idx, vocab_size).to(sched.beta.dtype)
    probs = (1.0 - beta) * onehot + beta / vocab_size
    return _clamp_context(probs, seq_idx, generation_mask)


def diffuse_single_step(
    sched: DiffusionSchedule,
    seq_idx: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """s_t ~ q(s_t | s_{t-1}); `gumbel` (b, L, K) injects the draw."""
    p = forward_prob_single_step(sched, seq_idx, t, generation_mask, vocab_size)
    return torch.where(generation_mask, categorical_from_probs(p, generator, gumbel), seq_idx)


def forward_prob_from_t0(
    sched: DiffusionSchedule,
    seq_idx_t0: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
) -> torch.Tensor:
    """q(s_t | s_0 = seq_idx_t0) = abar_t onehot(s_0) + (1 - abar_t)/K:
    (b, L) -> (b, L, K), context clamped."""
    abar = sched.alpha_bar[t][..., None, None]
    onehot = F.one_hot(seq_idx_t0, vocab_size).to(sched.alpha_bar.dtype)
    probs = abar * onehot + (1.0 - abar) / vocab_size
    return _clamp_context(probs, seq_idx_t0, generation_mask)


def posterior_single_step(
    sched: DiffusionSchedule,
    seq_idx_t: torch.Tensor,
    seq_idx_t0: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
) -> torch.Tensor:
    """The true posterior q(s_{t-1} | s_t, s_0), normalized over the vocab,
    in the ratio form the sampler's posterior uses."""
    abar_prev = sched.alpha_bar[t - 1][..., None, None]
    beta_ts = 1.0 - sched.alpha_bar[t][..., None, None] / abar_prev
    onehot_t = F.one_hot(seq_idx_t, vocab_size).to(sched.beta.dtype)
    p_single = (1.0 - beta_ts) * onehot_t + beta_ts / vocab_size
    p_single = _clamp_context(p_single, seq_idx_t, generation_mask)
    onehot_0 = F.one_hot(seq_idx_t0, vocab_size).to(sched.beta.dtype)
    p_prior = abar_prev * onehot_0 + (1.0 - abar_prev) / vocab_size
    p_prior = _clamp_context(p_prior, seq_idx_t, generation_mask)
    p = p_single * p_prior
    return p / torch.sum(p, dim=-1, keepdim=True)


def diffuse_from_t0(
    sched: DiffusionSchedule,
    seq_idx_t0: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
    return_posterior: bool = True,
):
    """s_t ~ q(s_t | s_0) and (return_posterior) the true posterior
    q(s_{t-1} | s_t, s_0), the KL target in training.  `gumbel` (b, L, K)
    injects the draw."""
    p = forward_prob_from_t0(sched, seq_idx_t0, t, generation_mask, vocab_size)
    seq_idx_t = categorical_from_probs(p, generator, gumbel)
    seq_idx_t = torch.where(generation_mask, seq_idx_t, seq_idx_t0)
    if not return_posterior:
        return seq_idx_t
    posterior = posterior_single_step(sched, seq_idx_t, seq_idx_t0, t,
                                      generation_mask, vocab_size)
    return seq_idx_t, posterior


def posterior_from_predicted_t0(
    sched: DiffusionSchedule,
    seq_idx_t: torch.Tensor,
    s0_probs: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    s: torch.Tensor | None = None,
) -> torch.Tensor:
    """q(s_prev | s_t, p_hat(s_0)), s_prev = s (default t - 1): the
    single-step likelihood with mixture weight beta_ts = 1 - abar_t/abar_s
    times the jump prior abar_s p_hat(s_0) + (1 - abar_s)/K, normalized."""
    if s is None:
        s = t - 1
    vocab_size = s0_probs.shape[-1]
    abar_prev = sched.alpha_bar[s][..., None, None]
    beta_ts = 1.0 - sched.alpha_bar[t][..., None, None] / abar_prev
    onehot = F.one_hot(seq_idx_t, vocab_size).to(sched.beta.dtype)
    p_single = (1.0 - beta_ts) * onehot + beta_ts / vocab_size
    p_single = _clamp_context(p_single, seq_idx_t, generation_mask)
    p_prior = abar_prev * s0_probs + (1.0 - abar_prev) / vocab_size
    p_prior = _clamp_context(p_prior, seq_idx_t, generation_mask)
    p = p_single * p_prior
    return p / torch.sum(p, dim=-1, keepdim=True)


def log_posterior_from_predicted_t0(
    sched: DiffusionSchedule,
    seq_idx_t: torch.Tensor,
    s0_probs: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
) -> torch.Tensor:
    """log q(s_{t-1} | s_t, p_hat(s_0)), floored at 1e-12 before the log:
    the training loss pushes the predicted p(s_0) through the same
    transform the sampler draws from."""
    p = posterior_from_predicted_t0(sched, seq_idx_t, s0_probs, t, generation_mask)
    return torch.log(torch.clamp(p, min=1e-12))


def reverse_step(
    sched: DiffusionSchedule,
    seq_idx_t: torch.Tensor,
    s0_probs: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    s: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample s_prev from the posterior against the predicted p(s_0);
    context residues are clamped."""
    posterior = posterior_from_predicted_t0(
        sched, seq_idx_t, s0_probs, t, generation_mask, s=s
    )
    sampled = categorical_from_probs(posterior, generator, gumbel)
    return torch.where(generation_mask, sampled, seq_idx_t)


def sample_prior(
    seq_idx_context: torch.Tensor,
    generation_mask: torch.Tensor,
    vocab_size: int = AA_VOCAB_SIZE,
    generator: torch.Generator | None = None,
    sampled: torch.Tensor | None = None,
) -> torch.Tensor:
    """s_T uniform over the vocab on generated positions; context keeps its
    sequence.  `sampled` injects the uniform draw."""
    if sampled is None:
        sampled = torch.randint(0, vocab_size, seq_idx_context.shape,
                                generator=generator,
                                device=seq_idx_context.device)
    return torch.where(generation_mask, sampled, seq_idx_context)
