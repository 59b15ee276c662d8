"""The reverse diffusion of a design job in plain PyTorch.

A job designs n variants of one target from the prior over T steps:
sequence by the multinomial posterior against the predicted p(s_0)
(Gumbel-max), C-alpha translations by the DDPM posterior mean from the
implied x0 (clipped to 1.5x the context's extent) plus noise, frames by
renoising the predicted clean frames at the next step's IGSO(3) sigma.

The few-step recipe starts instead from the anchor-anchor chord: each
generated residue's translation interpolated by residue index between the
nearest context residues before and after it on its chain, forward-noised
to t_start (residues without both anchors start from the prior), its
frames and types from the prior; `noise_scale` scales the coordinates'
reverse noise.

`JobDraws` reproduces the random numbers a job's generator gives, in the
order the port draws them: the initial state's (prior: residue types,
translations, quaternions; chord: the chord's forward noise, the prior's
translations, types and quaternions), then per step the Gumbel uniforms,
the coordinate noise and the axis-angle draw.  `step` is one reverse step
from a given state, so the check can follow the port's trajectory step by
step.
"""

from __future__ import annotations

import torch

from benchmark.reference.geometry import igso3_rotvec, matrix_of, scale_rot, exp_so3
from benchmark.reference.model import denoise, encode_context


class JobDraws:
    """The random numbers of one design job, drawn on `device` from a
    generator seeded with `seed`, in the port's order (prior, then step by
    step)."""

    def __init__(self, seed: int, bn: int, L: int, vocab: int, device, init: str = "prior"):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.shape, self.vocab, self.device = (bn, L), vocab, device
        kw = dict(generator=self.g, device=device)
        if init == "chord":
            self.chord_x = torch.randn(self.shape + (3,), **kw)
            self.prior_x = torch.randn(self.shape + (3,), **kw)
            self.prior_seq = torch.randint(0, vocab, self.shape, **kw)
        else:
            self.prior_seq = torch.randint(0, vocab, self.shape, **kw)
            self.prior_x = torch.randn(self.shape + (3,), **kw)
        self.prior_q = torch.randn(self.shape + (4,), **kw)

    def next_step(self) -> dict:
        u = torch.empty(self.shape + (self.vocab,), device=self.device).uniform_(generator=self.g)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        z = torch.empty(self.shape + (3,), device=self.device).normal_(generator=self.g)
        axis = torch.empty(self.shape + (3,), device=self.device).normal_(generator=self.g)
        uni = torch.empty(self.shape, device=self.device).uniform_(generator=self.g)
        nrm = torch.empty(self.shape, device=self.device).normal_(generator=self.g)
        return dict(gumbel=gumbel, coord=z, axis=axis, uniform=uni, normal=nrm)


class Job:
    """One target's context and masks, repeated for n designs."""

    def __init__(self, P, c, batch, n: int, prec):
        rep = lambda a: torch.repeat_interleave(a, n, 0)
        self.batch, self.n = batch, n
        gen = batch["generation_mask"] & batch["residue_mask"]
        ctx = batch["residue_mask"] & ~batch["generation_mask"]
        ca = batch["xyz"][:, :, 1]
        extent = torch.where(ctx[..., None], ca.abs(), torch.zeros_like(ca)).amax(dim=(1, 2))
        self.x0_clip = rep(1.5 * torch.clamp(extent, min=1.0))[:, None, None]
        self.seq_ctx, self.x_ctx = rep(batch["seq_idx"]), rep(ca)
        self.r_ctx, self.res_mask, self.gen = rep(batch["orientations"]), rep(
            batch["residue_mask"]), rep(gen)
        self.ridx, self.cidx = rep(batch["residue_idx"]), rep(batch["chain_idx"])
        self.res_emb, self.pair_emb = encode_context(P, c, batch, prec)

    def initial(self, draws: JobDraws, sched, init: str = "prior", t_start: int | None = None):
        """(seq, x, R) at t_start: from the prior, or (init "chord") with the
        translations on the forward-noised anchor chord."""
        g = self.gen
        q = draws.prior_q / torch.linalg.norm(draws.prior_q, dim=-1, keepdim=True)
        x = torch.where(g[..., None], draws.prior_x, self.x_ctx)
        if init == "chord":
            guess, has = anchor_chord(self.x_ctx, self.ridx, self.cidx, self.res_mask, g)
            t = torch.full((g.shape[0],), t_start, dtype=torch.long, device=g.device)
            noised = (sched.alpha_bar_sqrt[t][:, None, None] * guess
                      + sched.one_minus_alpha_bar_sqrt[t][:, None, None] * draws.chord_x)
            x = torch.where((g & has)[..., None], noised, x)
        return (torch.where(g, draws.prior_seq, self.seq_ctx), x,
                torch.where(g[..., None, None], matrix_of(q), self.r_ctx))


def anchor_chord(x, ridx, cidx, res_mask, gen):
    """Each generated residue on the straight line between its chain's
    nearest context residues before and after it (by residue index), and
    whether it has both."""
    ctx = res_mask & ~gen
    same = (cidx[:, :, None] == cidx[:, None, :]) & res_mask[:, None, :]
    ri = ridx.float()
    d = ridx[:, None, :] - ridx[:, :, None]
    big = torch.tensor(1e9, device=x.device)
    before = same & ctx[:, None, :] & (d < 0)
    after = same & ctx[:, None, :] & (d > 0)
    i0 = torch.argmax(torch.where(before, ri[:, None, :], -big), dim=2)
    i1 = torch.argmin(torch.where(after, ri[:, None, :], big), dim=2)
    has = before.any(2) & after.any(2)
    r0, r1 = torch.gather(ri, 1, i0), torch.gather(ri, 1, i1)
    frac = (ri - r0) / torch.clamp(r1 - r0, min=1.0)
    take = lambda idx: torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
    x0 = take(i0)
    chord = x0 + frac[..., None] * (take(i1) - x0)
    return torch.where((gen & has)[..., None], chord, x), gen & has


def step(P, c, sched, table, job: Job, state, t: int, s: int, noise: dict, prec,
         noise_scale: float = 1.0):
    """One reverse step t -> s from `state` = (seq, x, R); noise_scale
    scales the coordinates' noise.  Returns the next state and the sequence
    scores log p(s_prev) + Gumbel (b n, L, K) whose argmax the step takes."""
    seq_t, x_t, r_t = state
    bn, L = seq_t.shape
    K = c["aa_vocab_size"]
    dev = x_t.device
    tv = torch.full((bn,), t, dtype=torch.long, device=dev)
    sv = torch.full((bn,), s, dtype=torch.long, device=dev)
    out = denoise(P, c, seq_t, x_t, r_t, job.res_emb, job.pair_emb, sched.beta[tv],
                  job.res_mask, prec)
    g = job.gen

    # sequence: q(s_prev | s_t, p_hat(s_0)), the context a point mass
    abar_s = sched.alpha_bar[sv][:, None, None]
    beta_ts = 1.0 - sched.alpha_bar[tv][:, None, None] / abar_s
    onehot = torch.nn.functional.one_hot(seq_t, K).float()
    p_single = torch.where(g[..., None], (1.0 - beta_ts) * onehot + beta_ts / K, onehot)
    p_prior = torch.where(g[..., None], abar_s * out["seq_posterior"] + (1.0 - abar_s) / K,
                          onehot)
    post = p_single * p_prior
    post = post / post.sum(-1, keepdim=True)
    scores = torch.log(torch.clamp(post, min=1e-20)) + noise["gumbel"]
    seq_s = torch.where(g, scores.argmax(-1), seq_t)

    # frames: the forward kernel at s applied to the predicted clean frames
    rotvec = igso3_rotvec(table, sv, noise["axis"], noise["uniform"], noise["normal"])
    r_s = scale_rot(out["orientations_t0"], sched.alpha_bar_sqrt[sv]) @ exp_so3(rotvec)
    r_s = torch.where(g[..., None, None], r_s, r_t)

    # translations: posterior mean from the clipped x0 estimate, plus noise
    one_m = sched.one_minus_alpha_bar_sqrt[tv][:, None, None] ** 2
    abar_t = sched.alpha_bar[tv][:, None, None]
    alpha = abar_t / abar_s
    beta = 1.0 - alpha
    beta_tilde = (1.0 - abar_s) / one_m * beta
    x0 = (x_t - torch.sqrt(one_m) * out["translations_eps"]) / torch.sqrt(abar_t)
    x0 = torch.clamp(x0, -job.x0_clip, job.x0_clip)
    mean = (torch.sqrt(abar_s) * beta * x0 + torch.sqrt(alpha) * (1.0 - abar_s) * x_t) / one_m
    x_s = mean + noise_scale * torch.sqrt(torch.clamp(beta_tilde, min=0.0)) * noise["coord"]
    x_s = torch.where(g[..., None], x_s, x_t)
    return (seq_s, x_s, r_s), scores
