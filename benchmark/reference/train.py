"""A DiffAb training step in plain PyTorch: noising, the loss, its
gradients and the optimizer, on a dict of float32 parameters.

The loss (DiffAb, Luo et al., NeurIPS 2022): the three forward diffusions
at a drawn t, with mode dropout (a share p of the examples shows the
generated residues' structure, another p their sequence); the KL of the
true sequence posterior against the one implied by the predicted p(s_0),
the noise's squared error, 9 x the mean squared error of R_pred^T R_true
against I, and the cross-entropy of p(s_0); each averaged over the
generated residues it supervises.

The update: global-norm gradient clip, Adam with bias correction (eps
outside the root), a per-parameter cap on the update's RMS, the learning
rate of a linear warm-up then a cosine decay.

`StepDraws` reproduces a training step's random numbers in the order the
port draws them from its per-step generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.geometry import exp_so3, igso3_rotvec, scale_rot
from benchmark.reference.model import denoise, encode_context


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator in a run seeded with `seed`."""
    return (seed * 1_000_003 + step) % 2 ** 64


def step_draws(seed: int, step: int, b: int, L: int, K: int, T: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    kw = dict(generator=g, device=device)
    u = torch.rand((b, L, K), **kw)
    t = torch.randint(1, T + 1, (b,), **kw)
    mode_u = torch.rand((b,), **kw)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    return dict(t=t, mode_u=mode_u, gumbel=gumbel, coord=torch.randn((b, L, 3), **kw),
                axis=torch.randn((b, L, 3), **kw), uniform=torch.rand((b, L), **kw),
                normal=torch.randn((b, L), **kw))


def _posterior(sched, seq_t, p0, t, s, gen, K):
    """q(s_s | s_t, p0), context residues a point mass on s_t."""
    abar_s = sched.alpha_bar[s][:, None, None]
    beta_ts = 1.0 - sched.alpha_bar[t][:, None, None] / abar_s
    onehot = F.one_hot(seq_t, K).float()
    single = torch.where(gen[..., None], (1.0 - beta_ts) * onehot + beta_ts / K, onehot)
    prior = torch.where(gen[..., None], abar_s * p0 + (1.0 - abar_s) / K, onehot)
    p = single * prior
    return p / p.sum(-1, keepdim=True)


def loss(P, c, tc, sched, table, batch, d, prec):
    """The training loss of one batch under draws `d`; returns (loss, parts)."""
    K = c["aa_vocab_size"]
    gen, res = batch["generation_mask"], batch["residue_mask"]
    t = d["t"]
    p = tc["mode_dropout"]
    s_vis = d["mode_u"] < p
    q_vis = (d["mode_u"] >= p) & (d["mode_u"] < 2.0 * p)
    seq_gen, struct_gen = gen & ~q_vis[:, None], gen & ~s_vis[:, None]

    seq0 = batch["seq_idx"]
    abar = sched.alpha_bar[t][:, None, None]
    oh0 = F.one_hot(seq0, K).float()
    q_t = torch.where(seq_gen[..., None], abar * oh0 + (1.0 - abar) / K, oh0)
    seq_t = torch.where(seq_gen, (torch.log(torch.clamp(q_t, min=1e-20)) + d["gumbel"]).argmax(-1),
                        seq0)
    true_post = _posterior(sched, seq_t, oh0, t, t - 1, seq_gen, K)

    x0 = batch["xyz"][:, :, 1]
    x_t = (sched.alpha_bar_sqrt[t][:, None, None] * x0
           + sched.one_minus_alpha_bar_sqrt[t][:, None, None] * d["coord"])
    x_t = torch.where(struct_gen[..., None], x_t, x0)
    r0 = batch["orientations"]
    rotvec = igso3_rotvec(table, t, d["axis"], d["uniform"], d["normal"])
    r_t = scale_rot(r0, sched.alpha_bar_sqrt[t]) @ exp_so3(rotvec)
    r_t = torch.where(struct_gen[..., None, None], r_t, r0)

    res_emb, pair_emb = encode_context(P, c, batch, prec, structure_visible=s_vis,
                                       sequence_visible=q_vis)
    out = denoise(P, c, seq_t, x_t, r_t, res_emb, pair_emb, sched.beta[t], res, prec)

    mask = (struct_gen & res).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    qmask = (seq_gen & res).float()
    qdenom = torch.clamp(qmask.sum(), min=1.0)
    pred_log = torch.log(torch.clamp(_posterior(sched, seq_t, out["seq_posterior"], t, t - 1,
                                                seq_gen, K), min=1e-12))
    kl = (true_post * (torch.log(torch.clamp(true_post, min=1e-12)) - pred_log)).sum(-1)
    parts = dict(seq_loss=(kl * qmask).sum() / qdenom)
    parts["translations_loss"] = (((out["translations_eps"] - d["coord"]) ** 2).sum(-1)
                                  * mask).sum() / denom
    disc = torch.einsum("...ij,...ik->...jk", out["orientations_t0"], r0)
    orient = 9.0 * ((disc - torch.eye(3, device=disc.device)) ** 2).mean((-1, -2))
    parts["orientations_loss"] = (orient * mask).sum() / denom
    ce = -torch.gather(torch.log_softmax(out["seq_logits"], -1), -1, seq0[..., None])[..., 0]
    parts["seq_ce_loss"] = (ce * qmask).sum() / qdenom
    total = (parts["seq_loss"] + parts["translations_loss"] + parts["orientations_loss"]
             + tc["seq_ce_weight"] * parts["seq_ce_loss"])
    return total, parts


def learning_rate(tc, count: int) -> float:
    warm, lr = tc["lr_warmup_steps"], tc["lr"]
    if tc["lr_decay_steps"] > 0:
        if warm > 0 and count < warm:
            return lr * count / warm
        span = tc["lr_decay_steps"] - warm
        c = min(count - warm, span)
        return lr * ((1.0 - tc["lr_min_ratio"]) * 0.5 * (1.0 + math.cos(math.pi * c / span))
                     + tc["lr_min_ratio"])
    if warm > 0:
        return lr * min(max(count, 0), warm) / warm
    return lr


class Trainer:
    """Parameters and Adam moments of a reference run, float32.  (The EMA
    is not followed: over the three steps the check reads it moves by a
    thousandth of the parameters' change, under its own rounding.)"""

    def __init__(self, params: dict):
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    def grads(self, c, tc, sched, table, batch, d, prec):
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        total, parts = loss(leaves, c, tc, sched, table, batch, d, prec)
        names = list(leaves)
        g = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True,
                                materialize_grads=True)
        return float(total.detach()), dict(zip(names, g))

    @torch.no_grad()
    def update(self, tc, grads: dict) -> dict:
        """One optimizer step; returns the clipped gradient it used."""
        b1, b2 = tc["betas"]
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        clip = tc["grad_clip_norm"]
        scale = 1.0 if clip <= 0 or gnorm < clip else clip / gnorm
        lr = learning_rate(tc, self.count)
        n = self.count + 1
        used = {}
        for k, p in self.params.items():
            g = (grads[k].double() * scale).float()
            used[k] = g
            self.mu[k] = b1 * self.mu[k] + (1.0 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1.0 - b2) * g * g
            u = (self.mu[k] / (1.0 - b1 ** n)) / (torch.sqrt(self.nu[k] / (1.0 - b2 ** n))
                                                  + tc["adam_eps"])
            if tc["update_clip_rms"] > 0:
                rms = torch.linalg.vector_norm(u) / math.sqrt(u.numel())
                u = u / torch.clamp(rms / tc["update_clip_rms"], min=1.0)
            if tc["weight_decay"] > 0:
                u = u + tc["weight_decay"] * p
            self.params[k] = p - lr * u
        self.count += 1
        return used
