"""Scoring and ranking designs by the model's own likelihood, in plain
PyTorch.

Each design is taken as x_0, forward-noised at each timestep of a grid
(8 values evenly over [1, T/4], each drawn twice), denoised, and scored by
the cross-entropy of the predicted p(s_0) against its sequence, the noise's
squared error and 9 x the mean squared entry of R_pred^T R_design - I, each
averaged over the generated residues and then over the grid; the score is
their sum, lower is better.  The grid's random numbers are drawn from the
scoring generator in the port's order (per grid point: the sequence's
uniforms, the coordinate noise, the axis-angle draw).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.geometry import exp_so3, igso3_rotvec, scale_rot
from benchmark.reference.model import denoise, encode_context


def t_grid(T: int) -> list:
    return [int(t) for t in np.unique(np.round(np.linspace(1, max(T // 4, 1), num=8)))]


def _row_mean(elem, mask):
    m = mask.float()
    return (elem * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def score(P, c, sched, table, batch, designs, n: int, seed: int, prec, n_draws: int = 2):
    """Scores (n,) of the n designs (seq, x, R) of `batch`'s one target."""
    seq_d, x_d, r_d = designs
    K = c["aa_vocab_size"]
    rep = lambda a: torch.repeat_interleave(a, n, 0)
    gen = rep(batch["generation_mask"] & batch["residue_mask"])
    res_mask = rep(batch["residue_mask"])
    res_emb, pair_emb = encode_context(P, c, batch, prec)
    g = torch.Generator(device=x_d.device).manual_seed(seed)
    kw = dict(generator=g, device=x_d.device)
    bn, L = seq_d.shape
    total = torch.zeros(bn, device=x_d.device)
    ts = [t for t in t_grid(sched.T) for _ in range(n_draws)]
    oh = F.one_hot(seq_d, K).float()
    for t in ts:
        tv = torch.full((bn,), t, dtype=torch.long, device=x_d.device)
        u = torch.rand((bn, L, K), **kw)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        abar = sched.alpha_bar[tv][:, None, None]
        q = torch.where(gen[..., None], abar * oh + (1.0 - abar) / K, oh)
        seq_t = torch.where(gen, (torch.log(torch.clamp(q, min=1e-20)) + gumbel).argmax(-1), seq_d)
        z = torch.randn((bn, L, 3), **kw)
        x_t = torch.where(gen[..., None], sched.alpha_bar_sqrt[tv][:, None, None] * x_d
                          + sched.one_minus_alpha_bar_sqrt[tv][:, None, None] * z, x_d)
        axis = torch.randn((bn, L, 3), **kw)
        uni, nrm = torch.rand((bn, L), **kw), torch.randn((bn, L), **kw)
        r_t = scale_rot(r_d, sched.alpha_bar_sqrt[tv]) @ exp_so3(igso3_rotvec(table, tv, axis,
                                                                              uni, nrm))
        r_t = torch.where(gen[..., None, None], r_t, r_d)
        out = denoise(P, c, seq_t, x_t, r_t, res_emb, pair_emb, sched.beta[tv], res_mask, prec)
        ce = -torch.gather(torch.log_softmax(out["seq_logits"], -1), -1, seq_d[..., None])[..., 0]
        eps = ((out["translations_eps"] - z) ** 2).sum(-1)
        disc = torch.einsum("...ij,...ik->...jk", out["orientations_t0"], r_d)
        orient = 9.0 * ((disc - torch.eye(3, device=disc.device)) ** 2).mean((-1, -2))
        total = total + _row_mean(ce, gen) + _row_mean(eps, gen) + _row_mean(orient, gen)
    return total / len(ts)
