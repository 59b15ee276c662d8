"""Relaxation of designed C-alpha positions, in plain PyTorch.

A damped Jacobi projection onto two constraints of the backbone validity
gate (consecutive C-alphas of a chain 2.70-4.30 angstrom apart; no
non-bonded pair closer than 3.0): a violating chain edge is moved toward
2.90-4.10, a clashing pair pushed apart to 3.15, each correction split
between the constraint's designed ends (context residues never move).  A
designed run with an edge beyond twice the window starts from its anchor
chord.  200 iterations, damping 0.5.
"""

from __future__ import annotations

import torch

GATE = (2.70, 4.30)
TARGET = (2.90, 4.10)
CLASH, CLASH_TARGET = 3.0, 3.15


def relax(x, res_mask, cidx, ridx, gen, scale: float, n_iters: int = 200, damping: float = 0.5,
          prec=None):
    """Designed rows of x (b, L, 3) projected; the others returned as given.
    `prec` (a control): the positions rounded to that precision after every
    iteration, the arithmetic of a relaxation carried in it."""
    x_in = x
    x = x.float()
    rm = res_mask.bool()
    gm = gen.bool() & rm
    L = x.shape[1]
    same = (cidx[:, :, None] == cidx[:, None, :]) & (rm[:, :, None] & rm[:, None, :])
    d_seq = ridx[:, None, :] - ridx[:, :, None]
    succ = same & (d_seq == 1)
    nxt = torch.argmax(succ.int(), dim=2)
    gm_n = torch.gather(gm, 1, nxt)
    edge = succ.any(2) & (gm | gm_n)

    def shares(a, b):
        tot = torch.clamp(a.float() + b.float(), min=1.0)
        return a.float() / tot, b.float() / tot

    w_i, w_j = shares(gm, gm_n)
    nonbonded = (rm[:, :, None] & rm[:, None, :]) & ~(same & (d_seq.abs() <= 1))
    pair = nonbonded & (gm[:, :, None] | gm[:, None, :])
    w_pair, _ = shares(gm[:, :, None], gm[:, None, :])
    g_lo, g_hi, lo, hi = GATE[0] / scale, GATE[1] / scale, TARGET[0] / scale, TARGET[1] / scale
    clash, clash_to = CLASH / scale, CLASH_TARGET / scale
    take = lambda a, idx: torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))

    ctx = rm & ~gm
    rf = ridx.float()
    big = torch.tensor(1e9, device=x.device)
    before = same & ctx[:, None, :] & (d_seq < 0)
    after = same & ctx[:, None, :] & (d_seq > 0)
    i0 = torch.argmax(torch.where(before, rf[:, None, :], -big), dim=2)
    i1 = torch.argmin(torch.where(after, rf[:, None, :], big), dim=2)
    anchored = before.any(2) & after.any(2)
    key = torch.where(gm, i0, torch.arange(L, device=x.device)[None, :])
    edge_key = torch.where(gm, key, torch.gather(key, 1, nxt))
    length = torch.sqrt(((take(x, nxt) - x) ** 2).sum(-1) + 1e-12)
    extreme = edge & (length > 2.0 * g_hi)
    torn = ((key[:, :, None] == edge_key[:, None, :]) & extreme[:, None, :]).any(2)
    r0, r1 = torch.gather(rf, 1, i0), torch.gather(rf, 1, i1)
    frac = (rf - r0) / torch.clamp(r1 - r0, min=1.0)
    chord = take(x, i0) + frac[..., None] * (take(x, i1) - take(x, i0))
    x = torch.where((gm & anchored & torn)[..., None], chord, x)

    nxt3 = nxt[..., None].expand(-1, -1, 3)
    for _ in range(n_iters):
        dv = torch.gather(x, 1, nxt3) - x
        d = torch.sqrt((dv * dv).sum(-1) + 1e-12)
        bad = edge & ((d < g_lo) | (d > g_hi))
        delta = ((torch.clamp(d, lo, hi) - d) / d)[..., None] * dv * bad[..., None]
        upd = (-delta * w_i[..., None]).scatter_add(1, nxt3, delta * w_j[..., None])
        diff = x[:, :, None, :] - x[:, None, :, :]
        pd = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        hit = pair & (pd < clash)
        push = ((clash_to - pd) / pd)[..., None] * diff
        upd = upd + (push * (hit[..., None] * w_pair[..., None])).sum(2)
        x = x + damping * upd
        if prec is not None:
            x = prec.operand(x).float()
    return torch.where(gm[..., None], x.to(x_in.dtype), x_in)
