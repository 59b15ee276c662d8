"""Designed-loop relaxation in torch (`diffab_pytorch_tpu/structure/relax.py`).

The exact-posterior reverse chain leaves a designed loop near the native
at the scored positions, but often with one or two CA-CA steps outside the
validity window, mostly at the loop's anchors, where a designed residue
meets an immovable context residue.  `relax_ca` is a damped Jacobi
projection onto the validity gate's CA-level constraints
(`evaluation/metrics.py backbone_validity`):

  * chain continuity: a chain-successor edge outside the window is moved
    along its direction toward an inner target window;
  * clash repulsion: a non-bonded CA pair closer than the clash distance
    is pushed apart.

Each correction is split between the constraint's designed endpoints;
context residues never move.  Constraints fire only on gate-violating
geometry, so geometry that passes the gate is returned unchanged.  A
fixed number of iterations, each a few dozen element-wise launches on
(n, L, L) tensors.  Moving a CA moves its residue rigidly (N, C, O are
frame-local offsets), so the peptide-bond idealization composes after it.
"""

from __future__ import annotations

import torch

from diffab_pytorch_tpu_torch.evaluation.metrics import CA_CA_RANGE, CLASH_DIST, chain_graph
from diffab_pytorch_tpu_torch.utils.profiling import named_scope

# Repair targets sit inside the validity windows, so repaired geometry
# passes with margin; the chain window still admits cis-peptides (~2.95 A).
RELAX_CA_RANGE = (2.90, 4.10)
RELAX_CLASH_TARGET = 3.15


def _shares(g_a, g_b):
    """Each endpoint's share of a correction: 1 for a lone designed
    endpoint, 1/2 each for two, 0 for context."""
    wa, wb = g_a.to(torch.float32), g_b.to(torch.float32)
    tot = torch.clamp(wa + wb, min=1.0)
    return wa / tot, wb / tot


@named_scope("relax")
def relax_ca(
    translations: torch.Tensor,  # (b, L, 3) CA positions, model units
    residue_mask: torch.Tensor,  # (b, L)
    chain_idx: torch.Tensor,  # (b, L) int
    residue_idx: torch.Tensor,  # (b, L) int, position along the chain
    gen_mask: torch.Tensor,  # (b, L), designed positions (only these move)
    coord_scale: float = 1.0,  # model units times this = angstroms
    n_iters: int = 200,
    damping: float = 0.5,
) -> torch.Tensor:
    """Project the designed CA positions onto the chain-continuity and
    clash constraints of the validity gate.  Returns translations with only
    designed rows updated: context rows come back byte-identical, and
    geometry that passes the gate comes back unchanged."""
    x0 = translations
    x = translations.to(torch.float32)
    rm = residue_mask.to(torch.bool)
    gm = gen_mask.to(torch.bool) & rm
    L = x.shape[1]

    same_chain, dseq = chain_graph(rm, chain_idx, residue_idx)
    succ = same_chain & (dseq == 1)  # (b, i, j): j is i's chain successor
    # the first successor (argmax of a boolean; cast, as not every device
    # reduces booleans), 0 where there is none
    succ_idx = torch.argmax(succ.to(torch.int32), dim=2)
    has_succ = succ.any(dim=2)
    gm_j = torch.gather(gm, 1, succ_idx)
    edge = has_succ & (gm | gm_j)  # edges touching a designed residue
    w_i, w_j = _shares(gm, gm_j)

    bonded_or_self = same_chain & (torch.abs(dseq) <= 1)
    nonbonded = (rm[:, :, None] & rm[:, None, :]) & ~bonded_or_self
    pair_active = nonbonded & (gm[:, :, None] | gm[:, None, :])
    w_pair, _ = _shares(gm[:, :, None], gm[:, None, :])  # row i's share

    gate_lo = CA_CA_RANGE[0] / coord_scale
    gate_hi = CA_CA_RANGE[1] / coord_scale
    lo = RELAX_CA_RANGE[0] / coord_scale
    hi = RELAX_CA_RANGE[1] / coord_scale
    clash_gate = CLASH_DIST / coord_scale
    clash_target = RELAX_CLASH_TARGET / coord_scale
    take = lambda a, idx: torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))

    # Chord pre-pass: a designed run with an EXTREME edge (beyond 2x the
    # window: a torn loop, or scattered output of an undertrained model)
    # converges too slowly under local projection; its constrained optimum
    # is near the straight anchor-anchor chord, so such runs start there.
    ctx = rm & ~gm
    ri_f = residue_idx.to(torch.float32)
    big = torch.tensor(1e9, dtype=torch.float32, device=x.device)
    prev_cand = same_chain & ctx[:, None, :] & (dseq < 0)  # j before i
    next_cand = same_chain & ctx[:, None, :] & (dseq > 0)  # j after i
    prev_idx = torch.argmax(torch.where(prev_cand, ri_f[:, None, :], -big), dim=2)
    next_idx = torch.argmin(torch.where(next_cand, ri_f[:, None, :], big), dim=2)
    has_anchors = prev_cand.any(dim=2) & next_cand.any(dim=2)
    # run key: a designed residue belongs to the run of its previous
    # context anchor; a context residue anchors its own run
    key = torch.where(gm, prev_idx, torch.arange(L, device=x.device)[None, :])
    edge_key = torch.where(gm, key, torch.gather(key, 1, succ_idx))
    elen = torch.sqrt(torch.sum((take(x, succ_idx) - x) ** 2, dim=-1) + 1e-12)
    extreme_edge = edge & (elen > 2.0 * gate_hi)
    run_extreme = ((key[:, :, None] == edge_key[:, None, :]) & extreme_edge[:, None, :]).any(dim=2)
    ri_prev = torch.gather(ri_f, 1, prev_idx)
    ri_next = torch.gather(ri_f, 1, next_idx)
    frac = (ri_f - ri_prev) / torch.clamp(ri_next - ri_prev, min=1.0)
    x_prev = take(x, prev_idx)
    chord = x_prev + frac[..., None] * (take(x, next_idx) - x_prev)
    x = torch.where((gm & has_anchors & run_extreme)[..., None], chord, x)

    succ_idx3 = succ_idx[..., None].expand(-1, -1, 3)
    w_i3, w_j3 = w_i[..., None], w_j[..., None]
    for _ in range(n_iters):
        # chain continuity: violating successor edges to the inner window
        dvec = torch.gather(x, 1, succ_idx3) - x
        d = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
        viol = edge & ((d < gate_lo) | (d > gate_hi))
        target = torch.clamp(d, lo, hi)
        # delta: the way j must move for the edge to have the target length
        delta = ((target - d) / d)[..., None] * dvec * viol[..., None]
        upd = (-delta * w_i3).scatter_add(1, succ_idx3, delta * w_j3)
        # clash repulsion: each ordered pair (i, j) moves row i by its
        # share; the mirror pair (j, i) moves j
        diff = x[:, :, None, :] - x[:, None, :, :]
        pd = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        cviol = pair_active & (pd < clash_gate)
        push = ((clash_target - pd) / pd)[..., None] * diff
        upd = upd + torch.sum(push * (cviol[..., None] * w_pair[..., None]), dim=2)
        x = x + damping * upd
    return torch.where(gm[..., None], x.to(x0.dtype), x0)
