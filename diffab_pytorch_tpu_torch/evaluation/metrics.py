"""Design evaluation metrics in torch (`diffab_pytorch_tpu/evaluation/metrics.py`):
recovery, RMSD (unaligned and context-aligned), diversity, rank
correlation and the backbone's stereochemical validity.

  AAR       amino-acid recovery: the share of generated positions whose
            designed residue type is the native one.
  RMSD      C-alpha RMSD of the generated positions against the native;
            `aligned_ca_rmsd` first superposes the design on the native by
            a Kabsch fit over the CONTEXT residues.
  Diversity mean pairwise share of differing residues among the designs
            of one target.

Every function is batched and masked, and runs on the device of its
inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from diffab_pytorch_tpu_torch.constants import CDR
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
from diffab_pytorch_tpu_torch.structure.reconstruct import BACKBONE_LOCAL, IDEAL_PEPTIDE_BOND


def _masked_mean(values, mask):
    m = mask.to(torch.float32)
    return (values * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def amino_acid_recovery(pred_seq, native_seq, mask):
    """Per-sample AAR (b,) over the masked (generated) positions."""
    return _masked_mean((pred_seq == native_seq).to(torch.float32), mask)


def ca_rmsd(pred_xyz, native_xyz, mask, scale: float = 1.0):
    """Per-sample C-alpha RMSD over masked positions, (b,); multiply by
    COORD_SCALE (`data/dataset.py`) for angstroms."""
    sq = torch.sum((pred_xyz - native_xyz) ** 2, dim=-1)
    return torch.sqrt(_masked_mean(sq, mask)) * scale


def kabsch(mobile, target, mask):
    """Weighted least-squares rigid superposition, batched: (rot (b, 3, 3),
    trans (b, 3)) such that `mobile @ rot + trans` minimizes the masked
    RMSD to `target` (row vectors, as x @ O + t everywhere).

    The fit is a proper rotation whatever signs the SVD gives its
    singular vectors: det(U V^T) flips the smallest direction when it is
    -1, and for a degenerate (collinear) cloud any choice the solver makes
    is an optimal rotation."""
    w = mask.to(torch.float32)[..., None]  # (b, L, 1)
    denom = torch.clamp(w.sum(dim=1), min=1.0)  # (b, 1)
    mu_m = (mobile * w).sum(dim=1) / denom  # (b, 3)
    mu_t = (target * w).sum(dim=1) / denom
    pm = (mobile - mu_m[:, None]) * w
    pt = target - mu_t[:, None]
    h = torch.einsum("bli,blj->bij", pm, pt).to(torch.float32)
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(u @ vt)
    flip = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    rot = (u * flip[:, None, :]) @ vt  # u diag(flip) vt; x @ rot
    trans = mu_t - torch.einsum("bi,bij->bj", mu_m, rot)
    return rot, trans


def aligned_ca_rmsd(pred_xyz, native_xyz, rmsd_mask, align_mask, scale: float = 1.0):
    """Superpose pred on native by a Kabsch fit over `align_mask`
    positions, then the C-alpha RMSD over `rmsd_mask` positions, (b,)."""
    rot, trans = kabsch(pred_xyz, native_xyz, align_mask)
    moved = torch.einsum("bli,bij->blj", pred_xyz, rot) + trans[:, None]
    return ca_rmsd(moved, native_xyz, rmsd_mask, scale=scale)


def sequence_diversity(seqs, mask):
    """Mean pairwise share of differing residues among the n designs of one
    target, seqs (n, L), mask (L,) or (n, L); a 0-dim tensor."""
    n = seqs.shape[0]
    m = mask.to(torch.float32)
    if m.ndim == 1:
        m = m[None].expand(seqs.shape)
    diff = (seqs[:, None, :] != seqs[None, :, :]).to(torch.float32)
    pair_m = m[:, None, :] * m[None, :, :]
    per_pair = (diff * pair_m).sum(-1) / torch.clamp(pair_m.sum(-1), min=1.0)
    off_diag = 1.0 - torch.eye(n, device=seqs.device)
    return (per_pair * off_diag).sum() / torch.clamp(off_diag.sum(), min=1.0)


def spearman_corr(a, b):
    """Spearman rank correlation of two (n,) vectors; a 0-dim tensor.  Ties
    get distinct ranks in order of position (a stable double argsort)."""
    def rank(x):
        return torch.argsort(torch.argsort(x, stable=True), stable=True).to(torch.float32)

    ra, rb = rank(a), rank(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = torch.sqrt(torch.sum(ra * ra) * torch.sum(rb * rb))
    return torch.sum(ra * rb) / torch.clamp(denom, min=1e-12)


# Stereochemical validity of a designed loop: peptide-bond lengths across
# the loop and its anchors, CA-CA chain continuity, and CA clashes of the
# design with everything else.  Bond tolerance: 12 sigma of the Engh &
# Huber ideal (AlphaFold2's violation threshold); the CA-CA window admits
# cis-peptides (~2.95 A).
IDEAL_C_N = IDEAL_PEPTIDE_BOND  # C(i)-N(i+1), 1.329 A
IDEAL_CA_CA = 3.80  # trans-peptide CA(i)-CA(i+1)
BOND_TOL = 0.25
CA_CA_RANGE = (2.70, 4.30)
CLASH_DIST = 3.0  # non-bonded CA pairs closer than this clash


def chain_graph(residue_mask, chain_idx, residue_idx):
    """(same_chain, dseq) of a patch: same_chain[b, i, j] for two valid
    residues of one chain, dseq[b, i, j] = residue_idx[j] - residue_idx[i].
    Adjacency comes from these, not from row order: patch rows are
    nearest-residue selections."""
    rm = residue_mask.to(torch.bool)
    same_chain = (chain_idx[:, :, None] == chain_idx[:, None, :]) & (
        rm[:, :, None] & rm[:, None, :])
    return same_chain, residue_idx[:, None, :] - residue_idx[:, :, None]


def _pdist(a, b):
    d = a[:, :, None, :] - b[:, None, :, :]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def backbone_validity(n_xyz, ca_xyz, c_xyz, residue_mask, chain_idx, residue_idx,
                      gen_mask, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Stereochemistry of the designed loop and its anchor bonds, per
    sample; coordinates (b, L, 3), times `scale` for angstroms.  Only edges
    touching a designed residue are scored.

    Returns (b,) tensors:
      bond_viol     designed-edge peptide bonds with |C-N - 1.329| > 0.25 A
      bond_max_dev  the worst designed-edge |C-N - 1.329| (A)
      ca_break      designed-edge CA-CA distances outside [2.7, 4.3] A
      clash_count   non-bonded CA pairs (a designed residue against
                    anything; another chain or sequence separation > 1)
                    closer than 3 A
      valid         all three counts zero
    """
    f32 = torch.float32
    n_xyz = n_xyz.to(f32) * scale
    ca_xyz = ca_xyz.to(f32) * scale
    c_xyz = c_xyz.to(f32) * scale
    rm = residue_mask.to(torch.bool)
    gm = gen_mask.to(torch.bool) & rm
    same_chain, dseq = chain_graph(rm, chain_idx, residue_idx)
    succ = same_chain & (dseq == 1)  # j is i's chain successor
    designed_edge = succ & (gm[:, :, None] | gm[:, None, :])

    bond_dev = torch.abs(_pdist(c_xyz, n_xyz) - IDEAL_C_N)  # C(i) to N(j)
    bond_viol = torch.sum((bond_dev > BOND_TOL) & designed_edge, dim=(1, 2))
    bond_max_dev = torch.amax(
        torch.where(designed_edge, bond_dev, torch.zeros((), device=bond_dev.device)),
        dim=(1, 2))

    ca_d = _pdist(ca_xyz, ca_xyz)
    ca_bad = (ca_d < CA_CA_RANGE[0]) | (ca_d > CA_CA_RANGE[1])
    ca_break = torch.sum(ca_bad & designed_edge, dim=(1, 2))

    bonded_or_self = same_chain & (torch.abs(dseq) <= 1)
    nonbonded = (rm[:, :, None] & rm[:, None, :]) & ~bonded_or_self
    design_pair = nonbonded & (gm[:, :, None] | gm[:, None, :])
    clash = torch.sum((ca_d < CLASH_DIST) & design_pair, dim=(1, 2)) // 2

    valid = (bond_viol == 0) & (ca_break == 0) & (clash == 0)
    return {
        "bond_viol": bond_viol,
        "bond_max_dev": bond_max_dev,
        "ca_break": ca_break,
        "clash_count": clash,
        "valid": valid,
    }


def validity_from_result(result: SampleResult, batch: ProteinBatch,
                         coord_scale: float = 1.0, idealize: bool = False,
                         relax: bool = False) -> Dict[str, torch.Tensor]:
    """`backbone_validity` of a sampler output: N and C placed from the
    designed frames with ideal in-frame geometry, as the design PDBs are
    written.  idealize=True first snaps the designed-edge peptide bonds
    (N moved onto 1.329 A along the existing direction); relax=True first
    runs `relax_ca`.  Both together are the sample CLI's post-processing."""
    o = result.orientations.to(torch.float32)  # (b, L, 3, 3), rows = axes
    t = result.translations.to(torch.float32)
    if relax:
        from diffab_pytorch_tpu_torch.structure.relax import relax_ca

        t = relax_ca(t, batch.residue_mask, batch.chain_idx, batch.residue_idx,
                     batch.generation_mask, coord_scale=coord_scale)
    local = torch.as_tensor(BACKBONE_LOCAL, dtype=torch.float32, device=t.device) / coord_scale
    n_xyz = torch.einsum("i,blij->blj", local[0], o) + t
    c_xyz = torch.einsum("i,blij->blj", local[2], o) + t
    rm = batch.residue_mask.to(torch.bool)
    gm = batch.generation_mask.to(torch.bool) & rm
    if idealize:
        same_chain, dseq = chain_graph(rm, batch.chain_idx, batch.residue_idx)
        edge = same_chain & (dseq == 1) & (gm[:, :, None] | gm[:, None, :])
        # each j has at most one predecessor: the sum selects its C
        c_pred = torch.einsum("bij,bik->bjk", edge.to(torch.float32), c_xyz)
        has_pred = edge.any(dim=1)
        d = n_xyz - c_pred
        d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)
        n_ideal = c_pred + d * (IDEAL_C_N / coord_scale)
        n_xyz = torch.where(has_pred[..., None], n_ideal, n_xyz)
    return backbone_validity(n_xyz, t, c_xyz, batch.residue_mask, batch.chain_idx,
                             batch.residue_idx, gm, scale=coord_scale)


def evaluate_designs(result: SampleResult, batch: ProteinBatch, coord_scale: float = 1.0,
                     cdr_idx: Optional[torch.Tensor] = None, align: bool = False,
                     cdrs: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """The design metrics of a sampler output against its input batch (the
    same rows).  cdr_idx (b, L), the patch's per-residue CDR labels, adds a
    per-CDR breakdown (aar_H3, ca_rmsd_H3, ...) for the CDR names `cdrs`,
    or (None) for every CDR present in the generation mask.  align=True
    scores RMSD after a Kabsch fit on the context residues."""
    gen = batch.generation_mask & batch.residue_mask
    ctx = batch.residue_mask & ~batch.generation_mask

    def rmsd_fn(mask):
        if align:
            return aligned_ca_rmsd(result.translations, batch.translations, mask, ctx,
                                   scale=coord_scale)
        return ca_rmsd(result.translations, batch.translations, mask, scale=coord_scale)

    out = {
        "aar": amino_acid_recovery(result.seq_idx, batch.seq_idx, gen),
        "ca_rmsd": rmsd_fn(gen),
    }
    out.update(validity_from_result(result, batch, coord_scale=coord_scale))
    if cdr_idx is not None:
        for name, code in CDR.__members__.items():
            if code == CDR.NONE:
                continue
            cdr_mask = gen & (cdr_idx == int(code))
            if (name not in cdrs) if cdrs is not None else not bool(cdr_mask.any()):
                continue
            out[f"aar_{name}"] = amino_acid_recovery(result.seq_idx, batch.seq_idx, cdr_mask)
            out[f"ca_rmsd_{name}"] = rmsd_fn(cdr_mask)
    return out
