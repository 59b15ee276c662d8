"""Context encoders: per-residue and per-pair embeddings
(`diffab_pytorch_tpu/models/embedding.py`).

The pair-rank tables are plain gathers here; the JAX package's one-hot
contractions and split first pair-MLP layer are exact re-groupings of the
same arithmetic for the TPU.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.constants import AA, ATOM
from diffab_pytorch_tpu_torch.models.encoding import angular_encode, angular_encoding_dim
from diffab_pytorch_tpu_torch.models.layers import Embedding, Linear


def _mask_sequence_to_unk(seq_idx, sequence_context_mask):
    """Outside the sequence context, residue identity is hidden as UNK."""
    if sequence_context_mask is None:
        return seq_idx
    return torch.where(sequence_context_mask, seq_idx,
                       torch.full_like(seq_idx, int(AA.UNK)))


class ResidueEmbedding(nn.Module):
    """Per-residue context features -> d vector: amino-acid type, local-frame
    atom coordinates scattered by type, dihedral encoding masked to the
    {i-1, i, i+1} structure-context window, chain id; 4-layer ReLU MLP."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt, V, d = cfg.dtype, cfg.aa_vocab_size, cfg.d_residue_emb
        d_in = (d + V * cfg.n_atoms * 3
                + angular_encoding_dim(3, cfg.n_residue_dihedral_funcs) + d)
        self.aa_type_embedding = Embedding(V, d, dt)
        self.chain_embedding = Embedding(cfg.max_n_chains, d, dt)
        self.mlp_0 = Linear(d_in, 2 * d, dt)
        self.mlp_1 = Linear(2 * d, d, dt)
        self.mlp_2 = Linear(d, d, dt)
        self.mlp_3 = Linear(d, d, dt)

    def forward(self, seq_idx, xyz, orientations, dihedrals, chain_idx,
                atom_mask, structure_context_mask=None,
                sequence_context_mask=None, dihedrals_mask=None):
        cfg = self.cfg
        dt, V = cfg.dtype, cfg.aa_vocab_size
        seq_idx = _mask_sequence_to_unk(seq_idx, sequence_context_mask)
        aa_feat = self.aa_type_embedding(seq_idx)

        # local[a, j] = sum_i rel[a, i] O[j, i]: orientation rows are the
        # frame axes in global coordinates
        rel = (xyz - xyz[:, :, ATOM.CA:ATOM.CA + 1, :]).to(dt)
        o = orientations.to(dt)[:, :, None, :, :]
        local = (rel[..., 0:1] * o[..., :, 0] + rel[..., 1:2] * o[..., :, 1]
                 + rel[..., 2:3] * o[..., :, 2])
        # where, not multiply: garbage in masked atom slots must not leak
        local = torch.where(atom_mask[..., None], local, torch.zeros((), dtype=dt, device=local.device))
        onehot = F.one_hot(seq_idx, V).to(dt)
        coord_feat = onehot[..., None, None] * local[:, :, None, :, :]
        coord_feat = coord_feat.reshape(*seq_idx.shape, V * cfg.n_atoms * 3)
        if structure_context_mask is not None:
            coord_feat = coord_feat * structure_context_mask[..., None].to(dt)

        dihedral_feat = angular_encode(dihedrals.to(dt), cfg.n_residue_dihedral_funcs)
        if dihedrals_mask is not None:
            enc_mask = torch.repeat_interleave(
                dihedrals_mask.to(dt),
                dihedral_feat.shape[-1] // dihedrals.shape[-1], dim=-1)
            dihedral_feat = dihedral_feat * enc_mask
        if structure_context_mask is not None:
            m = structure_context_mask
            pad = torch.zeros_like(m[:, :1])
            left = torch.cat([pad, m[:, :-1]], dim=1)
            right = torch.cat([m[:, 1:], pad], dim=1)
            dihedral_feat = dihedral_feat * (m & left & right)[..., None].to(dt)

        chain_feat = self.chain_embedding(chain_idx) * (chain_idx > 0)[..., None].to(dt)

        x = torch.cat([aa_feat, coord_feat, dihedral_feat, chain_feat], dim=-1)
        x = torch.relu(self.mlp_0(x))
        x = torch.relu(self.mlp_1(x))
        x = torch.relu(self.mlp_2(x))
        return self.mlp_3(x)


def pairwise_dihedrals_from_xyz(xyz: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inter-residue (phi-like, psi-like) dihedrals (b, L, L, 2):
    phi[i, j] = dihedral(C_i, N_j, CA_j, C_j),
    psi[i, j] = dihedral(N_i, CA_i, C_i, N_j)."""
    if dtype is not None:
        xyz = xyz.to(dtype)
    n, ca, c = xyz[:, :, 0], xyz[:, :, 1], xyz[:, :, 2]

    def dihedral(p0, p1, p2, p3):
        b0 = p0 - p1
        b1 = p2 - p1
        b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-8)
        b2 = p3 - p2
        v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
        w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1
        x = torch.sum(v * w, dim=-1)
        y = torch.sum(torch.cross(torch.broadcast_to(b1, v.shape), v, dim=-1) * w, dim=-1)
        return torch.atan2(y, x)

    bi = lambda t: t[:, :, None, :]
    bj = lambda t: t[:, None, :, :]
    phi = dihedral(bi(c), bj(n), bj(ca), bj(c))
    psi = dihedral(bi(n), bi(ca), bi(c), bj(n))
    return torch.stack([phi, psi], dim=-1)


def pairwise_sq_distances(xyz: torch.Tensor, dtype=None) -> torch.Tensor:
    """All-atom inter-residue squared distances (b, L, L, A, A) by the
    |x|^2 + |y|^2 - 2 x.y expansion (coordinates must be centred)."""
    b, L, A, _ = xyz.shape
    x = xyz.reshape(b, L * A, 3)
    if dtype is not None:
        x = x.to(dtype)
    sq = torch.sum(x * x, dim=-1)
    cross = x @ x.transpose(1, 2)
    d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)
    return d2.reshape(b, L, A, L, A).permute(0, 1, 3, 2, 4)


class PairEmbedding(nn.Module):
    """Per-pair context features -> (b, L, L, d_pair): amino-acid pair type,
    clamped same-chain relative position, learned-width distance kernel
    through a 2-layer MLP, inter-residue dihedral encoding; 3-layer MLP,
    gated by CA validity."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt, V, d = cfg.dtype, cfg.aa_vocab_size, cfg.d_pair_emb
        k_at = cfg.dist_atoms or cfg.n_atoms
        self.aa_pair_embedding = Embedding(V * V, d, dt)
        self.relpos_embedding = Embedding(2 * cfg.max_dist_to_consider + 1, d, dt)
        self.pair2distcoef = Embedding(V * V, k_at * k_at, dt)
        self.distance_mlp_0 = Linear(k_at * k_at, d, dt)
        self.distance_mlp_1 = Linear(d, d, dt)
        d_in = 3 * d + angular_encoding_dim(2, cfg.n_pair_dihedral_funcs)
        self.mlp_0 = Linear(d_in, d, dt)
        self.mlp_1 = Linear(d, d, dt)
        self.mlp_2 = Linear(d, d, dt)

    def forward(self, seq_idx, xyz, pairwise_dihedrals, residue_idx, chain_idx,
                atom_mask, structure_context_mask=None,
                sequence_context_mask=None):
        cfg = self.cfg
        dt, V = cfg.dtype, cfg.aa_vocab_size
        seq_idx = _mask_sequence_to_unk(seq_idx, sequence_context_mask)
        seq_pair = seq_idx[:, :, None] * V + seq_idx[:, None, :]

        pair_feat = self.aa_pair_embedding(seq_pair)

        mdist = cfg.max_dist_to_consider
        relpos = torch.clamp(residue_idx[:, :, None] - residue_idx[:, None, :],
                             -mdist, mdist)
        same_chain = ((chain_idx[:, :, None] == chain_idx[:, None, :])
                      & (chain_idx > 0)[:, :, None])
        relpos_feat = self.relpos_embedding(relpos + mdist) * same_chain[..., None].to(dt)

        k_at = cfg.dist_atoms or cfg.n_atoms
        d_xyz, d_amask = xyz[:, :, :k_at], atom_mask[:, :, :k_at]
        coef = F.softplus(self.pair2distcoef(seq_pair))
        d2 = pairwise_sq_distances(d_xyz, dtype=dt).reshape(*seq_pair.shape, k_at * k_at)
        atom_pair_mask = (d_amask[:, :, None, :, None]
                          & d_amask[:, None, :, None, :]).reshape(*seq_pair.shape, k_at * k_at)
        d2 = torch.where(atom_pair_mask, d2, torch.zeros((), dtype=d2.dtype, device=d2.device))
        dist_kernel = torch.exp(-coef * d2) * atom_pair_mask.to(dt)
        dist_feat = torch.relu(self.distance_mlp_0(dist_kernel))
        dist_feat = torch.relu(self.distance_mlp_1(dist_feat))

        if pairwise_dihedrals is None:
            bb_ok = atom_mask[:, :, 0] & atom_mask[:, :, 1] & atom_mask[:, :, 2]
            pair_ok = bb_ok[:, :, None] & bb_ok[:, None, :]
            derived = pairwise_dihedrals_from_xyz(xyz, dtype=dt)
            pairwise_dihedrals = torch.where(pair_ok[..., None], derived,
                                             torch.zeros((), dtype=dt, device=xyz.device))
        dihedral_feat = angular_encode(pairwise_dihedrals.to(dt), cfg.n_pair_dihedral_funcs)

        if structure_context_mask is not None:
            pair_ctx = (structure_context_mask[:, :, None]
                        & structure_context_mask[:, None, :])[..., None].to(dt)
            dist_feat = dist_feat * pair_ctx
            dihedral_feat = dihedral_feat * pair_ctx

        x = torch.cat([pair_feat, relpos_feat, dist_feat, dihedral_feat], dim=-1)
        x = torch.relu(self.mlp_0(x))
        x = torch.relu(self.mlp_1(x))
        x = self.mlp_2(x)
        ca_valid = atom_mask[:, :, ATOM.CA]
        pair_valid = ca_valid[:, :, None] & ca_valid[:, None, :]
        return x * pair_valid[..., None].to(dt)
