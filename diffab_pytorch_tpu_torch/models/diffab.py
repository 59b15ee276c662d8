"""The DiffAb model: context encoding + denoising
(`diffab_pytorch_tpu/models/diffab.py`).

Context-conditioning modes (generate_structure, generate_sequence):
(True, True) codesign, (True, False) fix-sequence, (False, True)
fix-structure, (False, False) everything visible.  A modality that is not
generated is visible context for every valid residue.  Training's mode
dropout sets the same per sample through `structure_visible` /
`sequence_visible` (b,).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffab_pytorch_tpu_torch.config import ModelConfig, resolve_device
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.models.denoiser import Denoiser
from diffab_pytorch_tpu_torch.models.embedding import PairEmbedding, ResidueEmbedding
from diffab_pytorch_tpu_torch.models.ipa import precompute_pair_biases


class DiffAbModel(nn.Module):
    """Parameter names mirror the flax DiffAbModel tree, so a JAX parameter
    tree loads by name (`weights.load_jax_params`)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.residue_context_embedding = ResidueEmbedding(cfg)
        self.pair_context_embedding = PairEmbedding(cfg)
        self.denoiser = Denoiser(cfg)
        self.to(resolve_device(device))

    def encode_context(self, batch: ProteinBatch, generate_structure: bool = True,
                       generate_sequence: bool = True, structure_visible=None,
                       sequence_visible=None):
        """(res_context_emb (b, L, d), pair_context_emb (b, L, L, d_pair)) from
        the t0 features; t-independent.  structure_visible / sequence_visible
        (b,) bool, where given, override the flags per sample."""
        context_mask = batch.residue_mask & ~batch.generation_mask

        def ctx(flag, visible):
            if visible is not None:
                return torch.where(visible[:, None], batch.residue_mask, context_mask)
            return context_mask if flag else batch.residue_mask

        structure_ctx = ctx(generate_structure, structure_visible)
        sequence_ctx = ctx(generate_sequence, sequence_visible)
        res_emb = self.residue_context_embedding(
            batch.seq_idx, batch.xyz, batch.orientations,
            batch.backbone_dihedrals, batch.chain_idx, batch.atom_mask,
            structure_context_mask=structure_ctx,
            sequence_context_mask=sequence_ctx,
            dihedrals_mask=batch.backbone_dihedrals_mask,
        )
        pair_emb = self.pair_context_embedding(
            batch.seq_idx, batch.xyz, batch.pairwise_dihedrals,
            batch.residue_idx, batch.chain_idx, batch.atom_mask,
            structure_context_mask=structure_ctx,
            sequence_context_mask=sequence_ctx,
        )
        return res_emb, pair_emb

    def denoise(self, seq_idx_t, translations_t, orientations_t, res_context_emb,
                pair_context_emb, beta, generation_mask, residue_mask,
                pair_biases=None, kernel_weights=None, sc_translations_x0=None,
                sc_seq_probs=None, sc_mask=None, geo_pair_biases=None,
                geo_kernel_weights=None):
        """One denoising prediction at timestep t.  pair_biases: per-layer
        precomputed bias logits; kernel_weights: per-layer packed fused-layer
        weights (`denoiser.ipa.kernel_weights()`), both t-independent;
        geo_pair_biases / geo_kernel_weights: the same for `geo_ipa`
        (`denoiser.geo_ipa.pair_biases(pair)`, `.kernel_weights()`).
        sc_*: the previous clean-state estimate (x0_hat (b, L, 3), p(s_0)
        (b, L, K), sc_mask (b,) or (b, L)), gated to generation_mask."""
        return self.denoiser(
            seq_idx_t, translations_t, orientations_t, res_context_emb,
            pair_context_emb, beta, residue_mask=residue_mask,
            pair_biases=pair_biases, kernel_weights=kernel_weights,
            generation_mask=generation_mask, sc_translations_x0=sc_translations_x0,
            sc_seq_probs=sc_seq_probs, sc_mask=sc_mask, geo_pair_biases=geo_pair_biases,
            geo_kernel_weights=geo_kernel_weights,
        )

    def forward(self, batch: ProteinBatch, seq_idx_t, translations_t, orientations_t,
                beta, generate_structure: bool = True, generate_sequence: bool = True,
                structure_visible=None, sequence_visible=None, sc_translations_x0=None,
                sc_seq_probs=None, sc_mask=None, self_condition=None):
        """Encode the context, then denoise (the training forward, JAX
        `DiffAbModel.__call__`); the layers project their own pair biases.

        self_condition (a self-conditioned model's training pass, JAX
        `DiffAb.loss_fn`): a function from the first pass's outputs to the
        second pass's sc_* arguments.  The context is encoded once and the
        pair biases projected once; the first pass runs without gradients
        and the second with them."""
        res_emb, pair_emb = self.encode_context(
            batch, generate_structure, generate_sequence,
            structure_visible=structure_visible, sequence_visible=sequence_visible)
        args = (seq_idx_t, translations_t, orientations_t, res_emb, pair_emb, beta,
                batch.generation_mask, batch.residue_mask)
        if self_condition is None:
            return self.denoise(*args, sc_translations_x0=sc_translations_x0,
                                sc_seq_probs=sc_seq_probs, sc_mask=sc_mask)
        hoisted = dict(pair_biases=precompute_pair_biases(self.denoiser.ipa, pair_emb))
        if self.cfg.sc_split_trunk:
            hoisted["geo_pair_biases"] = self.denoiser.geo_ipa.pair_biases(pair_emb)
        with torch.no_grad():
            first = self.denoise(*args, **hoisted)
        return self.denoise(*args, **hoisted, **self_condition(first))
