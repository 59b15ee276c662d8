"""The per-step denoising network (`diffab_pytorch_tpu/models/denoiser.py`):
covariant coordinate and orientation heads, softplus on gamma, and the
three self-conditioning variants.

Outputs: translations_eps (b, L, 3) in the global frame, orientations_t0
(b, L, 3, 3) = exp(v_hat) @ R_t, seq_posterior (b, L, K) = predicted
p(s_0), and seq_logits.

Self-conditioning (`ModelConfig.self_conditioning`): the previous step's
clean-state estimate enters as 3 + K + 1 features per residue (K = 0 with
self_conditioning_sequence off): x0_hat in the residue's noisy frame,
saturated by 10 tanh(x / 10), the predicted p(s_0), and a validity flag,
all gated by generation_mask x sc_mask; zeros when no estimate is given.
They enter the fuse MLP (early fusion, the default), the coordinate and
orientation heads after the trunk (`sc_late_fusion`), or a second fuse
MLP and IPA stack `geo_ipa` whose output the geometry heads read
(`sc_split_trunk`).  In the last two the sequence head reads a trunk
computed from the context alone.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.geometry import so3
from diffab_pytorch_tpu_torch.models.encoding import beta_encode
from diffab_pytorch_tpu_torch.models.ipa import InvariantPointAttentionModule, frames_apply_inverse
from diffab_pytorch_tpu_torch.models.layers import Embedding, Linear, MLPHead


def sc_feature_width(cfg: ModelConfig) -> int:
    """Width of the self-conditioning features: displacement, p(s_0), flag."""
    return 3 + (cfg.aa_vocab_size if cfg.self_conditioning_sequence else 0) + 1


class Denoiser(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.sc_late_fusion and not cfg.self_conditioning:
            raise ValueError("sc_late_fusion requires self_conditioning")
        if cfg.sc_split_trunk and not cfg.self_conditioning:
            raise ValueError("sc_split_trunk requires self_conditioning")
        if cfg.sc_split_trunk and cfg.sc_late_fusion:
            raise ValueError("sc_split_trunk and sc_late_fusion are mutually exclusive")
        self.cfg = cfg
        dt, d = cfg.dtype, cfg.d_residue_emb
        sc_w = sc_feature_width(cfg) if cfg.self_conditioning else 0
        early = cfg.self_conditioning and not (cfg.sc_late_fusion or cfg.sc_split_trunk)
        self.sequence_embedding = Embedding(cfg.aa_vocab_size, d, dt)
        self.fuse_0 = Linear(2 * d + (sc_w if early else 0), d, dt)
        self.fuse_1 = Linear(d, d, dt)
        self.ipa = InvariantPointAttentionModule(cfg)
        if cfg.sc_split_trunk:
            self.geo_fuse_0 = Linear(2 * d + sc_w, d, dt)
            self.geo_fuse_1 = Linear(d, d, dt)
            self.geo_ipa = InvariantPointAttentionModule(cfg)
        geo_in = d + 3 + (sc_w if cfg.sc_late_fusion else 0)
        self.coordinate_head = MLPHead(geo_in, d, 3, dt)
        self.orientation_head = MLPHead(geo_in, d, 3, dt)
        self.sequence_head = MLPHead(d + 3, d, cfg.aa_vocab_size, dt)

    def sc_features(self, translations_t, orientations_t, generation_mask,
                    sc_translations_x0, sc_seq_probs, sc_mask):
        """(b, L, 3 + K + 1) features of the estimate in the compute dtype;
        zeros when none is given.  sc_mask (b,) or (b, L) marks a real
        estimate."""
        cfg, f32 = self.cfg, torch.float32
        b, L = translations_t.shape[:2]
        if sc_translations_x0 is None:
            return torch.zeros((b, L, sc_feature_width(cfg)), dtype=cfg.dtype,
                               device=translations_t.device)
        gate = (torch.ones((b, L), dtype=f32, device=translations_t.device)
                if generation_mask is None else generation_mask.to(f32))
        if sc_mask is not None:
            m = sc_mask.to(f32)
            gate = gate * (m if m.ndim == 2 else m[:, None])
        gate = gate[..., None]
        # the estimate in the residue's noisy frame, rotation invariant;
        # saturated, since x0_hat at high t divides by sqrt(abar_t) ~ 1e-3
        local = frames_apply_inverse(sc_translations_x0.to(f32), orientations_t.to(f32),
                                     translations_t.to(f32))
        pieces = [10.0 * torch.tanh(local / 10.0) * gate]
        if cfg.self_conditioning_sequence:
            pieces.append(sc_seq_probs.to(f32) * gate)
        pieces.append(gate)
        return torch.cat(pieces, dim=-1).to(cfg.dtype)

    def forward(self, seq_idx_t, translations_t, orientations_t, res_context_emb,
                pair_context_emb, beta, residue_mask=None, pair_biases=None,
                kernel_weights=None, generation_mask=None, sc_translations_x0=None,
                sc_seq_probs=None, sc_mask=None, geo_pair_biases=None,
                geo_kernel_weights=None) -> Dict[str, torch.Tensor]:
        """pair_biases / kernel_weights: `ipa`'s hoisted bias logits and packed
        weights; geo_pair_biases / geo_kernel_weights: `geo_ipa`'s
        (sc_split_trunk).  generation_mask gates the self-conditioning
        features."""
        cfg = self.cfg
        dt = cfg.dtype
        f32 = torch.float32
        if not cfg.self_conditioning and sc_translations_x0 is not None:
            raise ValueError("sc_* inputs given but ModelConfig.self_conditioning is off")
        if sc_translations_x0 is not None and sc_seq_probs is None:
            raise ValueError("sc_translations_x0 requires sc_seq_probs")
        b, L = seq_idx_t.shape
        bc = res_context_emb.shape[0]
        if bc != b:
            # design fan-out: the residue context broadcasts over each
            # target's n designs; the pair tensor stays at bp
            if b % bc:
                raise ValueError(f"state batch {b} is not a multiple of context batch {bc}")
            res_context_emb = torch.repeat_interleave(res_context_emb, b // bc, dim=0)
        s_emb = self.sequence_embedding(seq_idx_t)
        parts = [res_context_emb.to(dt), s_emb]
        sc_feats = None
        if cfg.self_conditioning:
            sc_feats = self.sc_features(translations_t, orientations_t, generation_mask,
                                        sc_translations_x0, sc_seq_probs, sc_mask)
            if not (cfg.sc_late_fusion or cfg.sc_split_trunk):
                parts.append(sc_feats)
        res = self.fuse_1(torch.relu(self.fuse_0(torch.cat(parts, dim=-1))))

        res = self.ipa(res, pair_context_emb, orientations_t, translations_t,
                       residue_mask, pair_biases=pair_biases,
                       kernel_weights=kernel_weights)

        t_emb = beta_encode(beta.to(dt))[:, None, :].expand(b, L, 3)
        res = torch.cat([res, t_emb], dim=-1)
        res_geo = res
        if cfg.sc_late_fusion:
            res_geo = torch.cat([res, sc_feats], dim=-1)
        elif cfg.sc_split_trunk:
            g = torch.cat([res_context_emb.to(dt), s_emb, sc_feats], dim=-1)
            g = self.geo_fuse_1(torch.relu(self.geo_fuse_0(g)))
            if geo_pair_biases is None:
                geo_pair_biases = self.geo_ipa.pair_biases(pair_context_emb)
            g = self.geo_ipa(g, pair_context_emb, orientations_t, translations_t,
                             residue_mask, pair_biases=geo_pair_biases,
                             kernel_weights=geo_kernel_weights)
            res_geo = torch.cat([g, t_emb], dim=-1)

        # the invariant head's noise is rotated into the global frame by the
        # residue's current orientation (rows are the frame axes)
        eps_local = self.coordinate_head(res_geo)
        r = orientations_t.to(dt)
        translations_eps = (eps_local[..., 0:1] * r[..., 0, :]
                            + eps_local[..., 1:2] * r[..., 1, :]
                            + eps_local[..., 2:3] * r[..., 2, :])

        v_eps = self.orientation_head(res_geo)
        o_eps = so3.vector_to_rotation_matrix(v_eps.to(f32))
        orientations_t0 = so3.compose(o_eps, orientations_t.to(f32))

        seq_logits = self.sequence_head(res).to(f32)
        return {
            "translations_eps": translations_eps.to(f32),
            "orientations_t0": orientations_t0,
            "seq_posterior": torch.softmax(seq_logits, dim=-1),
            "seq_logits": seq_logits,
        }
