"""The per-step denoising network (`diffab_pytorch_tpu/models/denoiser.py`),
default configuration: covariant coordinate and orientation heads,
softplus on gamma, no self-conditioning.

Outputs: translations_eps (b, L, 3) in the global frame, orientations_t0
(b, L, 3, 3) = exp(v_hat) @ R_t, seq_posterior (b, L, K) = predicted
p(s_0), and seq_logits.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.geometry import so3
from diffab_pytorch_tpu_torch.models.encoding import beta_encode
from diffab_pytorch_tpu_torch.models.ipa import InvariantPointAttentionModule
from diffab_pytorch_tpu_torch.models.layers import Embedding, Linear, MLPHead


class Denoiser(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.self_conditioning:
            raise NotImplementedError("self-conditioning is not ported yet")
        self.cfg = cfg
        dt, d = cfg.dtype, cfg.d_residue_emb
        self.sequence_embedding = Embedding(cfg.aa_vocab_size, d, dt)
        self.fuse_0 = Linear(2 * d, d, dt)
        self.fuse_1 = Linear(d, d, dt)
        self.ipa = InvariantPointAttentionModule(cfg)
        self.coordinate_head = MLPHead(d + 3, d, 3, dt)
        self.orientation_head = MLPHead(d + 3, d, 3, dt)
        self.sequence_head = MLPHead(d + 3, d, cfg.aa_vocab_size, dt)

    def forward(self, seq_idx_t, translations_t, orientations_t, res_context_emb,
                pair_context_emb, beta, residue_mask=None, pair_biases=None,
                kernel_weights=None) -> Dict[str, torch.Tensor]:
        dt = self.cfg.dtype
        f32 = torch.float32
        b, L = seq_idx_t.shape
        bc = res_context_emb.shape[0]
        if bc != b:
            # design fan-out: the residue context broadcasts over each
            # target's n designs; the pair tensor stays at bp
            if b % bc:
                raise ValueError(f"state batch {b} is not a multiple of context batch {bc}")
            res_context_emb = torch.repeat_interleave(res_context_emb, b // bc, dim=0)
        s_emb = self.sequence_embedding(seq_idx_t)
        res = torch.cat([res_context_emb.to(dt), s_emb], dim=-1)
        res = self.fuse_1(torch.relu(self.fuse_0(res)))

        res = self.ipa(res, pair_context_emb, orientations_t, translations_t,
                       residue_mask, pair_biases=pair_biases,
                       kernel_weights=kernel_weights)

        t_emb = beta_encode(beta.to(dt))[:, None, :].expand(b, L, 3)
        res = torch.cat([res, t_emb], dim=-1)

        # the invariant head's noise is rotated into the global frame by the
        # residue's current orientation (rows are the frame axes)
        eps_local = self.coordinate_head(res)
        r = orientations_t.to(dt)
        translations_eps = (eps_local[..., 0:1] * r[..., 0, :]
                            + eps_local[..., 1:2] * r[..., 1, :]
                            + eps_local[..., 2:3] * r[..., 2, :])

        v_eps = self.orientation_head(res)
        o_eps = so3.vector_to_rotation_matrix(v_eps.to(f32))
        orientations_t0 = so3.compose(o_eps, orientations_t.to(f32))

        seq_logits = self.sequence_head(res).to(f32)
        return {
            "translations_eps": translations_eps.to(f32),
            "orientations_t0": orientations_t0,
            "seq_posterior": torch.softmax(seq_logits, dim=-1),
            "seq_logits": seq_logits,
        }
