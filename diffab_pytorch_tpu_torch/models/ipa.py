"""Invariant Point Attention (`diffab_pytorch_tpu/models/ipa.py`).

The layer runs one of the JAX package's two kernel paths:

- `fuse_ipa_layer` None or True (default): one fused-layer call
  (`ops/ipa_fused_layer.py`, K1) computes the projections, frames,
  attention and the scalar/point/norm output slices;
- `fuse_ipa_layer=False`: one concatenated projection matmul and the
  frames in plain PyTorch, the attention core (`ops/ipa_attention.py`, K2),
  then the sliced W_s / W_p / W_n output projection after the inverse
  frames and point norms.

On both, the attended pair rows and their W_pair projection follow as
plain matmuls, target-major before the design-major transpose, then the
to_out bias row is added.

Design fan-out: when the state batch b is n times the pair batch bp, rows
[i n, (i+1) n) are n designs of target i sharing one pair tensor and one
set of bias logits.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.models.layers import Linear
from diffab_pytorch_tpu_torch.ops.ipa_attention import fused_ipa_attention_raw
from diffab_pytorch_tpu_torch.ops.ipa_fused_layer import (
    LayerKernelWeights,
    fused_ipa_layer_packed,
    pack_layer_weights,
)


def frames_apply(points, rot, trans):
    """Local -> global, x @ R + t; points (b, L, ..., 3), rot (b, L, 3, 3),
    trans (b, L, 3)."""
    extra = points.ndim - rot.ndim + 1
    r = rot.reshape(rot.shape[:2] + (1,) * extra + (3, 3))
    t = trans.reshape(trans.shape[:2] + (1,) * extra + (3,))
    return (points[..., 0:1] * r[..., 0, :] + points[..., 1:2] * r[..., 1, :]
            + points[..., 2:3] * r[..., 2, :] + t)


def frames_apply_inverse(points, rot, trans):
    """Global -> local, (x - t) @ R^T."""
    extra = points.ndim - rot.ndim + 1
    r = rot.reshape(rot.shape[:2] + (1,) * extra + (3, 3))
    t = trans.reshape(trans.shape[:2] + (1,) * extra + (3,))
    d = points - t
    return (d[..., 0:1] * r[..., :, 0] + d[..., 1:2] * r[..., :, 1]
            + d[..., 2:3] * r[..., :, 2])


def _pair_rows(attn, pair, n_designs: int):
    """Target-major attended pair rows (bp, L, n, h dp): the n h design and
    head rows of a target share one (j, dp) pair block per row i."""
    _, h, L, _ = attn.shape
    bp, dp = pair.shape[0], pair.shape[-1]
    a = attn.reshape(bp, n_designs, h, L, L).permute(0, 3, 1, 2, 4)
    out = a.reshape(bp, L, n_designs * h, L) @ pair  # (bp, i, n h, dp)
    return out.reshape(bp, L, n_designs, h * dp)


def attended_pair_rows(attn, pair, n_designs: int = 1):
    """Attention-weighted pair rows: attn (b, h, L, L) with b = bp n
    (design-major), pair (bp, L, L, dp) -> (b, L, h dp)."""
    b, _, L, _ = attn.shape
    return _pair_rows(attn, pair, n_designs).transpose(1, 2).reshape(b, L, -1)


class InvariantPointAttentionLayer(nn.Module):
    """One IPA layer; parameter names mirror the flax layer's."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.use_pair_bias or cfg.n_query_point_per_head != cfg.n_value_point_per_head:
            raise NotImplementedError(
                "only the fused layer (pair bias on, equal q/v point counts) "
                "is ported"
            )
        self.cfg = cfg
        dt, d, h = cfg.dtype, cfg.d_residue_emb, cfg.n_head
        ds, p, dp = cfg.d_scalar_per_head, cfg.n_query_point_per_head, cfg.d_pair_emb
        self.to_q_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_k_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_v_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_q_point = Linear(d, h * p * 3, dt, bias=False)
        self.to_k_point = Linear(d, h * p * 3, dt, bias=False)
        self.to_v_point = Linear(d, h * p * 3, dt, bias=False)
        self.to_pair_bias = Linear(dp, h, dt, bias=False)
        self.gamma = nn.Parameter(torch.full((h,), float(torch.log(torch.expm1(torch.tensor(1.0))))))
        self.to_out = Linear(h * ds + h * dp + h * p * 3 + h * p, d, dt)
        self.scale_scalar = ds ** -0.5
        self.scale_point = (4.5 * p) ** -0.5
        self.scale_total = 3 ** -0.5

    def kernel_weights(self) -> tuple[LayerKernelWeights, torch.Tensor, torch.Tensor]:
        """(packed fused-layer weights, W_pair (h dp, d), b_row (d,)) in the
        compute dtype — parameters only, so the sampler computes them once."""
        cfg = self.cfg
        dt, h, ds, dp = cfg.dtype, cfg.n_head, cfg.d_scalar_per_head, cfg.d_pair_emb
        p = cfg.n_value_point_per_head
        gamma = F.softplus(self.gamma.to(dt))
        # to_out rows: [scalar (h ds) | pair (h dp) | points (h p 3) | norms (h p)]
        W_s, W_pair, W_p, W_n = torch.split(
            self.to_out.kernel(dt), [h * ds, h * dp, h * p * 3, h * p])
        packed = pack_layer_weights(
            *(m.kernel(dt) for m in (self.to_q_scalar, self.to_k_scalar,
                                     self.to_v_scalar, self.to_q_point,
                                     self.to_k_point, self.to_v_point)),
            W_s, W_p, W_n, gamma, self.scale_scalar, self.scale_point, dt,
        )
        return packed, W_pair.contiguous(), self.to_out.bias.to(dt)

    def forward(self, x, pair, rot, trans, residue_mask=None, pair_bias=None,
                kernel_weights=None):
        """x (b, L, d), pair (bp, L, L, dp), rot (b, L, 3, 3), trans (b, L, 3),
        residue_mask (b, L), pair_bias (bp, h, L, L) precomputed or None."""
        cfg = self.cfg
        dt = cfg.dtype
        b, L, _ = x.shape
        bp = pair.shape[0]
        if b % bp:
            raise ValueError(f"state batch {b} is not a multiple of pair batch {bp}")
        n_designs = b // bp

        x = x.to(dt)
        if residue_mask is not None:
            # masked residues' frames and features are sanitised: garbage
            # there would otherwise reach every output through 0 * NaN
            m = residue_mask
            eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
            rot = torch.where(m[..., None, None], rot, eye)
            trans = torch.where(m[..., None], trans, torch.zeros((), dtype=trans.dtype, device=trans.device))
            x = torch.where(m[..., None], x, torch.zeros((), dtype=dt, device=x.device))
            mask = residue_mask.to(dt)
        else:
            mask = torch.ones((b, L), dtype=dt, device=x.device)
        if pair_bias is None:
            pair_bias = self.to_pair_bias(pair.to(dt)).permute(0, 3, 1, 2)
        bias = pair_bias.to(dt).contiguous()

        rot, trans = rot.to(dt).contiguous(), trans.to(dt).contiguous()
        if cfg.fuse_ipa_layer is False:
            acc, attn, W_pair, b_row = self._attention_core_path(x, rot, trans, mask, bias)
        else:
            if kernel_weights is None:
                kernel_weights = self.kernel_weights()
            packed, W_pair, b_row = kernel_weights
            acc, attn = fused_ipa_layer_packed(x.contiguous(), rot, trans, mask, packed,
                                               bias, self.scale_total)
        # the pair term is projected to d while still target-major; the
        # design-major transpose then moves a (b, L, d) tensor
        op = _pair_rows(attn, pair.to(dt), n_designs) @ W_pair  # (bp, i, n, d)
        acc = acc + op.transpose(1, 2).reshape(b, L, -1)
        return acc + b_row

    def _attention_core_path(self, x, rot, trans, mask, bias):
        """JAX `models/ipa.py:283-300`: projections and frames, the
        attention core, the sliced output projection.  Returns (acc without
        the pair term and bias row, attn, W_pair, b_row)."""
        cfg = self.cfg
        dt, h, ds, dp = cfg.dtype, cfg.n_head, cfg.d_scalar_per_head, cfg.d_pair_emb
        p = cfg.n_value_point_per_head
        b, L, _ = x.shape
        mods = (self.to_q_scalar, self.to_k_scalar, self.to_v_scalar,
                self.to_q_point, self.to_k_point, self.to_v_point)
        proj = x @ torch.cat([m.kernel(dt) for m in mods], dim=1)
        q_s, k_s, v_s, q_p, k_p, v_p = torch.split(proj, [h * ds] * 3 + [h * p * 3] * 3, dim=-1)
        q_s, k_s, v_s = (t.reshape(b, L, h, ds) for t in (q_s, k_s, v_s))
        q_p, k_p, v_p = (frames_apply(t.reshape(b, L, h, p, 3), rot, trans)
                         for t in (q_p, k_p, v_p))
        gamma = F.softplus(self.gamma.to(dt))
        out_s_t, attn, out_p = fused_ipa_attention_raw(
            q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma, mask,
            self.scale_scalar, self.scale_point, self.scale_total)
        W_s, W_pair, W_p, W_n = torch.split(
            self.to_out.kernel(dt), [h * ds, h * dp, h * p * 3, h * p])
        acc = out_s_t.reshape(b, h * ds, L).transpose(1, 2) @ W_s  # (b, L, d)
        out_p = frames_apply_inverse(out_p, rot, trans)
        nrm = torch.sqrt((out_p * out_p).sum(dim=-1) + 1e-8)
        acc = acc + out_p.reshape(b, L, h * p * 3) @ W_p + nrm.reshape(b, L, h * p) @ W_n
        return acc, attn, W_pair, self.to_out.bias.to(dt)


class InvariantPointAttentionModule(nn.Module):
    """Stack of IPA layers (layer_0, layer_1, ...); pair embedding and
    frames stay fixed, the residue embedding is refined layer to layer."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_ipa_layers):
            self.add_module(f"layer_{i}", InvariantPointAttentionLayer(cfg))

    @property
    def layers(self) -> list[InvariantPointAttentionLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_ipa_layers)]

    def kernel_weights(self) -> list | None:
        """Every layer's packed fused-layer weights, or None when the
        layers run the attention-core path (`fuse_ipa_layer=False`)."""
        if self.cfg.fuse_ipa_layer is False:
            return None
        return [ly.kernel_weights() for ly in self.layers]

    def pair_biases(self, pair_emb) -> list:
        """Every layer's pair-bias logits (bp, h, L, L) in the compute dtype,
        as the JAX stack computes them when none are given: one projection
        of the pair tensor onto the layers' concatenated (d_pair, h)
        kernels."""
        dt, h = self.cfg.dtype, self.cfg.n_head
        w = torch.cat([ly.to_pair_bias.kernel(dt) for ly in self.layers], dim=1)
        logits = (pair_emb.to(dt) @ w).permute(0, 3, 1, 2)
        return [logits[:, i * h:(i + 1) * h].contiguous() for i in range(self.cfg.n_ipa_layers)]

    def forward(self, res_emb, pair_emb, rot, trans, residue_mask=None,
                pair_biases=None, kernel_weights=None):
        for i, ly in enumerate(self.layers):
            res_emb = ly(
                res_emb, pair_emb, rot, trans, residue_mask,
                None if pair_biases is None else pair_biases[i],
                None if kernel_weights is None else kernel_weights[i],
            )
        return res_emb


def precompute_pair_biases(ipa: InvariantPointAttentionModule, pair_emb) -> list:
    """Pair-bias logits (bp, h, L, L) of every layer in float32, computed
    once from the t-independent pair embedding."""
    return [
        torch.einsum("bijd,dh->bhij", pair_emb.float(), ly.to_pair_bias.weight.t().float())
        for ly in ipa.layers
    ]
