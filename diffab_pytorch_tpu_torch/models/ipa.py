"""Invariant Point Attention (`diffab_pytorch_tpu/models/ipa.py`).

Where the kernels' preconditions hold (pair bias on, as many query as
value points: the JAX layer's `use_pair_bias and pq == pv`), the layer
runs one of the JAX package's two kernel paths:

- `fuse_ipa_layer` None or True (default): one fused-layer call
  (`ops/ipa_fused_layer.py`, K1) computes the projections, frames,
  attention and the scalar/point/norm output slices;
- `fuse_ipa_layer=False`: one concatenated projection matmul and the
  frames in plain PyTorch, the attention core (`ops/ipa_attention.py`, K2),
  then the sliced W_s / W_p / W_n output projection after the inverse
  frames and point norms.

On both, the attended pair rows and their W_pair projection follow as
plain matmuls, target-major before the design-major transpose, then the
to_out bias row is added.  Elsewhere (no pair bias, or pq != pv) the layer
is the JAX layer's XLA branch in plain PyTorch: logits from the scalar
and point terms (and the pair bias when on) over sqrt(3) or sqrt(2), the
softmax, the weighted sums, one to_out over the concatenated features.

Design fan-out: when the state batch b is n times the pair batch bp, rows
[i n, (i+1) n) are n designs of target i sharing one pair tensor and one
set of bias logits.

Tensor parallelism (`heads`, a `parallel.mesh.HeadShard`): a layer built
for one tp rank holds its h / tp heads' parameters (`param_sharding`: the
projections' columns, its heads' slice of each of to_out's four row
blocks) and the whole gamma and to_out bias.  Every branch runs on those
heads (K1, K2 or the plain branch at h / tp); the layer's input enters
through `copy_to_tp_region` (its gradient summed over tp, as is gamma's,
of which the rank reads its heads' slice), the partial output (b, L, d) is
summed over tp by `reduce_from_tp_region`, and the bias row is added once,
after the sum.

The official DiffAb block (`ModelConfig.ipa_block="ga"`, its
`modules/encoders/ga.py GABlock`): the layer's output is zeroed on masked
residues, then x <- LN_1(x + out) and x <- LN_2(x + MLP(x)), the MLP
Linear-ReLU-Linear-ReLU-Linear at width d; to_out's row blocks come in the
official order [pair | scalar | points | norms | directions]: each head's
value points also give their unit directions o / (|o| + 1e-4) (|o| the
point norm above), on every branch; K1 writes them from its epilogue.  Each GA block books `ga.blocks` to the
port's counters (through a graph's tally when captured), and its
residual, LayerNorms and MLP run in the span `ga.transition`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.models.layers import LayerNorm, Linear, MLPHead
from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.ops.ipa_attention import fused_ipa_attention_raw
from diffab_pytorch_tpu_torch.ops.ipa_fused_layer import (
    DIR_EPS,
    LayerKernelWeights,
    fused_ipa_layer_packed,
    pack_layer_weights,
)
from diffab_pytorch_tpu_torch.parallel.mesh import (
    HeadShard,
    copy_to_tp_region,
    reduce_from_tp_region,
)
from diffab_pytorch_tpu_torch.utils.profiling import span


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
    """One IPA layer; parameter names mirror the flax layer's.  With
    `heads`, one tp rank's part of it (the module docstring)."""

    def __init__(self, cfg: ModelConfig, heads: HeadShard | None = None):
        super().__init__()
        self.cfg = cfg
        self.heads = heads
        h_all = cfg.n_head
        self.n_head = h = h_all if heads is None else h_all // heads.size
        if heads is not None:
            heads.heads(h_all)  # raises unless tp divides the heads
        dt, d = cfg.dtype, cfg.d_residue_emb
        ds, dp = cfg.d_scalar_per_head, cfg.d_pair_emb
        pq, pv = cfg.n_query_point_per_head, cfg.n_value_point_per_head
        # the kernels take the layer only where JAX's does (models/ipa.py:237)
        self.use_kernel = cfg.use_pair_bias and pq == pv
        self.to_q_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_k_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_v_scalar = Linear(d, h * ds, dt, bias=False)
        self.to_q_point = Linear(d, h * pq * 3, dt, bias=False)
        self.to_k_point = Linear(d, h * pq * 3, dt, bias=False)
        self.to_v_point = Linear(d, h * pv * 3, dt, bias=False)
        if cfg.use_pair_bias:
            self.to_pair_bias = Linear(dp, h, dt, bias=False)
        self.gamma = nn.Parameter(
            torch.full((h_all,), float(torch.log(torch.expm1(torch.tensor(1.0))))))
        self.ga = cfg.ipa_block == "ga"
        self.to_out = Linear(sum(n for _, n in self.out_layout()), d, dt)
        if self.ga:
            self.layer_norm_1 = LayerNorm(d, dt)
            self.transition = MLPHead(d, d, d, dt)
            self.layer_norm_2 = LayerNorm(d, dt)
        self.scale_scalar = ds ** -0.5
        self.scale_point = (4.5 * pq) ** -0.5
        self.scale_total = (3 if cfg.use_pair_bias else 2) ** -0.5

    def out_layout(self) -> list:
        """to_out's input row blocks in order, (name, rows): [scalar | pair |
        points | norms], the GA block's [pair | scalar | points | norms], and
        [directions] last in the GA block (no pair block without the pair
        bias)."""
        cfg, h = self.cfg, self.n_head
        pv = cfg.n_value_point_per_head
        pair = [("pair", h * cfg.d_pair_emb)] if cfg.use_pair_bias else []
        scalar = [("scalar", h * cfg.d_scalar_per_head)]
        rows = (pair + scalar if self.ga else scalar + pair) + [("points", h * pv * 3),
                                                                ("norms", h * pv)]
        return rows + ([("dirs", h * pv * 3)] if self.ga else [])

    def out_blocks(self, dtype: torch.dtype) -> dict:
        """to_out's (in, d) kernel in `dtype`, split into the blocks of
        `out_layout`."""
        names, sizes = zip(*self.out_layout())
        return dict(zip(names, torch.split(self.to_out.kernel(dtype), list(sizes))))

    def softplus_gamma(self) -> torch.Tensor:
        """softplus(gamma) of the layer's heads, in the compute dtype."""
        g = self.gamma
        if self.heads is not None:
            g = copy_to_tp_region(g, self.heads)[self.heads.heads(self.cfg.n_head)]
        return F.softplus(g.to(self.cfg.dtype))

    def kernel_weights(self) -> tuple[LayerKernelWeights, torch.Tensor, torch.Tensor]:
        """(packed fused-layer weights, W_pair (h dp, d), b_row (d,)) in the
        compute dtype — parameters only, so the sampler computes them once."""
        cfg = self.cfg
        dt = cfg.dtype
        gamma = self.softplus_gamma()
        W = self.out_blocks(dt)
        packed = pack_layer_weights(
            *(m.kernel(dt) for m in (self.to_q_scalar, self.to_k_scalar,
                                     self.to_v_scalar, self.to_q_point,
                                     self.to_k_point, self.to_v_point)),
            W["scalar"], W["points"], W["norms"], gamma, self.scale_scalar,
            self.scale_point, dt, w_od=W.get("dirs"),
        )
        return packed, W["pair"].contiguous(), self.to_out.bias.to(dt)

    def forward(self, x, pair, rot, trans, residue_mask=None, pair_bias=None,
                kernel_weights=None):
        """x (b, L, d), pair (bp, L, L, dp), rot (b, L, 3, 3), trans (b, L, 3),
        residue_mask (b, L), pair_bias (bp, h, L, L) precomputed (the
        layer's h heads) or None."""
        cfg = self.cfg
        x_in = x
        x = copy_to_tp_region(x, self.heads)
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
        if pair_bias is None and cfg.use_pair_bias:
            pair_bias = self.to_pair_bias(pair.to(dt)).permute(0, 3, 1, 2)
        rot, trans = rot.to(dt).contiguous(), trans.to(dt).contiguous()
        if not self.use_kernel:
            acc = self._plain_path(x, pair, rot, trans, residue_mask, pair_bias, n_designs)
            out = reduce_from_tp_region(acc, self.heads) + self.to_out.bias.to(dt)
            return self._block(x_in, out, residue_mask)
        bias = pair_bias.to(dt).contiguous()
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
        return self._block(x_in, reduce_from_tp_region(acc, self.heads) + b_row, residue_mask)

    def _block(self, x, out, residue_mask):
        """The layer's output `out` (b, L, d): as it is, or in a GA block the
        residual, LayerNorm and transition around it from the input x."""
        if not self.ga:
            return out
        _build.count("ga.blocks")
        with span("ga.transition"):
            if residue_mask is not None:
                out = torch.where(residue_mask[..., None], out,
                                  torch.zeros((), dtype=out.dtype, device=out.device))
            x = self.layer_norm_1(x.to(out.dtype) + out)
            return self.layer_norm_2(x + self.transition(x))

    def _plain_path(self, x, pair, rot, trans, residue_mask, pair_bias, n_designs):
        """JAX `models/ipa.py:312-389`, the layer without the kernels'
        preconditions: separate query and value point counts, the pair
        term only when use_pair_bias.  Returns the layer's output without
        the bias row."""
        cfg = self.cfg
        dt, h, ds = cfg.dtype, self.n_head, cfg.d_scalar_per_head
        pq, pv = cfg.n_query_point_per_head, cfg.n_value_point_per_head
        b, L, _ = x.shape
        mods = (self.to_q_scalar, self.to_k_scalar, self.to_v_scalar,
                self.to_q_point, self.to_k_point, self.to_v_point)
        proj = x @ torch.cat([m.kernel(dt) for m in mods], dim=1)
        q_s, k_s, v_s, q_p, k_p, v_p = torch.split(
            proj, [h * ds] * 3 + [h * pq * 3] * 2 + [h * pv * 3], dim=-1)
        # (b, h, L, features): the head batched beside the design
        heads = lambda t, f: t.reshape(b, L, h, f).transpose(1, 2)
        q_p, k_p, v_p = (frames_apply(t.reshape(b, L, h, n, 3), rot, trans)
                         for t, n in ((q_p, pq), (k_p, pq), (v_p, pv)))
        qf, kf = heads(q_p, pq * 3), heads(k_p, pq * 3)
        # |q_i - k_j|^2 through its expansion, as the JAX branch computes it
        sq_dist = ((qf * qf).sum(-1)[..., :, None] + (kf * kf).sum(-1)[..., None, :]
                   - 2.0 * qf @ kf.transpose(-1, -2))
        gamma = self.softplus_gamma()
        logit = (heads(q_s, ds) @ heads(k_s, ds).transpose(-1, -2)) * self.scale_scalar
        logit = logit - 0.5 * self.scale_point * gamma[:, None, None] * sq_dist
        if cfg.use_pair_bias:
            # one bias per target, broadcast over its designs
            bp = pair.shape[0]
            logit = (logit.reshape(bp, n_designs, h, L, L)
                     + pair_bias.to(dt)[:, None]).reshape(b, h, L, L)
        logit = logit * self.scale_total
        if residue_mask is not None:
            logit = torch.where(residue_mask[:, None, None, :], logit, -1e9)
        attn = torch.softmax(logit, dim=-1)
        feats = {"scalar": (attn @ heads(v_s, ds)).transpose(1, 2).reshape(b, L, h * ds)}
        if cfg.use_pair_bias:
            feats["pair"] = attended_pair_rows(attn, pair.to(dt), n_designs)
        out_p = (attn @ heads(v_p, pv * 3)).transpose(1, 2).reshape(b, L, h, pv, 3)
        feats.update(self._point_features(frames_apply_inverse(out_p, rot, trans)))
        outs = [feats[name] for name, _ in self.out_layout()]
        return F.linear(torch.cat(outs, dim=-1), self.to_out.weight.to(dt))

    def _point_features(self, out_p) -> dict:
        """The points' features from the local value points (b, L, h, P, 3):
        "points", "norms" and, in the GA block, "dirs", each (b, L, -1)."""
        b, L = out_p.shape[:2]
        nrm = torch.sqrt((out_p * out_p).sum(dim=-1) + 1e-8)
        out = {"points": out_p.reshape(b, L, -1), "norms": nrm.reshape(b, L, -1)}
        if self.ga:
            out["dirs"] = (out_p / (nrm[..., None] + DIR_EPS)).reshape(b, L, -1)
        return out

    def _attention_core_path(self, x, rot, trans, mask, bias):
        """JAX `models/ipa.py:283-300`: projections and frames, the
        attention core, the sliced output projection.  Returns (acc without
        the pair term and bias row, attn, W_pair, b_row)."""
        cfg = self.cfg
        dt, h, ds = cfg.dtype, self.n_head, cfg.d_scalar_per_head
        p = cfg.n_value_point_per_head
        b, L, _ = x.shape
        mods = (self.to_q_scalar, self.to_k_scalar, self.to_v_scalar,
                self.to_q_point, self.to_k_point, self.to_v_point)
        proj = x @ torch.cat([m.kernel(dt) for m in mods], dim=1)
        q_s, k_s, v_s, q_p, k_p, v_p = torch.split(proj, [h * ds] * 3 + [h * p * 3] * 3, dim=-1)
        q_s, k_s, v_s = (t.reshape(b, L, h, ds) for t in (q_s, k_s, v_s))
        q_p, k_p, v_p = (frames_apply(t.reshape(b, L, h, p, 3), rot, trans)
                         for t in (q_p, k_p, v_p))
        gamma = self.softplus_gamma()
        out_s_t, attn, out_p = fused_ipa_attention_raw(
            q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma, mask,
            self.scale_scalar, self.scale_point, self.scale_total)
        W = self.out_blocks(dt)
        acc = out_s_t.reshape(b, h * ds, L).transpose(1, 2) @ W["scalar"]  # (b, L, d)
        for name, f in self._point_features(frames_apply_inverse(out_p, rot, trans)).items():
            acc = acc + f @ W[name]
        return acc, attn, W["pair"], self.to_out.bias.to(dt)


class InvariantPointAttentionModule(nn.Module):
    """Stack of IPA layers (layer_0, layer_1, ...); pair embedding and
    frames stay fixed, the residue embedding is refined layer to layer.
    With `heads`, every layer is one tp rank's part."""

    def __init__(self, cfg: ModelConfig, heads: HeadShard | None = None):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_ipa_layers):
            self.add_module(f"layer_{i}", InvariantPointAttentionLayer(cfg, heads))

    @property
    def layers(self) -> list[InvariantPointAttentionLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_ipa_layers)]

    def kernel_weights(self) -> list | None:
        """Every layer's packed fused-layer weights, or None when the
        layers run the attention-core path (`fuse_ipa_layer=False`) or no
        kernel at all."""
        if self.cfg.fuse_ipa_layer is False or not self.layers[0].use_kernel:
            return None
        return [ly.kernel_weights() for ly in self.layers]

    def pair_biases(self, pair_emb) -> list:
        """Every layer's pair-bias logits (bp, h, L, L) of its h heads in the
        compute dtype, as the JAX stack computes them when none are given:
        one projection of the pair tensor onto the layers' concatenated
        (d_pair, h) kernels.  Without the pair bias, None for every layer."""
        dt, h = self.cfg.dtype, self.layers[0].n_head
        if not self.cfg.use_pair_bias:
            return [None] * self.cfg.n_ipa_layers
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
    """Pair-bias logits (bp, h, L, L) of every layer's h heads in float32,
    computed once from the t-independent pair embedding (None for every
    layer without the pair bias)."""
    if not ipa.cfg.use_pair_bias:
        return [None] * ipa.cfg.n_ipa_layers
    return [
        torch.einsum("bijd,dh->bhij", pair_emb.float(), ly.to_pair_bias.weight.t().float())
        for ly in ipa.layers
    ]
