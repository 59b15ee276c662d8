"""The official DiffAb network in plain PyTorch, on a dict of float32
parameters: its GA encoder and EpsilonNet, a reverse step and the training
loss around them.

Written from the official implementation (Luo et al., NeurIPS 2022,
github.com/luost26/diffab): `diffab/modules/encoders/ga.py` (`GABlock`,
`GAEncoder`) and `diffab/modules/diffusion/dpm_full.py` (`EpsilonNet`).
One GA block, with x (b, L, d), frames (R, t), pair z (b, L, L, dp) and H
heads:

  logits = [q.k / sqrt(C) + W_b z - gamma/2 sqrt(2 / (9 P)) sum_p |Rq + t - Rk - t'|^2]
           * sqrt(1/3); masked pairs - 1e5; softmax over keys; the rows of
           masked queries zeroed
  out    = W_o [sum a z | sum a v | o | |o| | o / (|o| + 1e-4)] + b_o, zeroed
           on masked residues, o the attended value points in the query's
           frame
  x      = LN_1(x + out);  x = LN_2(x + MLP(x))   (LayerNorm eps 1e-10)

The frames and z are the same in every block.  EpsilonNet: the fuse MLP of
the residue context and the current sequence's embedding, the blocks, then
[x | beta, sin beta, cos beta] into three MLP heads: the coordinate noise
in the residue's frame, the rotation of the unit quaternion (1, v) / |(1,
v)| composed after R, and the sequence logits.

What this reference takes from the port's design in place of the official
code's (each listed under "assumed" in the configuration file): the
residue and pair context encoders (`model.encode_context`), the 21-letter
sequence head, |o| as sqrt(|o|^2 + 1e-8), and the rows' frames as
rotation matrices whose rows are the frame axes (a point p is p @ R + t in
the global frame; the official R is this one's transpose).

Parameters are read by their names in the port's state dict, which the
benchmark makes from the seed and hands to both sides.  Every matrix
product goes through `prec` (`precision.Precision`); everything else is
float32.  It imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import data as ref_data
from benchmark.reference.geometry import igso3_rotvec, scale_rot, exp_so3
from benchmark.reference.model import encode_context, lin, to_global, to_local
from benchmark.reference.train import _posterior

CDR_LABELS = {"H1": 1, "H2": 2, "H3": 3, "L1": 4, "L2": 5, "L3": 6}
LN_EPS = 1e-10  # the official LayerNorm's
DIR_EPS = 1e-4  # the official normalize_vector's
MASK_LOGIT = 1e5  # the official _alpha_from_logits' inf


def normalize(s: dict, cdrs) -> dict:
    """One patch's model inputs with the CDRs `cdrs` generated (the
    normalisation of `data.normalize`, whose context is then every residue
    outside these loops)."""
    labels = [CDR_LABELS[c] for c in cdrs]
    res = s["residue_mask"].astype(bool)
    gen = np.isin(s["cdr_idx"], labels) & res
    amask = s["atom_mask"].astype(bool)
    xyz = s["xyz"].astype(np.float32)
    w = (res & ~gen & amask[:, 1]).astype(np.float32)
    center = (xyz[:, 1] * w[:, None]).sum(0) / max(w.sum(), 1.0)
    xyz = xyz - center
    rot = ref_data._pose(xyz[:, 1], w)
    xyz = np.where(amask[..., None], np.einsum("lai,ij->laj", xyz, rot) / ref_data.COORD_SCALE,
                   0.0)
    out = ref_data.normalize(s)
    out.update(xyz=xyz.astype(np.float32), generation_mask=gen,
               orientations=np.einsum("lij,jk->lik", s["orientations"].astype(np.float32),
                                      rot).astype(np.float32))
    return out


def layer_norm(P, name, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * P[name + ".weight"] + P[name + ".bias"]


def ga_block(P, name, c, x, pair, rot, trans, mask, prec):
    """One GA block.  x (b, L, d); pair (bp, L, L, dp) shared by the b / bp
    designs of each target; rot (b, L, 3, 3) with the frame axes as rows."""
    h, ds, pq, pv = (c["n_head"], c["d_scalar_per_head"], c["n_query_point_per_head"],
                     c["n_value_point_per_head"])
    b, L, _ = x.shape
    bp, dp = pair.shape[0], pair.shape[-1]
    n = b // bp
    proj = lambda m, f: lin(P, f"{name}.{m}", x, prec, bias=False).reshape(b, L, h, f)
    q_s, k_s, v_s = proj("to_q_scalar", ds), proj("to_k_scalar", ds), proj("to_v_scalar", ds)
    pts = lambda m, p: to_global(proj(m, p * 3).reshape(b, L, h, p, 3), rot, trans)
    q_p, k_p, v_p = pts("to_q_point", pq), pts("to_k_point", pq), pts("to_v_point", pv)

    heads = lambda t: t.reshape(b, L, h, -1).transpose(1, 2)  # (b, h, L, f)
    qf, kf = heads(q_p), heads(k_p)
    sq_dist = ((qf * qf).sum(-1)[..., :, None] + (kf * kf).sum(-1)[..., None, :]
               - 2.0 * prec.mm(qf, kf.transpose(-1, -2)))
    gamma = F.softplus(P[name + ".gamma"].float())
    node = prec.mm(heads(q_s), heads(k_s).transpose(-1, -2)) / np.sqrt(ds)
    spatial = sq_dist * (-gamma[:, None, None] * np.sqrt(2.0 / (9.0 * pq)) / 2.0)
    bias = lin(P, name + ".to_pair_bias", pair, prec, bias=False).permute(0, 3, 1, 2)
    logit = ((node + spatial).reshape(bp, n, h, L, L) + bias[:, None]).reshape(b, h, L, L)
    logit = logit * np.sqrt(1.0 / 3.0)
    pair_ok = (mask[:, None, :, None] & mask[:, None, None, :])
    attn = torch.softmax(torch.where(pair_ok, logit, logit - MASK_LOGIT), -1)
    attn = torch.where(mask[:, None, :, None], attn, torch.zeros_like(attn))

    a = attn.reshape(bp, n, h, L, L).permute(0, 3, 1, 2, 4).reshape(bp, L, n * h, L)
    p2n = prec.mm(a, pair).reshape(bp, L, n, h * dp).transpose(1, 2).reshape(b, L, h * dp)
    node_f = prec.mm(attn, heads(v_s)).transpose(1, 2).reshape(b, L, h * ds)
    o = to_local(prec.mm(attn, heads(v_p)).transpose(1, 2).reshape(b, L, h, pv, 3), rot, trans)
    dist = torch.sqrt((o * o).sum(-1) + 1e-8)
    direction = o / (dist[..., None] + DIR_EPS)
    feats = torch.cat([p2n, node_f, o.reshape(b, L, -1), dist.reshape(b, L, -1),
                       direction.reshape(b, L, -1)], -1)
    out = lin(P, name + ".to_out", feats, prec)
    out = torch.where(mask[..., None], out, torch.zeros_like(out))
    x = layer_norm(P, name + ".layer_norm_1", x + out)
    y = torch.relu(lin(P, name + ".transition.dense_0", x, prec))
    y = torch.relu(lin(P, name + ".transition.dense_1", y, prec))
    return layer_norm(P, name + ".layer_norm_2", x + lin(P, name + ".transition.dense_2", y, prec))


def quaternion_1ijk(v):
    """The rotation matrix of the unit quaternion (1, v) / |(1, v)| (the
    official quaternion_1ijk_to_rotation_matrix)."""
    s = torch.sqrt(1.0 + (v * v).sum(-1))
    a, b, c, d = 1.0 / s, v[..., 0] / s, v[..., 1] / s, v[..., 2] / s
    o = torch.stack([a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c,
                     2 * b * c + 2 * a * d, a * a - b * b + c * c - d * d, 2 * c * d - 2 * a * b,
                     2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a - b * b - c * c + d * d],
                    -1)
    return o.reshape(v.shape[:-1] + (3, 3))


def denoise(P, c, seq_t, x_t, r_t, res_ctx, pair_ctx, beta, residue_mask, prec):
    """EpsilonNet's prediction: translations_eps (b, L, 3) in the global
    frame, orientations_t0 (b, L, 3, 3), seq_posterior and seq_logits
    (b, L, K).  res_ctx (bc, L, d) repeats over the b / bc designs."""
    p = "denoiser."
    b, L = seq_t.shape
    res_ctx = torch.repeat_interleave(res_ctx, b // res_ctx.shape[0], 0)
    s_emb = F.embedding(seq_t, P[p + "sequence_embedding.weight"])
    x = lin(P, p + "fuse_1", torch.relu(lin(P, p + "fuse_0", torch.cat([res_ctx, s_emb], -1),
                                            prec)), prec)
    for i in range(c["n_ipa_layers"]):
        x = ga_block(P, f"{p}ipa.layer_{i}", c, x, pair_ctx, r_t, x_t, residue_mask, prec)
    t_emb = torch.stack([beta, torch.sin(beta), torch.cos(beta)], -1)[:, None, :].expand(b, L, 3)
    x = torch.cat([x, t_emb], -1)

    def head(name, d_in):
        y = torch.relu(lin(P, f"{p}{name}.dense_0", d_in, prec))
        y = torch.relu(lin(P, f"{p}{name}.dense_1", y, prec))
        return lin(P, f"{p}{name}.dense_2", y, prec)

    eps = (head("coordinate_head", x)[..., None, :] @ r_t)[..., 0, :]
    # R_next = R U in the official (column) frames; U^T R here
    r0 = quaternion_1ijk(head("orientation_head", x)).transpose(-1, -2) @ r_t
    logits = head("sequence_head", x)
    return dict(translations_eps=eps, orientations_t0=r0, seq_logits=logits,
                seq_posterior=torch.softmax(logits, -1))


def denoise_blocks(P, c, seq_t, x_t, r_t, res_ctx, pair_ctx, beta, residue_mask, prec,
                   block: int):
    """`denoise` over the designs in blocks of `block` rows (one target's
    context), so that a block's attention tensors fit."""
    outs = [denoise(P, c, seq_t[i:i + block], x_t[i:i + block], r_t[i:i + block], res_ctx,
                    pair_ctx, beta[i:i + block], residue_mask[i:i + block], prec)
            for i in range(0, seq_t.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def step(P, c, sched, table, job, state, t: int, s: int, noise: dict, prec,
         noise_scale: float = 1.0, block: int = 25):
    """One reverse step t -> s from `state` = (seq, x, R), as
    `sampling.step` takes it with this network's prediction (computed in
    blocks of `block` designs).  Returns the next state and the sequence
    scores whose argmax the step takes."""
    seq_t, x_t, r_t = state
    bn, L = seq_t.shape
    K = c["aa_vocab_size"]
    dev = x_t.device
    tv = torch.full((bn,), t, dtype=torch.long, device=dev)
    sv = torch.full((bn,), s, dtype=torch.long, device=dev)
    out = denoise_blocks(P, c, seq_t, x_t, r_t, job.res_emb, job.pair_emb, sched.beta[tv],
                         job.res_mask, prec, block)
    g = job.gen

    abar_s = sched.alpha_bar[sv][:, None, None]
    beta_ts = 1.0 - sched.alpha_bar[tv][:, None, None] / abar_s
    onehot = F.one_hot(seq_t, K).float()
    p_single = torch.where(g[..., None], (1.0 - beta_ts) * onehot + beta_ts / K, onehot)
    p_prior = torch.where(g[..., None], abar_s * out["seq_posterior"] + (1.0 - abar_s) / K,
                          onehot)
    post = p_single * p_prior
    post = post / post.sum(-1, keepdim=True)
    scores = torch.log(torch.clamp(post, min=1e-20)) + noise["gumbel"]
    seq_s = torch.where(g, scores.argmax(-1), seq_t)

    rotvec = igso3_rotvec(table, sv, noise["axis"], noise["uniform"], noise["normal"])
    r_s = scale_rot(out["orientations_t0"], sched.alpha_bar_sqrt[sv]) @ exp_so3(rotvec)
    r_s = torch.where(g[..., None, None], r_s, r_t)

    one_m = sched.one_minus_alpha_bar_sqrt[tv][:, None, None] ** 2
    abar_t = sched.alpha_bar[tv][:, None, None]
    alpha = abar_t / abar_s
    beta = 1.0 - alpha
    beta_tilde = (1.0 - abar_s) / one_m * beta
    x0 = (x_t - torch.sqrt(one_m) * out["translations_eps"]) / torch.sqrt(abar_t)
    x0 = torch.clamp(x0, -job.x0_clip, job.x0_clip)
    mean = (torch.sqrt(abar_s) * beta * x0 + torch.sqrt(alpha) * (1.0 - abar_s) * x_t) / one_m
    x_s = mean + noise_scale * torch.sqrt(torch.clamp(beta_tilde, min=0.0)) * noise["coord"]
    x_s = torch.where(g[..., None], x_s, x_t)
    return (seq_s, x_s, r_s), scores


def loss(P, c, tc, sched, table, batch, d, prec):
    """The training loss of one batch under draws `d` (`train.loss` with
    this network's prediction); returns (loss, parts)."""
    K = c["aa_vocab_size"]
    gen, res = batch["generation_mask"], batch["residue_mask"]
    t = d["t"]
    p = tc["mode_dropout"]
    s_vis = d["mode_u"] < p
    q_vis = (d["mode_u"] >= p) & (d["mode_u"] < 2.0 * p)
    seq_gen, struct_gen = gen & ~q_vis[:, None], gen & ~s_vis[:, None]

    seq0 = batch["seq_idx"]
    abar = sched.alpha_bar[t][:, None, None]
    oh0 = F.one_hot(seq0, K).float()
    q_t = torch.where(seq_gen[..., None], abar * oh0 + (1.0 - abar) / K, oh0)
    seq_t = torch.where(seq_gen, (torch.log(torch.clamp(q_t, min=1e-20)) + d["gumbel"]).argmax(-1),
                        seq0)
    true_post = _posterior(sched, seq_t, oh0, t, t - 1, seq_gen, K)

    x0 = batch["xyz"][:, :, 1]
    x_t = (sched.alpha_bar_sqrt[t][:, None, None] * x0
           + sched.one_minus_alpha_bar_sqrt[t][:, None, None] * d["coord"])
    x_t = torch.where(struct_gen[..., None], x_t, x0)
    r0 = batch["orientations"]
    rotvec = igso3_rotvec(table, t, d["axis"], d["uniform"], d["normal"])
    r_t = scale_rot(r0, sched.alpha_bar_sqrt[t]) @ exp_so3(rotvec)
    r_t = torch.where(struct_gen[..., None, None], r_t, r0)

    res_emb, pair_emb = encode_context(P, c, batch, prec, structure_visible=s_vis,
                                       sequence_visible=q_vis)
    out = denoise(P, c, seq_t, x_t, r_t, res_emb, pair_emb, sched.beta[t], res, prec)

    mask = (struct_gen & res).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    qmask = (seq_gen & res).float()
    qdenom = torch.clamp(qmask.sum(), min=1.0)
    pred_log = torch.log(torch.clamp(_posterior(sched, seq_t, out["seq_posterior"], t, t - 1,
                                                seq_gen, K), min=1e-12))
    kl = (true_post * (torch.log(torch.clamp(true_post, min=1e-12)) - pred_log)).sum(-1)
    parts = dict(seq_loss=(kl * qmask).sum() / qdenom)
    parts["translations_loss"] = (((out["translations_eps"] - d["coord"]) ** 2).sum(-1)
                                  * mask).sum() / denom
    disc = torch.einsum("...ij,...ik->...jk", out["orientations_t0"], r0)
    orient = 9.0 * ((disc - torch.eye(3, device=disc.device)) ** 2).mean((-1, -2))
    parts["orientations_loss"] = (orient * mask).sum() / denom
    ce = -torch.gather(torch.log_softmax(out["seq_logits"], -1), -1, seq0[..., None])[..., 0]
    parts["seq_ce_loss"] = (ce * qmask).sum() / qdenom
    total = (parts["seq_loss"] + parts["translations_loss"] + parts["orientations_loss"]
             + tc["seq_ce_weight"] * parts["seq_ce_loss"])
    return total, parts
