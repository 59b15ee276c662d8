"""The DiffAb network in plain PyTorch, on a dict of float32 parameters.

Context encoders (residue and pair embeddings), the denoiser (fuse MLP,
the stack of invariant point attention layers with the pair bias, the
coordinate, orientation and sequence heads), written from the DiffAb
paper (Luo et al., NeurIPS 2022) and the widths of a configuration file.
Parameters are read by their names in the port's state dict, which the
benchmark makes from the seed and hands to both sides.  Every matrix
product goes through `prec` (`precision.Precision`); everything else is
float32.  It imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.geometry import exp_so3

UNK = 20  # the unknown residue type, last of the 21
CA = 1  # the C-alpha slot of the 15 atoms


def lin(P, name, x, prec, bias=True):
    return prec.linear(x, P[name + ".weight"], P.get(name + ".bias") if bias else None)


def angular(x, n_funcs):
    """[x, sin(f x), cos(f x)] for f in 1..n, 1, 1/2, .., 1/n, per input."""
    bands = torch.arange(1, n_funcs + 1, dtype=torch.float64, device=x.device)
    f = torch.cat([bands, 1.0 / bands]).float()
    fx = x[..., None] * f
    return torch.cat([x[..., None], torch.sin(fx), torch.cos(fx)], -1).reshape(*x.shape[:-1], -1)


def residue_embedding(P, c, batch, seq_ctx, struct_ctx, prec):
    p = "residue_context_embedding."
    V = c["aa_vocab_size"]
    seq = torch.where(seq_ctx, batch["seq_idx"], torch.full_like(batch["seq_idx"], UNK))
    aa = F.embedding(seq, P[p + "aa_type_embedding.weight"])
    xyz, rot = batch["xyz"], batch["orientations"]
    rel = xyz - xyz[:, :, CA:CA + 1]
    local = torch.einsum("blai,blji->blaj", rel, rot)  # rows of rot are the frame axes
    local = torch.where(batch["atom_mask"][..., None], local, torch.zeros_like(local))
    coord = F.one_hot(seq, V).float()[..., None, None] * local[:, :, None]
    coord = coord.reshape(*seq.shape, -1) * struct_ctx[..., None].float()
    dih = angular(batch["backbone_dihedrals"], c["n_residue_dihedral_funcs"])
    per = dih.shape[-1] // 3
    dih = dih * torch.repeat_interleave(batch["backbone_dihedrals_mask"].float(), per, -1)
    pad = torch.zeros_like(struct_ctx[:, :1])
    window = (struct_ctx & torch.cat([pad, struct_ctx[:, :-1]], 1)
              & torch.cat([struct_ctx[:, 1:], pad], 1))
    dih = dih * window[..., None].float()
    chain = F.embedding(batch["chain_idx"], P[p + "chain_embedding.weight"])
    chain = chain * (batch["chain_idx"] > 0)[..., None].float()
    x = torch.cat([aa, coord, dih, chain], -1)
    for i in range(4):
        x = lin(P, f"{p}mlp_{i}", x, prec)
        if i < 3:
            x = torch.relu(x)
    return x


def _dihedral(p0, p1, p2, p3):
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-8)
    v = b0 - (b0 * b1).sum(-1, keepdim=True) * b1
    w = b2 - (b2 * b1).sum(-1, keepdim=True) * b1
    y = (torch.cross(torch.broadcast_to(b1, v.shape), v, dim=-1) * w).sum(-1)
    return torch.atan2(y, (v * w).sum(-1))


def pair_embedding(P, c, batch, seq_ctx, struct_ctx, prec):
    p = "pair_context_embedding."
    V, md = c["aa_vocab_size"], c["max_dist_to_consider"]
    seq = torch.where(seq_ctx, batch["seq_idx"], torch.full_like(batch["seq_idx"], UNK))
    pair_type = seq[:, :, None] * V + seq[:, None, :]
    aa = F.embedding(pair_type, P[p + "aa_pair_embedding.weight"])
    ridx, cidx = batch["residue_idx"], batch["chain_idx"]
    relpos = torch.clamp(ridx[:, :, None] - ridx[:, None, :], -md, md) + md
    same = (cidx[:, :, None] == cidx[:, None, :]) & (cidx > 0)[:, :, None]
    rel = F.embedding(relpos, P[p + "relpos_embedding.weight"]) * same[..., None].float()

    k = c["dist_atoms"] or c["n_atoms"]
    xyz, amask = batch["xyz"][:, :, :k], batch["atom_mask"][:, :, :k]
    b, L = seq.shape
    flat = xyz.reshape(b, L * k, 3)
    sq = (flat * flat).sum(-1)
    d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * prec.mm(flat, flat.transpose(1, 2)),
                     min=0.0)
    d2 = d2.reshape(b, L, k, L, k).permute(0, 1, 3, 2, 4).reshape(b, L, L, k * k)
    am = (amask[:, :, None, :, None] & amask[:, None, :, None, :]).reshape(b, L, L, k * k)
    d2 = torch.where(am, d2, torch.zeros_like(d2))
    width = F.softplus(F.embedding(pair_type, P[p + "pair2distcoef.weight"]))
    dist = torch.exp(-width * d2) * am.float()
    dist = torch.relu(lin(P, p + "distance_mlp_0", dist, prec))
    dist = torch.relu(lin(P, p + "distance_mlp_1", dist, prec))

    bb = batch["atom_mask"][:, :, 0] & batch["atom_mask"][:, :, 1] & batch["atom_mask"][:, :, 2]
    n, ca, cc = batch["xyz"][:, :, 0], batch["xyz"][:, :, 1], batch["xyz"][:, :, 2]
    bi, bj = (lambda t: t[:, :, None]), (lambda t: t[:, None])
    dih = torch.stack([_dihedral(bi(cc), bj(n), bj(ca), bj(cc)),
                       _dihedral(bi(n), bi(ca), bi(cc), bj(n))], -1)
    dih = torch.where((bb[:, :, None] & bb[:, None, :])[..., None], dih, torch.zeros_like(dih))
    dih = angular(dih, c["n_pair_dihedral_funcs"])
    ctx = (struct_ctx[:, :, None] & struct_ctx[:, None, :])[..., None].float()
    x = torch.cat([aa, rel, dist * ctx, dih * ctx], -1)
    x = torch.relu(lin(P, p + "mlp_0", x, prec))
    x = torch.relu(lin(P, p + "mlp_1", x, prec))
    x = lin(P, p + "mlp_2", x, prec)
    ca_ok = batch["atom_mask"][:, :, CA]
    return x * (ca_ok[:, :, None] & ca_ok[:, None, :])[..., None].float()


def encode_context(P, c, batch, prec, structure_visible=None, sequence_visible=None):
    """(residue (b, L, d), pair (b, L, L, dp)) context embeddings.  By
    default both modalities are generated (codesign); *_visible (b,) make
    the generated residues visible for that modality."""
    ctx = batch["residue_mask"] & ~batch["generation_mask"]
    pick = lambda vis: ctx if vis is None else torch.where(vis[:, None], batch["residue_mask"], ctx)
    s_ctx, q_ctx = pick(structure_visible), pick(sequence_visible)
    return (residue_embedding(P, c, batch, q_ctx, s_ctx, prec),
            pair_embedding(P, c, batch, q_ctx, s_ctx, prec))


def to_global(pts, rot, trans):
    """Local points (b, L, ..., 3) -> global: p @ R + t."""
    extra = pts.ndim - rot.ndim + 1
    r = rot.reshape(rot.shape[:2] + (1,) * extra + (3, 3))
    t = trans.reshape(trans.shape[:2] + (1,) * extra + (3,))
    return (pts[..., None, :] @ r)[..., 0, :] + t


def to_local(pts, rot, trans):
    """Global points -> local: (p - t) @ R^T."""
    extra = pts.ndim - rot.ndim + 1
    r = rot.reshape(rot.shape[:2] + (1,) * extra + (3, 3))
    t = trans.reshape(trans.shape[:2] + (1,) * extra + (3,))
    return ((pts - t)[..., None, :] @ r.transpose(-1, -2))[..., 0, :]


def ipa_layer(P, name, c, x, pair, rot, trans, mask, prec):
    """One invariant point attention layer with the pair bias.  x (b, L, d);
    pair (bp, L, L, dp) shared by the b / bp designs of each target."""
    h, ds, pq, pv = c["n_head"], c["d_scalar_per_head"], c["n_query_point_per_head"], \
        c["n_value_point_per_head"]
    b, L, _ = x.shape
    bp, dp = pair.shape[0], pair.shape[-1]
    n = b // bp
    eye = torch.eye(3, device=x.device)
    rot = torch.where(mask[..., None, None], rot, eye)
    trans = torch.where(mask[..., None], trans, torch.zeros_like(trans))
    x = torch.where(mask[..., None], x, torch.zeros_like(x))
    proj = lambda m, f: lin(P, f"{name}.{m}", x, prec, bias=False).reshape(b, L, h, f)
    q_s, k_s, v_s = proj("to_q_scalar", ds), proj("to_k_scalar", ds), proj("to_v_scalar", ds)
    pts = lambda m, p: to_global(proj(m, p * 3).reshape(b, L, h, p, 3), rot, trans)
    q_p, k_p, v_p = pts("to_q_point", pq), pts("to_k_point", pq), pts("to_v_point", pv)

    heads = lambda t: t.reshape(b, L, h, -1).transpose(1, 2)  # (b, h, L, f)
    qf, kf = heads(q_p), heads(k_p)
    sq_dist = ((qf * qf).sum(-1)[..., :, None] + (kf * kf).sum(-1)[..., None, :]
               - 2.0 * prec.mm(qf, kf.transpose(-1, -2)))
    gamma = F.softplus(P[name + ".gamma"].float())
    logit = prec.mm(heads(q_s), heads(k_s).transpose(-1, -2)) * ds ** -0.5
    logit = logit - 0.5 * (4.5 * pq) ** -0.5 * gamma[:, None, None] * sq_dist
    bias = lin(P, name + ".to_pair_bias", pair, prec, bias=False).permute(0, 3, 1, 2)
    logit = (logit.reshape(bp, n, h, L, L) + bias[:, None]).reshape(b, h, L, L) * 3 ** -0.5
    logit = torch.where(mask[:, None, None, :], logit, torch.full_like(logit, -1e9))
    attn = torch.softmax(logit, -1)

    o_s = prec.mm(attn, heads(v_s)).transpose(1, 2).reshape(b, L, h * ds)
    a = attn.reshape(bp, n, h, L, L).permute(0, 3, 1, 2, 4).reshape(bp, L, n * h, L)
    o_pair = prec.mm(a, pair).reshape(bp, L, n, h * dp).transpose(1, 2).reshape(b, L, h * dp)
    o_p = prec.mm(attn, heads(v_p)).transpose(1, 2).reshape(b, L, h, pv, 3)
    o_p = to_local(o_p, rot, trans)
    norm = torch.sqrt((o_p * o_p).sum(-1) + 1e-8)
    feats = torch.cat([o_s, o_pair, o_p.reshape(b, L, -1), norm.reshape(b, L, -1)], -1)
    return lin(P, name + ".to_out", feats, prec)


def denoise(P, c, seq_t, x_t, r_t, res_ctx, pair_ctx, beta, residue_mask, prec):
    """One denoiser prediction: translations_eps (b, L, 3) in the global
    frame, orientations_t0 (b, L, 3, 3), seq_posterior and seq_logits
    (b, L, K).  res_ctx (bc, L, d) repeats over the b / bc designs."""
    p = "denoiser."
    b, L = seq_t.shape
    res_ctx = torch.repeat_interleave(res_ctx, b // res_ctx.shape[0], 0)
    s_emb = F.embedding(seq_t, P[p + "sequence_embedding.weight"])
    x = lin(P, p + "fuse_1", torch.relu(lin(P, p + "fuse_0", torch.cat([res_ctx, s_emb], -1),
                                            prec)), prec)
    for i in range(c["n_ipa_layers"]):
        x = ipa_layer(P, f"{p}ipa.layer_{i}", c, x, pair_ctx, r_t, x_t, residue_mask, prec)
    t_emb = torch.stack([beta, torch.sin(beta), torch.cos(beta)], -1)[:, None, :].expand(b, L, 3)
    x = torch.cat([x, t_emb], -1)

    def head(name, d_in):
        y = torch.relu(lin(P, f"{p}{name}.dense_0", d_in, prec))
        y = torch.relu(lin(P, f"{p}{name}.dense_1", y, prec))
        return lin(P, f"{p}{name}.dense_2", y, prec)

    eps = (head("coordinate_head", x)[..., None, :] @ r_t)[..., 0, :]
    r0 = exp_so3(head("orientation_head", x)) @ r_t
    logits = head("sequence_head", x)
    return dict(translations_eps=eps, orientations_t0=r0, seq_logits=logits,
                seq_posterior=torch.softmax(logits, -1))
