"""Work counted from shapes: operations and bytes, the card's peaks, bounds.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at 700 W: 989
TFLOP/s in bfloat16; float32 products run as 3xTF32 (three TF32 products
for each, the fastest float32-exact route on the card), a third of 494.7
TFLOP/s; 3.35 TB/s of HBM3.

Model FLOPs count each matrix product as 2 m n k: the dense layers, the
attention's logits and weighted sums, the pair-row reduction and the
pairwise-distance product.  Element-wise work is left out.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, n_bytes: float, dtype: str) -> float:
    """The least time the card could take: operations or bytes at peak."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES)


def ipa_layer_flops_bytes(b, bp, L, d, h, ds, p, itemsize, bias_itemsize):
    """Operations and compulsory bytes of one fused IPA-layer call (K1):
    each input read once, each output written once."""
    fq = h * (ds + 3 * p)
    flops = b * (
        2 * L * d * 3 * fq  # Q/K/V projections
        + 2 * h * L * L * (ds + 3 * p + 3)  # augmented logits
        + 2 * h * L * L * (ds + 3 * p)  # weighted sums
        + 2 * L * d * h * (ds + 4 * p)  # output projections
    )
    n_bytes = (
        b * L * d * itemsize * 2  # x in, acc out
        + b * h * L * L * itemsize  # attn out
        + bp * h * L * L * bias_itemsize  # bias
        + (d * 3 * fq + h * (ds + 4 * p) * d) * itemsize  # weights
        + b * L * 13 * itemsize + h * 4  # rot, trans, mask, g
    )
    return flops, n_bytes


def _dims(c: dict) -> dict:
    return dict(V=c["aa_vocab_size"], d=c["d_residue_emb"], dp=c["d_pair_emb"],
                k=c["dist_atoms"] or c["n_atoms"], h=c["n_head"], ds=c["d_scalar_per_head"],
                pq=c["n_query_point_per_head"], pv=c["n_value_point_per_head"],
                n_layers=c["n_ipa_layers"])


def context_flops(c: dict, bp: int, L: int) -> float:
    """The residue and pair context encoders over bp targets: the atoms in
    each residue's frame, the two MLPs, the pairwise-distance product."""
    m = _dims(c)
    d, dp, k, V = m["d"], m["dp"], m["k"], m["V"]
    res_in = d + V * c["n_atoms"] * 3 + 3 * (4 * c["n_residue_dihedral_funcs"] + 1) + d
    res = 18 * L * c["n_atoms"] + 2 * L * (res_in * 2 * d + 2 * d * d + d * d + d * d)
    pair_in = 3 * dp + 2 * (4 * c["n_pair_dihedral_funcs"] + 1)
    pair = (2 * (L * k) ** 2 * 3 + 2 * L * L * (k * k * dp + dp * dp)
            + 2 * L * L * (pair_in * dp + 2 * dp * dp))
    return bp * (res + pair)


def pair_bias_flops(c: dict, bp: int, L: int) -> float:
    """One layer's pair-bias logits from the pair tensor, for every layer."""
    m = _dims(c)
    return m["n_layers"] * 2 * bp * L * L * m["dp"] * m["h"]


def denoiser_flops(c: dict, b: int, bp: int, L: int, pair_bias: bool = True) -> float:
    """One denoiser call on b designs of bp targets: the fuse MLP, every
    IPA layer (projections, the points' frames, logits, the weighted sums
    of values, points and pair rows, the output projection), the three
    heads and the frames of their outputs.  pair_bias: the layers project
    their own pair biases (False: the caller hoisted them)."""
    m = _dims(c)
    d, dp, h, ds, pq, pv, V = m["d"], m["dp"], m["h"], m["ds"], m["pq"], m["pv"], m["V"]
    bl, bhll = b * L, b * h * L * L
    layer = (2 * bl * d * h * (3 * ds + 6 * pq + 3 * pv)  # projections
             + 18 * bl * h * (2 * pq + 2 * pv)  # points to and from the frames
             + 2 * bhll * (3 * pq + ds)  # logits
             + 2 * bhll * (ds + dp + 3 * pv)  # weighted sums
             + 2 * bl * h * (ds + dp + 4 * pv) * d)  # output projection
    if pair_bias:
        layer += 2 * bp * L * L * dp * h
    fuse = 2 * bl * 3 * d * d
    heads = 2 * bl * (3 * ((d + 3) * d + d * d) + d * (3 + 3 + V))
    frames = bl * (18 + 54 + 54)  # the noise into the global frame, exp, compose
    return fuse + m["n_layers"] * layer + heads + frames


def sample_job_flops(c: dict, n_designs: int, L: int, n_calls: int) -> float:
    """One design job: the context and pair biases once, n_calls denoiser
    calls on the job's designs."""
    return (context_flops(c, 1, L) + pair_bias_flops(c, 1, L)
            + n_calls * denoiser_flops(c, n_designs, 1, L, pair_bias=False))


def train_step_flops(c: dict, b: int, L: int) -> float:
    """One training step at 3x the forward (the backward twice the
    forward); K1's backward recomputes its forward, which is not counted."""
    return 3.0 * (context_flops(c, b, L) + denoiser_flops(c, b, b, L))
