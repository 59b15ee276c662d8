"""Work of the official DiffAb network counted from its shapes (`lib/work.py`
for the bare IPA stack): each GA block adds the point directions to K1's
features and output projection, and a three-layer transition at width d;
the LayerNorms and residuals are element-wise and left out, as `work.py`
leaves such work out."""

from __future__ import annotations

from benchmark.lib import work


def ga_layer_flops_bytes(b, bp, L, d, h, ds, p, itemsize, bias_itemsize):
    """Operations and compulsory bytes of one K1 call with direction rows:
    `work.ipa_layer_flops_bytes` plus the 3 P direction features a head
    through the output projection (their operations, and their rows of
    w_out read once)."""
    flops, n_bytes = work.ipa_layer_flops_bytes(b, bp, L, d, h, ds, p, itemsize, bias_itemsize)
    return flops + b * 2 * L * d * h * 3 * p, n_bytes + h * 3 * p * d * itemsize


def denoiser_flops(c: dict, b: int, bp: int, L: int, pair_bias: bool = True) -> float:
    """One EpsilonNet call (`work.denoiser_flops` of the same widths) with,
    in every block, the directions' rows of the output projection and the
    transition's three d x d layers."""
    h, pv, d = c["n_head"], c["n_value_point_per_head"], c["d_residue_emb"]
    per_block = 2 * b * L * h * 3 * pv * d + 3 * 2 * b * L * d * d
    return work.denoiser_flops(c, b, bp, L, pair_bias) + c["n_ipa_layers"] * per_block


def sample_job_flops(c: dict, n_designs: int, L: int, n_calls: int) -> float:
    """One design job: the context and pair biases once, n_calls EpsilonNet
    calls on the job's designs."""
    return (work.context_flops(c, 1, L) + work.pair_bias_flops(c, 1, L)
            + n_calls * denoiser_flops(c, n_designs, 1, L, pair_bias=False))

