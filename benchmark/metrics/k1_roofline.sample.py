"""k1_roofline.sample: K1's share of its roofline in the traced slice, in
percent: the bound of the IPA-layer applications the slice's work needs,
each counted from its shapes (`lib/work.py ipa_layer_flops_bytes`) at the
configuration's compute dtype, over the device time of K1's kernels, found
by the names below."""

from benchmark.lib.readers import k1_roofline

# the kernels of K1 (`csrc/ipa_fused_layer*.cu*`): the heads and output
# projection launches, and the attention launch beyond 128 residues
K1_KERNELS = ("layer_heads_kernel", "out_proj_kernel", "attend_kernel")


def read(rec):
    return k1_roofline(rec, K1_KERNELS)
