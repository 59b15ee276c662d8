"""k1_roofline.ga: K1's share of its roofline in the traced slice of the
official DiffAb network's design jobs, in percent: the bound of the GA
layer's K1 applications the slice's work needs (`lib/work_ga.py
ga_layer_flops_bytes`: the direction rows, the configuration's heads and
patch length) at the configuration's compute dtype, over the device time of
K1's kernels, found by the names below.  None without a traced slice or K1
device time."""

from benchmark.lib.readers import kernel_seconds
from benchmark.lib.work import ITEMSIZE, bound_s
from benchmark.lib.work_ga import ga_layer_flops_bytes

# the kernels of K1 (`csrc/ipa_fused_layer*.cu*`): the heads and output
# projection launches, and the attention launch beyond 128 residues
K1_KERNELS = ("layer_heads_kernel", "out_proj_kernel", "attend_kernel")


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    k1_s = kernel_seconds(prof, K1_KERNELS)
    if k1_s <= 0:
        return None
    c, isz = rec["model"], ITEMSIZE[rec["dtype"]]
    apps = prof["units"] * rec["denoiser_calls"] * c["n_ipa_layers"]
    flops, n_bytes = ga_layer_flops_bytes(rec["n_designs"], 1, rec["L"], c["d_residue_emb"],
                                          c["n_head"], c["d_scalar_per_head"],
                                          c["n_value_point_per_head"], isz, isz)
    return 100.0 * apps * bound_s(flops, n_bytes, rec["dtype"]) / k1_s
