"""Arithmetic shared by the per-layer metric readers (`benchmark/metrics/`).

A reader takes the run's record (what its driver measured: the window's
jobs or steps, the traced slice's summary, the configuration) and returns
its number, or None where the record holds nothing to read.  A share of a
roofline or a peak is never given as 0: without device time it is None.
"""

from __future__ import annotations

from benchmark.lib.work import ITEMSIZE, PEAK_FLOPS, bound_s, ipa_layer_flops_bytes


def kernel_seconds(prof: dict, names) -> float:
    """Device seconds of the events whose name contains one of `names`."""
    return sum(v[1] for n, v in prof["kernels"].items() if any(k in n for k in names))


def kernels_per_unit(rec: dict):
    """Kernels (device events other than copies and fills) per traced job
    or step."""
    prof = rec.get("profile")
    if not prof:
        return None
    n = sum(v[0] for name, v in prof["kernels"].items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / prof["units"]


def idle_share(rec: dict):
    """Percent of the traced slice's wall time with nothing on the device."""
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def peak_gib(rec: dict):
    return rec["peak_window_bytes"] / 2 ** 30 if rec.get("peak_window_bytes") else None


def k1_roofline(rec: dict, names) -> float | None:
    """K1's bound over its device time in the traced slice, in percent: the
    bound of each IPA-layer application the slice's work needs (the
    model's layers times its denoiser calls), from the call's shapes."""
    prof = rec.get("profile")
    if not prof:
        return None
    k1_s = kernel_seconds(prof, names)
    if k1_s <= 0:
        return None
    c, dtype = rec["model"], rec["dtype"]
    if rec["kind"] == "sample":
        b, bp = rec["n_designs"], 1
        apps = prof["units"] * rec["denoiser_calls"] * c["n_ipa_layers"]
    else:
        b = bp = rec["batch"]
        apps = prof["units"] * c["n_ipa_layers"]
    isz = ITEMSIZE[dtype]
    flops, n_bytes = ipa_layer_flops_bytes(b, bp, rec["L"], c["d_residue_emb"], c["n_head"],
                                           c["d_scalar_per_head"], c["n_value_point_per_head"],
                                           isz, isz)
    return 100.0 * apps * bound_s(flops, n_bytes, dtype) / k1_s


def mfu(rec: dict) -> float:
    """Model FLOPs of the work the window completed over the window's
    seconds times the peak of the configuration's compute dtype, percent."""
    if rec["kind"] == "sample":
        flops = rec["job_flops"] * sum(1 for j in rec["jobs"] if j["ok"])
    else:
        flops = rec["step_flops"] * rec["steps"]
    return 100.0 * flops / (rec["window_s"] * PEAK_FLOPS[rec["dtype"]])
