"""device_kernels.sample: device kernels per job in the traced slice (the
profiler's events other than copies and fills): what the compiled step
(`utils/graphs.py`) replays, and what runs beside it."""

from benchmark.lib.readers import kernels_per_unit


def read(rec):
    return kernels_per_unit(rec)
