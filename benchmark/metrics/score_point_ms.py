"""score_point_ms: mean host milliseconds of the port's `score.point` span
in the traced slice: one grid point of `score_designs`, its forward draws
and one eager denoiser call, as the host spends them.  The profiler records
each of the call's ops meanwhile, and that cost is in the reading."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("score.point")
