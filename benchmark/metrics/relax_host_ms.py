"""relax_host_ms: mean host milliseconds of the port's `relax` span in the
traced slice: one `relax_ca` call as the host spends it, without the
synchronise that `relax_ms` waits for.  The profiler records each of the
call's ops meanwhile, and that cost is in the reading."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("relax")
