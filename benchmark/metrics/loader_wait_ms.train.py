"""loader_wait_ms.train: mean host milliseconds of the port's
`fit.loader_wait` span in the traced slice: `fit()` waiting on the
`PrefetchLoader` for its next batch."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("fit.loader_wait")
