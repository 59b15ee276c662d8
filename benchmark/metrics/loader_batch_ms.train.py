"""loader_batch_ms.train: mean milliseconds of the port's `loader.batch`
span in the traced slice: the `PrefetchLoader` worker's time for one batch
(assembly, pinning and issuing the copy), on its own thread."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("loader.batch")
