"""sample_prepare_ms: mean host milliseconds of the port's `sample.prepare`
span in the traced slice: a `sample()` call from its entry to the first
reverse step (device copies, masks, the context encoding, the initial
state, the hoisted constants, the graph cache's lookup and input load)."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("sample.prepare")
