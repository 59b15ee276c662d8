"""graph_capture_s: seconds the port spent capturing CUDA graphs over the
run (its `graphs.capture_s` counter): set-up's captures, and any capture
again in the window or the traced slice."""

from benchmark.lib.port_spans import counter


def read(rec):
    return counter("graphs.capture_s")
