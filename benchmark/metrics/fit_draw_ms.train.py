"""fit_draw_ms.train: mean host milliseconds of the port's `fit.draw` span
in the traced slice: `fit()` seeding the step's generator and making the
step's draws."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("fit.draw")
