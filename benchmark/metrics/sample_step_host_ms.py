"""sample_step_host_ms: mean host milliseconds of the port's `sample.step`
span in the traced slice: one reverse step's draws plus its graph replay
(or eager body), as the host spends them; the card runs behind."""

from benchmark.lib.port_spans import span_ms


def read(rec):
    return span_ms("sample.step")
