"""device_idle.train: percent of the traced slice's wall time in which no
operation ran on the device."""

from benchmark.lib.readers import idle_share


def read(rec):
    return idle_share(rec)
