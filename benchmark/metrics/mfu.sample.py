"""mfu.sample: the whole window's model FLOPs (`lib/work.py`, from the
configuration's shapes) over the window's seconds times the card's peak
in the configuration's compute dtype, in percent."""

from benchmark.lib.readers import mfu


def read(rec):
    return mfu(rec)
