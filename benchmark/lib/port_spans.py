"""What the port records of itself: its spans and counters
(`diffab_pytorch_tpu_torch/utils/profiling.py`), read by the per-layer
metrics in the run's own process once the cell's work is done.

The port records spans only while a torch profiler records, which in a
run is the traced slice alone, so the span buffer holds that slice; the
counters are always on and hold the whole run.  A port without spans or
counters (or a slice without the named span) reads None, never 0.
"""

from __future__ import annotations


def _profiling():
    """The port's profiling module, or None where it keeps no records."""
    from diffab_pytorch_tpu_torch.utils import profiling

    if not (hasattr(profiling, "records") and hasattr(profiling, "counters")):
        return None
    return profiling


def span_ms(name: str):
    """Mean host milliseconds of the buffered spans called `name`."""
    prof = _profiling()
    if prof is None:
        return None
    spans = [r.end - r.start for r in prof.records() if r.name == name]
    return 1e3 * sum(spans) / len(spans) if spans else None


def counter(name: str):
    """The run's total of counter `name`."""
    prof = _profiling()
    if prof is None:
        return None
    return prof.counters().get(name)
