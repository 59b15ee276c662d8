"""sampler_ms: mean milliseconds of the window's `sample()` calls, each
from the call to the card's synchronise after it (the benchmark's span
around the Sampler layer, `sampling/sampler.py sample()`)."""


def read(rec):
    spans = [j["t_sample"] - j["t0"] for j in rec["jobs"]]
    return 1e3 * sum(spans) / len(spans)
