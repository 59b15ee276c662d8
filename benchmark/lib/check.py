"""The numbers that decide `correct`, each beside its limit.

A run is correct when every compared number is at or under its limit.
The limits live in `benchmark/limits/<cell>.json`, set from the readings
that `PERF.md` gives (sound runs of the port on a dozen seeds or more, the
control one precision lower, and planted faults).
"""

from __future__ import annotations

import math
import sys


class Checks:
    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values: dict = {}

    def add(self, name: str, value: float) -> None:
        """Record `name`, keeping the worst (largest) reading."""
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self.values[name] = max(value, self.values.get(name, -math.inf))

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(
            name in self.values and self.values[name] <= limit
            for name, limit in self.limits.items())

    def table(self) -> dict:
        """{name: {"value", "limit"}}; a missing or non-finite reading is
        given as the string "inf"."""
        out = {}
        for name, limit in self.limits.items():
            v = self.values.get(name, math.inf)
            out[name] = {"value": v if math.isfinite(v) else "inf", "limit": limit}
        return out

    def report(self, file=sys.stderr) -> None:
        """Every number beside its limit, as the last lines on stderr."""
        for name, row in self.table().items():
            v = row["value"]
            ok = "ok" if v != "inf" and v <= row["limit"] else "OVER"
            print(f"check {name} {row['value']!r} limit {row['limit']!r} {ok}", file=file)
        file.flush()


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref)); `keep` names the leaves compared."""
    import torch

    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names)
