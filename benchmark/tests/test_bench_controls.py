"""On the card: each cell's control fails its check, and the port passes.

The control is the reference one precision below the configuration's (the
cell's limits file: "tf32" for float32 with TF32 off, "fp8" for bfloat16)
put in the port's place, at the cell's own size and load, on three seeds.
In a design cell the control has to fail at least one of the cell's
numbers.  In the training cell the fp8 control reads within about 2x of
the port's bfloat16 on every number (PERF.md, section 2), so there each
fault planted in the reference in the port's place (half of the batch left
out) has to fail one instead.
"""

from __future__ import annotations

import json

import pytest

from benchmark import controls
from benchmark.run import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_port_passes(card, cell):
    for seed, port, ctrl, faults, limits in controls.readings(cell, SEEDS, 5.0, device=card):
        assert all(port[k] <= v for k, v in limits.items()), (seed, port, limits)
        for name, reading in faults.items():
            assert any(reading[k] > v for k, v in limits.items()), (seed, name, reading)
        if not faults:
            assert any(ctrl[k] > v for k, v in limits.items()), (seed, ctrl, limits)
