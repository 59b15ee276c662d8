"""Tests of the benchmark's own code, on the CPU unless marked `card`.

Run from the repository root:

    python -m pytest benchmark/tests -q                # CPU tests; card tests skip
    python -m pytest benchmark/tests -q -m card        # on a machine with a card

A test marked `card` asks for the `card` fixture, which skips it where no
CUDA device is present (decided when the test runs, not at import).
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a CPU-sized model: the widths of the port's tiny_config()
TINY_MODEL = dict(d_residue_emb=32, d_pair_emb=16, n_ipa_layers=2, d_scalar_per_head=8,
                  n_query_point_per_head=4, n_value_point_per_head=4, n_head=4)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


def tiny(dtype: str | None = None):
    """An `edit` for `run.main`: the cell at CPU size (tiny widths, T = 10,
    a few designs or rows), its compute dtype replaced by `dtype` if given."""
    def edit(conf, mix, limits):
        conf, mix = copy.deepcopy(conf), dict(mix)
        conf["model"].update(TINY_MODEL)
        if dtype is not None:
            conf["model"]["compute_dtype"] = dtype
        conf["diffusion"].update(T=10, igso3_n_bins=512, igso3_n_terms=256)
        if mix["driver"] == "design_jobs":
            mix.update(n_designs=4, n_targets=2, warmup_jobs=1)
            if "t_start" in mix.get("sample", {}):
                mix["sample"] = dict(mix["sample"], t_start=6)
        else:
            conf["train"].update(batch_size=4)
            mix.update(n_examples=24, workers=1, warmup_steps=4)
        return conf, mix, limits
    return edit


@pytest.fixture
def run_cell(capsys):
    """Run a cell on the CPU at tiny size; returns (exit code, result dict)."""
    import json

    import torch

    from benchmark import run

    def go(cell, seed=1, seconds=0.5, dtype="float32"):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], device=torch.device("cpu"), edit=tiny(dtype))
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if rc == 0 else None)
    return go
