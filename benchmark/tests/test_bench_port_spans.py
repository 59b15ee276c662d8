"""The readers of the port's own spans and counters
(`benchmark/lib/port_spans.py` and the metrics that use it), on the CPU.

Each reader is fed what the port records under a CPU profiler at tiny
size: a design job (`sample()`, `score_designs`, `relax_ca`) and a few
`fit()` steps through the `PrefetchLoader`.  With nothing recorded, or a
port that keeps no records, every reader gives None.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.lib import inputs

SPAN_METRICS = {
    "sample_prepare_ms": "design",
    "sample_step_host_ms": "design",
    "score_point_ms": "design",
    "relax_host_ms": "design",
    "loader_wait_ms.train": "train",
    "fit_draw_ms.train": "train",
    "loader_batch_ms.train": "train",
}


def reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py", "t_spans_" + name.replace(".", "_"))


@pytest.fixture(autouse=True)
def clean():
    from diffab_pytorch_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture(scope="module")
def harness():
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    cfg = C.tiny_config()
    h = DiffAb(dataclasses.replace(
        cfg, diffusion=dataclasses.replace(cfg.diffusion, T=5, igso3_n_bins=256,
                                           igso3_n_terms=128),
        train=dataclasses.replace(cfg.train, batch_size=2, log_every=2)), device="cpu")
    h.init(0)
    return h


def design_job(h):
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.structure.relax import relax_ca

    batch = synthetic_batch(0, 1, 24, h.config.model.n_atoms, n_generate=6)
    res = h.sample(None, batch, torch.Generator().manual_seed(0), n_designs=2)
    h.score_designs(None, batch, res, torch.Generator().manual_seed(1), t_grid=[1, 2],
                    n_draws=2)
    rep = lambda a: torch.repeat_interleave(a, 2, dim=0)
    relax_ca(res.translations, rep(batch.residue_mask), rep(batch.chain_idx),
             rep(batch.residue_idx), rep(batch.generation_mask), n_iters=2)


def train_steps(h, tmp_path):
    from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
    from diffab_pytorch_tpu_torch.train.trainer import fit

    paths = inputs.write_examples(str(tmp_path), 3, 4, 64)
    fit(h, PatchDataset(paths, cache=True), epochs=2, max_steps=3, seed=0)


def test_every_reader_reads_the_slice(harness, tmp_path, clean):
    with profile(activities=[ProfilerActivity.CPU]):
        design_job(harness)
        train_steps(harness, tmp_path)
    recs = clean.records()
    for name in SPAN_METRICS:
        value = reader(name).read({})
        assert value is not None and value > 0, name
    want = [r.end - r.start for r in recs if r.name == "score.point"]
    assert len(want) == 4
    assert reader("score_point_ms").read({}) == pytest.approx(1e3 * sum(want) / 4)
    # the counter holds the run, profiled or not
    assert reader("graph_capture_s").read({}) is None  # no capture on the CPU
    clean.count("graphs.capture_s", 0.25)
    clean.count("graphs.capture_s", 0.5)
    assert reader("graph_capture_s").read({}) == 0.75


def test_nothing_recorded_reads_none(harness, tmp_path):
    design_job(harness)  # no profiler: no spans
    for name in list(SPAN_METRICS) + ["graph_capture_s"]:
        assert reader(name).read({}) is None, name


def test_a_port_without_records_reads_none(monkeypatch, clean):
    """The parent of this change: its profiling module has no buffer."""
    clean.count("graphs.capture_s", 1.0)
    monkeypatch.delattr(clean, "records")
    for name in list(SPAN_METRICS) + ["graph_capture_s"]:
        assert reader(name).read({}) is None, name


def test_the_new_metrics_are_listed_where_their_spans_run():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    design = {w["name"] for w in bench["workloads"] if w["traffic"] != "train-b32"}
    for name, kind in SPAN_METRICS.items():
        cells = set(per_layer[name]["workloads"])
        assert cells <= (design if kind == "design" else {"production-train-b32"}), name
    assert set(per_layer["graph_capture_s"]["workloads"]) == {
        w["name"] for w in bench["workloads"]}
