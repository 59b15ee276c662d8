"""The port's spans and counters (`utils/profiling.py`) on the CPU.

With no profiler a span records nothing and costs one check; under
`torch.profiler.profile` every span of `sample()`, `score_designs`,
`relax_ca`, `fit()` and the loader's worker is a record with its parent
and call, and an event of the same name in the profiler's trace.  No span
opens inside a step body (a captured graph would replay nothing of it).

Small sizes: tiny_config() (2 IPA layers, d = 32), L = 24 or 64, T = 6.
"""

import collections
import dataclasses
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.cli import preprocess as tpreprocess
from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from diffab_pytorch_tpu_torch.structure import testing as ttesting
from diffab_pytorch_tpu_torch.structure.relax import relax_ca
from diffab_pytorch_tpu_torch.train.harness import DiffAb
from diffab_pytorch_tpu_torch.train.trainer import fit
from diffab_pytorch_tpu_torch.utils import graphs, profiling

T = 6
L = 24


@pytest.fixture(autouse=True)
def clean_buffer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def harness():
    cfg = tconfig.tiny_config()
    h = DiffAb(dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, T=T, igso3_n_bins=256, igso3_n_terms=128)), device="cpu")
    h.init(0)
    return h


@pytest.fixture(scope="module")
def target(harness):
    return synthetic_batch(0, 1, L, harness.config.model.n_atoms, n_generate=6)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r.name].append(r)
    return out


def test_no_profiler_no_records_and_counters_count(harness, target):
    harness.sample(None, target, torch.Generator().manual_seed(0), n_designs=2)
    relax_ca(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=torch.bool),
             torch.zeros(1, 4, dtype=torch.long), torch.arange(4)[None],
             torch.ones(1, 4, dtype=torch.bool), n_iters=2)
    with profiling.span("x") as s:
        assert s is None
    assert profiling.records() == [] and profiling.dropped() == 0
    profiling.count("c")
    profiling.count("c", 2.5)
    assert profiling.counters()["c"] == 3.5


def test_sample_spans_nest_under_one_call(harness, target):
    with cpu_profile() as prof:
        harness.sample(None, target, torch.Generator().manual_seed(0), n_designs=2)
    recs = profiling.records()
    names = by_name(recs)
    assert {k: len(v) for k, v in names.items()} == {
        "sample": 1, "sample.prepare": 1, "sample.step": T, "sample.draw": T, "sample.out": 1}
    top = names["sample"][0]
    assert top.parent is None and all(r.call == top.call for r in recs)
    assert all(r.thread == threading.get_ident() for r in recs)
    for child in ("sample.prepare", "sample.step", "sample.out"):
        assert all(r.parent == top.id for r in names[child])
    steps = {r.id for r in names["sample.step"]}
    assert all(r.parent in steps for r in names["sample.draw"])
    for r in recs:
        assert top.start <= r.start <= r.end <= top.end
    ordered = sorted(recs, key=lambda r: r.start)
    assert [r.name for r in ordered[:3]] == ["sample", "sample.prepare", "sample.step"]
    assert ordered[-1].name == "sample.out"
    # the same names on the profiler's clock, as many times
    events = collections.Counter(e.name for e in prof.events())
    assert all(events[k] == len(v) for k, v in names.items())


def test_each_call_has_its_own_number(harness, target):
    with cpu_profile():
        for seed in range(2):
            harness.sample(None, target, torch.Generator().manual_seed(seed), n_designs=1,
                           n_steps=2)
    calls = sorted({r.call for r in profiling.records()})
    tops = by_name(profiling.records())["sample"]
    assert len(calls) == 2 and sorted(r.call for r in tops) == calls


def test_score_points_and_relax(harness, target):
    designs = harness.sample(None, target, torch.Generator().manual_seed(0), n_designs=2,
                             n_steps=2)
    n = 2
    rep = lambda a: torch.repeat_interleave(a, n, dim=0)
    with cpu_profile():
        harness.score_designs(None, target, designs, torch.Generator().manual_seed(1),
                              t_grid=[1, 2, 3], n_draws=2)
        relax_ca(designs.translations, rep(target.residue_mask), rep(target.chain_idx),
                 rep(target.residue_idx), rep(target.generation_mask), n_iters=3)
    names = by_name(profiling.records())
    assert {k: len(v) for k, v in names.items()} == {
        "score": 1, "score.prepare": 1, "score.point": 6, "relax": 1}
    score = names["score"][0]
    assert all(r.parent == score.id and r.call == score.call
               for r in names["score.point"] + names["score.prepare"])
    assert names["relax"][0].parent is None and names["relax"][0].call != score.call


@pytest.fixture(scope="module")
def patch_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    for i in range(4):
        p = root / f"syn{i}.pdb"
        p.write_text(ttesting.make_synthetic_antibody_pdb(seed=20 + i))
        tpreprocess.process_one(str(p), str(root / f"syn{i}.npz"), "H", "L", "A", 64)
    return str(root)


def test_fit_steps_and_the_loader_thread(harness, patch_dir):
    ds = PatchDataset.from_dir(patch_dir)
    h = DiffAb(dataclasses.replace(harness.config, train=dataclasses.replace(
        harness.config.train, batch_size=2, log_every=2)), device="cpu")
    c0 = profiling.counters()
    with cpu_profile() as prof:
        state = fit(h, ds, epochs=2, max_steps=3, seed=0)
    assert state.step == 3
    names = by_name(profiling.records())
    for name in ("fit.draw", "fit.step"):
        assert sorted(r.call for r in names[name]) == [0, 1, 2]
    # the wait before each step and the one that found max_steps reached
    assert sorted(r.call for r in names["fit.loader_wait"]) == [0, 1, 2, 3]
    assert [r.call for r in names["fit.log"]] == [1]
    main = threading.get_ident()
    assert all(r.thread == main and r.parent is None
               for k in ("fit.loader_wait", "fit.draw", "fit.step") for r in names[k])
    batches = names["loader.batch"]
    assert len(batches) >= 3 and all(r.thread != main for r in batches)
    assert [r.call for r in batches] == list(range(len(batches)))
    c1 = profiling.counters()
    n = c1["loader.batches"] - c0.get("loader.batches", 0)
    assert n >= 3 and c1["loader.batch_s"] > c0.get("loader.batch_s", 0)
    events = collections.Counter(e.name for e in prof.events())
    assert events["fit.step"] == 3 and events["fit.draw"] == 3


def test_no_span_inside_a_step_body(harness, target, monkeypatch):
    """The sampler's reverse body and the training and evaluation bodies
    open no span while a profiler records, and stay capture-safe."""
    opened = []
    real = tsampler._reverse_body

    def watched(model, opts):
        body = real(model, opts)

        def step(c, *variant):
            n0 = len(profiling.records())
            graphs.capture_safe(body, c, *variant)
            opened.append(len(profiling.records()) - n0)
        return step
    monkeypatch.setattr(tsampler, "_reverse_body", watched)
    batch = synthetic_batch(1, 2, L, harness.config.model.n_atoms)
    state = harness.init(0)
    draws = harness.draw(batch, torch.Generator().manual_seed(2))
    with cpu_profile():
        harness.sample(None, target, torch.Generator().manual_seed(0), n_designs=2, n_steps=3)
        n0 = len(profiling.records())
        graphs.capture_safe(harness.train_step_impl, state, batch, draws,
                            harness.step_scalars(0, 0, 1)[0])
        graphs.capture_safe(harness.eval_step, state.params, batch, draws)
        assert len(profiling.records()) == n0
    assert opened == [0, 0, 0]


def test_a_span_closed_after_the_profiler_stopped_is_kept():
    with cpu_profile():
        outer = profiling.span("outer")
        outer.__enter__()
    outer.__exit__(None, None, None)
    with profiling.span("after"):
        pass
    assert [r.name for r in profiling.records()] == ["outer"]


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with cpu_profile():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.records()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2


def test_named_scope_keeps_the_function():
    @profiling.named_scope("work")
    def work(x, k=1):
        """doc"""
        return x + k

    assert work(1, k=2) == 3 and work.__name__ == "work" and work.__doc__ == "doc"
    with cpu_profile():
        assert work(1) == 2
    assert [r.name for r in profiling.records()] == ["work"]


def test_an_off_span_costs_one_check():
    """The off path's cost against a `record_function` opened in the same
    kind of loop (what `named_scope` paid before), the best of five loops
    each, so a loaded host slows both alike."""
    n = 20000

    def best_loop(open_span):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                with open_span("off"):
                    pass
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    off = best_loop(profiling.span)
    opened = best_loop(torch.profiler.record_function)
    assert off < opened / 4, (off, opened)


def test_counters_and_records_lose_nothing_across_threads():
    """More threads than cores counting and opening nested spans at a short
    switch interval: every increment and every record is kept, and each
    thread's children point at that thread's own parents."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 4), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n):
            profiling.count("stress")
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    try:
        with cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["stress"] == n_threads * n
    recs = profiling.records()
    outer = {r.id: r for r in recs if r.name == "outer"}
    inner = [r for r in recs if r.name == "inner"]
    assert len(outer) == len(inner) == n_threads * n
    assert len({r.id for r in recs}) == len(recs)
    for r in inner:
        up = outer[r.parent]
        assert up.thread == r.thread and up.call == r.call and up.start <= r.start
