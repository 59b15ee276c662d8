"""Production training through `fit()`, as `cli.train --production` runs it.

Set-up writes a seeded corpus of synthetic complexes as patch files, opens
it as a cached `PatchDataset` and fills its cache, builds the harness and a
fresh state on the benchmark's weights and trains its first steps through
`fit()` with the `PrefetchLoader` and the captured step
(`DiffAb.make_train_step()`, passed in a timing shim as
`fit(train_step=...)`).  The window is one `fit()` call continuing that
state, whose `max_steps` fills `--seconds` at the warm-up's rate; it ends in
a synchronise.  The steps it counts are those the state advanced by (a
state that `fit()`'s divergence guard rolls back counts the steps it lost
as failed, and so does every logging interval whose loss is not finite).
No validation and no checkpoints.

Correctness: the state's first three steps (in set-up, through the same
`fit()`, loader, filled cache and step as the window) are followed by the
reference (`benchmark/reference/train.py`): the same rows, rebuilt from the
patch files, the step draws from the port's per-step seeds, the
benchmark's weights.  Step 0 runs the step's body eagerly (the graph's
warm-up) and is captured; steps 1 and 2 replay the graph.  The check reads
each step's loss, the gradients of steps 0 and 1 as the optimizer took them
(from the port's first moments: g0 = mu0 / (1 - b1), g1 = (mu1 - b1 mu0) /
(1 - b1)) and the parameters' change over the three steps, the latter two
leaf by leaf as a gap of norms, and the window's logged losses that are not
finite.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark.lib import inputs, program, work
from benchmark.lib.check import Checks, leaf_gaps
from benchmark.lib.profile import Slice
from benchmark.lib.weights import make_params
from benchmark.reference import data as ref_data
from benchmark.reference import geometry as ref_geo
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision, f32_matmuls

FOLLOWED = 3  # steps the reference follows
GRADS = 2  # of them, the steps whose gradients are compared (0 eager, 1 replayed)
ROW_TOL = 1e-4  # normalized units (1e-3 angstrom): the port's rows against the rebuilt ones


class Losses:
    """A `fit()` logger that keeps the logged losses and logs on as
    `MetricLogger` does."""

    def __init__(self, logger):
        self.logger, self.values = logger, []

    def log(self, step, metrics):
        if "train/loss" in metrics:
            self.values.append(float(metrics["train/loss"]))
        self.logger.log(step, metrics)


class Shim:
    """The step `fit()` calls, timed: the host clock at each call's entry and
    return; `hooks` (call index -> fn(state, batch, draws, out)) run after
    the given calls."""

    def __init__(self, step):
        self.step = step
        self.enter, self.exit = [], []
        self.hooks = {}

    def __call__(self, state, batch, draws):
        self.enter.append(time.perf_counter())
        out = self.step(state, batch, draws)
        self.exit.append(time.perf_counter())
        hook = self.hooks.pop(len(self.exit) - 1, None)
        if hook is not None:
            hook(state, batch, draws, out)
        return out


class Run:
    def __init__(self, cell):
        self.cell, self.dev = cell, cell.device
        self.conf, self.mix = cell.conf, cell.mix
        self.tc = self.conf["train"]
        self.b = int(self.tc["batch_size"])
        self.L = int(self.conf["data"]["patch_size"])
        # fit()'s seed: the loader's order and the draws
        self.seed = inputs.derive("fit", cell.seed)
        self.followed = {}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def fit(self, steps: int):
        """One fit() call of `steps` more steps on the state."""
        from diffab_pytorch_tpu_torch.train.trainer import fit
        from diffab_pytorch_tpu_torch.utils.logging import MetricLogger

        per_epoch = max(1, len(self.ds) // self.b)
        epochs = math.ceil((self.state.step + steps) / per_epoch) + 1
        self.losses = Losses(MetricLogger(print_every=self.tc["log_every"], file=sys.stderr))
        self.state = fit(self.h, self.ds, epochs=epochs, max_steps=self.state.step + steps,
                         seed=self.seed, state=self.state, train_step=self.shim,
                         logger=self.losses)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from diffab_pytorch_tpu_torch.data.dataset import PatchDataset

        cell = self.cell
        program.build_kernels(self.dev)
        self.paths = inputs.write_examples(cell.tmp, cell.seed, int(self.mix["n_examples"]),
                                           self.L, workers=int(self.mix["workers"]))
        self.h = program.harness(self.conf, self.dev)
        self.params = make_params(program.param_shapes(self.h),
                                  inputs.derive("weights", cell.seed), self.dev)
        self.state = program.train_state(self.h, self.params)
        self.ds = PatchDataset(self.paths, cdrs_to_generate=tuple(
            self.conf["data"]["cdrs_to_generate"]), cache=True)
        for _ in self.ds.batches(self.b, shuffle=False, epochs=1, drop_last=False):
            pass  # fills the cache that every step from here on reads
        self.shim = Shim(self.h.make_train_step())
        for k in range(FOLLOWED):
            self.shim.hooks[k] = self._follow_hook(k)
        self.fit(FOLLOWED + 2)  # the followed steps: the warm-up and capture, then replays
        self.sync()
        # the rate of fit()'s steps on the filled cache: from the entry of a
        # step past the timed call's start (its start-up and first steps left
        # out, as one fixed cost in the window) to the card's synchronise
        warm = int(self.mix["warmup_steps"])
        skip = min(10, warm // 2)
        first = len(self.shim.enter) + skip
        self.fit(warm)
        self.sync()
        self.step_s = (time.perf_counter() - self.shim.enter[first]) / (warm - skip)
        gc.collect()
        cuda = self.dev.type == "cuda"
        self.peak_setup = torch.cuda.max_memory_allocated(self.dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def _follow_hook(self, k: int):
        """What the reference needs of step k: the rows, the loss, the
        first moment after each step whose gradient is compared, and the
        parameters after the last."""
        def hook(state, batch, draws, out):
            new_state, metrics = out
            ints = [getattr(batch, f).cpu().numpy() for f in ("seq_idx", "residue_idx",
                                                                "chain_idx")]
            ca = batch.xyz[:, :, 1].cpu().numpy()
            rows = [(ref_data.row_key(*(a[i] for a in ints)), ca[i])
                    for i in range(batch.batch_size)]
            rec = dict(rows=rows, loss=float(metrics["train/loss"]))
            if k < GRADS:
                rec["mu"] = {n: v.detach().clone() for n, v in new_state.opt_state.mu.items()}
            if k == FOLLOWED - 1:
                rec["params"] = {n: v.detach().clone() for n, v in new_state.params.items()}
            self.followed[k] = rec
        return hook

    def window(self) -> None:
        self.n_steps = max(1, round(self.cell.seconds / self.step_s))
        self.shim.enter.clear()
        self.shim.exit.clear()
        step0 = self.state.step
        self.sync()
        t0 = time.perf_counter()
        self.fit(self.n_steps)
        self.sync()
        self.window_s = time.perf_counter() - t0
        # steps that count: those the state kept, less every logging
        # interval whose loss is not finite
        self.nonfinite = sum(not math.isfinite(v) for v in self.losses.values)
        self.done = max(0, self.state.step - step0 - self.nonfinite * int(self.tc["log_every"]))
        self.gaps = [b - a for a, b in zip(self.shim.exit[:-1], self.shim.enter[1:])]

    def traced(self):
        if not (self.cell.trace and self.dev.type == "cuda"):
            return None
        lead, n = 5, int(self.mix["profile_steps"])
        s = Slice(torch)
        base = len(self.shim.exit)
        self.shim.hooks[base + lead - 1] = lambda *a: s.start()
        self.shim.hooks[base + lead + n - 1] = lambda *a: s.stop()
        launches0 = program.k1_launches()
        self.fit(lead + n)
        self.k1_per_step = (program.k1_launches() - launches0) / (lead + n)
        out = s.summary()
        out["units"] = n
        return out

    def free(self) -> None:
        self.peak_window = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" \
            else 0
        del self.h, self.state, self.shim
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def record(self, prof) -> dict:
        c = self.conf["model"]
        return dict(kind="train", model=c, dtype=c["compute_dtype"], batch=self.b, L=self.L,
                    steps=self.done, window_s=self.window_s, host_gaps=self.gaps,
                    k1_per_step=getattr(self, "k1_per_step", None), profile=prof,
                    step_flops=work.train_step_flops(c, self.b, self.L),
                    peak_window_bytes=self.peak_window)

    def e2e(self) -> dict:
        return {"train_examples_per_s": self.b * self.done / self.window_s}

    # ------------------------------------------------------------------
    def reference(self, prec: str, rows: slice = slice(None)) -> dict:
        """The reference's first FOLLOWED steps at precision `prec`: each
        step's loss, the clipped gradients of the first GRADS steps and the
        parameters' change.
        `rows` keeps part of each batch (a planted fault: the rest left out)."""
        c, d = self.conf["model"], self.conf["diffusion"]
        sched, table = ref_geo.diffusion_tables(d, self.dev)
        trainer = ref_train.Trainer(self.params)
        out = dict(loss=[], grad=[])
        for k in range(FOLLOWED):
            batch = ref_data.to_batch([self.corpus[i] for i in self.matched[k]], self.dev)
            draws = ref_train.step_draws(self.seed, k, self.b, self.L, c["aa_vocab_size"],
                                         d["T"], self.dev)
            batch = {n: v[rows] for n, v in batch.items()}
            draws = {n: v[rows] for n, v in draws.items()}
            loss, grads = trainer.grads(c, self.tc, sched, table, batch, draws, Precision(prec))
            used = trainer.update(self.tc, grads)
            out["loss"].append(loss)
            if k < GRADS:
                out["grad"].append(used)
        out["change"] = {n: trainer.params[n] - self.params[n] for n in self.params}
        return out

    def load_rows(self) -> int:
        """The corpus rebuilt from its patch files, and each row of the
        followed steps matched to the example with its residues and chains
        whose C-alpha coordinates lie nearest (within ROW_TOL); returns how
        many rows match none or repeat an earlier match."""
        self.corpus = [ref_data.normalize(ref_data.load(p)) for p in self.paths]
        by_key = {}
        for i, r in enumerate(self.corpus):
            by_key.setdefault(ref_data.row_key(r["seq_idx"], r["residue_idx"], r["chain_idx"]),
                              []).append(i)
        self.matched, off, seen = {}, 0, set()
        for k in range(FOLLOWED):
            self.matched[k] = []
            for key, ca in self.followed[k]["rows"]:
                cand = by_key.get(key, [])
                dist = [float(np.abs(self.corpus[i]["xyz"][:, 1] - ca).max()) for i in cand]
                if not cand or min(dist) > ROW_TOL:
                    off += 1
                    self.matched[k].append(cand[0] if cand else 0)
                    continue
                i = cand[int(np.argmin(dist))]
                off += i in seen
                seen.add(i)
                self.matched[k].append(i)
        return off

    def readings(self, ref: dict) -> dict:
        """The port's followed steps against the reference's `ref`."""
        b1 = self.tc["betas"][0]
        mu = [self.followed[k]["mu"] for k in range(GRADS)]
        grad = [{n: (v - b1 * (mu[k - 1][n] if k else 0.0)) / (1.0 - b1)
                 for n, v in mu[k].items()} for k in range(GRADS)]
        change = {n: self.followed[FOLLOWED - 1]["params"][n] - self.params[n]
                  for n in self.params}
        return self.compare([self.followed[k]["loss"] for k in range(FOLLOWED)], grad, change,
                            ref)

    def compare(self, loss, grad, change, ref) -> dict:
        """`grad`: the gradients of the first GRADS steps."""
        norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref["grad"][0].items()}
        med = sorted(norms.values())[len(norms) // 2]
        moving = {n for n, v in norms.items() if v >= 1e-3 * med}
        return dict(
            loss_gap=max(abs(a - b) / abs(b) for a, b in zip(loss, ref["loss"])),
            grad_gap=max(leaf_gaps(g, r) for g, r in zip(grad, ref["grad"])),
            change_gap=leaf_gaps(change, ref["change"], keep=moving))

    def check(self, limits: dict) -> Checks:
        checks = Checks(limits)
        checks.add("rows_off", self.load_rows())
        checks.add("loss_nonfinite", self.nonfinite)
        with f32_matmuls():
            for name, v in self.readings(self.reference("f32")).items():
                checks.add(name, v)
        return checks


    def control(self, prec: str) -> tuple[dict, dict, dict]:
        """The port's readings, those of the reference at `prec` in its
        place, and those of the reference in its place with half of each
        batch left out (the loss the mean over the rest), all against the
        reference.  (A state left unchanged reads 1 on the gradient and the
        change by their measure, and needs no run.)"""
        self.load_rows()
        with f32_matmuls():
            ref = self.reference("f32")
            port = self.readings(ref)
            faults = {}
            for name, (p, rows) in {prec: (prec, slice(None)),
                                    "half_batch": ("f32", slice(0, self.b // 2))}.items():
                other = self.reference(p, rows)
                faults[name] = self.compare(other["loss"], other["grad"], other["change"], ref)
        return port, faults.pop(prec), faults


def run(cell) -> dict:
    r = Run(cell)
    r.setup()
    cell.mark_setup_done()
    r.window()
    prof = r.traced()
    r.free()
    checks = r.check(dict(cell.limits, rows_off=0, loss_nonfinite=0))
    return dict(attempted=r.n_steps, failed=r.n_steps - r.done, e2e=r.e2e(),
                record=r.record(prof),
                checks=checks, peak_bytes=max(r.peak_setup, r.peak_window))
