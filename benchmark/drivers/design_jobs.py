"""Design jobs in a closed loop with one client.

One designer's campaign is a queue of design jobs that one process holding
the card works through one at a time, as `cli.sample` does for each
target: a job is `DiffAb.sample` on one target's batch with `n_designs`
designs and the mix's sampler options; with "score", then `score_designs`
on the sampler's output and `rank_per_target` (as `cli.sample --rank`);
with "relax", then `relax_ca` of the designed C-alphas (as `cli.sample`
before it writes its files); last the designs (and ranks and scores)
copied to the host.  The mix file (`benchmark/traffic/<mix>.json`) gives
the number of targets cycled, the designs per job, the sampler options,
the warm-up and traced jobs, the jobs the check follows and the name of
its rate metric ("rate_metric", default designs_per_s).

Correctness: jobs drawn from the seed before the window are followed after
it, stage by stage from the port's own outputs.  The reference
(`benchmark/reference/`) rebuilds the job's context from the target's
patch file and the benchmark's weights, draws the job's random numbers
from its seed in the port's order, and computes each reverse step from the
port's state before it.  Per step it reads, over the generated residues,
the widest gap by which the port's sequence choice scores below the
reference's best (log-probability plus the Gumbel draw), and the
distances of the translations and frames from the reference's, each
averaged over a design's generated residues and the steps, the worst
design read; the designs copied out must be the trajectory's last state.  The reference
scores the port's designs (the relative gap of the scores, and of the
reference's scores read in the port's rank order against sorted) and
relaxes them (the largest distance, in angstrom, from the port's relaxed
positions).  Every job returns its trajectory (`return_trajectory=True`),
so all jobs run the same captured chain.
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

from benchmark.lib import inputs, program, work
from benchmark.lib.check import Checks
from benchmark.lib.profile import Slice
from benchmark.lib.stats import percentile, rate
from benchmark.lib.weights import make_params
from benchmark.reference import data as ref_data
from benchmark.reference import geometry as ref_geo
from benchmark.reference import relax as ref_relax
from benchmark.reference import sampling as ref_sampling
from benchmark.reference import scoring as ref_scoring
from benchmark.reference.precision import Precision, f32_matmuls

COORD_SCALE = ref_data.COORD_SCALE  # angstrom per model unit



def job_seed(seed: int, k: int) -> int:
    return inputs.derive("job", seed, k)


def t_schedule(T: int, opts: dict) -> list:
    """The (t, s) jumps of the mix's chain: t_start..1 at stride 1, or
    n_steps of them evenly strided, each to the next or to 0."""
    t0 = int(opts.get("t_start", T))
    n = opts.get("n_steps")
    if n is None or n >= t0:
        ts = list(range(t0, 0, -1))
    else:
        ts = list(np.unique(np.round(np.linspace(t0, 1, n)).astype(np.int64))[::-1])
    return list(zip([int(t) for t in ts], [int(t) for t in ts[1:]] + [0]))


class Run:
    """One run of a design-job cell: set-up, window, traced slice, check."""

    def __init__(self, cell):
        self.cell, self.dev = cell, cell.device
        self.conf, self.mix = cell.conf, cell.mix
        self.n = int(self.mix["n_designs"])
        self.L = int(self.conf["data"]["patch_size"])
        self.opts = dict(self.mix.get("sample", {}))
        self.scoring = "score" in self.mix
        self.relaxing = bool(self.mix.get("relax"))
        self.kept = {}  # job id -> what the check follows, on the host

    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda():
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from diffab_pytorch_tpu_torch.data.dataset import assemble_batch
        from diffab_pytorch_tpu_torch.sampling.scoring import rank_per_target
        from diffab_pytorch_tpu_torch.structure.patch import load_patch
        from diffab_pytorch_tpu_torch.structure.relax import relax_ca

        self.rank_per_target, self.relax_ca = rank_per_target, relax_ca
        cell = self.cell
        program.build_kernels(self.dev)
        self.h = program.harness(self.conf, self.dev)
        self.params = make_params(program.param_shapes(self.h),
                                  inputs.derive("weights", cell.seed), self.dev)
        program.load_params(self.h, self.params)
        self.paths = inputs.write_examples(cell.tmp, cell.seed, int(self.mix["n_targets"]),
                                           self.L)
        cdrs = tuple(self.conf["data"]["cdrs_to_generate"])
        self.batches = [assemble_batch([load_patch(p)], cdrs, device=self.dev)[0]
                        for p in self.paths]
        for k in range(int(self.mix["warmup_jobs"])):
            last = self.job(-1 - k)
        # the jobs the check follows: drawn from the seed among those that
        # finish in the window even at half the warm-up's rate
        n_sure = max(1, int(0.5 * cell.seconds / max(last["t_end"] - last["t0"], 1e-3)))
        rng = random.Random(inputs.derive("checked", cell.seed))
        self.checked = set(rng.sample(range(n_sure), min(int(self.mix["checked_jobs"]), n_sure)))
        self.sync()
        gc.collect()
        self.peak_setup = torch.cuda.max_memory_allocated(self.dev) if self.cuda() else 0
        if self.cuda():
            torch.cuda.reset_peak_memory_stats(self.dev)

    def job(self, k: int) -> dict:
        """Job k (negative: warm-up): its host-clock marks and whether its
        designs are finite."""
        target = k % len(self.batches)
        batch = self.batches[target]
        seed = job_seed(self.cell.seed, k)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        rec = dict(t0=time.perf_counter())
        with torch.profiler.record_function("bench.sample"):
            res = self.h.sample(None, batch, generator=g, n_designs=self.n,
                                return_trajectory=True, **self.opts)
            self.sync()
        rec["t_sample"] = time.perf_counter()
        out = [res.seq_idx, res.translations, res.orientations]
        if self.scoring:
            with torch.profiler.record_function("bench.score"):
                sg = torch.Generator(device=self.dev).manual_seed(seed + 1)
                scores = self.h.score_designs(None, batch, res, generator=sg,
                                              **self.mix["score"]).score
                out += [scores, self.rank_per_target(scores, self.n)]
                self.sync()
            rec["t_score"] = time.perf_counter()
        if self.relaxing:
            with torch.profiler.record_function("bench.relax"):
                rep = lambda a: torch.repeat_interleave(a, self.n, dim=0)
                out[1] = self.relax_ca(res.translations, rep(batch.residue_mask),
                                       rep(batch.chain_idx), rep(batch.residue_idx),
                                       rep(batch.generation_mask), coord_scale=COORD_SCALE)
                self.sync()
            rec["t_relax"] = time.perf_counter()
        with torch.profiler.record_function("bench.copy_out"):
            host = [a.cpu() for a in out]
        rec["t_end"] = time.perf_counter()
        rec["ok"] = bool(torch.isfinite(host[1]).all() and torch.isfinite(host[2]).all())
        if k in getattr(self, "checked", ()):
            traj = [res.seq_trajectory.cpu(), res.translations_trajectory.cpu(),
                    res.orientations_trajectory.cpu()]
            self.kept[k] = dict(target=target, seed=seed, traj=traj, host=host,
                                raw_x=res.translations.cpu())
        return rec

    def window(self) -> None:
        seconds = self.cell.seconds
        launches0 = program.k1_launches()
        self.jobs = []
        t0 = time.perf_counter()
        while True:
            self.jobs.append(self.job(len(self.jobs)))
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = self.jobs[-1]["t_end"] - t0
        self.k1_per_job = (program.k1_launches() - launches0) / len(self.jobs)

    def traced(self) -> dict | None:
        if not (self.cell.trace and self.cuda()):
            return None
        n = int(self.mix["profile_jobs"])
        s = Slice(torch)
        s.start()
        for i in range(n):
            self.job(10 ** 6 + i)
        s.stop()
        out = s.summary()
        out["units"] = n
        return out

    def free(self) -> None:
        self.peak_window = torch.cuda.max_memory_allocated(self.dev) if self.cuda() else 0
        del self.h, self.batches
        gc.collect()
        if self.cuda():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def record(self, prof) -> dict:
        c = self.conf["model"]
        steps = len(t_schedule(self.conf["diffusion"]["T"], self.opts))
        flops = work.sample_job_flops(c, self.n, self.L, steps)
        calls = steps
        if self.scoring:
            grid = len(ref_scoring.t_grid(self.conf["diffusion"]["T"]))
            points = grid * int(self.mix["score"].get("n_draws", 2))
            flops += work.sample_job_flops(c, self.n, self.L, points)
            calls += points
        return dict(kind="sample", model=c, dtype=c["compute_dtype"], n_designs=self.n,
                    L=self.L, denoiser_calls=calls, jobs=self.jobs, window_s=self.window_s,
                    k1_per_job=self.k1_per_job, profile=prof, job_flops=flops,
                    peak_window_bytes=self.peak_window)

    def e2e(self) -> dict:
        lat = [(j["t_end"] - j["t0"]) if j["ok"] else math.inf for j in self.jobs]
        done = sum(j["ok"] for j in self.jobs)
        return {self.mix.get("rate_metric", "designs_per_s"): rate(self.n * done, self.window_s),
                "design_job_p90_ms": percentile(lat, 90) * 1e3}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def follow(self, job_id, sched, table, controls=()) -> dict:
        """Follow job `job_id` stage by stage from the port's outputs.
        Returns the gaps ("port") of the port's outputs and of each control
        precision's (the reference one precision lower, in the port's place
        from the same inputs) against the reference's."""
        c = self.conf["model"]
        kept = self.kept[job_id]
        traj, host = kept["traj"], kept["host"]
        batch = ref_data.to_batch([ref_data.normalize(ref_data.load(
            self.paths[kept["target"]]))], self.dev)
        precs = ("f32",) + tuple(controls)
        jobs = {p: ref_sampling.Job(self.params, c, batch, self.n, Precision(p)) for p in precs}
        ref = jobs["f32"]
        init = self.opts.get("init", "prior")
        draws = ref_sampling.JobDraws(kept["seed"], ref.gen.shape[0], self.L,
                                      c["aa_vocab_size"], self.dev, init=init)
        state = ref.initial(draws, sched, init, self.opts.get("t_start"))
        keys = ("port",) + tuple(controls)
        worst = {k: dict(seq_gap=0.0, x_max=0.0, r_max=0.0) for k in keys}
        gen = ref.gen
        sums = {k: dict(x=gen.new_zeros(gen.shape[0], dtype=torch.float64),
                        r=gen.new_zeros(gen.shape[0], dtype=torch.float64)) for k in keys}
        n_gen = gen.sum(-1).clamp(min=1).double()  # generated residues per design
        steps = t_schedule(self.conf["diffusion"]["T"], self.opts)
        noise_scale = float(self.opts.get("noise_scale", 1.0))
        for i, (t, s) in enumerate(steps):
            noise = draws.next_step()
            port = tuple(a[i].to(self.dev) for a in traj)
            outs = {p: ref_sampling.step(self.params, c, sched, table, job, state, t, s, noise,
                                         Precision(p), noise_scale) for p, job in jobs.items()}
            (_, x_ref, r_ref), scores = outs["f32"]
            best = scores.amax(-1)
            nexts = {"port": port, **{p: outs[p][0] for p in controls}}
            for k, (seq, x, r) in nexts.items():
                seq_gap = torch.where(gen, best - scores.gather(-1, seq[..., None])[..., 0],
                                      torch.zeros_like(best))
                dx = torch.where(gen, torch.linalg.vector_norm(x - x_ref, dim=-1), 0.0)
                dr = torch.where(gen, torch.linalg.matrix_norm(r - r_ref), 0.0)
                w = worst[k]
                w["seq_gap"] = max(w["seq_gap"], float(seq_gap.max()))
                w["x_max"] = max(w["x_max"], float(dx.max()))
                w["r_max"] = max(w["r_max"], float(dr.max()))
                sums[k]["x"] += dx.sum(-1).double()
                sums[k]["r"] += dr.sum(-1).double()
            state = port
        # per design, the mean over its generated residues and the steps;
        # the worst design
        gaps = {k: dict(worst[k], **{f"{q}_gap": float((sums[k][q] / (n_gen * len(steps))).max())
                                     for q in ("x", "r")}) for k in keys}
        designs = tuple(a[-1].to(self.dev) for a in traj)
        # the designs copied out are the trajectory's last state (the
        # translations after relax, when the job relaxes, are checked below)
        copied = [(traj[0][-1], host[0]), (traj[2][-1], host[2]), (traj[1][-1], kept["raw_x"])]
        if not self.relaxing:
            copied.append((traj[1][-1], host[1]))
        gaps["port"]["designs_off"] = float(sum(int((a != b).sum()) for a, b in copied))
        if self.scoring:
            n_draws = int(self.mix["score"].get("n_draws", 2))
            ref_scores = ref_scoring.score(self.params, c, sched, table, batch, designs, self.n,
                                           kept["seed"] + 1, Precision("f32"), n_draws)
            others = {"port": host[3].to(self.dev)}
            for p in controls:
                others[p] = ref_scoring.score(self.params, c, sched, table, batch, designs,
                                              self.n, kept["seed"] + 1, Precision(p), n_draws)
            scale = float(ref_scores.abs().median())
            for k, sc in others.items():
                order = host[4][0].to(self.dev) if k == "port" else torch.argsort(sc, stable=True)
                gaps[k]["score_gap"] = float((sc - ref_scores).abs().max()) / scale
                gaps[k]["rank_gap"] = float(
                    (ref_scores[order] - ref_scores.sort().values).abs().max()) / scale
        if self.relaxing:
            rep = lambda a: torch.repeat_interleave(a, self.n, 0)
            args = (designs[1], rep(batch["residue_mask"]), rep(batch["chain_idx"]),
                    rep(batch["residue_idx"]), rep(batch["generation_mask"]), COORD_SCALE)
            relaxed = ref_relax.relax(*args)
            others = {"port": host[1].to(self.dev),
                      **{p: ref_relax.relax(*args, prec=Precision(p)) for p in controls}}
            for k, x in others.items():
                gaps[k]["relax_gap_A"] = COORD_SCALE * float((x - relaxed).abs().max())
        return gaps

    def check(self, limits: dict) -> Checks:
        checks = Checks(limits)
        sched, table = ref_geo.diffusion_tables(self.conf["diffusion"], self.dev)
        with f32_matmuls():
            for job_id in sorted(self.kept):
                for name, v in self.follow(job_id, sched, table)["port"].items():
                    checks.add(name, v)
        checks.add("jobs_unfollowed", len(self.checked - set(self.kept)))
        return checks

    def control(self, prec: str) -> tuple[dict, dict, dict]:
        """The port's worst gaps and those of the reference at `prec` in its
        place, over the followed jobs (and no planted faults)."""
        sched, table = ref_geo.diffusion_tables(self.conf["diffusion"], self.dev)
        port, ctrl = {}, {}
        with f32_matmuls():
            for job_id in sorted(self.kept):
                gaps = self.follow(job_id, sched, table, controls=(prec,))
                for out, key in ((port, "port"), (ctrl, prec)):
                    for name, v in gaps[key].items():
                        out[name] = max(v, out.get(name, v))
        return port, ctrl, {}


def run(cell) -> dict:
    r = Run(cell)
    r.setup()
    cell.mark_setup_done()
    r.window()
    prof = r.traced()
    r.free()
    checks = r.check(dict(cell.limits, designs_off=0, jobs_unfollowed=0))
    return dict(attempted=len(r.jobs), failed=sum(not j["ok"] for j in r.jobs), e2e=r.e2e(),
                record=r.record(prof), checks=checks,
                peak_bytes=max(r.peak_setup, r.peak_window))
