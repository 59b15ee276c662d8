"""Design jobs of the official DiffAb network, in `design_jobs`'s closed loop.

The loop, the window, the traced slice and the copies to the host are
`design_jobs.Run`'s: one client's queue of `DiffAb.sample` jobs, each of
`n_designs` designs of one target with the mix's sampler options, the
designs copied to the host.  What differs:

  * the network is the official one (`benchmark/reference/ga.py`), so the
    weights hold its LayerNorms (`lib/weights_ga.py`) and its work is
    counted by `lib/work_ga.py`;
  * the targets' generated residues are the configuration's CDRs (all six
    in the official multi-CDR design), in the port's batches and in the
    reference's rebuilt ones alike;
  * the reference follows each reverse step in blocks of the mix's
    `reference_block` designs, so that one block's attention fits;
  * the record holds the port's `ga.blocks` counter over the traced jobs.

Correctness is `design_jobs`'s for a job without scoring or relax: for
each followed job, per step from the port's state before it, the widest
gap by which the port's sequence choice scores below the reference's
best, the translations' and frames' distances from the reference's (each
design's mean over its generated residues and the steps, the worst design
read), and the designs copied out against the trajectory's last state.
"""

from __future__ import annotations

import gc
import random

import torch

from benchmark.drivers import design_jobs
from benchmark.lib import inputs, port_spans, program, work_ga
from benchmark.lib.weights_ga import make_params
from benchmark.reference import data as ref_data
from benchmark.reference import ga as ref_ga
from benchmark.reference import sampling as ref_sampling
from benchmark.reference.precision import Precision


class Run(design_jobs.Run):
    def __init__(self, cell):
        super().__init__(cell)
        if self.scoring or self.relaxing:
            raise ValueError("design_jobs_ga follows sampling jobs only (no score, no relax)")
        self.cdrs = tuple(self.conf["data"]["cdrs_to_generate"])
        self.block = int(self.mix.get("reference_block", self.n))

    def setup(self) -> None:
        from diffab_pytorch_tpu_torch.data.dataset import assemble_batch
        from diffab_pytorch_tpu_torch.structure.patch import load_patch

        cell = self.cell
        program.diffab_config(self.conf)  # a port without the network's options stops here
        program.build_kernels(self.dev)
        self.h = program.harness(self.conf, self.dev)
        self.params = make_params(program.param_shapes(self.h),
                                  inputs.derive("weights", cell.seed), self.dev)
        program.load_params(self.h, self.params)
        self.paths = inputs.write_examples(cell.tmp, cell.seed, int(self.mix["n_targets"]),
                                           self.L)
        self.batches = [assemble_batch([load_patch(p)], self.cdrs, device=self.dev)[0]
                        for p in self.paths]
        for k in range(int(self.mix["warmup_jobs"])):
            last = self.job(-1 - k)
        n_sure = max(1, int(0.5 * cell.seconds / max(last["t_end"] - last["t0"], 1e-3)))
        rng = random.Random(inputs.derive("checked", cell.seed))
        self.checked = set(rng.sample(range(n_sure), min(int(self.mix["checked_jobs"]), n_sure)))
        self.sync()
        gc.collect()
        self.peak_setup = torch.cuda.max_memory_allocated(self.dev) if self.cuda() else 0
        if self.cuda():
            torch.cuda.reset_peak_memory_stats(self.dev)

    def traced(self):
        before = port_spans.counter("ga.blocks")
        out = super().traced()
        after = port_spans.counter("ga.blocks")
        self.ga_blocks_traced = None if out is None or after is None else after - (before or 0)
        return out

    def record(self, prof) -> dict:
        rec = super().record(prof)
        steps = len(design_jobs.t_schedule(self.conf["diffusion"]["T"], self.opts))
        rec.update(job_flops=work_ga.sample_job_flops(self.conf["model"], self.n, self.L, steps),
                   ga_blocks_traced=getattr(self, "ga_blocks_traced", None))
        return rec

    @torch.no_grad()
    def follow(self, job_id, sched, table, controls=()) -> dict:
        """`design_jobs.Run.follow` for this network: the gaps of the port's
        outputs ("port") and of each control precision's against the
        reference's."""
        c = self.conf["model"]
        kept = self.kept[job_id]
        traj, host = kept["traj"], kept["host"]
        batch = ref_data.to_batch([ref_ga.normalize(ref_data.load(self.paths[kept["target"]]),
                                                    self.cdrs)], self.dev)
        precs = ("f32",) + tuple(controls)
        jobs = {p: ref_sampling.Job(self.params, c, batch, self.n, Precision(p))
                for p in precs}
        ref = jobs["f32"]
        draws = ref_sampling.JobDraws(kept["seed"], ref.gen.shape[0], self.L,
                                      c["aa_vocab_size"], self.dev)
        keys = ("port",) + tuple(controls)
        worst = {k: dict(seq_gap=0.0, x_max=0.0, r_max=0.0) for k in keys}
        gen = ref.gen
        sums = {k: dict(x=gen.new_zeros(gen.shape[0], dtype=torch.float64),
                        r=gen.new_zeros(gen.shape[0], dtype=torch.float64)) for k in keys}
        n_gen = gen.sum(-1).clamp(min=1).double()
        steps = design_jobs.t_schedule(self.conf["diffusion"]["T"], self.opts)
        noise_scale = float(self.opts.get("noise_scale", 1.0))
        state = ref.initial(draws, sched)
        for i, (t, s) in enumerate(steps):
            noise = draws.next_step()
            port = tuple(a[i].to(self.dev) for a in traj)
            outs = {p: ref_ga.step(self.params, c, sched, table, job, state, t, s, noise,
                                   Precision(p), noise_scale, self.block)
                    for p, job in jobs.items()}
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
        gaps = {k: dict(worst[k], **{f"{q}_gap": float((sums[k][q] / (n_gen * len(steps))).max())
                                     for q in ("x", "r")}) for k in keys}
        copied = [(traj[0][-1], host[0]), (traj[2][-1], host[2]), (traj[1][-1], kept["raw_x"]),
                  (traj[1][-1], host[1])]
        gaps["port"]["designs_off"] = float(sum(int((a != b).sum()) for a, b in copied))
        return gaps


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
