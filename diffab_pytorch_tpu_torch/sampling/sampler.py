"""The reverse-diffusion sampler (`diffab_pytorch_tpu/sampling/sampler.py`):
generation from the prior, the few-step recipes and optimization by
renoising, on one chain loop.

  1. encode the context once and precompute every layer's pair-bias logits
     and packed fused-layer weights (all t-independent);
  2. initialize generated positions: from the priors (s uniform, x ~
     N(0, I), R uniform on SO(3)); for `init="chord"` x (and with
     `chord_orientations` R) from the forward-noised anchor-anchor chord
     at t_start; for t_start < T by renoising the batch's own values to
     t_start; context positions from the batch;
  3. per step of the descending t-subsequence (`timestep_schedule`: all of
     t_start..1, or n_steps of them, uniform, "hight" or with a stride-1
     fine tail), jump t -> s (the next element, or 0): denoise, then the
     three reverse kernels respaced to s (sequence posterior draw;
     coordinates by the posterior mean, the DDIM direction above
     coord_ddim_t_min, or a solver's x0 estimate, "heun" or "ab2";
     orientations by renoising or the geodesic posterior); context
     residues are clamped.  A self-conditioned model also reads the
     previous step's estimate: x0_hat at that step's t (unclipped) and
     p(s_0), with the flag 0 at the first step and at every t > sc_t_max.

With n_designs = n every batch row gets n designs that share one copy of
its context (embeddings, pair tensor, bias logits); output row i n + d is
design d of target i.  Every draw can be injected (`init_noise` and
`step_noise`), so tests feed this sampler the numbers the JAX key schedule
draws.

The JAX `lax.scan` body is `_reverse_body`: one step over buffers that
hold the carry (written back in place), the call's constants and the
step's noise, with t and s read on the device from the step index.  On a
CUDA device `sample()` replays the body as a captured CUDA graph
(`utils/graphs.py`) once per element of t_seq, from a cache per model
(`chain_graphs`) into whose buffers each call copies its state and
constants; the first step of a new capture runs eagerly as its warm-up.
Before each replay the step's draws are made from the generator, or
copied from `step_noise`, into the noise buffers.  With graphs=False,
under `utils.graphs.disabled()` and on the CPU the same body runs eagerly.

Spans (`utils/profiling.py`, recorded while a profiler records): `sample`
around the call; inside it `sample.prepare` (entry to the first step),
`sample.step` per step (its draws, `sample.draw`, and its replay or eager
body) and `sample.out` (the output copies).  None opens inside the body.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence
from diffab_pytorch_tpu_torch.diffusion.orientation import OrientationDiffusionTables
from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffab_pytorch_tpu_torch.geometry import so3
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.models.ipa import precompute_pair_biases
from diffab_pytorch_tpu_torch.utils import graphs as graphs_lib
from diffab_pytorch_tpu_torch.utils.profiling import named_scope, span


def _anchor_indices(residue_idx, chain_idx, residue_mask, generation_mask):
    """Nearest flanking context residues (same chain, by residue index) of
    every position: (prev_idx, next_idx, frac in [0, 1], has_both)."""
    ctx = residue_mask & ~generation_mask
    same_chain = (chain_idx[:, :, None] == chain_idx[:, None, :]) & residue_mask[:, None, :]
    ri = residue_idx.to(torch.float32)
    dseq = residue_idx[:, None, :] - residue_idx[:, :, None]  # j - i
    big = torch.tensor(1e9, dtype=torch.float32, device=ri.device)
    prev_cand = same_chain & ctx[:, None, :] & (dseq < 0)
    next_cand = same_chain & ctx[:, None, :] & (dseq > 0)
    prev_idx = torch.argmax(torch.where(prev_cand, ri[:, None, :], -big), dim=2)
    next_idx = torch.argmin(torch.where(next_cand, ri[:, None, :], big), dim=2)
    has = prev_cand.any(dim=2) & next_cand.any(dim=2)
    ri_prev = torch.gather(ri, 1, prev_idx)
    ri_next = torch.gather(ri, 1, next_idx)
    frac = (ri - ri_prev) / torch.clamp(ri_next - ri_prev, min=1.0)
    return prev_idx, next_idx, frac, has


def _take(a, idx):
    """a[b, idx[b, l]] for a (b, L, ...) and idx (b, L)."""
    idx = idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def anchor_chord(x, residue_idx, chain_idx, residue_mask, generation_mask):
    """Anchor-anchor chord guess for generated spans: each generated residue
    interpolated linearly (by residue index) between the nearest preceding
    and following context residues of its chain.  Returns (x_chord,
    has_anchors); residues without both anchors, and context residues,
    keep their input values (has_anchors False for the former)."""
    gm = generation_mask & residue_mask
    prev_idx, next_idx, frac, has = _anchor_indices(residue_idx, chain_idx, residue_mask,
                                                    generation_mask)
    x_prev = _take(x, prev_idx)
    chord = x_prev + frac[..., None] * (_take(x, next_idx) - x_prev)
    return torch.where((gm & has)[..., None], chord, x), gm & has


def anchor_chord_frames(r, residue_idx, chain_idx, residue_mask, generation_mask):
    """The orientation analogue of `anchor_chord`: geodesic interpolation
    R_prev exp(frac log(R_prev^T R_next)) between the flanking anchors'
    frames; the same has_anchors contract."""
    gm = generation_mask & residue_mask
    prev_idx, next_idx, frac, has = _anchor_indices(residue_idx, chain_idx, residue_mask,
                                                    generation_mask)
    r_prev, r_next = _take(r, prev_idx), _take(r, next_idx)
    rel = so3.compose(r_prev.transpose(-1, -2), r_next)
    chord = so3.compose(r_prev, so3.scale_rot(rel, frac))
    return torch.where((gm & has)[..., None, None], chord, r), gm & has


def timestep_schedule(
    t_start: int,
    n_steps: int | None,
    step_schedule: str = "uniform",
    step_schedule_p: float = 0.5,
    n_fine_tail: int | None = None,
) -> np.ndarray:
    """The descending t-subsequence of the reverse loop (host-side numpy),
    ending at 1; each step jumps to the next element, or to 0 from the
    last.  n_steps None or >= t_start: every t.  "uniform": n_steps evenly
    strided values of t_start..1.  "hight": t(u) = 1 + (t_start - 1)
    (1 - u)^p, dense at high t.  n_fine_tail = k (uniform only): the last
    k steps k..1 at stride 1, the other n_steps - k strided over
    [k + 1, t_start]."""
    t_start = int(t_start)
    if n_fine_tail and step_schedule != "uniform":
        raise ValueError("n_fine_tail composes only with step_schedule='uniform'")
    if n_steps is None or n_steps >= t_start:
        return np.arange(t_start, 0, -1)
    if step_schedule == "hight":
        u = np.linspace(0.0, 1.0, n_steps)
        return np.unique(np.round(
            1.0 + (t_start - 1.0) * (1.0 - u) ** float(step_schedule_p)).astype(np.int64))[::-1]
    if n_fine_tail:
        k = int(n_fine_tail)
        if k >= n_steps:
            raise ValueError(f"n_fine_tail ({k}) must be < n_steps ({n_steps})")
        if k >= t_start:
            return np.arange(t_start, 0, -1)
        coarse = np.unique(
            np.round(np.linspace(t_start, k + 1, n_steps - k)).astype(np.int64))[::-1]
        return np.concatenate([coarse, np.arange(k, 0, -1)])
    return np.unique(np.round(np.linspace(t_start, 1, n_steps)).astype(np.int64))[::-1]


class SampleResult(NamedTuple):
    """Designed sequence and backbone of every residue (context residues
    keep their input values).  With return_trajectory the trajectory
    fields hold the state after each reverse step, in step order (t =
    t_start - 1 ... 0 for the full chain), shape (steps, b n, ...)."""

    seq_idx: torch.Tensor  # (b n, L)
    translations: torch.Tensor  # (b n, L, 3)
    orientations: torch.Tensor  # (b n, L, 3, 3)
    seq_trajectory: torch.Tensor | None = None
    translations_trajectory: torch.Tensor | None = None
    orientations_trajectory: torch.Tensor | None = None


class StepNoise(NamedTuple):
    """The random numbers of one reverse step, for tests that feed the same
    draw to this sampler and to the JAX one.  `coord` serves every
    coordinate arm of the step (posterior, DDIM, the solvers' predictor
    and final step), as the JAX key does; `orientation` both orientation
    modes."""

    gumbel: torch.Tensor  # (b n, L, K) sequence draw
    coord: torch.Tensor  # (b n, L, 3) coordinate noise
    orientation: AxisAngleNoise  # (b n, L) axis-angle draw


class InitNoise(NamedTuple):
    """The random numbers of the initialization, for tests (None: drawn
    from the generator).  seq: the prior's uniform draw (b n, L) (prior
    and chord) or, for t_start < T, the renoising Gumbel draw (b n, L, K);
    coord: x_T (prior) or the forward noise eps at t_start (chord,
    t_start < T); coord_prior: the chord fallback's prior draw; rot: the
    forward axis-angle draw at t_start (t_start < T, chord_orientations);
    rot_prior: the uniform-frame prior's Gaussian quaternions (b n, L, 4)."""

    seq: torch.Tensor | None = None
    coord: torch.Tensor | None = None
    coord_prior: torch.Tensor | None = None
    rot: AxisAngleNoise | None = None
    rot_prior: torch.Tensor | None = None


def _initial_state(model, sched, tables, batch, rep, t_start, init, chord_orientations,
                   seq_ctx, x_ctx, r_ctx, res_mask, seq_gen, struct_gen, generator, noise):
    """(seq, x, R) at t_start (see the module docstring, step 2)."""
    vocab = model.cfg.aa_vocab_size
    tvec = torch.full((seq_ctx.shape[0],), t_start, dtype=torch.long, device=seq_ctx.device)
    if init == "chord":
        x0_guess, has = anchor_chord(x_ctx, rep(batch.residue_idx), rep(batch.chain_idx),
                                     res_mask, struct_gen)
        x_chord, _ = coordinate.diffuse_from_t0(sched, x0_guess, tvec, struct_gen & has,
                                                generator=generator, noise=noise.coord)
        x_prior = coordinate.sample_prior(x_ctx, struct_gen, generator=generator,
                                          noise=noise.coord_prior)
        x_t = torch.where((struct_gen & has)[..., None], x_chord, x_prior)
        seq_t = sequence.sample_prior(seq_ctx, seq_gen, vocab, generator=generator,
                                      sampled=noise.seq)
        r_prior = orientation.sample_prior(r_ctx, struct_gen, generator=generator,
                                           normal=noise.rot_prior)
        if not chord_orientations:
            return seq_t, x_t, r_prior
        r0_guess, r_has = anchor_chord_frames(r_ctx, rep(batch.residue_idx),
                                              rep(batch.chain_idx), res_mask, struct_gen)
        r_chord = orientation.diffuse_from_t0(tables, r0_guess, tvec, struct_gen & r_has,
                                              generator=generator, noise=noise.rot)
        return seq_t, x_t, torch.where((struct_gen & r_has)[..., None, None], r_chord, r_prior)
    if t_start == sched.T:
        return (sequence.sample_prior(seq_ctx, seq_gen, vocab, generator=generator,
                                      sampled=noise.seq),
                coordinate.sample_prior(x_ctx, struct_gen, generator=generator,
                                        noise=noise.coord),
                orientation.sample_prior(r_ctx, struct_gen, generator=generator,
                                         normal=noise.rot_prior))
    # optimization: renoise the batch's own values to t_start
    return (sequence.diffuse_from_t0(sched, seq_ctx, tvec, seq_gen, vocab, generator=generator,
                                     gumbel=noise.seq, return_posterior=False),
            coordinate.diffuse_from_t0(sched, x_ctx, tvec, struct_gen, generator=generator,
                                       noise=noise.coord)[0],
            orientation.diffuse_from_t0(tables, r_ctx, tvec, struct_gen, generator=generator,
                                        noise=noise.rot))


def hoist_denoiser_constants(model: DiffAbModel, pair_emb) -> dict:
    """The t-independent arguments of `model.denoise` for a loop over t:
    `ipa`'s per-layer pair-bias logits and packed fused-layer weights and,
    for a split-trunk model, `geo_ipa`'s (its biases in the compute dtype,
    the numbers the JAX `geo_ipa` projects on every call)."""
    den = model.denoiser
    dt = model.cfg.dtype
    out = dict(pair_biases=[None if b is None else b.to(dt)
                            for b in precompute_pair_biases(den.ipa, pair_emb)],
               kernel_weights=den.ipa.kernel_weights())
    if model.cfg.sc_split_trunk:
        out.update(geo_pair_biases=den.geo_ipa.pair_biases(pair_emb),
                   geo_kernel_weights=den.geo_ipa.kernel_weights())
    return out


_CHAINS: "weakref.WeakKeyDictionary[DiffAbModel, graphs_lib.GraphCache]" = (
    weakref.WeakKeyDictionary())


def chain_graphs(model: DiffAbModel) -> graphs_lib.GraphCache:
    """The captured reverse chains of `model`'s `sample()` calls (dropped
    with the model)."""
    return _CHAINS.setdefault(model, graphs_lib.GraphCache())


_CARRY = ("i", "sc_x", "sc_p", "sc_flag", "ab2_x0", "ab2_lam", "ab2_have")


def _chain_buffers(model: DiffAbModel, c: dict, n_traj: int) -> dict:
    """The buffers the reverse body writes, next to a call's inputs `c`:
    the step index, the step's noise, the carry (reset each call by
    `_reset_carry`) and a trajectory of n_traj steps."""
    x, seq, dev = c["x"], c["seq"], c["x"].device
    shape, vocab, f32 = tuple(seq.shape), model.cfg.aa_vocab_size, c["sched"].beta.dtype
    sigma = c["tables"].igso3.sigmas.dtype
    out = dict(i=torch.empty((1,), dtype=torch.long, device=dev),
               noise=StepNoise(gumbel=torch.empty(shape + (vocab,), dtype=f32, device=dev),
                               coord=torch.empty_like(x),
                               orientation=AxisAngleNoise(*(
                                   torch.empty(shape + tail, dtype=sigma, device=dev)
                                   for tail in ((3,), (), ())))))
    if model.cfg.self_conditioning:  # the estimate carried from step to step
        out.update(sc_x=torch.empty_like(x),
                   sc_p=torch.empty(shape + (vocab,), dtype=x.dtype, device=dev),
                   sc_flag=torch.empty((shape[0],), dtype=torch.float32, device=dev))
    if "lam_tab" in c:  # AB2's previous estimate
        out.update(ab2_x0=torch.empty_like(x), ab2_lam=torch.empty((1,), dtype=f32, device=dev),
                   ab2_have=torch.empty((1,), dtype=torch.bool, device=dev))
    if n_traj:
        out["traj"] = tuple(torch.empty((n_traj,) + tuple(v.shape), dtype=v.dtype, device=dev)
                            for v in (seq, x, c["r"]))
    return out


def _reset_carry(c: dict) -> None:
    """A chain's start: step 0, no self-conditioning or AB2 estimate yet."""
    for k in _CARRY:
        if k in c:
            c[k].zero_()


def _draw_step(noise: StepNoise, generator: torch.Generator) -> None:
    """One reverse step's random numbers, drawn in place into `noise`."""
    g = noise.gumbel.uniform_(generator=generator)
    g.clamp_(min=torch.finfo(g.dtype).tiny).log_().neg_().log_().neg_()
    noise.coord.normal_(generator=generator)
    noise.orientation.axis.normal_(generator=generator)
    noise.orientation.uniform.uniform_(generator=generator)
    noise.orientation.normal.normal_(generator=generator)


def _load_step(noise: StepNoise, given: StepNoise) -> None:
    """Copy an injected step draw into the step's noise buffers."""
    for buf, value in zip((noise.gumbel, noise.coord, *noise.orientation),
                          (given.gumbel, given.coord, *given.orientation)):
        buf.copy_(value)


def _reverse_body(model, opts: dict):
    """The reverse chain's step body, JAX's `body(carry, t_pair)`: from the
    buffers `c` (the carry: state, step index and, where used, the
    self-conditioning estimate, AB2's previous estimate and the trajectory;
    the call's constants, schedule and tables; the step's noise) one jump
    t -> s, written back into the carry in place.  t and s are read on the
    device from the schedule at the step index, and every switch on t is a
    device select or multiply, as in JAX; only Heun's corrector is chosen on
    the host (the `heun_active` argument), since t_seq is known before the
    loop."""
    noise_scale, noise_t_max = opts["noise_scale"], opts["noise_t_max"]
    sc_t_max, ddim_t_min = opts["sc_t_max"], opts["coord_ddim_t_min"]
    solver, solver_t_min = opts["coord_solver"], opts["coord_solver_t_min"]
    sc_on = model.cfg.self_conditioning

    def body(c, heun_active: bool = False):
        sched, tables = c["sched"], c["tables"]
        bn = c["seq"].shape[0]
        t = c["t_seq"].index_select(0, c["i"])  # (1,)
        s_t = c["s_seq"].index_select(0, c["i"])
        tvec, svec = t.expand(bn), s_t.expand(bn)
        seq_t, x_t, r_t, noise = c["seq"], c["x"], c["r"], c["noise"]
        x0_clip, gen = c["x0_clip"], c["gen"]
        sc = {}
        if sc_on:
            flag = c["sc_flag"]
            if sc_t_max is not None:
                flag = flag * (t <= sc_t_max).to(flag.dtype)
            sc = dict(sc_translations_x0=c["sc_x"], sc_seq_probs=c["sc_p"], sc_mask=flag)

        def denoise(seq, x, r, tv):
            return model.denoise(seq, x, r, c["res_emb"], c["pair_emb"], sched.beta[tv], gen,
                                 c["res_mask"], **c["hoisted"], **sc)

        den = denoise(seq_t, x_t, r_t, tvec)
        seq_next = sequence.reverse_step(sched, seq_t, den["seq_posterior"], tvec,
                                         c["seq_gen"], s=svec, gumbel=noise.gumbel)
        ns_t = noise_scale  # noiseless above noise_t_max
        if noise_t_max is not None:
            ns_t = noise_scale * (tvec <= noise_t_max).to(x_t.dtype)[:, None, None]
        r_next = orientation.reverse_step(
            tables, r_t, den["orientations_t0"], tvec, c["struct_gen"],
            noise_scale=opts["orientation_noise_scale"], s=svec,
            mode=opts["orientation_reverse"], noise=noise.orientation)
        eps, z = den["translations_eps"], noise.coord  # one draw for every arm
        if solver == "none":
            step = lambda mode: coordinate.reverse_step(
                sched, x_t, eps, tvec, c["struct_gen"], x0_clip=x0_clip, noise_scale=ns_t,
                s=svec, mode=mode, noise=z)
            x_next = step("posterior")
            if ddim_t_min is not None:  # a per-step select, as JAX's where
                x_next = torch.where((tvec > ddim_t_min)[:, None, None], step("ddim"), x_next)
        else:
            x0_hat = coordinate.predicted_x0(sched, x_t, eps, tvec)
            clip_b = coordinate._per_sample(x0_clip)
            if clip_b is not None:
                x0_hat = torch.clamp(x0_hat, -clip_b, clip_b)
            x0_use = x0_hat
            if solver == "ab2":
                # D = (1 + c) x0_t - c x0_prev, c = h / (2 h_prev); first-order
                # on the first step, at s = 0 and at t <= coord_solver_t_min
                lam_t = c["lam_tab"].index_select(0, t)
                lam_s = c["lam_tab"].index_select(0, s_t)
                coef = (lam_s - lam_t) / (2.0 * torch.clamp(lam_t - c["ab2_lam"], min=1e-6))
                active = (t > solver_t_min) & (s_t >= 1) & c["ab2_have"]
                coef = torch.where(active, coef, torch.zeros_like(coef))
                x0_use = (1.0 + coef) * x0_hat - coef * c["ab2_x0"]
                c["ab2_x0"].copy_(x0_hat)
                c["ab2_lam"].copy_(lam_t)
                c["ab2_have"].fill_(True)
            elif heun_active:  # the denoiser again at the predicted landing point
                x_pred = coordinate.reverse_step_from_x0(
                    sched, x_t, x0_hat, tvec, c["struct_gen"], x0_clip=x0_clip,
                    noise_scale=0.0, s=svec, noise=z)
                d2 = denoise(seq_next, x_pred, r_next, svec)
                x0_2 = coordinate.predicted_x0(sched, x_pred, d2["translations_eps"], svec)
                x0_use = 0.5 * (x0_hat + x0_2)
            x_next = coordinate.reverse_step_from_x0(
                sched, x_t, x0_use, tvec, c["struct_gen"], x0_clip=x0_clip, noise_scale=ns_t,
                s=svec, noise=z)
        if sc_on:
            c["sc_x"].copy_(coordinate.predicted_x0(sched, x_t, eps, tvec))
            c["sc_p"].copy_(den["seq_posterior"])
            c["sc_flag"].fill_(1.0)
        if "traj" in c:
            for buf, value in zip(c["traj"], (seq_next, x_next, r_next)):
                buf.index_copy_(0, c["i"], value[None])
        seq_t.copy_(seq_next)
        x_t.copy_(x_next)
        r_t.copy_(r_next)
        c["i"].add_(1)

    return body


@named_scope("sample")
def sample(
    model: DiffAbModel,
    sched: DiffusionSchedule,
    tables: OrientationDiffusionTables,
    batch: ProteinBatch,
    *,
    generator: torch.Generator | None = None,
    device=None,
    generate_structure: bool = True,
    generate_sequence: bool = True,
    t_start: int | None = None,
    return_trajectory: bool = False,
    x0_clip: object = "auto",
    noise_scale: float = 1.0,
    orientation_noise_scale: float = 1.0,
    orientation_reverse: str = "renoise",
    n_designs: int = 1,
    n_steps: int | None = None,
    sc_t_max: int | None = None,
    coord_ddim_t_min: int | None = None,
    noise_t_max: int | None = None,
    step_schedule: str = "uniform",
    step_schedule_p: float = 0.5,
    n_fine_tail: int | None = None,
    coord_solver: str = "none",
    coord_solver_t_min: int = 0,
    init: str = "prior",
    chord_orientations: bool = False,
    init_noise: InitNoise | None = None,
    step_noise: Callable[[int], StepNoise] | None = None,
    graphs: bool | None = None,
) -> SampleResult:
    """Run the reverse chain; the options are the JAX `sample()`'s (see its
    docstring for each recipe's rationale).  Runs on the card unless
    `device` names another; the model, schedule, tables and batch are
    moved there.  `generator` (on that device) drives every draw not
    injected through `init_noise` (InitNoise) or `step_noise` (t ->
    StepNoise).  x0_clip: "auto" (1.5 x the largest |coordinate| of any
    context residue, per target), a float, or None.  sc_t_max: with a
    self-conditioned model, feed the estimate only at steps t <= sc_t_max
    (None: every step after the first).  graphs: replay the step body as a
    captured CUDA graph (default: on a CUDA device, outside
    `utils.graphs.disabled()`); False runs the same body eagerly."""
    with torch.no_grad():
        with span("sample.prepare"):
            device = resolve_device(device)
            T = sched.T
            t_start = T if t_start is None else int(t_start)
            if not 1 <= t_start <= T:
                raise ValueError(f"t_start must be in [1, {T}], got {t_start}")
            if not (generate_structure or generate_sequence):
                raise ValueError("nothing to generate: both modalities are fixed")
            n = int(n_designs)
            if n < 1:
                raise ValueError(f"n_designs must be >= 1, got {n}")
            if coord_solver not in ("none", "ab2", "heun"):
                raise ValueError(
                    f"coord_solver must be 'none', 'ab2' or 'heun', got {coord_solver!r}")
            if coord_solver != "none" and coord_ddim_t_min is not None:
                raise ValueError("coord_ddim_t_min composes only with coord_solver='none' "
                                 "(the solvers already choose the step form)")
            if init not in ("prior", "chord"):
                raise ValueError(f"init must be 'prior' or 'chord', got {init!r}")
            if step_schedule not in ("uniform", "hight"):
                raise ValueError(
                    f"step_schedule must be 'uniform' or 'hight', got {step_schedule!r}")
            if n_fine_tail is not None and step_schedule != "uniform":
                raise ValueError("n_fine_tail composes only with step_schedule='uniform'")
            if orientation_reverse not in ("renoise", "posterior"):
                raise ValueError(f"unknown orientation reverse mode: {orientation_reverse!r}")
            use_graphs = graphs_lib.use_graphs(device, graphs)
            t_seq = timestep_schedule(t_start, n_steps, step_schedule, step_schedule_p,
                                      n_fine_tail)
            s_seq = np.append(t_seq[1:], 0)

            model = model.to(device)
            sched, tables, batch = sched.to(device), tables.to(device), batch.to(device)
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)

            gen = batch.generation_mask & batch.residue_mask
            seq_gen = gen if generate_sequence else torch.zeros_like(gen)
            struct_gen = gen if generate_structure else torch.zeros_like(gen)
            if isinstance(x0_clip, str):
                if x0_clip != "auto":
                    raise ValueError(f"x0_clip must be 'auto', a float, or None; got {x0_clip!r}")
                ctx = batch.residue_mask & ~batch.generation_mask
                extent = torch.where(ctx[..., None], batch.translations.abs(),
                                     torch.zeros((), device=device)).amax(dim=(1, 2))
                x0_clip = 1.5 * torch.clamp(extent, min=1.0)

            rep = lambda a: torch.repeat_interleave(a, n, dim=0)
            seq_ctx, x_ctx = rep(batch.seq_idx), rep(batch.translations)
            r_ctx, res_mask = rep(batch.orientations), rep(batch.residue_mask)
            gen, seq_gen, struct_gen = rep(gen), rep(seq_gen), rep(struct_gen)
            if isinstance(x0_clip, torch.Tensor):
                x0_clip = rep(x0_clip)

            res_emb, pair_emb = model.encode_context(batch, generate_structure,
                                                     generate_sequence)
            seq_t, x_t, r_t = _initial_state(
                model, sched, tables, batch, rep, t_start, init, chord_orientations, seq_ctx,
                x_ctx, r_ctx, res_mask, seq_gen, struct_gen, generator,
                init_noise or InitNoise())

            # what the step body reads, as JAX's scan closure and initial
            # carry: this call's state, constants, schedule and tables
            inputs = dict(seq=seq_t, x=x_t, r=r_t, sched=sched, tables=tables, res_emb=res_emb,
                          pair_emb=pair_emb, hoisted=hoist_denoiser_constants(model, pair_emb),
                          gen=gen, res_mask=res_mask, seq_gen=seq_gen, struct_gen=struct_gen,
                          x0_clip=x0_clip,
                          t_seq=torch.as_tensor(t_seq.copy(), dtype=torch.long, device=device),
                          s_seq=torch.as_tensor(s_seq, dtype=torch.long, device=device))
            if coord_solver == "ab2":
                # log-SNR lambda(t) = 0.5 log(abar / (1 - abar)), index 0 clamped
                abar_f = torch.clamp(sched.alpha_bar, 1e-12, 1.0 - 1e-12)
                inputs["lam_tab"] = 0.5 * (torch.log(abar_f) - torch.log1p(-abar_f))
            n_traj = len(t_seq) if return_trajectory else 0
            buffers = lambda: _chain_buffers(model, inputs, n_traj)
            opts = dict(noise_scale=noise_scale, noise_t_max=noise_t_max, sc_t_max=sc_t_max,
                        coord_ddim_t_min=coord_ddim_t_min, coord_solver=coord_solver,
                        coord_solver_t_min=coord_solver_t_min,
                        orientation_noise_scale=orientation_noise_scale,
                        orientation_reverse=orientation_reverse)
            body = _reverse_body(model, opts)
            if use_graphs:
                key = (graphs_lib.signature(inputs), n_traj, graphs_lib.mode(),
                       repr(model.cfg), tuple(sorted(opts.items())),
                       graphs_lib.addresses([*model.parameters(), *model.buffers()]))
                chain = chain_graphs(model).get(key, inputs, buffers)
                c = chain.inputs
                run = lambda variant: chain.run(variant,
                                                lambda inputs: body(inputs, *variant))
            else:
                c = {**inputs, **buffers()}
                run = lambda variant: body(c, *variant)
            _reset_carry(c)
        for t, s_t in zip(t_seq.tolist(), s_seq.tolist()):
            with span("sample.step"):
                with span("sample.draw"):
                    if step_noise is None:
                        _draw_step(c["noise"], generator)
                    else:
                        _load_step(c["noise"], step_noise(t))
                heun = coord_solver == "heun" and t > coord_solver_t_min and s_t >= 1
                run((heun,))
        with span("sample.out"):
            out = [c[k].clone() if use_graphs else c[k] for k in ("seq", "x", "r")]
            if return_trajectory:
                out += [v.clone() if use_graphs else v for v in c["traj"]]
    return SampleResult(*out)


def optimize(model, sched, tables, batch, t_restart: int, **kwargs) -> SampleResult:
    """Optimization by partial renoising (t-restart) of the batch's own
    CDRs: `sample(t_start=t_restart)`."""
    return sample(model, sched, tables, batch, t_start=t_restart, **kwargs)
