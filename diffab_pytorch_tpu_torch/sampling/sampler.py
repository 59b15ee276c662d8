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
design d of target i.  The JAX `lax.scan` is a Python loop here.  Every
draw can be injected (`init_noise` and `step_noise`), so tests feed this
sampler the numbers the JAX key schedule draws.
"""

from __future__ import annotations

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
    out = dict(pair_biases=[b.to(dt) for b in precompute_pair_biases(den.ipa, pair_emb)],
               kernel_weights=den.ipa.kernel_weights())
    if model.cfg.sc_split_trunk:
        out.update(geo_pair_biases=den.geo_ipa.pair_biases(pair_emb),
                   geo_kernel_weights=den.geo_ipa.kernel_weights())
    return out


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
) -> SampleResult:
    """Run the reverse chain; the options are the JAX `sample()`'s (see its
    docstring for each recipe's rationale).  Runs on the card unless
    `device` names another; the model, schedule, tables and batch are
    moved there.  `generator` (on that device) drives every draw not
    injected through `init_noise` (InitNoise) or `step_noise` (t ->
    StepNoise).  x0_clip: "auto" (1.5 x the largest |coordinate| of any
    context residue, per target), a float, or None.  sc_t_max: with a
    self-conditioned model, feed the estimate only at steps t <= sc_t_max
    (None: every step after the first)."""
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
        raise ValueError(f"coord_solver must be 'none', 'ab2' or 'heun', got {coord_solver!r}")
    if coord_solver != "none" and coord_ddim_t_min is not None:
        raise ValueError("coord_ddim_t_min composes only with coord_solver='none' "
                         "(the solvers already choose the step form)")
    if init not in ("prior", "chord"):
        raise ValueError(f"init must be 'prior' or 'chord', got {init!r}")
    if step_schedule not in ("uniform", "hight"):
        raise ValueError(f"step_schedule must be 'uniform' or 'hight', got {step_schedule!r}")
    if n_fine_tail is not None and step_schedule != "uniform":
        raise ValueError("n_fine_tail composes only with step_schedule='uniform'")
    if orientation_reverse not in ("renoise", "posterior"):
        raise ValueError(f"unknown orientation reverse mode: {orientation_reverse!r}")
    t_seq = timestep_schedule(t_start, n_steps, step_schedule, step_schedule_p, n_fine_tail)
    s_seq = np.append(t_seq[1:], 0)

    model = model.to(device)
    sched, tables, batch = sched.to(device), tables.to(device), batch.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    with torch.no_grad():
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
        bn = batch.batch_size * n

        res_emb, pair_emb = model.encode_context(batch, generate_structure,
                                                 generate_sequence)
        hoisted = hoist_denoiser_constants(model, pair_emb)

        seq_t, x_t, r_t = _initial_state(
            model, sched, tables, batch, rep, t_start, init, chord_orientations, seq_ctx,
            x_ctx, r_ctx, res_mask, seq_gen, struct_gen, generator, init_noise or InitNoise())

        def denoise(seq, x, r, tvec, **sc):
            return model.denoise(seq, x, r, res_emb, pair_emb, sched.beta[tvec], gen,
                                 res_mask, **hoisted, **sc)

        sc_on = model.cfg.self_conditioning
        if sc_on:  # the estimate carried from step to step; none yet
            sc_x = torch.zeros_like(x_t)
            sc_p = torch.zeros(seq_t.shape + (model.cfg.aa_vocab_size,), dtype=x_t.dtype,
                               device=device)
            sc_flag = torch.zeros((bn,), dtype=torch.float32, device=device)

        if coord_solver == "ab2":
            # log-SNR lambda(t) = 0.5 log(abar / (1 - abar)), index 0 clamped
            abar_f = torch.clamp(sched.alpha_bar, 1e-12, 1.0 - 1e-12)
            lam_tab = 0.5 * (torch.log(abar_f) - torch.log1p(-abar_f))
            ab2_prev = None  # (x0 estimate, lambda) of the previous step
        clip_b = coordinate._per_sample(x0_clip)
        trajectory = []
        for t, s_t in zip(t_seq.tolist(), s_seq.tolist()):
            tvec = torch.full((bn,), t, dtype=torch.long, device=device)
            svec = torch.full((bn,), s_t, dtype=torch.long, device=device)
            noise = None if step_noise is None else step_noise(t)
            sc = {}
            if sc_on:
                flag = sc_flag if sc_t_max is None else sc_flag * float(t <= sc_t_max)
                sc = dict(sc_translations_x0=sc_x, sc_seq_probs=sc_p, sc_mask=flag)
            den = denoise(seq_t, x_t, r_t, tvec, **sc)
            seq_next = sequence.reverse_step(
                sched, seq_t, den["seq_posterior"], tvec, seq_gen, s=svec,
                generator=generator, gumbel=None if noise is None else noise.gumbel)
            # noiseless above noise_t_max
            ns_t = noise_scale if noise_t_max is None else noise_scale * float(t <= noise_t_max)
            r_next = orientation.reverse_step(
                tables, r_t, den["orientations_t0"], tvec, struct_gen,
                noise_scale=orientation_noise_scale, s=svec, mode=orientation_reverse,
                generator=generator, noise=None if noise is None else noise.orientation)
            # one coordinate draw for every arm of the step
            z = (torch.randn(x_t.shape, generator=generator, dtype=x_t.dtype, device=device)
                 if noise is None else noise.coord)
            eps = den["translations_eps"]
            if coord_solver == "none":
                mode = ("ddim" if coord_ddim_t_min is not None and t > coord_ddim_t_min
                        else "posterior")
                x_next = coordinate.reverse_step(sched, x_t, eps, tvec, struct_gen,
                                                 x0_clip=x0_clip, noise_scale=ns_t, s=svec,
                                                 mode=mode, noise=z)
            else:
                x0_hat = coordinate.predicted_x0(sched, x_t, eps, tvec)
                if clip_b is not None:
                    x0_hat = torch.clamp(x0_hat, -clip_b, clip_b)
                active = t > coord_solver_t_min and s_t >= 1
                if coord_solver == "ab2":
                    lam_t, lam_s = lam_tab[t], lam_tab[s_t]
                    x0_use = x0_hat
                    if active and ab2_prev is not None:
                        # D = (1 + c) x0_t - c x0_prev, c = h / (2 h_prev)
                        x0_prev, lam_prev = ab2_prev
                        c = (lam_s - lam_t) / (2.0 * torch.clamp(lam_t - lam_prev, min=1e-6))
                        x0_use = (1.0 + c) * x0_hat - c * x0_prev
                    ab2_prev = (x0_hat, lam_t)
                else:  # heun: the denoiser again at the predicted landing point
                    x0_use = x0_hat
                    if active:
                        x_pred = coordinate.reverse_step_from_x0(
                            sched, x_t, x0_hat, tvec, struct_gen, x0_clip=x0_clip,
                            noise_scale=0.0, s=svec, noise=z)
                        d2 = denoise(seq_next, x_pred, r_next, svec, **sc)
                        x0_2 = coordinate.predicted_x0(sched, x_pred, d2["translations_eps"],
                                                       svec)
                        x0_use = 0.5 * (x0_hat + x0_2)
                x_next = coordinate.reverse_step_from_x0(
                    sched, x_t, x0_use, tvec, struct_gen, x0_clip=x0_clip, noise_scale=ns_t,
                    s=svec, noise=z)
            if sc_on:
                sc_x = coordinate.predicted_x0(sched, x_t, eps, tvec)
                sc_p = den["seq_posterior"]
                sc_flag = torch.ones((bn,), dtype=torch.float32, device=device)
            seq_t, x_t, r_t = seq_next, x_next, r_next
            if return_trajectory:
                trajectory.append((seq_t, x_t, r_t))
    if not return_trajectory:
        return SampleResult(seq_idx=seq_t, translations=x_t, orientations=r_t)
    seq_tr, x_tr, r_tr = (torch.stack(parts) for parts in zip(*trajectory))
    return SampleResult(seq_t, x_t, r_t, seq_tr, x_tr, r_tr)


def optimize(model, sched, tables, batch, t_restart: int, **kwargs) -> SampleResult:
    """Optimization by partial renoising (t-restart) of the batch's own
    CDRs: `sample(t_start=t_restart)`."""
    return sample(model, sched, tables, batch, t_start=t_restart, **kwargs)
