"""The reverse-diffusion sampler (`diffab_pytorch_tpu/sampling/sampler.py`),
main path: generation from the prior over the full T-step chain.

  1. encode the context once and precompute every layer's pair-bias logits
     and packed fused-layer weights (all t-independent);
  2. initialize generated positions from the priors (s_T uniform, x_T ~
     N(0, I), R_T uniform on SO(3)), context positions from the batch;
  3. per step t = T..1: denoise, then the three reverse kernels (sequence
     posterior draw, DDPM posterior, IGSO(3) renoise at t-1 of the
     predicted R0); context residues are clamped.

With n_designs = n every batch row gets n designs that share one copy of
its context (embeddings, pair tensor, bias logits); output row i n + d is
design d of target i.  The JAX `lax.scan` is a Python loop here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence
from diffab_pytorch_tpu_torch.diffusion.orientation import OrientationDiffusionTables
from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.models.ipa import precompute_pair_biases


class SampleResult(NamedTuple):
    seq_idx: torch.Tensor  # (b n, L)
    translations: torch.Tensor  # (b n, L, 3)
    orientations: torch.Tensor  # (b n, L, 3, 3)


class StepNoise(NamedTuple):
    """The random numbers of one reverse step, for tests that feed the same
    draw to this sampler and to the JAX one."""

    gumbel: torch.Tensor  # (b n, L, K) sequence draw
    coord: torch.Tensor  # (b n, L, 3) coordinate noise
    orientation: AxisAngleNoise  # (b n, L) axis-angle draw


# options of the JAX sampler that this slice has not ported
_NOT_PORTED = {
    "init": "prior", "n_steps": None, "n_fine_tail": None,
    "coord_solver": "none", "noise_t_max": None, "coord_ddim_t_min": None,
    "orientation_reverse": "renoise", "return_trajectory": False,
    "sc_t_max": None, "chord_orientations": False,
}


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
    x0_clip: object = "auto",
    noise_scale: float = 1.0,
    orientation_noise_scale: float = 1.0,
    n_designs: int = 1,
    initial_state: tuple | None = None,
    step_noise: Callable[[int], StepNoise] | None = None,
    **options,
) -> SampleResult:
    """Run the full reverse chain.  Runs on the card unless `device` names
    another; the model, schedule, tables and batch are moved there.
    `generator` (on that device) drives every draw not injected through
    `initial_state` ((seq_T, x_T, R_T) at b n rows) or `step_noise`
    (t -> StepNoise).  x0_clip: "auto" (1.5 x the largest |coordinate| of
    any context residue, per target), a float, or None."""
    device = resolve_device(device)
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"sample() got an unexpected keyword argument {name!r}")
        if value != _NOT_PORTED[name]:
            raise NotImplementedError(f"sample({name}={value!r}) is not ported yet")
    T = sched.T
    if t_start is not None and int(t_start) != T:
        raise NotImplementedError("t_start < T (optimization by renoising) is not ported yet")
    if not (generate_structure or generate_sequence):
        raise ValueError("nothing to generate: both modalities are fixed")
    n = int(n_designs)
    if n < 1:
        raise ValueError(f"n_designs must be >= 1, got {n}")

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
        ipa = model.denoiser.ipa
        dt = model.cfg.dtype
        pair_biases = [bias.to(dt) for bias in precompute_pair_biases(ipa, pair_emb)]
        kernel_weights = ipa.kernel_weights()

        if initial_state is None:
            seq_t = sequence.sample_prior(seq_ctx, seq_gen, model.cfg.aa_vocab_size,
                                          generator=generator)
            x_t = coordinate.sample_prior(x_ctx, struct_gen, generator=generator)
            r_t = orientation.sample_prior(r_ctx, struct_gen, generator=generator)
        else:
            seq_t, x_t, r_t = (s.to(device) for s in initial_state)
            seq_t = torch.where(seq_gen, seq_t, seq_ctx)
            x_t = torch.where(struct_gen[..., None], x_t, x_ctx)
            r_t = torch.where(struct_gen[..., None, None], r_t, r_ctx)

        for t in range(T, 0, -1):
            tvec = torch.full((bn,), t, dtype=torch.long, device=device)
            noise = None if step_noise is None else step_noise(t)
            den = model.denoise(seq_t, x_t, r_t, res_emb, pair_emb,
                                sched.beta[tvec], gen, res_mask,
                                pair_biases=pair_biases,
                                kernel_weights=kernel_weights)
            seq_t_next = sequence.reverse_step(
                sched, seq_t, den["seq_posterior"], tvec, seq_gen,
                generator=generator, gumbel=None if noise is None else noise.gumbel)
            r_t = orientation.reverse_step(
                tables, r_t, den["orientations_t0"], tvec, struct_gen,
                noise_scale=orientation_noise_scale, generator=generator,
                noise=None if noise is None else noise.orientation)
            x_t = coordinate.reverse_step(
                sched, x_t, den["translations_eps"], tvec, struct_gen,
                x0_clip=x0_clip, noise_scale=noise_scale, generator=generator,
                noise=None if noise is None else noise.coord)
            seq_t = seq_t_next
    return SampleResult(seq_idx=seq_t, translations=x_t, orientations=r_t)
