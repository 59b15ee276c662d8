"""Model-based design scoring and ranking
(`diffab_pytorch_tpu/sampling/scoring.py`).

At design time there is no native structure to score a design against.
`score_designs` orders the n designs of a target by a Monte-Carlo
estimate of the diffusion training objective evaluated ON THE DESIGN: the
design is taken as x_0, forward-noised at a grid of timesteps, denoised,
and scored by how well the model's predictions recover it:

  seq_score            cross-entropy of the predicted p(s_0) against the
                       designed sequence
  translations_score   |eps_hat - eps|^2 over the designed CAs
  orientations_score   9 x the mean squared entry of R_pred^T R_design - I

A design the model finds likely denoises back to itself from every t; an
implausible one does not.  Lower is better, and scores compare only the
designs of one target.  The cost is |t_grid| x n_draws denoiser calls
(16 by default) against T for sampling.

The context is encoded once per target, and each layer's pair-bias logits
once, shared by the target's n designs inside attention as in
`sample(n_designs=n)`: the IPA kernels run at b = n x targets with
bp = targets.  A self-conditioned model is scored cold (no estimate), as
the JAX scorer does.  Every draw can be injected (`ScoreDraws`), so tests feed
this scorer the numbers the JAX key schedule draws.  Spans
(`utils/profiling.py`): `score` around the call, `score.prepare` up to the
grid, `score.point` per grid point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence
from diffab_pytorch_tpu_torch.diffusion.orientation import OrientationDiffusionTables
from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult, hoist_denoiser_constants
from diffab_pytorch_tpu_torch.train.losses import orientation_discrepancy
from diffab_pytorch_tpu_torch.utils.profiling import named_scope, span


class DesignScores(NamedTuple):
    """Per-design score vectors (b n,), design-major (row i n + d is design
    d of target i), the sampler's row order.  Lower is better.  `score` is
    the sum of the components; a fixed modality contributes 0."""

    score: torch.Tensor
    seq_score: torch.Tensor
    translations_score: torch.Tensor
    orientations_score: torch.Tensor


class ScoreDraws(NamedTuple):
    """The random numbers of one `score_designs` call, one row per grid
    point in the grid's order (each t, then each draw): G = len(t_grid) x
    n_draws."""

    gumbel: torch.Tensor  # (G, b n, L, K) sequence forward draw
    coord: torch.Tensor  # (G, b n, L, 3) coordinate noise eps
    orientation: AxisAngleNoise  # (G, b n, L) axis-angle draws

    def point(self, i: int):
        """(gumbel, coord, orientation) of grid point i."""
        return self.gumbel[i], self.coord[i], AxisAngleNoise(*(a[i] for a in self.orientation))

    def to(self, device) -> "ScoreDraws":
        return ScoreDraws(self.gumbel.to(device), self.coord.to(device),
                          AxisAngleNoise(*(a.to(device) for a in self.orientation)))


def _masked_row_mean(elem, mask):
    m = mask.to(torch.float32)
    return torch.sum(elem * m, dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)


def default_t_grid(T: int) -> np.ndarray:
    """8 timesteps evenly spaced over [1, T/4], rounded half to even
    (numpy's rounding, as the JAX scorer's), duplicates removed.  Low t
    discriminates best: x_t is nearly the design, so an implausible design
    cannot hide behind the noise."""
    return np.unique(np.round(np.linspace(1, max(T // 4, 1), num=8)).astype(np.int64))


@named_scope("score")
def score_designs(
    model: DiffAbModel,
    sched: DiffusionSchedule,
    tables: OrientationDiffusionTables,
    batch: ProteinBatch,
    designs: SampleResult,
    *,
    generator: torch.Generator | None = None,
    device=None,
    draws: ScoreDraws | None = None,
    generate_structure: bool = True,
    generate_sequence: bool = True,
    t_grid: Optional[Sequence[int]] = None,
    n_draws: int = 2,
) -> DesignScores:
    """Score the designs of `batch`'s b targets.

    batch:   the targets the designs were sampled from (context features
             and masks come from here).
    designs: b n rows, design-major, as `sample(n_designs=n)` returns them;
             n is the row ratio.
    t_grid:  the grid's timesteps (default `default_t_grid(T)`), each in
             [1, T]; n_draws noise draws per timestep.
    draws:   the grid's random numbers (`ScoreDraws`); None draws them from
             `generator` (on the device).

    generate_structure / generate_sequence must be the sampling mode's: a
    fixed modality was not generated, is the same in every design and is
    part of the context.  Runs on the card unless `device` names another;
    the model, schedule, tables, batch and designs are moved there."""
    with torch.no_grad():
        with span("score.prepare"):
            device = resolve_device(device)
            b = batch.batch_size
            bn = designs.seq_idx.shape[0]
            if bn % b:
                raise ValueError(f"designs rows {bn} not a multiple of batch {b}")
            n = bn // b
            if not (generate_structure or generate_sequence):
                raise ValueError("nothing was generated: both modalities are fixed")
            T = sched.T
            if t_grid is None:
                t_grid = default_t_grid(T)
            n_draws = max(1, int(n_draws))
            t_arr = [int(t) for t in t_grid for _ in range(n_draws)]
            if not all(1 <= t <= T for t in t_arr):
                raise ValueError(f"t_grid values must be in [1, {T}]")
            if draws is not None and draws.gumbel.shape[0] != len(t_arr):
                raise ValueError(f"draws hold {draws.gumbel.shape[0]} grid points, the grid has "
                                 f"{len(t_arr)}")

            model = model.to(device)
            sched, tables, batch = sched.to(device), tables.to(device), batch.to(device)
            seq_d = designs.seq_idx.to(device)
            x_d = designs.translations.to(device)
            r_d = designs.orientations.to(device)
            if draws is not None:
                draws = draws.to(device)
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)

            gen = batch.generation_mask & batch.residue_mask
            seq_gen = gen if generate_sequence else torch.zeros_like(gen)
            struct_gen = gen if generate_structure else torch.zeros_like(gen)
            rep = (lambda a: torch.repeat_interleave(a, n, dim=0)) if n > 1 else (lambda a: a)
            gen, seq_gen, struct_gen = rep(gen), rep(seq_gen), rep(struct_gen)
            res_mask = rep(batch.residue_mask)

            # the context once per target, the bias logits once per layer
            res_emb, pair_emb = model.encode_context(batch, generate_structure,
                                                     generate_sequence)
            hoisted = hoist_denoiser_constants(model, pair_emb)
            r_d32 = r_d.to(torch.float32)

            zero = torch.zeros((bn,), dtype=torch.float32, device=device)
            seq_s, trans_s, orient_s = zero, zero.clone(), zero.clone()

        for i, t in enumerate(t_arr):
            with span("score.point"):
                gumbel, coord_noise, rot_noise = ((None, None, None) if draws is None
                                                  else draws.point(i))
                tvec = torch.full((bn,), t, dtype=torch.long, device=device)
                seq_t = sequence.diffuse_from_t0(sched, seq_d, tvec, seq_gen,
                                                 model.cfg.aa_vocab_size, generator=generator,
                                                 gumbel=gumbel, return_posterior=False)
                x_t, eps = coordinate.diffuse_from_t0(sched, x_d, tvec, struct_gen,
                                                      generator=generator, noise=coord_noise)
                r_t = orientation.diffuse_from_t0(tables, r_d, tvec, struct_gen,
                                                  generator=generator, noise=rot_noise)
                # a self-conditioned model scores cold: no estimate
                den = model.denoise(seq_t, x_t, r_t, res_emb, pair_emb, sched.beta[tvec], gen,
                                    res_mask, **hoisted)

                log_p0 = torch.log_softmax(den["seq_logits"].to(torch.float32), dim=-1)
                ce = -torch.gather(log_p0, -1, seq_d[..., None])[..., 0]
                seq_s = seq_s + _masked_row_mean(ce, seq_gen)
                eps_err = torch.sum((den["translations_eps"].to(torch.float32)
                                     - eps.to(torch.float32)) ** 2, dim=-1)
                trans_s = trans_s + _masked_row_mean(eps_err, struct_gen)
                orient_err = 9.0 * orientation_discrepancy(
                    den["orientations_t0"].to(torch.float32), r_d32)
                orient_s = orient_s + _masked_row_mean(orient_err, struct_gen)

        steps = float(len(t_arr))
        seq_s, trans_s, orient_s = seq_s / steps, trans_s / steps, orient_s / steps
    return DesignScores(score=seq_s + trans_s + orient_s, seq_score=seq_s, translations_score=trans_s,
                        orientations_score=orient_s)


def rank_per_target(scores: torch.Tensor, n_designs: int) -> torch.Tensor:
    """The designs of each target by ascending score (best first), ties in
    row order: (b n,) design-major scores -> (b, n) int64; target i's
    rank-r design is flat row i n + out[i, r]."""
    return torch.argsort(scores.reshape(-1, n_designs), dim=-1, stable=True)
