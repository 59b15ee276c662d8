"""IGSO(3) diffusion on per-residue orientation frames
(`diffab_pytorch_tpu/diffusion/orientation.py`).

Forward: R_t = scale_rot(R_0, sqrt(abar_t)) @ IGSO3-noise(sqrt(1 - abar_t)).

The IGSO(3) sigma table is sqrt(1 - abar_t) indexed by timestep, so the
timestep is the sigma index.  Reverse step ("renoise", the DiffAb-paper
heuristic): apply the forward kernel at s to the predicted R0,
  R_s = scale_rot(R0_hat, sqrt(abar_s)) @ IGSO3-noise(sigma_s),
with zero noise at s = 0 (sigma_0 = 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffab_pytorch_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffab_pytorch_tpu_torch.geometry import igso3 as igso3_lib
from diffab_pytorch_tpu_torch.geometry import so3


class OrientationDiffusionTables(NamedTuple):
    sched: DiffusionSchedule
    igso3: igso3_lib.IGSO3Table

    def to(self, device) -> "OrientationDiffusionTables":
        return OrientationDiffusionTables(self.sched.to(device),
                                          self.igso3.to(device))


def make_orientation_tables(
    sched: DiffusionSchedule,
    n_bins: int = igso3_lib.DEFAULT_N_BINS,
    n_terms: int = igso3_lib.DEFAULT_N_TERMS,
    sigma_threshold: float = igso3_lib.DEFAULT_SIGMA_THRESHOLD,
) -> OrientationDiffusionTables:
    """IGSO(3) tables over sigma_t = sqrt(1 - abar_t) for every t, built
    once (float64 numpy) on the schedule's device."""
    sigmas = sched.one_minus_alpha_bar_sqrt.detach().cpu().numpy().astype(np.float64)
    table = igso3_lib.build_igso3_table(
        sigmas, n_bins=n_bins, n_terms=n_terms, sigma_threshold=sigma_threshold,
        device=sched.beta.device,
    )
    return OrientationDiffusionTables(sched=sched, igso3=table)


def _apply_forward_kernel(
    tables: OrientationDiffusionTables,
    orientations: torch.Tensor,  # (b, L, 3, 3)
    t: torch.Tensor,  # (b,) timestep == sigma index
    noise_scale: float = 1.0,
    generator: torch.Generator | None = None,
    noise: igso3_lib.AxisAngleNoise | None = None,
) -> torch.Tensor:
    """scale_rot(R, sqrt(abar_t)) @ IGSO3-noise(sigma_t); noise_scale
    scales the sampled angle."""
    n_residues = orientations.shape[-3]
    mean = so3.scale_rot(orientations, tables.sched.alpha_bar_sqrt[t])
    rotvec = igso3_lib.sample_axis_angle(tables.igso3, t, (n_residues,),
                                         generator=generator, noise=noise)
    return so3.compose(mean, so3.vector_to_rotation_matrix(noise_scale * rotvec))


def diffuse_from_t0(
    tables: OrientationDiffusionTables,
    orientations_t0: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: igso3_lib.AxisAngleNoise | None = None,
) -> torch.Tensor:
    """R_t ~ IGSO3(scale_rot(R_0, sqrt(abar_t)), sqrt(1 - abar_t)) on
    generated positions; `noise` injects the axis-angle draw."""
    r_t = _apply_forward_kernel(tables, orientations_t0, t, generator=generator,
                                noise=noise)
    return torch.where(generation_mask[..., None, None], r_t, orientations_t0)


def reverse_step(
    tables: OrientationDiffusionTables,
    orientations_t: torch.Tensor,
    orientations_t0_hat: torch.Tensor,
    t: torch.Tensor,
    generation_mask: torch.Tensor,
    noise_scale: float = 1.0,
    s: torch.Tensor | None = None,
    mode: str = "renoise",
    generator: torch.Generator | None = None,
    noise: igso3_lib.AxisAngleNoise | None = None,
) -> torch.Tensor:
    """One reverse step R_t -> R_s (s defaults to t - 1) by renoising the
    predicted clean frames to level s; context frames are kept."""
    if mode != "renoise":
        raise NotImplementedError(
            f"orientation reverse mode {mode!r} is not ported; use 'renoise'"
        )
    if s is None:
        s = t - 1
    r_prev = _apply_forward_kernel(tables, orientations_t0_hat, s,
                                   noise_scale=noise_scale,
                                   generator=generator, noise=noise)
    return torch.where(generation_mask[..., None, None], r_prev, orientations_t)


def sample_prior(
    orientations_context: torch.Tensor,
    generation_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    normal: torch.Tensor | None = None,
) -> torch.Tensor:
    """R_T ~ uniform on SO(3) for generated positions; context keeps its
    frames.  `normal` (b, L, 4) injects the quaternion draw."""
    r = so3.uniform(orientations_context.shape[:-2], generator=generator,
                    normal=normal, dtype=orientations_context.dtype,
                    device=orientations_context.device)
    return torch.where(generation_mask[..., None, None], r, orientations_context)
