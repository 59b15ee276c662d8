"""IGSO(3) diffusion on per-residue orientation frames
(`diffab_pytorch_tpu/diffusion/orientation.py`).

Forward: R_t = scale_rot(R_0, sqrt(abar_t)) @ IGSO3-noise(sqrt(1 - abar_t)).

The IGSO(3) sigma table is sqrt(1 - abar_t) indexed by timestep, so the
timestep is the sigma index.  Reverse step ("renoise", the DiffAb-paper
heuristic): apply the forward kernel at s to the predicted R0,
  R_s = scale_rot(R0_hat, sqrt(abar_s)) @ IGSO3-noise(sigma_s),
with zero noise at s = 0 (sigma_0 = 0); or ("posterior") the geodesic
analogue of the DDPM posterior, noised at a sigma between the table's rows.
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
    """One reverse step R_t -> R_s (s defaults to t - 1); context frames
    are kept.  mode "renoise": the forward kernel at s applied to the
    predicted clean frames.  mode "posterior": the rotational analogue of
    the DDPM posterior q(x_s | x_t, x0_hat), with wt = alpha_ts (1 -
    abar_s) / (1 - abar_t) and sigma_tilde = sqrt((1 - abar_s) beta_ts /
    (1 - abar_t)):
      A = scale_rot(R0_hat, sqrt(abar_s)), B = scale_rot(R_t, 1 / sqrt(alpha_ts)),
      R_s = A scale_rot(A^T B, wt) IGSO3(sigma_tilde).
    noise_scale scales the sampled angle in both modes."""
    if s is None:
        s = t - 1
    if mode == "renoise":
        r_prev = _apply_forward_kernel(tables, orientations_t0_hat, s,
                                       noise_scale=noise_scale,
                                       generator=generator, noise=noise)
    elif mode == "posterior":
        sched = tables.sched
        abar_t, abar_s = sched.alpha_bar[t], sched.alpha_bar[s]
        alpha_ts = abar_t / abar_s
        beta_ts = 1.0 - alpha_ts
        one_m_t = torch.clamp(1.0 - abar_t, min=1e-12)
        one_m_s = 1.0 - abar_s
        w_t = alpha_ts * one_m_s / one_m_t  # (b,)
        sigma_tilde = torch.sqrt(torch.clamp(one_m_s * beta_ts / one_m_t, min=0.0))
        a = so3.scale_rot(orientations_t0_hat, torch.sqrt(abar_s))
        b_pt = so3.scale_rot(orientations_t, 1.0 / torch.sqrt(torch.clamp(alpha_ts, min=1e-6)))
        rel = so3.compose(a.transpose(-1, -2), b_pt)
        mean = so3.compose(a, so3.scale_rot(rel, w_t))
        rotvec = igso3_lib.sample_axis_angle_continuous(
            tables.igso3, sigma_tilde, (orientations_t.shape[-3],),
            generator=generator, noise=noise)
        r_prev = so3.compose(mean, so3.vector_to_rotation_matrix(noise_scale * rotvec))
    else:
        raise ValueError(f"unknown orientation reverse mode: {mode!r}")
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


class OrientationDiffuser:
    """The reference's class API over the functions above, holding the
    IGSO(3) tables of a cosine schedule (s, beta_max, on `device`: the card
    unless named) or `tables` as given.  Each draw comes from `generator`,
    or is injected as `noise`."""

    def __init__(self, T: int, s: float = 0.01, beta_max: float = 0.999,
                 tables: OrientationDiffusionTables | None = None, device=None):
        from diffab_pytorch_tpu_torch.config import resolve_device
        from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule

        if tables is None:
            tables = make_orientation_tables(cosine_variance_schedule(
                T, s=s, beta_max=beta_max, device=resolve_device(device)))
        self.tables = tables
        self.sched = tables.sched

    def diffuse_from_t0(self, orientations_t0, generation_mask, t, generator=None, noise=None):
        # the reference's argument order: (orientations, generation_mask, t)
        return diffuse_from_t0(self.tables, orientations_t0, t, generation_mask,
                               generator=generator, noise=noise)

    def reverse_step(self, orientations_t, orientations_t0_hat, t, generation_mask,
                     generator=None, noise=None):
        return reverse_step(self.tables, orientations_t, orientations_t0_hat, t,
                            generation_mask, generator=generator, noise=noise)
