"""IGSO(3) angular density tables and sampling
(`diffab_pytorch_tpu/geometry/igso3.py`).

The (n_sigmas, n_bins) table is one float64 numpy build at set-up and is
converted to float32 tensors afterwards.  Sampling draws the angle from
the piecewise-linear inverse CDF (small sigma) or from N(2 sigma, sigma^2)
folded into [0, pi) (sigma >= threshold); the axis is a normalized 3D
Gaussian.  Every draw can be injected (`AxisAngleNoise`), so tests feed the
same numbers to this module and to the JAX one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_N_BINS = 8192
DEFAULT_N_TERMS = 1024
DEFAULT_SIGMA_THRESHOLD = 0.1


class IGSO3Table(NamedTuple):
    """Per-sigma angular tables: sigmas (S,), probs / cdf (S, n_bins),
    inv_cdf (S, n_bins + 1) theta at evenly spaced quantiles, use_hist (S,)."""

    sigmas: torch.Tensor
    probs: torch.Tensor
    cdf: torch.Tensor
    inv_cdf: torch.Tensor
    use_hist: torch.Tensor

    @property
    def n_bins(self) -> int:
        return self.probs.shape[-1]

    def to(self, device) -> "IGSO3Table":
        return IGSO3Table(*(t.to(device) for t in self))


class AxisAngleNoise(NamedTuple):
    """The random numbers of one axis-angle draw of shape S:
    axis (S + (3,)) standard normal, uniform (S) in [0, 1), normal (S)."""

    axis: torch.Tensor
    uniform: torch.Tensor
    normal: torch.Tensor

    @staticmethod
    def draw(shape, generator=None, dtype=torch.float32, device="cpu"):
        shape = tuple(shape)
        kw = dict(generator=generator, dtype=dtype, device=device)
        return AxisAngleNoise(
            axis=torch.randn(shape + (3,), **kw),
            uniform=torch.rand(shape, **kw),
            normal=torch.randn(shape, **kw),
        )


def igso3_angular_pdf(theta, sigmas, n_terms: int = DEFAULT_N_TERMS) -> np.ndarray:
    """IGSO(3) angular density on a (S, len(theta)) grid, float64 on host:
    (1 - cos theta)/pi * sum_l (2l+1) e^{-l(l+1) sigma^2}
    sin((l+1/2) theta)/sin(theta/2)."""
    theta = np.asarray(theta, dtype=np.float64)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    ls = np.arange(n_terms, dtype=np.float64)
    coef = (2.0 * ls + 1.0) * np.exp(-ls * (ls + 1.0) * sigmas[:, None] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ang = np.sin((ls[:, None] + 0.5) * theta[None, :]) / np.sin(theta[None, :] / 2.0)
    pdf = (1.0 - np.cos(theta))[None, :] / np.pi * (coef @ ang)
    return np.clip(np.nan_to_num(pdf), 0.0, None)


def build_igso3_table(
    sigmas,
    n_bins: int = DEFAULT_N_BINS,
    n_terms: int = DEFAULT_N_TERMS,
    sigma_threshold: float = DEFAULT_SIGMA_THRESHOLD,
    device="cpu",
) -> IGSO3Table:
    """Build the sampling tables for a sigma grid (float64 on host, float32
    tensors out).  n_bins equal bins over [0, pi), pdf at bin centres;
    rows whose truncated series has not converged (sigma * n_terms < 6) or
    sums to zero fall back to a point mass at theta ~ 0."""
    sigmas = np.asarray(sigmas, dtype=np.float64).reshape(-1)
    binsize = np.pi / n_bins
    bin_centers = np.arange(n_bins, dtype=np.float64) * binsize + binsize / 2.0
    probs = igso3_angular_pdf(bin_centers, sigmas, n_terms=n_terms)
    row_sum = probs.sum(axis=-1, keepdims=True)
    degenerate = (row_sum <= 0.0) | (sigmas[:, None] * n_terms < 6.0)
    fallback = np.zeros_like(probs)
    fallback[:, 0] = 1.0
    probs = np.where(degenerate, fallback, probs / np.where(degenerate, 1.0, row_sum))
    cdf = np.cumsum(probs, axis=-1)
    cdf = cdf / cdf[:, -1:]
    n_q = n_bins + 1
    quantiles = np.linspace(0.0, 1.0, n_q)
    edges = np.arange(n_bins + 1, dtype=np.float64) * binsize
    inv = np.empty((sigmas.size, n_q), np.float64)
    for i in range(sigmas.size):
        inv[i] = np.interp(quantiles, np.concatenate([[0.0], cdf[i]]), edges)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return IGSO3Table(
        sigmas=f32(sigmas),
        probs=f32(probs),
        cdf=f32(cdf),
        inv_cdf=f32(inv),
        use_hist=torch.as_tensor(sigmas < sigma_threshold, device=device),
    )


def sample_angle(
    table: IGSO3Table,
    sigma_idx: torch.Tensor,
    sample_shape: tuple,
    uniform: torch.Tensor,
    normal: torch.Tensor,
) -> torch.Tensor:
    """Rotation angles of shape sigma_idx.shape + sample_shape, each drawn
    from the distribution of sigmas[sigma_idx] with the given uniform and
    normal numbers: inverse-CDF lerp for small sigma, folded Gaussian
    otherwise."""
    out_shape = tuple(sigma_idx.shape) + tuple(sample_shape)
    expand = tuple(sigma_idx.shape) + (1,) * len(sample_shape)
    n_q = table.inv_cdf.shape[-1]
    flat_idx = sigma_idx.reshape(-1)
    inv_rows = table.inv_cdf[flat_idx]  # (S, n_q)
    pos = uniform * (n_q - 1)
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_q - 2)
    frac = pos - i0.to(pos.dtype)
    i0_rows = i0.reshape(flat_idx.shape[0], -1)
    t0 = torch.gather(inv_rows, 1, i0_rows).reshape(out_shape)
    t1 = torch.gather(inv_rows, 1, i0_rows + 1).reshape(out_shape)
    theta_hist = t0 * (1.0 - frac) + t1 * frac

    sig = table.sigmas[sigma_idx].reshape(expand)
    theta_gauss = torch.remainder(2.0 * sig + sig * normal, math.pi)
    use_hist = table.use_hist[sigma_idx].reshape(expand)
    return torch.where(use_hist, theta_hist, theta_gauss)


def sample_axis_angle(
    table: IGSO3Table,
    sigma_idx: torch.Tensor,
    sample_shape: tuple,
    generator: torch.Generator | None = None,
    noise: AxisAngleNoise | None = None,
) -> torch.Tensor:
    """Axis-angle vectors from IGSO3(I, sigmas[sigma_idx]), shape
    sigma_idx.shape + sample_shape + (3,): a uniform axis on S^2 times an
    angle from `sample_angle`.  `noise` injects the draw."""
    out_shape = tuple(sigma_idx.shape) + tuple(sample_shape)
    if noise is None:
        noise = AxisAngleNoise.draw(out_shape, generator, table.sigmas.dtype,
                                    table.sigmas.device)
    axis = noise.axis / torch.linalg.norm(noise.axis, dim=-1, keepdim=True)
    theta = sample_angle(table, sigma_idx, sample_shape, noise.uniform,
                         noise.normal)
    return axis * theta[..., None]


def sample_angle_continuous(
    table: IGSO3Table,
    sigma: torch.Tensor,
    sample_shape: tuple,
    uniform: torch.Tensor,
    normal: torch.Tensor,
    sigma_threshold: float = DEFAULT_SIGMA_THRESHOLD,
) -> torch.Tensor:
    """Rotation angles of shape sigma.shape + sample_shape at arbitrary
    sigma values (not only the table's rows), with the given uniform and
    normal numbers: the folded Gaussian N(2 sigma, sigma^2) mod pi for
    sigma >= sigma_threshold; below it, the piecewise-linear inverse CDFs
    of the two bracketing table rows read at the same quantile and lerped
    by sigma.  table.sigmas must be ascending (true for schedule tables)."""
    out_shape = tuple(sigma.shape) + tuple(sample_shape)
    expand = tuple(sigma.shape) + (1,) * len(sample_shape)
    srt = table.sigmas
    hi = torch.clamp(torch.searchsorted(srt, sigma.contiguous()), 1, srt.shape[0] - 1)
    lo = hi - 1
    w = (sigma - srt[lo]) / torch.clamp(srt[hi] - srt[lo], min=1e-12)
    w = torch.clamp(w, 0.0, 1.0).reshape(expand)

    n_q = table.inv_cdf.shape[-1]
    pos = uniform * (n_q - 1)
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_q - 2)
    frac = pos - i0.to(pos.dtype)

    def row_theta(idx):
        flat = idx.reshape(-1)
        rows = table.inv_cdf[flat]  # (S, n_q)
        i0_rows = i0.reshape(flat.shape[0], -1)
        t0 = torch.gather(rows, 1, i0_rows).reshape(out_shape)
        t1 = torch.gather(rows, 1, i0_rows + 1).reshape(out_shape)
        return t0 * (1.0 - frac) + t1 * frac

    theta_hist = (1.0 - w) * row_theta(lo) + w * row_theta(hi)
    sig = sigma.reshape(expand).to(table.sigmas.dtype)
    theta_gauss = torch.remainder(2.0 * sig + sig * normal, math.pi)
    return torch.where(sig < sigma_threshold, theta_hist, theta_gauss)


def sample_axis_angle_continuous(
    table: IGSO3Table,
    sigma: torch.Tensor,
    sample_shape: tuple,
    generator: torch.Generator | None = None,
    noise: AxisAngleNoise | None = None,
    sigma_threshold: float = DEFAULT_SIGMA_THRESHOLD,
) -> torch.Tensor:
    """Axis-angle IGSO3(I, sigma) vectors at arbitrary sigma (see
    `sample_angle_continuous`), shape sigma.shape + sample_shape + (3,).
    `noise` injects the draw (the same numbers as `sample_axis_angle`)."""
    out_shape = tuple(sigma.shape) + tuple(sample_shape)
    if noise is None:
        noise = AxisAngleNoise.draw(out_shape, generator, table.sigmas.dtype,
                                    table.sigmas.device)
    axis = noise.axis / torch.linalg.norm(noise.axis, dim=-1, keepdim=True)
    theta = sample_angle_continuous(table, sigma, sample_shape, noise.uniform,
                                    noise.normal, sigma_threshold)
    return axis * theta[..., None]
