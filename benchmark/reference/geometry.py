"""Plain rotations, the cosine schedule and the IGSO(3) sampling tables.

Written from the DiffAb paper's definitions (Luo et al., NeurIPS 2022) and
held against the port in `benchmark/tests/test_bench_reference.py`; it
imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-8


def hat(v):
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(vx)
    return torch.stack([torch.stack([z, -vz, vy], -1), torch.stack([vz, z, -vx], -1),
                        torch.stack([-vy, vx, z], -1)], -2)


def exp_so3(v):
    """Rotation vector (..., 3) -> matrix, Rodrigues with a Taylor form at 0."""
    s = hat(v)
    t2 = (v * v).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(s.shape)
    return eye + a[..., None, None] * s + b[..., None, None] * (s @ s)


def quaternion_of(r):
    """Matrix -> unit quaternion (w, x, y, z), w >= 0 (Shepperd)."""
    m = [[r[..., i, j] for j in range(3)] for i in range(3)]
    z = torch.zeros_like(m[0][0])
    tr = [torch.maximum(z, 1.0 + m[0][0] + m[1][1] + m[2][2]),
          torch.maximum(z, 1.0 + m[0][0] - m[1][1] - m[2][2]),
          torch.maximum(z, 1.0 - m[0][0] + m[1][1] - m[2][2]),
          torch.maximum(z, 1.0 - m[0][0] - m[1][1] + m[2][2])]
    safe = lambda x: torch.where(x > _EPS, x, torch.ones_like(x))
    sq = [torch.sqrt(safe(q)) for q in tr]
    a, b, c = m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]
    p01, p02, p12 = m[0][1] + m[1][0], m[0][2] + m[2][0], m[1][2] + m[2][1]
    cand = [torch.stack([sq[0], a / safe(sq[0]), b / safe(sq[0]), c / safe(sq[0])], -1),
            torch.stack([a / safe(sq[1]), sq[1], p01 / safe(sq[1]), p02 / safe(sq[1])], -1),
            torch.stack([b / safe(sq[2]), p01 / safe(sq[2]), sq[2], p12 / safe(sq[2])], -1),
            torch.stack([c / safe(sq[3]), p02 / safe(sq[3]), p12 / safe(sq[3]), sq[3]], -1)]
    best = torch.argmax(torch.stack(tr, -1), -1)[..., None]
    q = torch.where(best == 0, cand[0], torch.where(best == 1, cand[1],
                                                    torch.where(best == 2, cand[2], cand[3])))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_of(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def log_so3(r):
    """Matrix -> rotation vector, through the quaternion."""
    q = quaternion_of(r)
    w, xyz = q[..., 0], q[..., 1:]
    n2 = (xyz * xyz).sum(-1)
    small = n2 < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), 2.0 * torch.atan2(n, w) / n)
    return xyz * scale[..., None]


def scale_rot(r, k):
    """exp(k log R), k (B,) broadcast over R's trailing batch dims."""
    k = k.reshape(k.shape + (1,) * (r.ndim - 2 - k.ndim))
    return exp_so3(k[..., None] * log_so3(r))


class Schedule(NamedTuple):
    alpha_bar: torch.Tensor
    alpha_bar_sqrt: torch.Tensor
    one_minus_alpha_bar_sqrt: torch.Tensor
    beta: torch.Tensor

    @property
    def T(self) -> int:
        return self.beta.shape[0] - 1


def cosine_schedule(T: int, s: float, beta_max: float, device) -> Schedule:
    """Nichol & Dhariwal's cosine schedule, float64 on the host, float32 out."""
    t = np.arange(T + 1, dtype=np.float64)
    f = np.cos((t / T + s) / (1.0 + s) * np.pi / 2.0) ** 2
    abar = f / f[0]
    beta = np.concatenate([[0.0], np.clip(1.0 - abar[1:] / abar[:-1], 1e-5, beta_max)])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Schedule(f32(abar), f32(np.sqrt(abar)), f32(np.sqrt(1.0 - abar)), f32(beta))


class IGSO3(NamedTuple):
    sigmas: torch.Tensor  # (S,)
    inv_cdf: torch.Tensor  # (S, n_bins + 1)
    use_hist: torch.Tensor  # (S,)


def igso3_table(sigmas: np.ndarray, n_bins: int, n_terms: int, threshold: float,
                device) -> IGSO3:
    """Inverse CDFs of the IGSO(3) angle at each sigma: the truncated series
    (1 - cos th)/pi sum_l (2l+1) exp(-l(l+1) s^2) sin((l+1/2) th)/sin(th/2)
    at bin centres, normalised; rows whose series has not converged (s
    n_terms < 6) are a point mass at 0."""
    sigmas = np.asarray(sigmas, np.float64).reshape(-1)
    width = np.pi / n_bins
    th = np.arange(n_bins, dtype=np.float64) * width + width / 2.0
    ls = np.arange(n_terms, dtype=np.float64)
    coef = (2.0 * ls + 1.0) * np.exp(-ls * (ls + 1.0) * sigmas[:, None] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ang = np.sin((ls[:, None] + 0.5) * th[None, :]) / np.sin(th[None, :] / 2.0)
    pdf = np.clip(np.nan_to_num((1.0 - np.cos(th))[None, :] / np.pi * (coef @ ang)), 0.0, None)
    total = pdf.sum(-1, keepdims=True)
    bad = (total <= 0.0) | (sigmas[:, None] * n_terms < 6.0)
    point = np.zeros_like(pdf)
    point[:, 0] = 1.0
    pdf = np.where(bad, point, pdf / np.where(bad, 1.0, total))
    cdf = np.cumsum(pdf, -1)
    cdf /= cdf[:, -1:]
    q = np.linspace(0.0, 1.0, n_bins + 1)
    edges = np.arange(n_bins + 1, dtype=np.float64) * width
    inv = np.stack([np.interp(q, np.concatenate([[0.0], c]), edges) for c in cdf])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return IGSO3(f32(sigmas), f32(inv), torch.as_tensor(sigmas < threshold, device=device))


def igso3_rotvec(table: IGSO3, idx, axis, uniform, normal):
    """Axis-angle draws at sigma row idx (B,) for noise of shape (B, L, ...):
    a normalised Gaussian axis times an angle from the inverse CDF (small
    sigma, lerped between quantiles) or N(2 s, s^2) folded into [0, pi)."""
    rows = table.inv_cdf[idx]  # (B, Q)
    nq = rows.shape[-1]
    pos = uniform * (nq - 1)
    i0 = torch.clamp(torch.floor(pos).long(), 0, nq - 2)
    frac = pos - i0.float()
    flat = i0.reshape(idx.shape[0], -1)
    t0 = torch.gather(rows, 1, flat).reshape(uniform.shape)
    t1 = torch.gather(rows, 1, flat + 1).reshape(uniform.shape)
    expand = (idx.shape[0],) + (1,) * (uniform.ndim - 1)
    sig = table.sigmas[idx].reshape(expand)
    theta = torch.where(table.use_hist[idx].reshape(expand), t0 * (1.0 - frac) + t1 * frac,
                        torch.remainder(2.0 * sig + sig * normal, math.pi))
    return axis / torch.linalg.norm(axis, dim=-1, keepdim=True) * theta[..., None]


def diffusion_tables(d: dict, device) -> tuple:
    """(schedule, IGSO(3) table) of a configuration's diffusion group."""
    sched = cosine_schedule(d["T"], d["s"], d["beta_max"], device)
    table = igso3_table(sched.one_minus_alpha_bar_sqrt.double().cpu().numpy(),
                        d["igso3_n_bins"], d["igso3_n_terms"], d["igso3_sigma_threshold"],
                        device)
    return sched, table
