"""SO(3) numerics: exp/log maps, axis-angle conversions, geodesic scaling
(`diffab_pytorch_tpu/geometry/so3.py`).

The log map goes through a unit quaternion (Shepperd's method), so it is
safe at theta ~ 0 and theta ~ pi; every function is branchless and
batched over arbitrary leading dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Vector (..., 3) -> skew-symmetric matrix (..., 3, 3)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(vx)
    return torch.stack([
        torch.stack([zero, -vz, vy], dim=-1),
        torch.stack([vz, zero, -vx], dim=-1),
        torch.stack([-vy, vx, zero], dim=-1),
    ], dim=-2)


def vee(s: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (..., 3, 3) -> vector (..., 3)."""
    return torch.stack([s[..., 2, 1], s[..., 0, 2], s[..., 1, 0]], dim=-1)


def matrix_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0.

    Shepperd's method: four candidate extractions, the one with the largest
    divisor selected per element."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    zero = torch.zeros_like(m00)
    qw2 = torch.maximum(zero, 1.0 + m00 + m11 + m22)
    qx2 = torch.maximum(zero, 1.0 + m00 - m11 - m22)
    qy2 = torch.maximum(zero, 1.0 - m00 + m11 - m22)
    qz2 = torch.maximum(zero, 1.0 - m00 - m11 + m22)

    def safe(x):
        return torch.where(x > _EPS, x, torch.ones_like(x))

    sw, sx, sy, sz = (torch.sqrt(safe(q)) for q in (qw2, qx2, qy2, qz2))
    q_w = torch.stack([sw, (m21 - m12) / safe(sw), (m02 - m20) / safe(sw),
                       (m10 - m01) / safe(sw)], dim=-1)
    q_x = torch.stack([(m21 - m12) / safe(sx), sx, (m01 + m10) / safe(sx),
                       (m02 + m20) / safe(sx)], dim=-1)
    q_y = torch.stack([(m02 - m20) / safe(sy), (m01 + m10) / safe(sy), sy,
                       (m12 + m21) / safe(sy)], dim=-1)
    q_z = torch.stack([(m10 - m01) / safe(sz), (m02 + m20) / safe(sz),
                       (m12 + m21) / safe(sz), sz], dim=-1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 0, q_w,
                    torch.where(best == 1, q_x, torch.where(best == 2, q_y, q_z)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], dim=-1),
    ], dim=-2)


def rotation_matrix_to_vector(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector axis * angle (..., 3)."""
    q = matrix_to_quaternion(r)
    w, xyz = q[..., 0], q[..., 1:]
    n2 = torch.sum(xyz * xyz, dim=-1)
    small = n2 < _EPS * _EPS
    n_safe = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    theta = 2.0 * torch.atan2(n_safe, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / n_safe)
    return xyz * scale[..., None]


def log_rotmat(r: torch.Tensor) -> torch.Tensor:
    """Matrix log: rotation matrix -> skew-symmetric matrix in so(3)."""
    return hat(rotation_matrix_to_vector(r))


def exp_skew_symmetric_mat(s: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with Taylor fall-backs at the identity."""
    v = vee(s)
    t2 = torch.sum(v * v, dim=-1)
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t_safe = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t_safe) / t_safe)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t_safe)) / t2_safe)
    eye = torch.eye(3, dtype=s.dtype, device=s.device).expand(s.shape)
    return eye + a[..., None, None] * s + b[..., None, None] * (s @ s)


def vector_to_rotation_matrix(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    return exp_skew_symmetric_mat(hat(v))


def scale_rot(r: torch.Tensor, k) -> torch.Tensor:
    """Geodesic scaling exp(k log R); `k` broadcasts against R's batch dims
    from the left (a (B,) k scales every residue of batch row b by k[b])."""
    k = torch.as_tensor(k, dtype=r.dtype, device=r.device)
    if k.ndim > r.ndim - 2:
        raise ValueError(f"k.ndim ({k.ndim}) larger than R's batch ndim ({r.ndim - 2})")
    k = k.reshape(k.shape + (1,) * (r.ndim - 2 - k.ndim))
    return vector_to_rotation_matrix(k[..., None] * rotation_matrix_to_vector(r))


def uniform(
    shape,
    generator: torch.Generator | None = None,
    normal: torch.Tensor | None = None,
    dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Haar-random rotations of shape `shape + (3, 3)` from normalized 4D
    Gaussian quaternions.  `normal` (shape + (4,)) injects the Gaussian
    draw; otherwise it comes from `generator`."""
    if normal is None:
        normal = torch.randn(tuple(shape) + (4,), generator=generator,
                             dtype=dtype, device=device)
    q = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    return quaternion_to_matrix(q)


def compose(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Rotation composition R1 @ R2 over the last two dims."""
    return r1 @ r2
