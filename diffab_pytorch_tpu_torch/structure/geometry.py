"""Structural geometry on the host (numpy;
`diffab_pytorch_tpu/structure/geometry.py`): backbone frames and backbone
dihedrals.  `backbone_geometry`, the featurizer's entry, runs the C++
featurizer (`structure/native.py`) unless told `prefer_native=False`; the
numpy functions here are the reference it is held to.

Frame convention (the models' `frames_apply`): orientation ROWS are the
frame axes in global coordinates, by Gram-Schmidt on the backbone:
    e1 = normalize(C - CA)
    e2 = normalize((N - CA) - <N - CA, e1> e1)
    e3 = e1 x e2
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_EPS = 1e-8


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), _EPS)


def backbone_orientations(
    xyz: np.ndarray, atom_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(L, A, 3), (L, A) -> orientations (L, 3, 3), valid (L,).  Residues
    missing N, CA or C get the identity and valid False."""
    n, ca, c = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    valid = atom_mask[:, 0] & atom_mask[:, 1] & atom_mask[:, 2]

    e1 = _normalize(c - ca)
    u = n - ca
    e2 = _normalize(u - np.sum(u * e1, axis=-1, keepdims=True) * e1)
    e3 = np.cross(e1, e2)
    rot = np.stack([e1, e2, e3], axis=-2)  # rows are axes
    rot = np.where(valid[:, None, None], rot, np.eye(3, dtype=xyz.dtype))
    return rot.astype(np.float32), valid


def dihedral_angle(
    p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, p3: np.ndarray
) -> np.ndarray:
    """Signed dihedral about the p1-p2 axis, broadcast over leading dims
    (IUPAC sign convention)."""
    b0 = p0 - p1
    b1 = _normalize(p2 - p1)
    b2 = p3 - p2
    v = b0 - np.sum(b0 * b1, axis=-1, keepdims=True) * b1
    w = b2 - np.sum(b2 * b1, axis=-1, keepdims=True) * b1
    x = np.sum(v * w, axis=-1)
    y = np.sum(np.cross(b1, v) * w, axis=-1)
    return np.arctan2(y, x)


def backbone_dihedrals(
    xyz: np.ndarray, atom_mask: np.ndarray, chain_idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(phi, psi, omega) per residue: (L, 3) values + (L, 3) validity.

    phi_i   = dihedral(C_{i-1}, N_i,  CA_i, C_i)
    psi_i   = dihedral(N_i,  CA_i, C_i,  N_{i+1})
    omega_i = dihedral(CA_i, C_i,  N_{i+1}, CA_{i+1})

    Neighbours must be consecutive rows of one chain joined by a peptide
    bond (|C_i - N_{i+1}| < 2.5 A).  Computed on the whole structure before
    a patch is cut, so a patch boundary cannot make up an angle.
    """
    L = xyz.shape[0]
    n, ca, c = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    bb_ok = atom_mask[:, 0] & atom_mask[:, 1] & atom_mask[:, 2]

    adj = np.zeros(L, bool)  # i bonded to i + 1
    if L > 1:
        same_chain = chain_idx[:-1] == chain_idx[1:]
        bond = np.linalg.norm(c[:-1] - n[1:], axis=-1) < 2.5
        adj[:-1] = same_chain & bond & bb_ok[:-1] & bb_ok[1:]

    vals = np.zeros((L, 3), np.float32)
    mask = np.zeros((L, 3), bool)

    prev_ok = np.zeros(L, bool)
    prev_ok[1:] = adj[:-1]
    idx = np.nonzero(prev_ok)[0]
    if idx.size:
        vals[idx, 0] = dihedral_angle(c[idx - 1], n[idx], ca[idx], c[idx])
        mask[idx, 0] = True

    idx = np.nonzero(adj)[0]
    if idx.size:
        vals[idx, 1] = dihedral_angle(n[idx], ca[idx], c[idx], n[idx + 1])
        vals[idx, 2] = dihedral_angle(ca[idx], c[idx], n[idx + 1], ca[idx + 1])
        mask[idx, 1] = True
        mask[idx, 2] = True

    return vals, mask


def backbone_geometry(
    xyz: np.ndarray, atom_mask: np.ndarray, chain_idx: np.ndarray,
    prefer_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frames and backbone dihedrals in one call: (orientations (L, 3, 3),
    dihedrals (L, 3), dihedrals_mask (L, 3)); the C++ featurizer (raising
    if it cannot be built) or, with prefer_native=False, numpy."""
    if prefer_native:
        from diffab_pytorch_tpu_torch.structure import native

        return native.backbone_geometry_native(xyz, atom_mask, chain_idx)
    rot, _ = backbone_orientations(xyz, atom_mask)
    vals, mask = backbone_dihedrals(xyz, atom_mask, chain_idx)
    return rot, vals, mask
