"""Backbone atoms from designed frames, and peptide-bond idealization
(host-side numpy; `diffab_pytorch_tpu/structure/reconstruct.py`).

N and C are placed in the frame plane with ideal bond geometry (Engh &
Huber), O in plane at the ideal carbonyl geometry (its true position
depends on psi, so expect ~1 A off).  Frame convention: rows of the
orientation are (e1, e2, e3); local -> global is x_local @ O + t.
"""

from __future__ import annotations

import numpy as np

from diffab_pytorch_tpu_torch.constants import ATOM, MAX_N_ATOMS_PER_RESIDUE

_BOND_CA_C = 1.523
_BOND_CA_N = 1.458
_ANGLE_N_CA_C = np.deg2rad(111.0)
_BOND_C_O = 1.231
_ANGLE_CA_C_O = np.deg2rad(120.8)
IDEAL_PEPTIDE_BOND = 1.329  # C(i)-N(i+1), angstroms

_N_LOCAL = np.array(
    [_BOND_CA_N * np.cos(_ANGLE_N_CA_C), _BOND_CA_N * np.sin(_ANGLE_N_CA_C), 0.0]
)
_CA_LOCAL = np.zeros(3)
_C_LOCAL = np.array([_BOND_CA_C, 0.0, 0.0])
_O_LOCAL = _C_LOCAL + np.array(
    [
        _BOND_C_O * np.cos(np.pi - _ANGLE_CA_C_O),
        -_BOND_C_O * np.sin(np.pi - _ANGLE_CA_C_O),
        0.0,
    ]
)

BACKBONE_LOCAL = np.stack([_N_LOCAL, _CA_LOCAL, _C_LOCAL, _O_LOCAL])  # (4, 3)


def reconstruct_backbone(
    orientations: np.ndarray,  # (..., L, 3, 3)
    translations: np.ndarray,  # (..., L, 3)
    n_atoms: int = MAX_N_ATOMS_PER_RESIDUE,
) -> tuple[np.ndarray, np.ndarray]:
    """Frames -> (xyz (..., L, n_atoms, 3), atom_mask (..., L, n_atoms))
    with slots N, CA, C, O filled (in float64, stored float32)."""
    orientations = np.asarray(orientations, np.float64)
    translations = np.asarray(translations, np.float64)
    global_bb = (
        np.einsum("ai,...ij->...aj", BACKBONE_LOCAL, orientations)
        + translations[..., None, :]
    )  # (..., L, 4, 3)

    shape = translations.shape[:-1]
    xyz = np.zeros(shape + (n_atoms, 3), np.float32)
    mask = np.zeros(shape + (n_atoms,), bool)
    xyz[..., :4, :] = global_bb
    mask[..., :4] = True
    return xyz, mask


def idealize_peptide_bonds(
    xyz: np.ndarray,  # (L, A, 3) — modified copy returned
    atom_mask: np.ndarray,  # (L, A)
    chain_idx: np.ndarray,  # (L,)
    residue_idx: np.ndarray,  # (L,)
    edge_mask: np.ndarray | None = None,  # (L,) — only edges touching these
) -> np.ndarray:
    """Move each N(i+1) onto the ideal 1.329 A peptide bond along the
    existing C(i) -> N(i+1) direction; CA positions and frames stay.

    Chain adjacency comes from (chain_idx, residue_idx): patch rows are
    nearest-residue selections, not chain-contiguous.  With edge_mask
    (the generation mask), only edges touching a masked residue are
    repaired, and the context stays byte-identical.
    """
    xyz = np.array(xyz, np.float32)
    L = xyz.shape[0]
    succ_of = {
        (int(chain_idx[i]), int(residue_idx[i])): i for i in range(L)
    }
    for i in range(L):
        j = succ_of.get((int(chain_idx[i]), int(residue_idx[i]) + 1))
        if j is None:
            continue
        if not (atom_mask[i, ATOM.C] and atom_mask[j, ATOM.N]):
            continue
        if edge_mask is not None and not (edge_mask[i] or edge_mask[j]):
            continue
        c = xyz[i, ATOM.C]
        n = xyz[j, ATOM.N]
        d = n - c
        norm = float(np.linalg.norm(d))
        if norm > 1e-6:
            xyz[j, ATOM.N] = c + d * (IDEAL_PEPTIDE_BOND / norm)
    return xyz
