"""A patch file to model inputs, in numpy and plain PyTorch.

The benchmark writes each target or training example as a patch `.npz`
(the format `cli.sample --patch` and `cli.train --data-dir` read); both the
port and this reference read those files.  Here the generated residues are
the CDR-H3 loop's, and coordinates are centred on the context's C-alpha
centroid, turned into the context's principal-axes pose (the first two
axes signed by the third moment, the last right-handed) and divided by 10
angstrom.
"""

from __future__ import annotations

import numpy as np
import torch

COORD_SCALE = 10.0
CDR_H3 = 3  # the per-residue CDR label of H3


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _pose(ca: np.ndarray, w: np.ndarray) -> np.ndarray:
    cov = np.einsum("l,li,lj->ij", w, ca, ca) / max(w.sum(), 1.0)
    v = np.linalg.eigh(cov)[1][:, ::-1].copy()
    for j in (0, 1):
        v[:, j] *= 1.0 if (w * (ca @ v[:, j]) ** 3).sum() >= 0.0 else -1.0
    v[:, 2] = np.cross(v[:, 0], v[:, 1])
    return (np.eye(3) if w.sum() < 3.0 else v).astype(np.float32)


def normalize(s: dict) -> dict:
    """One patch's model inputs as numpy arrays."""
    res = s["residue_mask"].astype(bool)
    gen = (s["cdr_idx"] == CDR_H3) & res
    amask = s["atom_mask"].astype(bool)
    xyz = s["xyz"].astype(np.float32)
    w = (res & ~gen & amask[:, 1]).astype(np.float32)
    center = (xyz[:, 1] * w[:, None]).sum(0) / max(w.sum(), 1.0)
    xyz = xyz - center
    rot = _pose(xyz[:, 1], w)
    xyz = np.where(amask[..., None], np.einsum("lai,ij->laj", xyz, rot) / COORD_SCALE, 0.0)
    return dict(xyz=xyz.astype(np.float32),
                orientations=np.einsum("lij,jk->lik", s["orientations"].astype(np.float32),
                                       rot).astype(np.float32),
                backbone_dihedrals=s["backbone_dihedrals"].astype(np.float32),
                backbone_dihedrals_mask=s["backbone_dihedrals_mask"].astype(bool),
                atom_mask=amask, seq_idx=s["seq_idx"].astype(np.int64),
                chain_idx=s["chain_idx"].astype(np.int64),
                residue_idx=s["residue_idx"].astype(np.int64), residue_mask=res,
                generation_mask=gen)


def to_batch(rows: list[dict], device) -> dict:
    """Stack normalized rows into a batch of tensors on `device`."""
    return {k: torch.from_numpy(np.stack([r[k] for r in rows])).to(device) for k in rows[0]}


def row_key(seq_idx, residue_idx, chain_idx) -> bytes:
    """What identifies an example among a corpus's rows."""
    return b"".join(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes()
                    for a in (seq_idx, residue_idx, chain_idx))
