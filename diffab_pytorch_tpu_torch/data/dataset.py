"""Batch assembly from patches (`diffab_pytorch_tpu/data/dataset.py`, the
batch half): normalization into diffusion space and stacking into the
port's `ProteinBatch` on a device.

  * generation_mask comes from the stored per-CDR labels, for any subset
    of CDRs to generate;
  * coordinates are centred on the CONTEXT (non-generated) CA centroid,
    rotated into the context's canonical principal-axes pose and divided
    by COORD_SCALE, so that the coordinate prior N(0, I) matches the data
    and the frames live in a pose the model can reproduce at sampling
    time; `NormalizationInfo` inverts the transform after sampling;
  * the pairwise dihedrals are left to the model (PairEmbedding).

The normalization is host-side numpy in float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.constants import CDR, CDR_NAMES
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch

# angstrom -> diffusion units: CA coordinates of a centred 128-residue
# patch have a std of ~10 A
COORD_SCALE = 10.0


@dataclasses.dataclass
class NormalizationInfo:
    """Per-sample invertible pose transform:
    x_norm = ((x - center) @ rot) / scale, frames O_norm = O @ rot."""

    center: np.ndarray  # (b, 3)
    scale: float
    rot: np.ndarray  # (b, 3, 3)

    def denormalize(self, xyz_norm: np.ndarray) -> np.ndarray:
        x = np.asarray(xyz_norm) * self.scale
        x = np.einsum("b...i,bji->b...j", x, self.rot)  # x @ rot^T
        return x + self.center[:, None, :]

    def denormalize_orientations(self, orientations_norm: np.ndarray) -> np.ndarray:
        return np.einsum(
            "b...ij,bkj->b...ik", np.asarray(orientations_norm), self.rot
        )  # O @ rot^T


def _canonical_rotation(ca_centered: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Canonical pose of the weighted context CA cloud (batched): principal
    axes by descending eigenvalue, the first two signed by the third moment
    of the projections, the last by right-handedness, so that
    x_centered @ V does not depend on how the input was posed.  Fewer than
    3 context points: the identity."""
    denom = np.maximum(w.sum(1), 1.0)
    cov = (
        np.einsum("bl,bli,blj->bij", w, ca_centered, ca_centered)
        / denom[:, None, None]
    )
    _, eigvec = np.linalg.eigh(cov)  # ascending eigenvalues
    v = eigvec[:, :, ::-1].copy()  # columns = axes, descending variance
    for j in (0, 1):
        proj = np.einsum("bli,bi->bl", ca_centered, v[:, :, j])
        m3 = (w * proj**3).sum(1)
        v[:, :, j] *= np.where(m3 >= 0.0, 1.0, -1.0)[:, None]
    v[:, :, 2] = np.cross(v[:, :, 0], v[:, :, 1], axis=-1)
    degenerate = w.sum(1) < 3.0
    if degenerate.any():
        v[degenerate] = np.eye(3)
    return v.astype(np.float32)


def generation_mask_from_cdr(
    cdr_idx: np.ndarray, cdrs_to_generate: Sequence[str]
) -> np.ndarray:
    bad = set(cdrs_to_generate) - set(CDR_NAMES)
    if bad:
        raise ValueError(f"unknown CDRs {sorted(bad)}; must be in {CDR_NAMES}")
    wanted = np.array([int(CDR[c]) for c in cdrs_to_generate], cdr_idx.dtype)
    return np.isin(cdr_idx, wanted)


def normalize_sample(
    s: Dict[str, np.ndarray], cdrs_to_generate: Sequence[str]
) -> Dict[str, np.ndarray]:
    """One patch's normalized pose and masks: the patch's keys with xyz and
    orientations normalized (see the module docstring), plus
    generation_mask, norm_center and norm_rot.  Depends only on the patch
    and the CDR subset."""
    gen = generation_mask_from_cdr(s["cdr_idx"], cdrs_to_generate)
    gen = gen & s["residue_mask"].astype(bool)
    xyz = s["xyz"].astype(np.float32)
    orientations = s["orientations"].astype(np.float32)

    ctx = s["residue_mask"].astype(bool) & ~gen & s["atom_mask"][:, 1].astype(bool)
    w = ctx.astype(np.float32)[None]  # (1, L): the batched helpers
    denom = np.maximum(w.sum(1), 1.0)
    center = (xyz[None, :, 1, :] * w[..., None]).sum(1) / denom[:, None]
    xyz = xyz - center[0][None, None, :]
    rot = _canonical_rotation(xyz[None, :, 1, :], w)[0]
    xyz = np.einsum("lai,ij->laj", xyz, rot) / COORD_SCALE
    orientations = np.einsum("lij,jk->lik", orientations, rot)
    # masked atom slots carry zeros, whatever the file held
    xyz = np.where(s["atom_mask"][..., None].astype(bool), xyz, 0.0)

    out = dict(s)
    out["xyz"] = xyz.astype(np.float32)
    out["orientations"] = orientations.astype(np.float32)
    out["generation_mask"] = gen
    out["norm_center"] = center[0].astype(np.float32)
    out["norm_rot"] = rot
    return out


def assemble_batch(
    samples: List[Dict[str, np.ndarray]],
    cdrs_to_generate: Sequence[str] = ("H3",),
    device=None,
) -> tuple[ProteinBatch, NormalizationInfo]:
    """Normalize patch dicts (those not normalized yet) and stack them into
    a ProteinBatch on `device` (the card unless named); return it with the
    coordinate transform."""
    device = resolve_device(device)
    samples = [
        s if "norm_center" in s else normalize_sample(s, cdrs_to_generate)
        for s in samples
    ]
    stack = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    info = NormalizationInfo(center=stack["norm_center"], scale=COORD_SCALE,
                             rot=stack["norm_rot"])
    batch = ProteinBatch.from_numpy(dict(
        xyz=stack["xyz"],
        orientations=stack["orientations"],
        backbone_dihedrals=stack["backbone_dihedrals"].astype(np.float32),
        backbone_dihedrals_mask=stack["backbone_dihedrals_mask"].astype(bool),
        pairwise_dihedrals=None,
        atom_mask=stack["atom_mask"].astype(bool),
        seq_idx=stack["seq_idx"],
        chain_idx=stack["chain_idx"],
        residue_idx=stack["residue_idx"],
        residue_mask=stack["residue_mask"].astype(bool),
        generation_mask=stack["generation_mask"].astype(bool),
    ), device=device)
    return batch, info
