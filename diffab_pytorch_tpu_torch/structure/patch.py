"""Fixed-size patch extraction and .npz serialization (host-side numpy;
`diffab_pytorch_tpu/structure/patch.py`).

A patch is the union of the k residues nearest the CDR anchors among all
residues, the k nearest among antigen residues, and the CDRs themselves,
cut or zero-padded to exactly `patch_size` rows.  Backbone dihedrals are
computed on the whole structure and then subset.  The per-residue CDR
labels are stored, so one patch serves any choice of CDRs to generate.
Coordinates stay in angstroms in the input's frame; `data/dataset.py`
normalizes them when a batch is assembled.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from diffab_pytorch_tpu_torch.structure import geometry
from diffab_pytorch_tpu_torch.structure.antibody import AntibodyComplex

PATCH_KEYS = (
    "xyz",
    "atom_mask",
    "seq_idx",
    "chain_idx",
    "residue_idx",
    "residue_number",
    "icode",
    "cdr_idx",
    "orientations",
    "backbone_dihedrals",
    "backbone_dihedrals_mask",
    "residue_mask",
)


def extract_patch_mask(complex_: AntibodyComplex, k: int = 128) -> np.ndarray:
    """Union of the k nearest residues to the anchors over all residues,
    over antigen residues, and the CDR loops."""
    anchor = complex_.get_cdr_anchor_mask() & complex_.get_residue_mask()
    if not anchor.any():
        raise ValueError("no CDR anchor residues found — is the PDB Chothia-numbered?")
    anchor_ca = complex_.xyz[anchor, 1]

    near_any = complex_.get_topk_nearest_residue_mask(anchor_ca, k=k, mask=None)
    # the loops are the design targets: always in the patch
    cdrs = complex_.get_cdr_mask() & complex_.get_residue_mask()
    ag = complex_.get_antigen_mask()
    if ag.any():
        near_ag = complex_.get_topk_nearest_residue_mask(anchor_ca, k=k, mask=ag)
        return near_any | near_ag | cdrs
    return near_any | cdrs


def featurize_patch(
    complex_: AntibodyComplex,
    patch_size: int = 128,
    patch_mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Extract and featurize a fixed-size patch -> dict of arrays
    (PATCH_KEYS).  More than `patch_size` residues: the nearest to the
    anchors win, CDR residues are never dropped; fewer: zero-padded with
    residue_mask False."""
    if patch_mask is None:
        patch_mask = extract_patch_mask(complex_, k=patch_size)

    orientations, dihedrals, dihedrals_mask = geometry.backbone_geometry(
        complex_.xyz, complex_.atom_mask, complex_.chain_idx
    )

    idx = np.nonzero(patch_mask)[0]
    if idx.size > patch_size:
        anchor = complex_.get_cdr_anchor_mask() & complex_.get_residue_mask()
        anchor_ca = complex_.xyz[anchor, 1]
        d = np.linalg.norm(
            complex_.xyz[idx, 1][:, None, :] - anchor_ca[None, :, :], axis=-1
        ).min(axis=1)
        is_cdr = complex_.cdr_idx[idx] > 0
        d = np.where(is_cdr, -1.0, d)
        idx = idx[np.argsort(d, kind="stable")[:patch_size]]
        idx.sort()
    n = idx.size

    def pad(arr: np.ndarray) -> np.ndarray:
        out = np.zeros((patch_size,) + arr.shape[1:], arr.dtype)
        out[:n] = arr[idx]
        return out

    sample = {
        "xyz": pad(complex_.xyz),
        "atom_mask": pad(complex_.atom_mask),
        "seq_idx": pad(complex_.seq_idx),
        "chain_idx": pad(complex_.chain_idx),
        "residue_idx": pad(complex_.residue_idx),
        "residue_number": pad(complex_.residue_number),
        "icode": pad(complex_.icode),
        "cdr_idx": pad(complex_.cdr_idx),
        "orientations": pad(orientations),
        "backbone_dihedrals": pad(dihedrals),
        "backbone_dihedrals_mask": pad(dihedrals_mask),
        "residue_mask": np.zeros(patch_size, bool),
    }
    sample["residue_mask"][:n] = complex_.get_residue_mask()[idx]
    # padded rows: identity orientations keep downstream math finite
    sample["orientations"][n:] = np.eye(3, dtype=np.float32)
    return sample


def save_patch(path: str, sample: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **sample)


def load_patch(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
