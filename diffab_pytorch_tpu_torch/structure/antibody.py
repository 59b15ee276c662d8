"""Antibody-antigen complex assembly: chains -> flat arrays + CDR masks
(host-side numpy; `diffab_pytorch_tpu/structure/antibody.py`).

CDRs are the Chothia loop ranges on the input's residue numbers; anchors
are the framework residues just outside each loop.  residue_idx is the
per-chain sequential index (0, 1, ... in file order), not the author
numbering, so relative-position features measure sequence separation
across insertion codes and stay right after a patch is cut.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from diffab_pytorch_tpu_torch.constants import (
    CDR,
    CDR_NAMES,
    CHOTHIA_CDR_RANGES,
    FIRST_ANTIGEN_CHAIN_IDX,
    FV_MAX_RESNUM,
    HEAVY_CHAIN_IDX,
    LIGHT_CHAIN_IDX,
    MAX_N_ATOMS_PER_RESIDUE,
)
from diffab_pytorch_tpu_torch.structure import geometry
from diffab_pytorch_tpu_torch.structure.pdb import Residue, parse_pdb, parse_pdb_file


@dataclasses.dataclass
class AntibodyComplex:
    """Flat per-residue arrays of one antibody(-antigen) complex: heavy,
    light, then antigen chains, each in file order; L residues in all."""

    xyz: np.ndarray  # (L, A, 3) float32
    atom_mask: np.ndarray  # (L, A) bool
    seq_idx: np.ndarray  # (L,) int32
    chain_idx: np.ndarray  # (L,) int32 (1=H, 2=L, 3+=antigen)
    residue_idx: np.ndarray  # (L,) int32 per-chain sequential
    residue_number: np.ndarray  # (L,) int32 author (Chothia) numbering
    icode: np.ndarray  # (L,) uint8 insertion-code char (ord(' ') = none)
    cdr_idx: np.ndarray  # (L,) int8 CDR enum (0 = not a CDR)
    anchor_mask: np.ndarray  # (L,) bool CDR-flanking framework residues
    chain_ids: List[str]  # per-residue original chain letter

    @property
    def n_residues(self) -> int:
        return self.xyz.shape[0]

    # protstruc-style getters
    def get_xyz(self) -> np.ndarray:
        return self.xyz

    def get_seq_idx(self) -> np.ndarray:
        return self.seq_idx

    def get_chain_idx(self) -> np.ndarray:
        return self.chain_idx

    def get_atom_mask(self) -> np.ndarray:
        return self.atom_mask

    def get_residue_mask(self) -> np.ndarray:
        return self.atom_mask[:, 1].copy()  # CA present

    def get_cdr_mask(self, subset: Optional[Sequence[str]] = None) -> np.ndarray:
        names = CDR_NAMES if subset is None else list(subset)
        bad = set(names) - set(CDR_NAMES)
        if bad:
            raise ValueError(f"unknown CDRs {sorted(bad)}; must be in {CDR_NAMES}")
        wanted = np.array([int(CDR[n]) for n in names], np.int8)
        return np.isin(self.cdr_idx, wanted)

    def get_cdr_anchor_mask(self) -> np.ndarray:
        return self.anchor_mask.copy()

    def get_antigen_mask(self) -> np.ndarray:
        return self.chain_idx >= FIRST_ANTIGEN_CHAIN_IDX

    def get_max_n_residues(self) -> int:
        return self.n_residues

    def get_max_n_atoms_per_residue(self) -> int:
        return self.xyz.shape[1]

    def backbone_orientations(self) -> np.ndarray:
        rot, _ = geometry.backbone_orientations(self.xyz, self.atom_mask)
        return rot

    def backbone_dihedrals(self):
        return geometry.backbone_dihedrals(self.xyz, self.atom_mask, self.chain_idx)

    def pairwise_dihedrals(self) -> np.ndarray:
        return geometry.pairwise_dihedrals(self.xyz, self.atom_mask)

    def pairwise_distance_matrix(self):
        return geometry.pairwise_distance_matrix(self.xyz, self.atom_mask)

    def residue_masked_select(self, mask: np.ndarray) -> "AntibodyComplex":
        """The complex of the residues where `mask` holds, in order."""
        idx = np.nonzero(mask)[0]
        return AntibodyComplex(
            xyz=self.xyz[idx],
            atom_mask=self.atom_mask[idx],
            seq_idx=self.seq_idx[idx],
            chain_idx=self.chain_idx[idx],
            residue_idx=self.residue_idx[idx],
            residue_number=self.residue_number[idx],
            icode=self.icode[idx],
            cdr_idx=self.cdr_idx[idx],
            anchor_mask=self.anchor_mask[idx],
            chain_ids=[self.chain_ids[i] for i in idx],
        )

    def get_topk_nearest_residue_mask(
        self, query_xyz: np.ndarray, k: int, mask: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """The k residues nearest (CA distance) to any query point, among
        those in `mask` where given."""
        ca = self.xyz[:, 1]
        d = np.linalg.norm(ca[:, None, :] - query_xyz[None, :, :], axis=-1)
        d = d.min(axis=1)
        eligible = self.get_residue_mask()
        if mask is not None:
            eligible = eligible & mask
        d = np.where(eligible, d, np.inf)
        k_eff = min(k, int(eligible.sum()))
        out = np.zeros(self.n_residues, bool)
        if k_eff > 0:
            out[np.argpartition(d, k_eff - 1)[:k_eff]] = True
        return out


def _cdr_label(chain_role: str, resnum: int) -> int:
    for name, (lo, hi) in CHOTHIA_CDR_RANGES.items():
        if name[0] == chain_role and lo <= resnum <= hi:
            return int(CDR[name])
    return int(CDR.NONE)


def _is_anchor(chain_role: str, resnum: int) -> bool:
    for name, (lo, hi) in CHOTHIA_CDR_RANGES.items():
        if name[0] == chain_role and (resnum == lo - 1 or resnum == hi + 1):
            return True
    return False


def from_chains(
    chains: Dict[str, List[Residue]],
    heavy_chain_id: Optional[str],
    light_chain_id: Optional[str],
    antigen_chain_ids: Sequence[str] = (),
    keep_fv_only: bool = False,
) -> AntibodyComplex:
    """Assemble parsed chains into one flat complex (H, L, antigens order)."""
    order: List[tuple] = []  # (chain_letter, chain_idx, role)
    if heavy_chain_id:
        order.append((heavy_chain_id, HEAVY_CHAIN_IDX, "H"))
    if light_chain_id:
        order.append((light_chain_id, LIGHT_CHAIN_IDX, "L"))
    for i, cid in enumerate(antigen_chain_ids):
        order.append((cid, FIRST_ANTIGEN_CHAIN_IDX + i, "AG"))
    if not order:
        raise ValueError("no chains selected")

    rows = []
    for letter, cidx, role in order:
        if letter not in chains:
            raise KeyError(f"chain {letter!r} not found in PDB (has {sorted(chains)})")
        residues = chains[letter]
        if keep_fv_only and role in FV_MAX_RESNUM:
            residues = [r for r in residues if r.resseq <= FV_MAX_RESNUM[role]]
        for seq_pos, r in enumerate(residues):
            rows.append((letter, cidx, role, seq_pos, r))

    L = len(rows)
    A = MAX_N_ATOMS_PER_RESIDUE
    out = AntibodyComplex(
        xyz=np.zeros((L, A, 3), np.float32),
        atom_mask=np.zeros((L, A), bool),
        seq_idx=np.zeros(L, np.int32),
        chain_idx=np.zeros(L, np.int32),
        residue_idx=np.zeros(L, np.int32),
        residue_number=np.zeros(L, np.int32),
        icode=np.full(L, ord(" "), np.uint8),
        cdr_idx=np.zeros(L, np.int8),
        anchor_mask=np.zeros(L, bool),
        chain_ids=[row[0] for row in rows],
    )
    for i, (_, cidx, role, seq_pos, r) in enumerate(rows):
        out.xyz[i] = r.xyz
        out.atom_mask[i] = r.atom_mask
        out.seq_idx[i] = r.aa_index
        out.chain_idx[i] = cidx
        out.residue_idx[i] = seq_pos
        out.residue_number[i] = r.resseq
        out.icode[i] = ord(r.icode[:1] or " ")
        if role in ("H", "L"):
            out.cdr_idx[i] = _cdr_label(role, r.resseq)
            out.anchor_mask[i] = _is_anchor(role, r.resseq)
    return out


def from_arrays(
    xyz: np.ndarray,  # (L, A, 3)
    atom_mask: np.ndarray,  # (L, A)
    seq_idx: np.ndarray,  # (L,)
    chain_idx: np.ndarray,  # (L,)
    residue_number: Optional[np.ndarray] = None,  # (L,) author numbering
) -> AntibodyComplex:
    """A complex straight from arrays.  CDR labels and anchors come from
    residue_number on chains 1 (heavy) and 2 (light)."""
    L = xyz.shape[0]
    if residue_number is None:
        residue_number = np.arange(1, L + 1, dtype=np.int32)
    chain_idx = np.asarray(chain_idx, np.int32)
    residue_idx = np.zeros(L, np.int32)
    for c in np.unique(chain_idx):
        sel = chain_idx == c
        residue_idx[sel] = np.arange(int(sel.sum()), dtype=np.int32)
    cdr_idx = np.zeros(L, np.int8)
    anchor = np.zeros(L, bool)
    for i in range(L):
        role = {HEAVY_CHAIN_IDX: "H", LIGHT_CHAIN_IDX: "L"}.get(int(chain_idx[i]))
        if role:
            cdr_idx[i] = _cdr_label(role, int(residue_number[i]))
            anchor[i] = _is_anchor(role, int(residue_number[i]))
    return AntibodyComplex(
        xyz=np.asarray(xyz, np.float32),
        atom_mask=np.asarray(atom_mask, bool),
        seq_idx=np.asarray(seq_idx, np.int32),
        chain_idx=chain_idx,
        residue_idx=residue_idx,
        residue_number=np.asarray(residue_number, np.int32),
        icode=np.full(L, ord(" "), np.uint8),
        cdr_idx=cdr_idx,
        anchor_mask=anchor,
        chain_ids=[str(c) for c in chain_idx],
    )


def from_pdb(
    path: str,
    heavy_chain_id: Optional[str] = None,
    light_chain_id: Optional[str] = None,
    antigen_chain_ids: Sequence[str] = (),
    keep_fv_only: bool = False,
) -> AntibodyComplex:
    """Parse a PDB file and assemble the named chains in one call."""
    return from_chains(
        parse_pdb_file(path),
        heavy_chain_id,
        light_chain_id,
        antigen_chain_ids,
        keep_fv_only,
    )


def fetch_pdb(pdb_id: str, timeout: float = 30.0) -> str:
    """PDB text of `pdb_id` from RCSB.  Needs network access: without it,
    raises ConnectionError saying to download the file and use from_pdb()."""
    import urllib.error
    import urllib.request

    url = f"https://files.rcsb.org/download/{pdb_id.lower()}.pdb"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(
            f"cannot fetch {pdb_id!r} from RCSB ({e}); this environment may "
            "have no network egress — download the file manually and use "
            "from_pdb()"
        ) from e


def from_pdb_id(
    pdb_id: str,
    heavy_chain_id: Optional[str] = None,
    light_chain_id: Optional[str] = None,
    antigen_chain_ids: Sequence[str] = (),
    keep_fv_only: bool = False,
) -> AntibodyComplex:
    """`fetch_pdb` then assemble the named chains, as `from_pdb` does for a file."""
    return from_chains(
        parse_pdb(fetch_pdb(pdb_id)),
        heavy_chain_id,
        light_chain_id,
        antigen_chain_ids,
        keep_fv_only,
    )
