"""PDB ATOM-record parser and writer (host-side numpy;
`diffab_pytorch_tpu/structure/pdb.py`, the Python parser).

Parsing rules:
  * ATOM records only, plus HETATM MSE (selenomethionine -> MET).
  * First model only (stop at ENDMDL).
  * Alternate locations: the first occurrence of each (residue, atom) wins,
    which keeps altloc A of an A/B pair and keeps atoms present only as B.
  * Unknown residue names -> UNK with backbone atoms only.
  * Insertion codes are kept; residues are keyed by (resseq, icode) in
    file order.
  * Residues without a CA are dropped.

`parse_pdb` runs the C++ parser (`structure/native.py`) unless told
`prefer_native=False`; the Python parser below is the semantic reference
the C++ one is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from diffab_pytorch_tpu_torch.constants import (
    AA,
    AA_INDEX,
    AA_THREE,
    MAX_N_ATOMS_PER_RESIDUE,
    RESIDUE_ATOMS,
)

# slot lookup: resname -> {atom_name: slot}
_ATOM_SLOT = {
    res: {name: i for i, name in enumerate(atoms)}
    for res, atoms in RESIDUE_ATOMS.items()
}
_BACKBONE_SLOT = {"N": 0, "CA": 1, "C": 2, "O": 3}


@dataclasses.dataclass
class Residue:
    resseq: int
    icode: str
    resname: str
    xyz: np.ndarray  # (A, 3) float32
    atom_mask: np.ndarray  # (A,) bool

    @property
    def aa_index(self) -> int:
        return AA_INDEX.get(self.resname, int(AA.UNK))


def parse_pdb(text: str, prefer_native: bool = True) -> Dict[str, List[Residue]]:
    """Parse PDB text into {chain_id: [Residue, ...]} in file order, with
    the C++ parser (raising if it cannot be built) or, with
    prefer_native=False, in Python."""
    if prefer_native:
        from diffab_pytorch_tpu_torch.structure import native

        return native.parse_pdb_native(text)
    chains: Dict[str, List[Residue]] = {}
    current: Dict[str, tuple] = {}  # chain -> (resseq, icode)
    buffers: Dict[str, Residue] = {}

    def flush(chain_id: str):
        if chain_id in buffers:
            chains.setdefault(chain_id, []).append(buffers.pop(chain_id))

    for line in text.splitlines():
        rec = line[:6]
        if rec == "ENDMDL":
            break
        is_atom = rec == "ATOM  "
        is_mse = rec == "HETATM" and line[17:20] == "MSE"
        if not (is_atom or is_mse):
            continue
        atom_name = line[12:16].strip()
        resname = line[17:20].strip()
        if is_mse:
            resname = "MET"
            if atom_name == "SE":
                atom_name = "SD"
        chain_id = line[21]
        try:
            resseq = int(line[22:26])
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
        except ValueError:
            continue
        icode = line[26]

        key = (resseq, icode)
        if current.get(chain_id) != key:
            flush(chain_id)
            current[chain_id] = key
            buffers[chain_id] = Residue(
                resseq=resseq,
                icode=icode,
                resname=resname if resname in RESIDUE_ATOMS else "UNK",
                xyz=np.zeros((MAX_N_ATOMS_PER_RESIDUE, 3), np.float32),
                atom_mask=np.zeros(MAX_N_ATOMS_PER_RESIDUE, bool),
            )

        res = buffers[chain_id]
        slots = _ATOM_SLOT.get(res.resname, _BACKBONE_SLOT)
        slot = slots.get(atom_name)
        if slot is None and res.resname == "UNK":
            slot = _BACKBONE_SLOT.get(atom_name)
        if slot is not None and not res.atom_mask[slot]:
            res.xyz[slot] = (x, y, z)
            res.atom_mask[slot] = True

    for chain_id in list(buffers):
        flush(chain_id)
    for chain_id in chains:
        chains[chain_id] = [r for r in chains[chain_id] if r.atom_mask[1]]
    return chains


def parse_pdb_file(path: str, prefer_native: bool = True) -> Dict[str, List[Residue]]:
    with open(path) as f:
        return parse_pdb(f.read(), prefer_native)


def _coord(v: float) -> str:
    """An 8-column PDB coordinate field: fewer decimals for values that
    would overflow it (designs from an untrained model can be far out)."""
    for dec in (3, 2, 1, 0):
        s = f"{v:8.{dec}f}"
        if len(s) == 8:
            return s
    return f"{max(min(v, 9.9e7), -9.9e6):8.0f}"


def write_pdb(
    path: str,
    xyz: np.ndarray,  # (L, A, 3)
    atom_mask: np.ndarray,  # (L, A)
    seq_idx: np.ndarray,  # (L,)
    chain_ids: List[str],  # per residue
    residue_numbers: np.ndarray,  # (L,)
    icodes: np.ndarray | None = None,  # (L,) uint8 char codes (or None)
) -> None:
    """Write a structure as PDB ATOM records, the slots with atom_mask set.
    Insertion codes are written, so Chothia-numbered loops (100A-K in a
    long H3) keep their residues apart when the file is parsed again."""
    lines = []
    serial = 1
    for i in range(xyz.shape[0]):
        resname = AA_THREE[int(seq_idx[i])] if int(seq_idx[i]) < 20 else "UNK"
        atom_names = RESIDUE_ATOMS.get(resname, ["N", "CA", "C", "O"])
        ic = " "
        if icodes is not None and int(icodes[i]) not in (0, ord(" ")):
            ic = chr(int(icodes[i]))
        for a, name in enumerate(atom_names):
            if a >= atom_mask.shape[1] or not atom_mask[i, a]:
                continue
            x, y, z = (_coord(float(v)) for v in xyz[i, a])
            element = name[0]
            name4 = f" {name:<3s}" if len(name) < 4 else name
            lines.append(
                f"ATOM  {serial:5d} {name4} {resname:>3s} {chain_ids[i]}"
                f"{int(residue_numbers[i]):4d}{ic}   "
                f"{x}{y}{z}{1.0:6.2f}{0.0:6.2f}"
                f"          {element:>2s}"
            )
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
