"""Synthetic antibody-antigen PDB text for tests, the smoke run and the
synthetic corpus (`diffab_pytorch_tpu/structure/testing.py`).

Chothia-numbered heavy and light chains with consistent backbones (exact
1.33 A peptide bonds, non-degenerate frames) and an antigen chain placed
near the CDR loops.  Two layers: `_chain_residues` builds one chain's
atom coordinates along a gently curving path (arrays, so a caller can move
them before any text exists) and `format_pdb` renders residues into strict
PDB columns.  For one seed the text is the JAX package's byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from diffab_pytorch_tpu_torch.constants import AA_THREE, RESIDUE_ATOMS

_CA_STEP = 3.8


@dataclasses.dataclass
class Residue:
    """One residue's identity and atom coordinates (name -> (3,) array)."""

    resname: str
    resnum: int
    atoms: dict


def _chain_residues(
    resnums: list[int],
    origin: np.ndarray,
    direction: np.ndarray,
    perp: np.ndarray,
    rng: np.random.Generator,
    curvature: float = 0.04,
    sequence: list[str] | None = None,
) -> tuple[list[Residue], np.ndarray]:
    """One chain's residues and its (n, 3) CA array.

    With unit step d along the path and p perpendicular to it:
      CA_i = path(i);  C_i = CA_i + 0.40 d + 0.8 p;  N_i = CA_i - 0.25 d + 0.8 p
    so |C_i - N_{i+1}| = 0.35 * 3.8 = 1.33 A on straight segments.
    sequence: per-residue 3-letter names; None draws uniform random types
    (one rng call per residue)."""
    d = direction / np.linalg.norm(direction)
    p = perp - np.dot(perp, d) * d
    p = p / np.linalg.norm(p)

    residues = []
    ca_list = []
    pos = origin.astype(np.float64).copy()
    axis = d.copy()
    for i, resnum in enumerate(resnums):
        if sequence is None:
            resname = AA_THREE[int(rng.integers(0, 20))]
        else:
            resname = sequence[i]
        ca = pos.copy()
        step = axis * _CA_STEP
        n = ca - 0.25 * step + 0.8 * p
        c = ca + 0.40 * step + 0.8 * p
        o = c + np.array([0.0, 0.0, 1.23])
        atoms = {"N": n, "CA": ca, "C": c, "O": o}
        if "CB" in RESIDUE_ATOMS[resname]:
            atoms["CB"] = ca + 1.5 * np.cross(axis, p)
        residues.append(Residue(resname, resnum, atoms))
        ca_list.append(ca)
        # coil the chain: turn the direction a little each residue
        rot_axis = np.cross(axis, p)
        axis = axis + curvature * rot_axis
        axis = axis / np.linalg.norm(axis)
        pos = pos + axis * _CA_STEP
    return residues, np.array(ca_list)


def _format_chain(
    chain_id: str, residues: list[Residue], serial_start: int
) -> tuple[list[str], int]:
    """Strict-column ATOM lines (name 13-16, altloc 17, resname 18-20,
    chain 22, resseq 23-26, icode 27, xyz from 31); returns them and the
    next serial."""
    lines = []
    serial = serial_start
    for res in residues:
        for name in RESIDUE_ATOMS[res.resname][:5]:
            if name not in res.atoms:
                continue
            x, y, z = res.atoms[name]
            name4 = f" {name:<3s}" if len(name) < 4 else name
            lines.append(
                f"ATOM  {serial:5d} {name4} {res.resname:>3s} {chain_id}"
                f"{res.resnum:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                f"          {name[0]:>2s}"
            )
            serial += 1
    return lines, serial


def format_pdb(chains: list[tuple[str, list[Residue]]]) -> str:
    """Whole PDB text for (chain_id, residues) pairs, serials continuous."""
    lines: list[str] = []
    serial = 1
    for chain_id, residues in chains:
        chain_lines, serial = _format_chain(chain_id, residues, serial)
        lines += chain_lines
    lines.append("END")
    return "\n".join(lines) + "\n"


def make_synthetic_antibody_pdb(
    seed: int = 0,
    heavy_len: int = 118,
    light_len: int = 107,
    antigen_len: int = 60,
    with_antigen: bool = True,
) -> str:
    """PDB text with chains H (Chothia 1..heavy_len) and L, random residue
    types, and optionally an antigen chain A near the H3 loop."""
    rng = np.random.default_rng(seed)
    h_res, h_ca = _chain_residues(
        list(range(1, heavy_len + 1)),
        origin=np.zeros(3), direction=np.array([1.0, 0.2, 0.0]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng,
    )
    l_res, _ = _chain_residues(
        list(range(1, light_len + 1)),
        origin=np.array([0.0, 14.0, 4.0]), direction=np.array([1.0, -0.2, 0.1]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng,
    )
    chains = [("H", h_res), ("L", l_res)]
    if with_antigen:
        # near CDR-H3 (Chothia 95-102)
        h3_center = h_ca[94:102].mean(axis=0) if heavy_len >= 102 else h_ca.mean(0)
        a_res, _ = _chain_residues(
            list(range(1, antigen_len + 1)),
            origin=h3_center + np.array([0.0, -8.0, 6.0]),
            direction=np.array([-1.0, 0.3, 0.2]),
            perp=np.array([0.2, 0.0, 1.0]), rng=rng,
        )
        chains.append(("A", a_res))
    return format_pdb(chains)
