"""A learnable synthetic antibody corpus (`diffab_pytorch_tpu/data/synthetic.py`,
its family corpus; the compositional and meta-shaped corpora there are not
ported yet).

F antibody families.  Each family f has a fixed CDR-H3 sequence motif
(Chothia H 95-102), a family "barcode" in the framework residues flanking
H3 (H 88-94 and 103-109) that identifies the family from the context, and
a family-specific H3 conformation (a smooth bump whose direction and
amplitude are set by f).  Every sample draws its own global rotation and
per-atom jitter.  The rest of the sequence is a function of position
only, so the H3 identity is reachable only through the barcode: a trained
model recovers it far above the 1/20 of chance.  For one (family, seed)
the PDB text is the JAX package's byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

from diffab_pytorch_tpu_torch.constants import AA_THREE
from diffab_pytorch_tpu_torch.structure.testing import Residue, _chain_residues, format_pdb

H3_RANGE = (95, 102)  # Chothia, inclusive
BARCODE_RANGES = ((88, 94), (103, 109))


def _aa(i: int) -> str:
    return AA_THREE[i % 20]


def family_h3_motif(family: int) -> list[str]:
    """The family's 8-residue H3 motif; 7 is coprime to 20, so motifs
    differ at every position across families f < 20."""
    lo, hi = H3_RANGE
    return [_aa(family * 7 + 3 * k + 1) for k in range(hi - lo + 1)]


def _heavy_sequence(resnums: list[int], family: int) -> list[str]:
    seq = []
    lo, hi = H3_RANGE
    for r in resnums:
        if lo <= r <= hi:
            seq.append(family_h3_motif(family)[r - lo])
        elif any(a <= r <= b for a, b in BARCODE_RANGES):
            seq.append(_aa(family * 7 + 5 + r))  # the family barcode
        else:
            seq.append(_aa(3 * r))  # shared framework
    return seq


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation from the QR of a Gaussian matrix."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diagonal(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def make_family_pdb(
    family: int,
    seed: int,
    n_families: int = 8,
    heavy_len: int = 118,
    light_len: int = 107,
    antigen_len: int = 60,
    bump_base: float = 1.5,
    bump_step: float = 0.35,
    jitter: float = 0.1,
) -> str:
    """One complex of `family`: chains H, L and A in Chothia numbering, the
    family's motif, barcode and H3 bump, a random global rotation and
    per-atom jitter, all drawn from (family, seed)."""
    rng = np.random.default_rng((family + 1) * 1_000_003 + seed)
    h_nums = list(range(1, heavy_len + 1))
    l_nums = list(range(1, light_len + 1))
    a_nums = list(range(1, antigen_len + 1))
    h_res, h_ca = _chain_residues(
        h_nums, origin=np.zeros(3), direction=np.array([1.0, 0.2, 0.0]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=_heavy_sequence(h_nums, family))
    l_res, _ = _chain_residues(
        l_nums, origin=np.array([0.0, 14.0, 4.0]), direction=np.array([1.0, -0.2, 0.1]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=[_aa(5 * r + 2) for r in l_nums])
    h3_center = h_ca[94:102].mean(axis=0)
    a_res, _ = _chain_residues(
        a_nums, origin=h3_center + np.array([0.0, -8.0, 6.0]),
        direction=np.array([-1.0, 0.3, 0.2]), perp=np.array([0.2, 0.0, 1.0]), rng=rng,
        sequence=[_aa(11 * r + 4) for r in a_nums])

    # the family's H3 conformation: a rigid per-residue shift with a sine
    # profile along the loop, its direction turning about the chain axis
    # with f and its amplitude growing with f
    lo, hi = H3_RANGE
    phi = 2.0 * np.pi * family / max(n_families, 1)
    u = np.array([0.0, np.cos(phi), np.sin(phi)])
    amp = bump_base + bump_step * family
    for res in h_res:
        if lo <= res.resnum <= hi:
            shift = amp * np.sin(np.pi * (res.resnum - lo + 0.5) / (hi - lo + 1)) * u
            for name in res.atoms:
                res.atoms[name] = res.atoms[name] + shift

    rot = _random_rotation(rng)
    for residues in (h_res, l_res, a_res):
        for res in residues:
            for name, xyz in res.atoms.items():
                res.atoms[name] = xyz @ rot.T + rng.normal(scale=jitter, size=3)
    return format_pdb([("H", h_res), ("L", l_res), ("A", a_res)])


def write_family_corpus(
    out_dir: str,
    n_families: int = 8,
    n_per_family: int = 48,
    seed: int = 0,
    **pdb_kwargs,
) -> str:
    """Write {out_dir}/pdb/fam{f}_s{i}.pdb for every family and sample and
    a meta.csv in the reference's format (pdb_id, Hchain, Lchain,
    antigen_chain; `cli/preprocess.py` bulk mode).  Returns the meta path."""
    pdb_dir = os.path.join(out_dir, "pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    rows = ["pdb_id,Hchain,Lchain,antigen_chain"]
    for f in range(n_families):
        for i in range(n_per_family):
            pdb_id = f"fam{f}_s{i}"
            text = make_family_pdb(f, seed * 1_000 + i, n_families=n_families, **pdb_kwargs)
            with open(os.path.join(pdb_dir, f"{pdb_id}.pdb"), "w") as fh:
                fh.write(text)
            rows.append(f"{pdb_id},H,L,A")
    meta_path = os.path.join(out_dir, "meta.csv")
    with open(meta_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return meta_path
