"""Learnable synthetic antibody corpora (`diffab_pytorch_tpu/data/synthetic.py`).

The family corpus.  F antibody families.  Each family f has a fixed CDR-H3
sequence motif (Chothia H 95-102), a family "barcode" in the framework
residues flanking H3 (H 88-94 and 103-109) that identifies the family from
the context, and a family-specific H3 conformation (a smooth bump whose
direction and amplitude are set by f).  Every sample draws its own global
rotation and per-atom jitter.  The rest of the sequence is a function of
position only, so the H3 identity is reachable only through the barcode: a
trained model recovers it far above the 1/20 of chance.

The compositional corpus.  The barcode is N_SLOTS independent slots of
n_values values, each written into its own framework positions; loop
position k's residue depends only on slot k mod N_SLOTS, and the loop's
shape is a linear mixture of per-slot displacements.  Training sees a
subset of the combinations that covers every (slot, value) pair; held-out
combinations are then answerable only by a model that learned the
per-slot rule.  Options: several CDR-H loops (`cdr_loops`), several valid
residues per position (`seq_degeneracy`), and a second barcode that alone
drives the shapes (`decouple_shape`).

The meta-shaped corpus.  The compositional rule laid into files with the
exact chain inventory of a SAbDab meta.csv: one PDB per pdb_id holding
every row's chains under their ids (multi-Fv files, multi-chain
antigens, rows without a heavy or light chain).  The meta.csv is read with
the `csv` module into the values `pandas.read_csv` gives.

For the same arguments every file written (PDBs, meta.csv, the JSON
manifests) is the JAX package's byte for byte.
"""

from __future__ import annotations

import csv
import json
import os
import re
import zlib

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


def _light_sequence(resnums: list[int]) -> list[str]:
    return [_aa(5 * r + 2) for r in resnums]


def _antigen_sequence(resnums: list[int]) -> list[str]:
    return [_aa(11 * r + 4) for r in resnums]


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation from the QR of a Gaussian matrix."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diagonal(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _transform(residues: list[Residue], rot: np.ndarray, jitter: float,
               rng: np.random.Generator) -> None:
    """Rotate every atom by `rot` and add per-atom Gaussian jitter, in place."""
    for res in residues:
        for name, xyz in res.atoms.items():
            res.atoms[name] = xyz @ rot.T + rng.normal(scale=jitter, size=3)


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
        perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=_light_sequence(l_nums))
    h3_center = h_ca[94:102].mean(axis=0)
    a_res, _ = _chain_residues(
        a_nums, origin=h3_center + np.array([0.0, -8.0, 6.0]),
        direction=np.array([-1.0, 0.3, 0.2]), perp=np.array([0.2, 0.0, 1.0]), rng=rng,
        sequence=_antigen_sequence(a_nums))

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
        _transform(residues, rot, jitter, rng)
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


# ---------------------------------------------------------------------------
# The compositional corpus

N_SLOTS = 4
# the barcode's framework positions, 3 per slot (within H 88-94 and 103-109)
_SLOT_POSITIONS = [(88, 89, 90), (91, 92, 93), (103, 104, 105), (106, 107, 108)]
# the shape barcode's positions (decouple_shape), flanking the H2 anchor so
# that every multi-CDR patch holds them
_SHAPE_SLOT_POSITIONS = [(57, 58, 59), (60, 61, 62), (63, 64, 65), (66, 67, 68)]
# Chothia heavy loop ranges; each loop has its own sequence offset, fan
# phase and (H1, H2) gentler bump amplitudes; H3's come from the arguments
CDR_LOOP_RANGES = {"H1": (26, 32), "H2": (52, 56), "H3": (95, 102)}
_LOOP_SEQ_OFFSET = {"H1": 2, "H2": 4, "H3": 1}
_LOOP_PHASE = {"H1": 0.9, "H2": 1.9, "H3": 0.0}
_LOOP_BUMP = {"H1": (0.6, 0.35), "H2": (0.6, 0.35)}
# option g of a degenerate position shifts the residue by 9 g (9 is coprime
# to 20, so up to 4 options stay distinct)
_DEGENERACY_SHIFT = 9


def all_combos(n_values: int) -> list[tuple[int, ...]]:
    """Every slot-value combination, in lexicographic order."""
    combos = [()]
    for _ in range(N_SLOTS):
        combos = [c + (v,) for c in combos for v in range(n_values)]
    return combos


def loop_motif_index_options(combo: tuple[int, ...], loop: str,
                             degeneracy: int) -> list[list[int]]:
    """The valid amino-acid indices (0..19) at each position of `loop`: the
    ground truth of valid-set recovery on a degenerate corpus."""
    lo, hi = CDR_LOOP_RANGES[loop]
    off = _LOOP_SEQ_OFFSET[loop]
    return [[(combo[k % N_SLOTS] * 7 + 3 * k + off + _DEGENERACY_SHIFT * g) % 20
             for g in range(degeneracy)]
            for k in range(hi - lo + 1)]


def combo_loop_motif(combo: tuple[int, ...], loop: str = "H3",
                     choices: list[int] | None = None) -> list[str]:
    """`loop`'s residues: position k depends only on slot k mod N_SLOTS.
    `choices` picks each position's option (None: option 0 everywhere)."""
    lo, hi = CDR_LOOP_RANGES[loop]
    off = _LOOP_SEQ_OFFSET[loop]
    n = hi - lo + 1
    if choices is None:
        choices = [0] * n
    return [_aa(combo[k % N_SLOTS] * 7 + 3 * k + off + _DEGENERACY_SHIFT * choices[k])
            for k in range(n)]


def combo_h3_motif(combo: tuple[int, ...]) -> list[str]:
    return combo_loop_motif(combo, "H3")


def _heavy_sequence_combo(
    resnums: list[int],
    combo: tuple[int, ...],
    cdr_loops: tuple[str, ...] = ("H3",),
    loop_choices: dict[str, list[int]] | None = None,
    shape_combo: tuple[int, ...] | None = None,
) -> list[str]:
    loop_of_pos = {r: (loop, r - CDR_LOOP_RANGES[loop][0]) for loop in cdr_loops
                   for r in range(CDR_LOOP_RANGES[loop][0], CDR_LOOP_RANGES[loop][1] + 1)}
    slot_of_pos = {p: (j, i) for j, positions in enumerate(_SLOT_POSITIONS)
                   for i, p in enumerate(positions)}
    shape_slot_of_pos = ({} if shape_combo is None else
                         {p: (j, i) for j, positions in enumerate(_SHAPE_SLOT_POSITIONS)
                          for i, p in enumerate(positions)})
    seq = []
    for r in resnums:
        if r in loop_of_pos:
            loop, k = loop_of_pos[r]
            ch = None if loop_choices is None else loop_choices.get(loop)
            seq.append(combo_loop_motif(combo, loop, choices=ch)[k])
        elif r in slot_of_pos:
            j, i = slot_of_pos[r]
            seq.append(_aa(combo[j] * 7 + 5 + 4 * i + j))  # the slot's value code
        elif r in shape_slot_of_pos:
            j, i = shape_slot_of_pos[r]
            seq.append(_aa(shape_combo[j] * 7 + 2 + 4 * i + 3 * j))  # the shape slot's code
        else:
            seq.append(_aa(3 * r))  # shared framework
    return seq


def _repair_peptide_bonds(residues: list[Residue]) -> None:
    """Move every N(i+1) onto the ideal 1.329 A peptide bond along the
    C(i) -> N(i+1) direction: the loop shifts and the jitter stretch the
    bonds between residues (each residue moves rigidly), and this keeps the
    corpus valid under `backbone_validity` without moving the CAs."""
    for a, b in zip(residues, residues[1:]):
        if b.resnum - a.resnum != 1:
            continue
        c, n = a.atoms.get("C"), b.atoms.get("N")
        if c is None or n is None:
            continue
        d = n - c
        norm = float(np.linalg.norm(d))
        if norm > 1e-6:
            b.atoms["N"] = c + d * (1.329 / norm)


def _loop_mix(slots, base: float, step: float, phase: float) -> np.ndarray:
    """A loop's displacement: the mean over slots of a fixed direction per
    slot (a 150-degree fan in the y-z plane, turned by `phase`) scaled by
    base + step * value."""
    mix = np.zeros(3)
    for j, v in enumerate(slots):
        # a fan, not a full circle: opposed directions would cancel equal
        # slot values and collapse distinct combinations onto one shape
        phi = (j / max(N_SLOTS - 1, 1) - 0.5) * (5.0 * np.pi / 6.0) + phase
        u = np.array([0.0, np.cos(phi), np.sin(phi)])
        mix = mix + (base + step * v) * u
    return mix / N_SLOTS


def _shift_loop(residues: list[Residue], lo: int, hi: int, mix: np.ndarray) -> None:
    """Shift the residues numbered lo..hi by mix, with a sine profile."""
    for res in residues:
        if lo <= res.resnum <= hi:
            w = np.sin(np.pi * (res.resnum - lo + 0.5) / (hi - lo + 1))
            for name in res.atoms:
                res.atoms[name] = res.atoms[name] + w * mix


def make_combo_pdb(
    combo: tuple[int, ...],
    seed: int,
    heavy_len: int = 118,
    light_len: int = 107,
    antigen_len: int = 60,
    bump_base: float = 1.0,
    bump_step: float = 0.6,
    jitter: float = 0.1,
    cdr_loops: tuple[str, ...] = ("H3",),
    seq_degeneracy: int = 1,
    shape_combo: tuple[int, ...] | None = None,
) -> str:
    """One complex of a slot-value combination: chains H, L and A, each of
    `cdr_loops` with the combination's residues and shape.  seq_degeneracy
    d > 1 draws each loop position among its d options; `shape_combo`
    drives the shapes in place of `combo` (the decoupled-shape corpus)."""
    if not 1 <= seq_degeneracy <= 4:
        raise ValueError("seq_degeneracy must be in [1, 4] (option shifts stay distinct mod 20)")
    # hash() of a tuple of ints is not salted: the same stream in every process
    rng = np.random.default_rng((hash(combo) & 0x7FFFFFFF) * 2_000_003 + seed)
    loop_choices = None
    if seq_degeneracy > 1:
        loop_choices = {loop: rng.integers(0, seq_degeneracy,
                                           size=CDR_LOOP_RANGES[loop][1]
                                           - CDR_LOOP_RANGES[loop][0] + 1).tolist()
                        for loop in cdr_loops}
    h_nums = list(range(1, heavy_len + 1))
    l_nums = list(range(1, light_len + 1))
    a_nums = list(range(1, antigen_len + 1))
    h_res, h_ca = _chain_residues(
        h_nums, origin=np.zeros(3), direction=np.array([1.0, 0.2, 0.0]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng,
        sequence=_heavy_sequence_combo(h_nums, combo, tuple(cdr_loops),
                                       loop_choices=loop_choices, shape_combo=shape_combo))
    l_res, _ = _chain_residues(
        l_nums, origin=np.array([0.0, 14.0, 4.0]), direction=np.array([1.0, -0.2, 0.1]),
        perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=_light_sequence(l_nums))
    h3_center = h_ca[94:102].mean(axis=0)
    a_res, _ = _chain_residues(
        a_nums, origin=h3_center + np.array([0.0, -8.0, 6.0]),
        direction=np.array([-1.0, 0.3, 0.2]), perp=np.array([0.2, 0.0, 1.0]), rng=rng,
        sequence=_antigen_sequence(a_nums))
    for loop in cdr_loops:
        base, step = _LOOP_BUMP.get(loop, (bump_base, bump_step))
        mix = _loop_mix(shape_combo if shape_combo is not None else combo, base, step,
                        _LOOP_PHASE[loop])
        _shift_loop(h_res, *CDR_LOOP_RANGES[loop], mix)

    rot = _random_rotation(rng)
    for residues in (h_res, l_res, a_res):
        _transform(residues, rot, jitter, rng)
        _repair_peptide_bonds(residues)
    return format_pdb([("H", h_res), ("L", l_res), ("A", a_res)])


def split_combos(n_values: int, n_train: int, n_heldout: int,
                 seed: int = 0) -> tuple[list[tuple[int, ...]], list[tuple[int, ...]]]:
    """A random train / held-out split of the combinations whose train part
    covers every (slot, value) pair."""
    combos = all_combos(n_values)
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        order = rng.permutation(len(combos))
        train = [combos[i] for i in order[:n_train]]
        heldout = [combos[i] for i in order[n_train:n_train + n_heldout]]
        seen = {(j, v) for c in train for j, v in enumerate(c)}
        if len(seen) == N_SLOTS * n_values:
            return train, heldout
    raise RuntimeError(f"could not cover all {N_SLOTS}x{n_values} (slot, value) pairs "
                       f"with {n_train} train combos")


def write_combo_corpus(
    out_dir: str,
    n_values: int = 4,
    n_train_combos: int = 40,
    n_heldout_combos: int = 12,
    n_per_combo: int = 12,
    n_val_instances: int = 2,
    seed: int = 0,
    cdr_loops: tuple[str, ...] = ("H3",),
    seq_degeneracy: int = 1,
    decouple_shape: bool = False,
    **pdb_kwargs,
) -> dict:
    """Write {out_dir}/pdb/c{idx}_s{i}.pdb (train combinations, i <
    n_per_combo; the last n_val_instances of each are the held-out
    instances) and h{idx}_s{i}.pdb (held-out combinations, i <
    n_val_instances), meta.csv, and the split manifest combos.json, which
    is returned.  decouple_shape: every instance draws its own shape
    barcode, so the loop shapes say nothing of the sequence rule."""
    pdb_dir = os.path.join(out_dir, "pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    train, heldout = split_combos(n_values, n_train_combos, n_heldout_combos, seed=seed)
    shape_rng = np.random.default_rng(seed * 7 + 13)
    draw_shape = ((lambda: tuple(int(v) for v in shape_rng.integers(0, n_values, N_SLOTS)))
                  if decouple_shape else (lambda: None))
    rows = ["pdb_id,Hchain,Lchain,antigen_chain"]
    for prefix, combos, n_inst, seed_off in (("c", train, n_per_combo, 0),
                                             ("h", heldout, n_val_instances, 500)):
        for idx, combo in enumerate(combos):
            for i in range(n_inst):
                pdb_id = f"{prefix}{idx}_s{i}"
                text = make_combo_pdb(combo, seed * 1_000 + seed_off + i, cdr_loops=cdr_loops,
                                      seq_degeneracy=seq_degeneracy, shape_combo=draw_shape(),
                                      **pdb_kwargs)
                with open(os.path.join(pdb_dir, f"{pdb_id}.pdb"), "w") as fh:
                    fh.write(text)
                rows.append(f"{pdb_id},H,L,A")
    with open(os.path.join(out_dir, "meta.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    manifest = {
        "n_values": n_values,
        "n_slots": N_SLOTS,
        "cdr_loops": list(cdr_loops),
        "seq_degeneracy": seq_degeneracy,
        "decouple_shape": decouple_shape,
        "train_combos": [list(c) for c in train],
        "heldout_combos": [list(c) for c in heldout],
        "n_per_combo": n_per_combo,
        "n_val_instances": n_val_instances,
    }
    with open(os.path.join(out_dir, "combos.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


# ---------------------------------------------------------------------------
# The meta-shaped corpus


def _fv_unit_chains(
    rng: np.random.Generator,
    heavy_id: str | None,
    light_id: str | None,
    antigen_ids: list[str],
    combo: tuple[int, ...] | None,
    heavy_len: int = 118,
    light_len: int = 107,
    jitter: float = 0.1,
    bump_base: float = 1.0,
    bump_step: float = 0.6,
) -> list[tuple[str, list[Residue]]]:
    """One Fv unit as (chain id, residues) pairs in a pose of its own: the
    heavy chain (with the compositional H3 when `combo` is given) and/or
    the light chain, and 0..n antigen chains of random length docked at
    H3 (or L3 when there is no heavy chain), as one meta.csv row has them."""
    chains: list[tuple[str, list[Residue]]] = []
    anchor_ca = None
    if heavy_id is not None:
        resnums = list(range(1, heavy_len + 1))
        seq = (_heavy_sequence_combo(resnums, combo, ("H3",)) if combo is not None
               else [_aa(3 * r) for r in resnums])
        h_res, h_ca = _chain_residues(
            resnums, origin=np.zeros(3), direction=np.array([1.0, 0.2, 0.0]),
            perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=seq)
        if combo is not None:
            _shift_loop(h_res, *CDR_LOOP_RANGES["H3"],
                        _loop_mix(combo, bump_base, bump_step, 0.0))
        chains.append((heavy_id, h_res))
        anchor_ca = h_ca[94:102].mean(axis=0)
    if light_id is not None:
        resnums = list(range(1, light_len + 1))
        l_res, l_ca = _chain_residues(
            resnums, origin=np.array([0.0, 14.0, 4.0]), direction=np.array([1.0, -0.2, 0.1]),
            perp=np.array([0.0, 0.0, 1.0]), rng=rng, sequence=_light_sequence(resnums))
        chains.append((light_id, l_res))
        if anchor_ca is None:
            anchor_ca = l_ca[88:97].mean(axis=0)  # no heavy chain: dock near L3
    for j, ag_id in enumerate(antigen_ids):
        ag_len = int(rng.integers(40, 91))
        resnums = list(range(1, ag_len + 1))
        # a fan of antigen chains around the docking site, all within patch range
        phi = 2.0 * np.pi * j / max(len(antigen_ids), 1)
        side = np.array([0.0, -8.0 - 6.0 * np.cos(phi), 6.0 + 5.0 * np.sin(phi)])
        a_res, _ = _chain_residues(
            resnums, origin=anchor_ca + side, direction=np.array([-1.0, 0.3, 0.2 + 0.15 * j]),
            perp=np.array([0.2, 0.0, 1.0]), rng=rng, sequence=_antigen_sequence(resnums))
        chains.append((ag_id, a_res))
    rot = _random_rotation(rng)
    for _, residues in chains:
        _transform(residues, rot, jitter, rng)
        _repair_peptide_bonds(residues)
    return chains


# the strings pandas.read_csv reads as missing by default
_NA_STRINGS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                         "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                         "nan", "null"})
_INT = re.compile(r"[+-]?[0-9]+")
_META_COLUMNS = ("pdb_id", "Hchain", "Lchain", "antigen_chain")


def _column_values(raw: list[str]) -> list:
    """One csv column as pandas.read_csv types it: None where missing; ints
    when every other value is an integer and none is missing, floats when
    every other value is a number; else the strings as written."""
    present = [v for v in raw if v not in _NA_STRINGS]

    def is_float(v: str) -> bool:
        try:
            float(v)
        except ValueError:
            return False
        return "_" not in v and v == v.strip()  # Python's float() is laxer
    if present and len(present) == len(raw) and all(_INT.fullmatch(v) for v in present):
        return [int(v) for v in raw]
    if present and all(map(is_float, present)):
        return [None if v in _NA_STRINGS else float(v) for v in raw]
    return [None if v in _NA_STRINGS else v for v in raw]


def _read_meta(meta_path: str, limit: int | None) -> list[tuple]:
    """(pdb_id, Hchain, Lchain, antigen_chain) of each row of a meta.csv,
    valued as pandas.read_csv(meta_path) values them; the first `limit`
    rows."""
    with open(meta_path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [r for r in reader if r]  # read_csv skips blank lines
    cols = [_column_values([r[header.index(c)] for r in rows]) for c in _META_COLUMNS]
    records = list(zip(*cols))
    return records if limit is None else records[:limit]


def _chain(v) -> str | None:
    s = "" if v is None or (isinstance(v, float) and np.isnan(v)) else str(v).strip()
    return s or None


def write_meta_shaped_corpus(
    out_dir: str,
    meta_path: str,
    n_values: int = 4,
    n_train_combos: int = 40,
    n_heldout_combos: int = 12,
    n_heldout_targets: int = 24,
    seed: int = 0,
    limit: int | None = None,
) -> dict:
    """A corpus with the chain inventory of a SAbDab meta.csv: one PDB per
    pdb_id holding every row's chains under their ids (a shared antigen
    chain once), each Fv unit its own pose apart from the others; a
    meta.csv in the reference's columns ('a | b' antigen joins, empty for
    a missing chain); and manifest.json mapping each row's patch stem to
    its combination and split, which is returned.  Rows with a heavy chain
    draw a train combination, except in `n_heldout_targets` single-row
    files, which cycle through the held-out combinations."""
    meta = _read_meta(meta_path, limit)
    train_combos, heldout_combos = split_combos(n_values, n_train_combos, n_heldout_combos,
                                                seed=seed)
    rng = np.random.default_rng(seed * 9_000_017 + 5)
    groups: dict = {}
    for rec in meta:
        if rec[0] is not None:  # groupby drops a missing key
            groups.setdefault(rec[0], []).append(rec)
    group_ids = sorted(groups)
    # held-out targets: single-row files with a heavy chain (the rule lives in H3)
    single = [p for p in group_ids if len(groups[p]) == 1 and _chain(groups[p][0][1]) is not None]
    heldout_pdbs = set(rng.permutation(sorted(single))[:n_heldout_targets].tolist())

    pdb_dir = os.path.join(out_dir, "pdb")
    os.makedirs(pdb_dir, exist_ok=True)
    manifest_rows = {}
    ho_cycle = 0
    for pdb_id in group_ids:
        units = []
        for _, h, l, ag in groups[pdb_id]:
            heavy, light, ag_raw = _chain(h), _chain(l), _chain(ag)
            antigens = [c.strip() for c in ag_raw.split("|")] if ag_raw else []
            if heavy is None:
                combo = None
            elif pdb_id in heldout_pdbs:
                combo = heldout_combos[ho_cycle % len(heldout_combos)]
                ho_cycle += 1
            else:
                combo = train_combos[int(rng.integers(len(train_combos)))]
            stem = "_".join([str(pdb_id), heavy or "na", light or "na",
                             "".join(antigens) or "na"])
            manifest_rows[stem] = {
                "pdb_id": str(pdb_id),
                "combo": list(combo) if combo is not None else None,
                "split": ("heldout" if pdb_id in heldout_pdbs else
                          "train" if combo is not None else "no_heavy"),
            }
            units.append((heavy, light, antigens, combo))
        # crc32, not hash(): str hashing is salted per process
        unit_rng = np.random.default_rng(
            (zlib.crc32(str(pdb_id).encode()) & 0x7FFFFFFF) * 3_000_161 + seed)
        chains: list[tuple[str, list[Residue]]] = []
        seen_ids: set[str] = set()
        for u, (heavy, light, antigens, combo) in enumerate(units):
            unit = _fv_unit_chains(unit_rng, heavy, light, antigens, combo)
            off = np.array([95.0 * u, 23.0 * (u % 3), 40.0 * (u // 3)])  # units apart
            for cid, residues in unit:
                if cid in seen_ids:
                    continue  # a shared antigen chain: the first definition stays
                seen_ids.add(cid)
                for res in residues:
                    for name in res.atoms:
                        res.atoms[name] = res.atoms[name] + off
                chains.append((cid, residues))
        with open(os.path.join(pdb_dir, f"{pdb_id}.pdb"), "w") as fh:
            fh.write(format_pdb(chains))

    out_rows = ["pdb_id,Hchain,Lchain,antigen_chain"]
    for pdb_id, h, l, ag in meta:
        out_rows.append(f"{pdb_id},{_chain(h) or ''},{_chain(l) or ''},{_chain(ag) or ''}")
    with open(os.path.join(out_dir, "meta.csv"), "w") as fh:
        fh.write("\n".join(out_rows) + "\n")
    manifest = {
        "meta_path": meta_path,
        "n_rows": len(meta),
        "n_pdb_files": len(group_ids),
        "n_values": n_values,
        "train_combos": [list(c) for c in train_combos],
        "heldout_combos": [list(c) for c in heldout_combos],
        "heldout_pdbs": sorted(heldout_pdbs),
        "rows": manifest_rows,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest
