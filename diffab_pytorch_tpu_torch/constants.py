"""Amino-acid vocabulary, atom slots, CDR definitions and chain indices.

The port's own copy of what it needs from `diffab_pytorch_tpu/constants.py`
(the JAX package is never imported here).  Vocabulary: 20 standard amino
acids in alphabetical 3-letter order plus UNK, size 21 everywhere.  Atom
slots: N, CA, C, O, CB first, then side-chain heavy atoms, up to 15 per
residue.  CDRs: Chothia loop ranges on the input's residue numbering.
Chain index 0 is padding; heavy 1, light 2, antigens from 3.
"""

from __future__ import annotations

import enum

AA_VOCAB_SIZE = 21

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}

AA_THREE = list(THREE_TO_ONE.keys())  # canonical index order, 0..19
AA_INDEX = {name: i for i, name in enumerate(AA_THREE)}
AA_ONE_INDEX = {THREE_TO_ONE[k]: i for i, k in enumerate(AA_THREE)}


class AA(enum.IntEnum):
    ALA = 0
    ARG = 1
    ASN = 2
    ASP = 3
    CYS = 4
    GLN = 5
    GLU = 6
    GLY = 7
    HIS = 8
    ILE = 9
    LEU = 10
    LYS = 11
    MET = 12
    PHE = 13
    PRO = 14
    SER = 15
    THR = 16
    TRP = 17
    TYR = 18
    VAL = 19
    UNK = 20


MAX_N_ATOMS_PER_RESIDUE = 15


class ATOM(enum.IntEnum):
    N = 0
    CA = 1
    C = 2
    O = 3
    CB = 4


# Per-residue heavy-atom names in slot order: slot i of residue r holds
# RESIDUE_ATOMS[r][i]; missing slots are masked.
RESIDUE_ATOMS = {
    "ALA": ["N", "CA", "C", "O", "CB"],
    "ARG": ["N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"],
    "ASP": ["N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"],
    "CYS": ["N", "CA", "C", "O", "CB", "SG"],
    "GLN": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"],
    "GLU": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"],
    "GLY": ["N", "CA", "C", "O"],
    "HIS": ["N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"],
    "LEU": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"],
    "LYS": ["N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"],
    "MET": ["N", "CA", "C", "O", "CB", "CG", "SD", "CE"],
    "PHE": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["N", "CA", "C", "O", "CB", "CG", "CD"],
    "SER": ["N", "CA", "C", "O", "CB", "OG"],
    "THR": ["N", "CA", "C", "O", "CB", "OG1", "CG2"],
    "TRP": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2",
            "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2",
            "CZ", "OH"],
    "VAL": ["N", "CA", "C", "O", "CB", "CG1", "CG2"],
}

CDR_NAMES = ["H1", "H2", "H3", "L1", "L2", "L3"]


class CDR(enum.IntEnum):
    """Per-residue CDR label; 0 = framework or antigen."""
    NONE = 0
    H1 = 1
    H2 = 2
    H3 = 3
    L1 = 4
    L2 = 5
    L3 = 6


# Chothia CDR loop boundaries, inclusive residue numbers (insertion codes
# included)
CHOTHIA_CDR_RANGES = {
    "H1": (26, 32),
    "H2": (52, 56),
    "H3": (95, 102),
    "L1": (24, 34),
    "L2": (50, 56),
    "L3": (89, 97),
}

# Fv region upper bounds in Chothia numbering (keep_fv_only trimming)
FV_MAX_RESNUM = {"H": 113, "L": 107}

MAX_N_CHAINS = 10
HEAVY_CHAIN_IDX = 1
LIGHT_CHAIN_IDX = 2
FIRST_ANTIGEN_CHAIN_IDX = 3
