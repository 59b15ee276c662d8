"""Amino-acid vocabulary, atom slots and chain-index constants.

The port's own copy of what it needs from `diffab_pytorch_tpu/constants.py`
(the JAX package is never imported here).  Vocabulary: 20 standard amino
acids in alphabetical 3-letter order plus UNK, size 21 everywhere.  Atom
slots: N, CA, C, O, CB first, up to 15 per residue.  Chain index 0 is
padding.
"""

from __future__ import annotations

import enum

AA_VOCAB_SIZE = 21


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


MAX_N_CHAINS = 10
HEAVY_CHAIN_IDX = 1
LIGHT_CHAIN_IDX = 2
FIRST_ANTIGEN_CHAIN_IDX = 3
