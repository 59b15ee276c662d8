"""The C++ PDB parser and backbone featurizer on the host
(`diffab_pytorch_tpu/structure/native.py`), bound with ctypes.

The library is compiled at first use from the repository's
`native/pdb_parser.cpp` and `native/featurize.cpp`, as they stand, with
the flags of `native/Makefile`, into `build/native/` at the repository
root, keyed by a hash of the sources and flags (a changed source is
rebuilt, an unchanged one reused).  The prebuilt `native/*.so` of the JAX
package is never loaded.  A failed build or load raises with the
compiler's output: the Python parser and numpy geometry
(`structure/pdb.py`, `structure/geometry.py`) are the explicit
`prefer_native=False` route, not a silent fall-back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from diffab_pytorch_tpu_torch.constants import AA_THREE, MAX_N_ATOMS_PER_RESIDUE
from diffab_pytorch_tpu_torch.structure.pdb import Residue

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "pdb_parser.cpp", ROOT / "native" / "featurize.cpp")
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
ABI_VERSION = 1

_lib: list[ctypes.CDLL] = []  # the loaded library, once built

_f32 = ctypes.POINTER(ctypes.c_float)
_u8 = ctypes.POINTER(ctypes.c_ubyte)
_i32 = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdiffab_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this hash is already built; returns its
    path.  Concurrent builders each write a temporary file and rename it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the native library ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the native library failed to build ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), its ABI checked."""
    if _lib:
        return _lib[0]
    path = build()
    lib = ctypes.CDLL(str(path))
    lib.diffab_native_abi_version.restype = ctypes.c_int
    lib.diffab_native_abi_version.argtypes = []
    abi = lib.diffab_native_abi_version()
    if abi != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {abi}, expected {ABI_VERSION}")
    lib.diffab_parse_pdb.restype = ctypes.c_int
    lib.diffab_parse_pdb.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _f32, _u8, _i32, _i32,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.diffab_backbone_geometry.restype = ctypes.c_int
    lib.diffab_backbone_geometry.argtypes = [
        _f32, _u8, _i32, ctypes.c_int, ctypes.c_int, _f32, _f32, _u8,
    ]
    _lib.append(lib)
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a failure's reason is
    what `load()` raises)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def parse_pdb_native(text: str) -> Dict[str, list]:
    """`pdb.parse_pdb` through the C++ parser: {chain: [Residue]} in file
    order."""
    lib = load()
    data = text.encode()
    # every residue has at least one line, so this never overflows
    max_res = text.count("\n") + 1
    xyz = np.zeros((max_res, MAX_N_ATOMS_PER_RESIDUE, 3), np.float32)
    mask = np.zeros((max_res, MAX_N_ATOMS_PER_RESIDUE), np.uint8)
    seq = np.zeros(max_res, np.int32)
    resseq = np.zeros(max_res, np.int32)
    icode = ctypes.create_string_buffer(max_res)
    chain = ctypes.create_string_buffer(max_res)
    n = lib.diffab_parse_pdb(
        data, len(data), max_res, xyz.ctypes.data_as(_f32), mask.ctypes.data_as(_u8),
        seq.ctypes.data_as(_i32), resseq.ctypes.data_as(_i32), icode, chain)
    if n < 0:
        raise RuntimeError(f"native parser overflow at {max_res} residues")
    chains: Dict[str, List[Residue]] = {}
    chain_bytes, icode_bytes = chain.raw[:n], icode.raw[:n]
    for i in range(n):
        aa = int(seq[i])
        chains.setdefault(chr(chain_bytes[i]), []).append(Residue(
            resseq=int(resseq[i]),
            icode=chr(icode_bytes[i]),
            resname=AA_THREE[aa] if aa < 20 else "UNK",
            xyz=xyz[i].copy(),
            atom_mask=mask[i].astype(bool),
        ))
    return chains


def backbone_geometry_native(
    xyz: np.ndarray,  # (L, A, 3)
    atom_mask: np.ndarray,  # (L, A) bool
    chain_idx: np.ndarray,  # (L,)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`geometry.backbone_geometry` through the C++ featurizer:
    (orientations (L, 3, 3) f32, dihedrals (L, 3) f32, dihedrals_mask
    (L, 3) bool)."""
    lib = load()
    L, A = atom_mask.shape
    if xyz.shape != (L, A, 3) or chain_idx.shape != (L,):
        raise ValueError(f"shapes {xyz.shape}, {atom_mask.shape}, {chain_idx.shape} do not "
                         "form (L, A, 3), (L, A), (L,)")
    xyz_c = np.ascontiguousarray(xyz, np.float32)
    mask_c = np.ascontiguousarray(atom_mask, np.uint8)
    chain_c = np.ascontiguousarray(chain_idx, np.int32)
    rot = np.empty((L, 3, 3), np.float32)
    dih = np.empty((L, 3), np.float32)
    dih_mask = np.empty((L, 3), np.uint8)
    rc = lib.diffab_backbone_geometry(
        xyz_c.ctypes.data_as(_f32), mask_c.ctypes.data_as(_u8), chain_c.ctypes.data_as(_i32),
        L, A, rot.ctypes.data_as(_f32), dih.ctypes.data_as(_f32), dih_mask.ctypes.data_as(_u8))
    if rc != 0:
        raise RuntimeError(f"native featurizer failed (code {rc}) on L={L}, A={A}")
    return rot, dih, dih_mask.astype(bool)
