"""The structure layer on the host (numpy): PDB parsing (in Python or
through the C++ library) and writing, geometry, complex assembly,
patches, backbone reconstruction, synthetic PDB text; and the
designed-loop relaxation on the device (torch).

The JAX package's names are importable from here too, loaded on first use,
so that a process that needs one numpy module imports no other (and no
torch)."""

import importlib

# public name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("Residue", "parse_pdb", "parse_pdb_file", "write_pdb"), "pdb"),
    **dict.fromkeys(("AntibodyComplex", "fetch_pdb", "from_arrays", "from_chains", "from_pdb",
                     "from_pdb_id"), "antibody"),
    **dict.fromkeys(("PATCH_KEYS", "extract_patch_mask", "featurize_patch", "load_patch",
                     "save_patch"), "patch"),
    "reconstruct_backbone": "reconstruct",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
