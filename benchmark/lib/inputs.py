"""The run's inputs: synthetic antibody-antigen complexes as patch files.

Each example is one complex of the port's synthetic family corpus
(`data/synthetic.py make_family_pdb`: heavy, light and antigen chains in
Chothia numbering, a family's CDR-H3 motif and bump, a random pose and
per-atom jitter) parsed and cut to a 128-residue patch the way
`cli.preprocess` and `cli.sample --pdb` do (`structure.antibody.from_chains`,
`structure.patch.featurize_patch`), and written as the `.npz` that
`cli.sample --patch` and `cli.train --data-dir` read.  Both the port and
the reference read those files.

Examples are drawn from the run's seed: example i is family i mod 8 with a
sample seed from (seed, i), so every seed gives the same number of
examples of each family and the same patch size.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os

N_FAMILIES = 8


def derive(*parts) -> int:
    """A 48-bit seed for one use of the run's seed (weights, a job, an
    example, ...), so that every use draws its own numbers."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:6], "little")


def write_example(args) -> str:
    """Write example (out_dir, seed, i, patch_size); returns its path.  Imports
    only the port's numpy structure layer, so it runs in a worker process."""
    out_dir, seed, i, patch_size = args
    from diffab_pytorch_tpu_torch.data.synthetic import make_family_pdb
    from diffab_pytorch_tpu_torch.structure.antibody import from_chains
    from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch
    from diffab_pytorch_tpu_torch.structure.pdb import parse_pdb

    text = make_family_pdb(i % N_FAMILIES, derive(seed, i) % 2 ** 32,
                           n_families=N_FAMILIES)
    patch = featurize_patch(from_chains(parse_pdb(text), "H", "L", ["A"]), patch_size)
    path = os.path.join(out_dir, f"ex{i:05d}.npz")
    save_patch(path, patch)
    return path


def write_examples(out_dir: str, seed: int, n: int, patch_size: int, workers: int = 1) -> list:
    """Write n examples into out_dir (in worker processes when workers > 1);
    returns their paths in order."""
    from diffab_pytorch_tpu_torch.structure import native

    native.build()  # the C++ parser and featurizer, once, before any worker loads it
    jobs = [(out_dir, seed, i, patch_size) for i in range(n)]
    if workers <= 1:
        return [write_example(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        paths = pool.map(write_example, jobs, chunksize=max(1, n // (4 * workers)))
        pool.close()
        pool.join()
    return paths
