"""Preprocessing CLI: PDB(s) -> fixed-shape .npz patches
(`diffab_pytorch_tpu/cli/preprocess.py`, its flags, files and semantics).

    python -m diffab_pytorch_tpu_torch.cli.preprocess -i x.pdb -o x.npz \\
        --heavy-chain-id H --light-chain-id L -a A
    python -m diffab_pytorch_tpu_torch.cli.preprocess --meta meta.csv \\
        --data-dir pdbs --out-dir patches -j 8

Single mode (-i/-o) featurizes one complex.  Bulk mode reads a meta.csv
(columns pdb_id, Hchain, Lchain, antigen_chain; 'nan', 'none' and empty
chain ids mean absent; multi-chain antigens are written 'a | b'), runs
one process per job (spawned), and logs and skips a complex that fails
(keep-going), writing {pdb_id}_{H}_{L}_{antigens}.npz for the rest.
Parsing and the backbone geometry run in the C++ library
(`structure/native.py`), built once before the workers start.  The work
is host numpy; nothing here touches the card.
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing as mp
import os
import sys
import traceback

from diffab_pytorch_tpu_torch.structure import antibody, native, patch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", "--input", help="Path to a single input PDB file.")
    p.add_argument("-o", "--output", help="Output .npz path (single mode).")
    p.add_argument("--heavy-chain-id", default=None)
    p.add_argument("--light-chain-id", default=None)
    p.add_argument("-a", "--antigen-chain-ids", default=None,
                   help="Concatenated chain letters, e.g. 'AB'.")
    p.add_argument("-k", "--nearest-k", type=int, default=128,
                   help="Patch size (K nearest residues around CDR anchors).")
    p.add_argument("--no-fv-trim", action="store_true",
                   help="Keep full chains instead of trimming to the Fv region.")
    p.add_argument("--meta", help="meta.csv for bulk preprocessing.")
    p.add_argument("--data-dir", help="Directory of {pdb_id}.pdb files.")
    p.add_argument("--out-dir", help="Output directory for .npz patches.")
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count() or 1)
    return p.parse_args(argv)


def _norm_chain(v):
    s = "" if v is None else str(v).strip()
    return None if s.lower() in ("", "nan", "none") else s


def process_one(pdb_path: str, out_path: str, heavy: str | None, light: str | None,
                antigens: str | None, k: int, keep_fv_only: bool = True) -> None:
    complex_ = antibody.from_pdb(
        pdb_path,
        heavy_chain_id=_norm_chain(heavy),
        light_chain_id=_norm_chain(light),
        antigen_chain_ids=list(antigens) if antigens else (),
        keep_fv_only=keep_fv_only,
    )
    patch.save_patch(out_path, patch.featurize_patch(complex_, patch_size=k))


def _bulk_worker(row) -> tuple[str, str | None]:
    try:
        process_one(*row)
        return row[1], None
    except Exception:  # keep-going: the row is reported and skipped
        return row[1], traceback.format_exc(limit=2)


def bulk_rows(meta_path: str, data_dir: str, out_dir: str, k: int, keep_fv_only: bool):
    """process_one's arguments for every row of meta.csv."""
    rows = []
    with open(meta_path, newline="") as fh:
        for rec in csv.DictReader(fh):
            heavy = _norm_chain(rec.get("Hchain"))
            light = _norm_chain(rec.get("Lchain"))
            ag_raw = _norm_chain(rec.get("antigen_chain"))
            antigens = "".join(ag_raw.split(" | ")) if ag_raw else None
            pdb_id = rec["pdb_id"]
            name = "_".join([pdb_id, heavy or "na", light or "na", antigens or "na"])
            rows.append((os.path.join(data_dir, f"{pdb_id}.pdb"),
                         os.path.join(out_dir, f"{name}.npz"),
                         heavy, light, antigens, k, keep_fv_only))
    return rows


def run_bulk(args) -> int:
    os.makedirs(args.out_dir, exist_ok=True)
    rows = bulk_rows(args.meta, args.data_dir, args.out_dir, args.nearest_k,
                     not args.no_fv_trim)
    native.build()  # once, before the workers load it
    n_ok = n_fail = 0
    # spawn, not fork: the parent has torch's threads
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        for out_path, err in pool.imap_unordered(_bulk_worker, rows):
            if err is None:
                n_ok += 1
            else:
                n_fail += 1
                print(f"[skip] {out_path}:\n{err}", file=sys.stderr)
    print(f"preprocessed {n_ok} complexes, skipped {n_fail}")
    return 0 if n_ok > 0 else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.meta:
        if not (args.data_dir and args.out_dir):
            print("bulk mode requires --data-dir and --out-dir", file=sys.stderr)
            return 2
        return run_bulk(args)
    if not (args.input and args.output):
        print("single mode requires --input and --output (or use --meta for bulk)",
              file=sys.stderr)
        return 2
    process_one(args.input, args.output, args.heavy_chain_id, args.light_chain_id,
                args.antigen_chain_ids, args.nearest_k, not args.no_fv_trim)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
