"""Evaluation CLI: designed PDBs against the native patch -> design metrics
(`diffab_pytorch_tpu/cli/evaluate.py`, its table and its --json report).

    python -m diffab_pytorch_tpu_torch.cli.evaluate --native-patch target.npz \\
        --designs designs --json report.json [--device cpu]

Per design: amino-acid recovery over the designed CDR positions, C-alpha
RMSD in the native frame (the design PDBs are written in the native pose),
the context-aligned RMSD (a Kabsch fit on the fixed residues) and the
backbone's validity.  Across designs: means and spreads, pairwise sequence
diversity and, when `scores.json` from `cli.sample --rank` is found, how
well the model's ranking tracked the RMSD.  The metrics run on the card
unless --device names another.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.constants import ATOM, CDR_NAMES
from diffab_pytorch_tpu_torch.data.dataset import generation_mask_from_cdr
from diffab_pytorch_tpu_torch.evaluation.metrics import (
    aligned_ca_rmsd,
    amino_acid_recovery,
    backbone_validity,
    ca_rmsd,
    sequence_diversity,
    spearman_corr,
)
from diffab_pytorch_tpu_torch.structure.patch import load_patch
from diffab_pytorch_tpu_torch.structure.pdb import parse_pdb_file


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--native-patch", required=True,
                   help="Preprocessed .npz patch of the native complex (the cli.sample "
                        "input)")
    p.add_argument("--designs", required=True,
                   help="Directory of design_*.pdb files (cli.sample output) or a glob "
                        "pattern")
    p.add_argument("--cdrs", nargs="+", default=["H3"],
                   help="CDRs that were designed (must match cli.sample)")
    p.add_argument("--json", default=None, help="Also write metrics JSON here")
    p.add_argument("--scores", default=None,
                   help="scores.json written by `cli.sample --rank` (default: next to "
                        "the designs, if there)")
    p.add_argument("--device", default=None,
                   help="Device to run on (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    return p.parse_args(argv)


def _design_arrays(path: str, n_expected: int):
    """A design PDB back as patch-ordered arrays: cli.sample writes the
    valid patch rows in order, so file order is patch order."""
    chains = parse_pdb_file(path)
    seq, xyz, amask, resnums = [], [], [], []
    for residues in chains.values():
        for r in residues:
            seq.append(r.aa_index)
            xyz.append(r.xyz)
            amask.append(r.atom_mask)
            resnums.append(r.resseq)
    if len(seq) != n_expected:
        raise ValueError(f"{path}: {len(seq)} residues, native patch has {n_expected}")
    return (np.array(seq), np.array(xyz, np.float32), np.array(amask, bool),
            np.array(resnums))


def main(argv=None) -> int:
    args = parse_args(argv)
    bad = set(args.cdrs) - set(CDR_NAMES)
    if bad:
        print(f"unknown CDRs {sorted(bad)}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    native = load_patch(args.native_patch)
    res_mask = native["residue_mask"].astype(bool)
    gen_full = generation_mask_from_cdr(native["cdr_idx"], args.cdrs) & res_mask
    # design PDBs hold only the valid rows, in patch order
    gen = gen_full[res_mask]
    ctx = ~gen
    native_seq = native["seq_idx"][res_mask].astype(np.int64)
    native_ca = native["xyz"][res_mask, ATOM.CA, :].astype(np.float32)
    native_resnums = native["residue_number"][res_mask]
    n_rows = int(res_mask.sum())
    chain_idx = native["chain_idx"][res_mask].astype(np.int64)
    residue_idx = native["residue_idx"][res_mask].astype(np.int64)

    pattern = (os.path.join(args.designs, "design_*.pdb") if os.path.isdir(args.designs)
               else args.designs)
    paths = sorted(glob.glob(pattern))
    if not paths:
        print(f"no designs match {pattern}", file=sys.stderr)
        return 1

    parsed = [_design_arrays(path, n_rows) for path in paths]
    for path, (_, _, _, resnums) in zip(paths, parsed):
        if not np.array_equal(resnums, native_resnums):
            raise ValueError(f"{path}: residue numbering differs from the native patch")
    # every metric runs once on the (n, L) stack of the designs
    n = len(paths)
    on = lambda a: torch.as_tensor(np.asarray(a), device=device)
    fan = lambda a: on(a)[None].expand(n, *np.shape(a))
    seqs = np.stack([p[0] for p in parsed])
    xyz = on(np.stack([p[1] for p in parsed]))
    amask = np.stack([p[2] for p in parsed])
    ca = xyz[:, :, ATOM.CA, :]
    # rows missing backbone N or C (possible in the native context)
    # drop out of the edge set rather than count as violations
    has_bb = amask[..., ATOM.N] & amask[..., ATOM.CA] & amask[..., ATOM.C]
    val = backbone_validity(xyz[:, :, ATOM.N, :], ca, xyz[:, :, ATOM.C, :], on(has_bb),
                            fan(chain_idx), fan(residue_idx), fan(gen))
    per_design = {
        "aar": amino_acid_recovery(on(seqs), fan(native_seq), fan(gen)),
        "ca_rmsd": ca_rmsd(ca, fan(native_ca), fan(gen)),
        "ca_rmsd_aligned": aligned_ca_rmsd(ca, fan(native_ca), fan(gen), fan(ctx)),
        **val,
    }
    per_design = {k: v.cpu().tolist() for k, v in per_design.items()}
    rows = [{
        "design": os.path.basename(path),
        "aar": per_design["aar"][i],
        "ca_rmsd": per_design["ca_rmsd"][i],
        "ca_rmsd_aligned": per_design["ca_rmsd_aligned"][i],
        "bond_viol": per_design["bond_viol"][i],
        "bond_max_dev": per_design["bond_max_dev"][i],
        "ca_break": per_design["ca_break"][i],
        "clash_count": per_design["clash_count"][i],
        "valid": per_design["valid"][i],
    } for i, path in enumerate(paths)]

    diversity = float(sequence_diversity(on(seqs), on(gen))) if n > 1 else 0.0

    scores_path = args.scores
    if scores_path is None and os.path.isdir(args.designs):
        cand = os.path.join(args.designs, "scores.json")
        scores_path = cand if os.path.exists(cand) else None
    rank_agg = {}
    if scores_path:
        with open(scores_path) as fh:
            score_map = json.load(fh)
        matched = [m for m in rows if os.path.splitext(m["design"])[0] in score_map]
        for m in matched:
            m["model_score"] = float(score_map[os.path.splitext(m["design"])[0]]["score"])
        if len(matched) > 1:
            sc = np.array([m["model_score"] for m in matched])
            rm = np.array([m["ca_rmsd"] for m in matched])
            rank_agg = {
                "rank_spearman": float(spearman_corr(
                    torch.as_tensor(sc, dtype=torch.float32, device=device),
                    torch.as_tensor(rm, dtype=torch.float32, device=device))),
                "ca_rmsd_top1_by_score": float(rm[sc.argmin()]),
                "ca_rmsd_best_of_n": float(rm.min()),
                "aar_top1_by_score": float(matched[int(sc.argmin())]["aar"]),
            }

    print(f"{'design':<20s} {'AAR':>6s} {'RMSD(A)':>8s} {'alnRMSD':>8s} {'valid':>6s}")
    for m in rows:
        flag = "ok" if m["valid"] else f"b{m['bond_viol']}/c{m['ca_break']}/x{m['clash_count']}"
        print(f"{m['design']:<20s} {m['aar']:>6.3f} "
              f"{m['ca_rmsd']:>8.3f} {m['ca_rmsd_aligned']:>8.3f} {flag:>6s}")
    agg = {
        "n_designs": len(rows),
        "cdrs": args.cdrs,
        "aar_mean": float(np.mean([m["aar"] for m in rows])),
        "aar_std": float(np.std([m["aar"] for m in rows])),
        "ca_rmsd_mean": float(np.mean([m["ca_rmsd"] for m in rows])),
        "ca_rmsd_std": float(np.std([m["ca_rmsd"] for m in rows])),
        "ca_rmsd_aligned_mean": float(np.mean([m["ca_rmsd_aligned"] for m in rows])),
        "diversity": diversity,
        "valid_rate": float(np.mean([m["valid"] for m in rows])),
        "bond_viol_rate": float(np.mean([m["bond_viol"] > 0 for m in rows])),
        "clash_rate": float(np.mean([m["clash_count"] > 0 for m in rows])),
        **rank_agg,
    }
    print(f"{'mean':<20s} {agg['aar_mean']:>6.3f} {agg['ca_rmsd_mean']:>8.3f} "
          f"{agg['ca_rmsd_aligned_mean']:>8.3f}   diversity={diversity:.3f} "
          f"valid={agg['valid_rate']:.2f}")
    if rank_agg:
        print(f"[evaluate] ranking: rho={rank_agg['rank_spearman']:+.2f}  "
              f"top1-by-score {rank_agg['ca_rmsd_top1_by_score']:.3f} A "
              f"vs oracle best-of-n {rank_agg['ca_rmsd_best_of_n']:.3f} A")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"designs": rows, "aggregate": agg}, fh, indent=2)
        print(f"[evaluate] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
