"""Design CLI: checkpoint + complex -> designed CDRs
(`diffab_pytorch_tpu/cli/sample.py`, its flags and its files).

    python -m diffab_pytorch_tpu_torch.cli.sample --patch target.npz \\
        --checkpoint-dir ckpt -n 64 --rank -o designs [--device cpu]

Input: a preprocessed .npz patch (--patch) or a PDB with chain ids (--pdb,
--heavy-chain-id, ...; featurized inline).  The checkpoint is the port's
format (`train/checkpoint.py`, with its model_config.json).  Output: one
backbone PDB per design (`design_{i:04d}.pdb`: the designed sequence, the
designed backbone rebuilt from its frames in the input's pose, the context
as it was), `designs.fasta`, and with --rank `scores.json`.

Modes: codesign (default), fix-sequence (structure only), fix-structure
(sequence only), --t-restart T' (optimization by renoising from T' < T).
Sampling, scoring and the loop relaxation run on the card unless --device
names another; the rest of the post-processing is host numpy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from diffab_pytorch_tpu_torch.config import default_config, resolve_device, tiny_config
from diffab_pytorch_tpu_torch.constants import AA_THREE, THREE_TO_ONE
from diffab_pytorch_tpu_torch.data.dataset import COORD_SCALE, assemble_batch
from diffab_pytorch_tpu_torch.structure import antibody
from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, load_patch
from diffab_pytorch_tpu_torch.structure.pdb import write_pdb
from diffab_pytorch_tpu_torch.structure.reconstruct import (
    idealize_peptide_bonds,
    reconstruct_backbone,
)
from diffab_pytorch_tpu_torch.structure.relax import relax_ca
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from diffab_pytorch_tpu_torch.train.harness import DiffAb

CHAIN_LETTERS = ["?", "H", "L"] + [chr(ord("A") + i) for i in range(7)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_argument_group("input")
    src.add_argument("--patch", help="Preprocessed .npz patch")
    src.add_argument("--pdb", help="Raw PDB (preprocessed inline)")
    src.add_argument("--heavy-chain-id", default=None)
    src.add_argument("--light-chain-id", default=None)
    src.add_argument("-a", "--antigen-chain-ids", default=None)

    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--cdrs", nargs="+", default=["H3"])
    p.add_argument("-n", "--n-samples", type=int, default=8)
    p.add_argument("--mode", choices=["codesign", "fix-sequence", "fix-structure"],
                   default="codesign")
    p.add_argument("--t-restart", type=int, default=None,
                   help="Optimization: renoise to this timestep (< T)")
    p.add_argument("--n-steps", type=int, default=None,
                   help="Few-step sampling: length of the strided reverse chain")
    p.add_argument("--noise-scale", type=float, default=1.0,
                   help="Posterior-noise std multiplier of the coordinate reverse chain "
                        "(1.0 exact DDPM, 0 the deterministic posterior-mean chain)")
    p.add_argument("--orientation-reverse", choices=["renoise", "posterior"],
                   default="renoise", help="Frame reverse kernel")
    p.add_argument("--noise-t-max", type=int, default=None,
                   help="Coordinate posterior noise only at t <= this.  Default: T//2 "
                        "for full-length stochastic chains, off for few-step chains and "
                        "noise-scale 0; 0 forces it off")
    p.add_argument("--init", choices=["prior", "chord"], default="prior",
                   help="Start designed coordinates from the prior or from the "
                        "forward-noised anchor-anchor chord")
    p.add_argument("--chord-orientations", action="store_true",
                   help="With --init chord: frames also start from the anchors' "
                        "geodesic interpolation")
    p.add_argument("--coord-solver", choices=["none", "ab2", "heun"], default="none",
                   help="Higher-order coordinate solver for few-step chains")
    p.add_argument("--coord-solver-t-min", type=int, default=0,
                   help="Apply the solver correction only at t above this")
    p.add_argument("--step-schedule", choices=["uniform", "hight"], default="uniform",
                   help="Few-step t-subsequence: uniform, or dense at high t")
    p.add_argument("--n-fine-tail", type=int, default=None,
                   help="Few-step chains: the final k timesteps at stride 1")
    p.add_argument("--x0-clip", default="auto",
                   help="Clip of the implied clean coordinates each step: 'auto' (from "
                        "the context extent), a float (normalized units) or 'none'")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("-o", "--out-dir", default="designs")
    p.add_argument("--no-idealize", action="store_true",
                   help="Skip the peptide-bond idealization of designed edges")
    p.add_argument("--no-relax", action="store_true",
                   help="Skip the designed-CA relaxation (loop closure)")
    p.add_argument("--data-parallel", action="store_true",
                   help="Fan designs out over all local devices (not ported)")
    p.add_argument("--multihost", action="store_true",
                   help="Multi-host run (not ported)")
    p.add_argument("--rank", action="store_true",
                   help="Score every design with the model-based likelihood ranking; "
                        "outputs stay in design order with score and rank (0 = best) "
                        "on each FASTA header and scores.json entry")
    p.add_argument("--device", default=None,
                   help="Device to run on (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    return p.parse_args(argv)


def resolve_noise_t_max(noise_t_max, *, T, n_steps, noise_scale):
    """--noise-t-max: None (auto) gives T//2 to full-length stochastic
    chains and None to few-step or noiseless ones; 0 or less forces it
    off; a positive value passes through."""
    if noise_t_max is None:
        if n_steps is None and noise_scale > 0:
            return T // 2
        return None
    if noise_t_max <= 0:
        return None
    return noise_t_max


def write_scores(out_dir: str, scores) -> tuple[np.ndarray, np.ndarray]:
    """scores.json for the designs' DesignScores; returns (score, rank) by
    design, rank 0 = the lowest score (a stable sort: ties in design
    order)."""
    host = {k: getattr(scores, k).detach().cpu().numpy()
            for k in ("score", "seq_score", "translations_score", "orientations_score")}
    order = np.argsort(host["score"], kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(order))
    with open(os.path.join(out_dir, "scores.json"), "w") as f:
        json.dump({f"design_{i:04d}": {**{k: float(v[i]) for k, v in host.items()},
                                       "rank": int(ranks[i])}
                   for i in range(len(order))}, f, indent=2)
    return host["score"], ranks


def write_designs(out_dir: str, result, batch, norm, sample_dict, cdrs, *,
                  relax: bool = True, idealize: bool = True, scores=None, ranks=None) -> None:
    """The designs of one target to `out_dir`: relax the designed CAs (on
    the batch's device, in model units), invert the pose normalization of
    coordinates and frames, rebuild the designed backbone from its frames
    (context residues keep their atoms), idealize the designed peptide
    bonds, write `design_{i:04d}.pdb` and `designs.fasta`.  result: the
    sampler's (n, L) rows of batch's one target."""
    n = result.seq_idx.shape[0]
    translations = result.translations
    if relax:
        rep = lambda a: torch.repeat_interleave(a, n, dim=0)
        translations = relax_ca(translations, rep(batch.residue_mask), rep(batch.chain_idx),
                                rep(batch.residue_idx), rep(batch.generation_mask),
                                coord_scale=COORD_SCALE)
    seqs = result.seq_idx.cpu().numpy()
    fan_norm = dataclasses.replace(
        norm, center=np.repeat(norm.center, n, axis=0), rot=np.repeat(norm.rot, n, axis=0))
    xyz_ca = fan_norm.denormalize(translations.cpu().numpy())
    ori = fan_norm.denormalize_orientations(result.orientations.cpu().numpy())
    mask = batch.residue_mask[0].cpu().numpy()
    gen = batch.generation_mask[0].cpu().numpy()
    chain_idx = batch.chain_idx[0].cpu().numpy()
    orig_xyz = np.asarray(sample_dict["xyz"], np.float32)
    orig_mask = np.asarray(sample_dict["atom_mask"], bool)
    icodes = sample_dict.get("icode")

    fasta_lines = []
    for i in range(n):
        xyz, am = reconstruct_backbone(ori[i], xyz_ca[i])
        xyz = np.where(gen[:, None, None], xyz, orig_xyz)
        am = np.where(gen[:, None], am, orig_mask)
        if idealize:
            xyz = idealize_peptide_bonds(xyz, am, np.asarray(sample_dict["chain_idx"]),
                                         np.asarray(sample_dict["residue_idx"]), edge_mask=gen)
        write_pdb(
            os.path.join(out_dir, f"design_{i:04d}.pdb"),
            xyz[mask], am[mask], seqs[i][mask],
            [CHAIN_LETTERS[c] for c in chain_idx[mask]],
            np.asarray(sample_dict["residue_number"])[mask],
            icodes=None if icodes is None else np.asarray(icodes)[mask],
        )
        cdr_seq = "".join(THREE_TO_ONE.get(AA_THREE[s], "X") if s < 20 else "X"
                          for s in seqs[i][gen])
        header = f">design_{i:04d} cdrs={'+'.join(cdrs)}"
        if scores is not None:
            header += f" score={scores[i]:.4f} rank={int(ranks[i])}"
        fasta_lines += [header, cdr_seq]
        print(f"design {i:04d}: {cdr_seq}"
              + (f" score={scores[i]:.4f}" if scores is not None else ""))
    with open(os.path.join(out_dir, "designs.fasta"), "w") as f:
        f.write("\n".join(fasta_lines) + "\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.data_parallel or args.multihost:
        raise NotImplementedError(
            "--data-parallel and --multihost are not ported yet (ROADMAP A14, parallelism)")
    device = resolve_device(args.device)

    if args.patch:
        sample_dict = load_patch(args.patch)
    elif args.pdb:
        complex_ = antibody.from_pdb(
            args.pdb, heavy_chain_id=args.heavy_chain_id,
            light_chain_id=args.light_chain_id,
            antigen_chain_ids=list(args.antigen_chain_ids or ""), keep_fv_only=True)
        sample_dict = featurize_patch(complex_)
    else:
        print("need --patch or --pdb")
        return 2

    batch, norm = assemble_batch([sample_dict], cdrs_to_generate=args.cdrs, device=device)
    cfg = tiny_config() if args.tiny else default_config()
    saved_model = ckpt_lib.load_model_config(args.checkpoint_dir)
    if saved_model is not None:
        # the recorded architecture: a self-conditioned checkpoint has a
        # wider fuse layer or a second trunk
        cfg = dataclasses.replace(cfg, model=saved_model)
        print("[sample] using the checkpoint's recorded model config"
              + (" (self-conditioning)" if saved_model.self_conditioning else ""))
    harness = DiffAb(cfg, device=device)
    params, step = ckpt_lib.restore_params(args.checkpoint_dir)
    print(f"[sample] restored checkpoint at step {step}")

    noise_t_max = resolve_noise_t_max(args.noise_t_max, T=cfg.diffusion.T,
                                      n_steps=args.n_steps, noise_scale=args.noise_scale)
    if noise_t_max is not None and args.noise_t_max is None:
        print(f"[sample] deferred-noise recipe on: noise_t_max={noise_t_max} "
              f"(pass --noise-t-max 0 to disable)")
    modes = dict(generate_structure=args.mode != "fix-structure",
                 generate_sequence=args.mode != "fix-sequence")
    x0_clip = (None if str(args.x0_clip).lower() in ("none", "0")
               else "auto" if args.x0_clip == "auto" else float(args.x0_clip))
    result = harness.sample(
        params, batch, generator=torch.Generator(device=device).manual_seed(args.seed),
        n_designs=args.n_samples, t_start=args.t_restart, init=args.init,
        chord_orientations=args.chord_orientations, n_steps=args.n_steps,
        noise_scale=args.noise_scale, noise_t_max=noise_t_max,
        step_schedule=args.step_schedule, n_fine_tail=args.n_fine_tail,
        coord_solver=args.coord_solver, coord_solver_t_min=args.coord_solver_t_min,
        orientation_reverse=args.orientation_reverse, x0_clip=x0_clip, **modes)

    os.makedirs(args.out_dir, exist_ok=True)
    scores = ranks = None
    if args.rank:
        # the sampler's raw output is scored, before relax and
        # idealization touch it: the model's likelihood of what it made
        sc = harness.score_designs(
            None, batch, result,
            generator=torch.Generator(device=device).manual_seed(args.seed + 1), **modes)
        scores, ranks = write_scores(args.out_dir, sc)
        best = int(np.argmin(ranks))
        print(f"[sample] best design by model score: design_{best:04d} "
              f"(score {scores[best]:.4f})")
    write_designs(args.out_dir, result, batch, norm, sample_dict, args.cdrs,
                  relax=not args.no_relax and args.mode != "fix-structure",
                  idealize=not args.no_idealize, scores=scores, ranks=ranks)
    print(f"[sample] wrote {args.n_samples} designs to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
