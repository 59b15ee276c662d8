"""Training CLI: preprocessed .npz patches -> a checkpoint
(`diffab_pytorch_tpu/cli/train.py`, its flags and files).

    python -m diffab_pytorch_tpu_torch.cli.preprocess --meta meta.csv \\
        --data-dir pdbs --out-dir patches -j 8
    python -m diffab_pytorch_tpu_torch.cli.train --data-dir patches \\
        --production [--device-pool] --checkpoint-dir ckpt
    python -m diffab_pytorch_tpu_torch.cli.sample --checkpoint-dir ckpt ...

A seeded 10% of the patches (--val-pct) is held out for validation at
every epoch end.  --production starts from `production_config()` with its
cosine horizon set to the run's planned steps (--max-steps, else epochs x
steps per epoch); explicit recipe flags still win.  The checkpoint is the
port's format (`train/checkpoint.py`) with model_config.json beside it,
which `cli.sample` reads.  --self-conditioning trains a self-conditioned
model (--sc-geometry-only, --sc-late-fusion, --sc-split-trunk choose the
variant; the --sc-rate, --sc-onset, --sc-rate-warmup,
--sc-seq-loss-weight and --sc-per-residue schedule is read with it).
Training runs on the card unless --device names another.

Data parallelism: --data-parallel splits each batch's rows over the ranks
of `python -m torch.distributed.run` (--standalone --nproc-per-node
<cards> on one node; each rank takes cuda:LOCAL_RANK, NCCL; with --device
cpu, gloo), and only rank 0 validates and writes.  --multihost is the same
code across nodes (torchrun's --nnodes, --rdzv-endpoint); without
--data-parallel every rank trains the whole batch.  Without torchrun's
environment either flag runs as a one-rank group.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch.distributed as dist

from diffab_pytorch_tpu_torch.config import (
    DiffAbConfig,
    TrainConfig,
    default_config,
    official_config,
    production_config,
    resolve_device,
    tiny_config,
)
from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
from diffab_pytorch_tpu_torch.parallel.mesh import init_distributed
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from diffab_pytorch_tpu_torch.train.harness import DiffAb
from diffab_pytorch_tpu_torch.train.trainer import fit
from diffab_pytorch_tpu_torch.utils.logging import MetricLogger, is_primary


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True, help="Directory of preprocessed .npz patches")
    p.add_argument("--cdrs", nargs="+", default=None,
                   help="CDRs to generate (subset of H1 H2 H3 L1 L2 L3; default H3, all "
                        "six under --official)")
    p.add_argument("--val-pct", type=float, default=0.1)
    p.add_argument("--no-cache-data", action="store_true",
                   help="Disable the in-RAM normalized-sample cache (~35 KB/sample)")
    p.add_argument("--device-pool", action="store_true",
                   help="Put the whole dataset on the card once and gather each step's "
                        "rows there (a step moves batch-size indices, not features)")
    p.add_argument("--production", action="store_true",
                   help="Start from production_config(): dist_atoms=4, d_pair 48, bf16, "
                        "lr 6e-4 warmup + cosine over the run, gradient and update "
                        "clipping, EMA, mode dropout.  Explicit recipe flags still win.")
    p.add_argument("--official", action="store_true",
                   help="Start from official_config(): the official DiffAb network (GA "
                        "blocks of 12 heads with point directions and transitions, the "
                        "quaternion rotation head), float32, all six CDRs unless --cdrs")
    p.add_argument("-b", "--bsz", type=int, default=None,
                   help="Batch size (default 16; 32 under --production)")
    p.add_argument("-e", "--epochs", type=int, default=60)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("-l", "--learning-rate", type=float, default=None,
                   help="Peak lr (default 1e-4; 6e-4 under --production)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="Global gradient-norm clip (default 0 = off; 1.0 under --production)")
    p.add_argument("--update-clip-rms", type=float, default=1.0,
                   help="Per-parameter RMS cap on the Adam-normalized update; 0 off")
    p.add_argument("--ema", type=float, default=0.999,
                   help="Parameter-EMA decay; checkpoints then carry EMA weights, which "
                        "cli.sample prefers.  0 off")
    p.add_argument("--seq-ce-weight", type=float, default=1.0,
                   help="Weight of the direct CE on p(s_0); 0 = pure KL")
    p.add_argument("--lr-warmup-steps", type=int, default=None,
                   help="Warmup steps (default 0; min(100, steps/10) under --production)")
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="Cosine-decay horizon including the warmup; 0 = constant lr "
                        "(default; the planned steps under --production)")
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="Tiny model preset")
    p.add_argument("--mode-dropout", type=float, default=None,
                   help="Probability each that a sample is presented as fix-structure / "
                        "fix-sequence (default 0; 0.15 under --production)")
    sc = p.add_argument_group("self-conditioning")
    sc.add_argument("--self-conditioning", action="store_true",
                    help="Train with self-conditioning: the denoiser also reads the previous "
                         "step's clean-state estimate")
    sc.add_argument("--sc-geometry-only", action="store_true",
                    help="The estimate's features exclude the predicted p(s_0)")
    sc.add_argument("--sc-late-fusion", action="store_true",
                    help="The estimate enters after the IPA trunk, geometry heads only")
    sc.add_argument("--sc-split-trunk", action="store_true",
                    help="A second fuse MLP and IPA stack for the geometry heads reads the "
                         "estimate; the sequence head's trunk stays cold")
    sc.add_argument("--sc-rate", type=float, default=0.5,
                    help="Share of each batch trained conditioned")
    sc.add_argument("--sc-onset", type=int, default=0,
                    help="Steps trained fully cold before conditioning starts")
    sc.add_argument("--sc-rate-warmup", type=int, default=0,
                    help="Steps to ramp the rate 0 -> --sc-rate after the onset")
    sc.add_argument("--sc-seq-loss-weight", type=float, default=1.0,
                    help="Weight of the sequence losses (KL + CE) of the conditioned rows")
    sc.add_argument("--sc-per-residue", action="store_true",
                    help="Draw the conditioning mask per residue instead of per sample")
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (parameters float32)")
    p.add_argument("--dist-atoms", type=int, default=-1,
                   help="Atoms entering the pair distance feature (4 = backbone N/CA/C/O). "
                        "Default all atoms, 4 under --production; 0 forces all atoms")
    p.add_argument("--d-pair", type=int, default=None,
                   help="Pair-embedding width (default 64; 48 under --production)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--csv", default=None, help="Metrics CSV path")
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--data-parallel", action="store_true",
                   help="Split each batch over the ranks of torch.distributed.run")
    p.add_argument("--multihost", action="store_true",
                   help="Join the process group torch.distributed.run sets up across nodes")
    p.add_argument("--device", default=None,
                   help="Device to run on (default: the CUDA card; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def build_config(args, horizon: int = 0) -> DiffAbConfig:
    """Resolve the flags into a DiffAbConfig.  Recipe flags default to None
    (-1 for --dist-atoms) so --production can fill them while explicit
    values win; horizon = the planned optimizer steps (the production
    cosine; 0 = unknown)."""
    if args.production and args.official:
        raise SystemExit("--production and --official are two recipes; pick one")
    prod = production_config(steps=max(horizon, 1)) if args.production else None
    cfg = (tiny_config() if args.tiny else prod if prod is not None
           else official_config() if args.official else default_config())

    def pick(user, prod_value, plain_default):
        if user is not None:
            return user
        return prod_value if prod is not None else plain_default

    pt = prod.train if prod is not None else TrainConfig()
    train = TrainConfig(
        batch_size=pick(args.bsz, pt.batch_size, 16),
        epochs=args.epochs,
        lr=pick(args.learning_rate, pt.lr, 1e-4),
        grad_clip_norm=pick(args.grad_clip, pt.grad_clip_norm, 0.0),
        seq_ce_weight=args.seq_ce_weight,
        lr_warmup_steps=pick(args.lr_warmup_steps, pt.lr_warmup_steps, 0),
        lr_decay_steps=pick(args.lr_decay_steps, pt.lr_decay_steps, 0),
        seed=args.seed,
        val_pct=args.val_pct,
        checkpoint_dir=args.checkpoint_dir,
        mode_dropout=pick(args.mode_dropout, pt.mode_dropout, 0.0),
        sc_rate=args.sc_rate,
        sc_onset_steps=args.sc_onset,
        sc_rate_warmup=args.sc_rate_warmup,
        sc_seq_loss_weight=args.sc_seq_loss_weight,
        sc_per_residue=args.sc_per_residue,
        adam_eps=args.adam_eps,
        update_clip_rms=args.update_clip_rms,
        ema_decay=args.ema,
    )
    model = cfg.model
    if args.bf16 or args.production:
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    dist_atoms = args.dist_atoms
    if dist_atoms == -1:  # unset: 4 under --production, else all atoms
        dist_atoms = 4 if args.production else None
    elif dist_atoms == 0:  # all atoms, explicitly
        dist_atoms = None
    model = dataclasses.replace(model, dist_atoms=dist_atoms)
    if args.d_pair is not None:
        model = dataclasses.replace(model, d_pair_emb=args.d_pair)
    if args.self_conditioning:
        model = dataclasses.replace(
            model, self_conditioning=True, self_conditioning_sequence=not args.sc_geometry_only,
            sc_late_fusion=args.sc_late_fusion, sc_split_trunk=args.sc_split_trunk)
    return dataclasses.replace(cfg, model=model, train=train)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (args.data_parallel or args.multihost):
        return train(args, resolve_device(args.device))
    with init_distributed(args.device) as device:
        if args.multihost:
            print(f"[train] multihost: rank {dist.get_rank()} of {dist.get_world_size()}")
        group = dist.group.WORLD if args.data_parallel else None
        return train(args, device, group)


def train(args, device, dp_group=None) -> int:
    if args.cdrs is None:
        args.cdrs = list(official_config().data.cdrs_to_generate) if args.official else ["H3"]
    ds = PatchDataset.from_dir(args.data_dir, cdrs_to_generate=args.cdrs)
    if len(ds) == 0:
        print(f"no .npz patches under {args.data_dir}")
        return 1
    order = np.random.default_rng(args.seed).permutation(len(ds.paths))
    n_val = int(len(order) * args.val_pct)
    val_paths = [ds.paths[i] for i in order[:n_val]]
    train_paths = [ds.paths[i] for i in order[n_val:]]

    # the planned optimizer steps: the production cosine's horizon
    bsz = args.bsz or (32 if args.production else 16)
    steps_per_epoch = max(len(train_paths) // max(bsz, 1), 1)
    horizon = args.max_steps or args.epochs * steps_per_epoch
    cfg = build_config(args, horizon=horizon)
    train_ds = PatchDataset(train_paths, cdrs_to_generate=args.cdrs,
                            cache=not args.no_cache_data)
    val_ds = PatchDataset(val_paths, cdrs_to_generate=args.cdrs) if n_val else None

    harness = DiffAb(cfg, device=device)
    if is_primary():
        ckpt_lib.save_model_config(args.checkpoint_dir, cfg.model)
    logger = MetricLogger(csv_path=args.csv, use_wandb=args.wandb,
                          config=dataclasses.asdict(cfg), print_every=cfg.train.log_every)
    print(f"[train] {len(train_paths)} training and {n_val} validation patches, batch "
          f"{cfg.train.batch_size}, on {device}"
          + (" (device pool)" if args.device_pool else "")
          + (f" (data-parallel over {dist.get_world_size(dp_group)} ranks)"
             if dp_group is not None else ""))
    try:
        fit(harness, train_ds, val_ds, epochs=args.epochs, max_steps=args.max_steps,
            logger=logger, checkpoint_dir=args.checkpoint_dir, resume=not args.no_resume,
            device_pool=args.device_pool, dp_group=dp_group)
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
