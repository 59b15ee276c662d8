#!/usr/bin/env python3
"""Convert a training run of the JAX package (an orbax checkpoint) into the
PyTorch port's checkpoint format, so that the port samples it on the card.

    python scripts/jax_checkpoint_to_torch.py --jax-dir RUN --out DIR [--step N] \
        [the cli.train flags the run was trained with]

RUN is the JAX `cli.train --checkpoint-dir`.  The script rebuilds the JAX
TrainState template from the same flags as JAX's `cli.train` (its
optimizer chain decides the structure of the Adam state) and the run's
model_config.json, restores the latest step (or --step) with JAX's
`restore_checkpoint` on the host CPU, converts the parameters, the Adam
count and moments and, when the checkpoint has them, the EMA weights
(`weights.params_from_jax`, `weights.opt_state_from_jax`), and writes DIR
with the port's `save_checkpoint` and `save_model_config`.  Then:

    python -m diffab_pytorch_tpu_torch.cli.sample --checkpoint-dir DIR --patch P.npz ...

It refuses, naming the field, when the flags give another architecture
than the run recorded, or when the run's ModelConfig sets a field that
the port's ModelConfig does not have to a value other than its default.

This is the one file that imports both packages (JAX, orbax and the port);
the port itself never imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog="Every other flag is JAX cli.train's.")
    p.add_argument("--jax-dir", required=True, help="the JAX run's checkpoint directory")
    p.add_argument("--out", required=True, help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="the step to convert (default latest)")
    args, rest = p.parse_known_args(argv)
    from diffab_pytorch_tpu.cli import train as jax_train

    # cli.train's parser asks for --data-dir; the conversion reads no data
    return args, jax_train.parse_args(["--data-dir", "-", *rest])


def model_config(train_args, jax_dir: str):
    """(the JAX DiffAbConfig, the port's ModelConfig) of the run: the flags'
    config with the run's recorded ModelConfig where there is one, after
    two checks that raise ValueError naming the field: the flags give the
    recorded architecture in every field the port has, and no field the
    port lacks differs from its default."""
    from diffab_pytorch_tpu.cli import train as jax_train
    from diffab_pytorch_tpu.config import ModelConfig as JaxModelConfig
    from diffab_pytorch_tpu.train import checkpoint as jax_ckpt
    from diffab_pytorch_tpu_torch.config import ModelConfig

    cfg = jax_train.build_config(train_args, horizon=train_args.max_steps or train_args.epochs)
    # the fields both configs have; the port's own (the official network's
    # options) keep their defaults, the bare network the JAX package runs
    jax_fields = {f.name for f in dataclasses.fields(JaxModelConfig)}
    ported = [f.name for f in dataclasses.fields(ModelConfig) if f.name in jax_fields]
    recorded = jax_ckpt.load_model_config(jax_dir)
    if recorded is not None:
        differ = [(k, getattr(cfg.model, k), getattr(recorded, k)) for k in ported
                  if getattr(cfg.model, k) != getattr(recorded, k)]
        if differ:
            raise ValueError("the flags disagree with the run's recorded architecture: " + "; ".join(
                f"{k}: flags give {a!r}, the run recorded {b!r}" for k, a, b in differ))
        cfg = dataclasses.replace(cfg, model=recorded)
    for f in dataclasses.fields(JaxModelConfig):
        if f.name not in ported and getattr(cfg.model, f.name) != f.default:
            raise ValueError(f"ModelConfig.{f.name} = {getattr(cfg.model, f.name)!r} (default "
                             f"{f.default!r}) has no counterpart in the port's ModelConfig")
    return cfg, ModelConfig(**{k: getattr(cfg.model, k) for k in ported})


def convert(jax_dir: str, out: str, train_args, step: int | None = None) -> int:
    """Write the port's checkpoint of the run's step (default latest) into
    `out`; returns the step."""
    import jax

    jax.config.update("jax_platforms", "cpu")  # the restore is host work
    from diffab_pytorch_tpu.data.batch import synthetic_batch
    from diffab_pytorch_tpu.train import checkpoint as jax_ckpt
    from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import TrainState
    from diffab_pytorch_tpu_torch.weights import opt_state_from_jax, params_from_jax

    cfg, port_model = model_config(train_args, jax_dir)
    step = jax_ckpt.latest_step(jax_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {jax_dir}")
    harness = JaxDiffAb(cfg)
    # the template's values are overwritten; its structure is the run's
    template = harness.init(jax.random.key(0),
                            synthetic_batch(jax.random.key(0), 1, 16, cfg.model.n_atoms))
    has_ema = jax_ckpt._checkpoint_has_ema(jax_dir, step)
    if not has_ema:
        template = template.replace(ema_params=None)
    elif template.ema_params is None:
        template = template.replace(ema_params=template.params)
    try:
        state = jax.device_get(jax_ckpt.restore_checkpoint(jax_dir, template, step))
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"the checkpoint at step {step} does not fit the TrainState the flags "
                         f"build (its optimizer chain comes from cli.train's flags: pass the "
                         f"run's): {e}") from e
    params = params_from_jax(state.params)
    ckpt.save_checkpoint(out, TrainState(
        step=int(state.step),
        params={k: v.requires_grad_(True) for k, v in params.items()},
        opt_state=opt_state_from_jax(state.opt_state),
        ema_params=params_from_jax(state.ema_params) if has_ema else None))
    ckpt.save_model_config(out, port_model)
    return int(state.step)


def main(argv=None) -> int:
    args, train_args = parse_args(argv)
    try:
        step = convert(args.jax_dir, args.out, train_args, args.step)
    except (ValueError, FileNotFoundError) as e:
        print(f"jax_checkpoint_to_torch: {e}", file=sys.stderr)
        return 1
    print(f"converted {args.jax_dir} step {step} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
