"""Checkpoints of the training state (`diffab_pytorch_tpu/train/checkpoint.py`),
in a torch-native format.

Layout: `<directory>/<step>/state.pt` holds the whole TrainState (step,
parameters, Adam count and moments, EMA) as tensors written by
`torch.save` and read back with `weights_only=True`; `model_config.json`
beside the step directories records the architecture, so inference entry
points rebuild the same parameter shapes.  The newest `max_to_keep`
checkpoints are kept.  The diffusion schedule and IGSO(3) tables are not
saved: they are rebuilt deterministically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import torch

from diffab_pytorch_tpu_torch.config import ModelConfig, resolve_device
from diffab_pytorch_tpu_torch.train.harness import OptState, TrainState

_MODEL_CONFIG_FILE = "model_config.json"
_STATE_FILE = "state.pt"


def save_model_config(directory: str, model_cfg: ModelConfig) -> None:
    """Record the architecture next to the weights."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _MODEL_CONFIG_FILE), "w") as fh:
        json.dump(dataclasses.asdict(model_cfg), fh, indent=2)


def load_model_config(directory: str) -> Optional[ModelConfig]:
    """The ModelConfig recorded by `save_model_config`, or None when there
    is none.  Keys this ModelConfig does not have are ignored."""
    path = os.path.join(directory, _MODEL_CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        raw = json.load(fh)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in raw.items() if k in fields})


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.exists(os.path.join(directory, n, _STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state: TrainState, max_to_keep: int = 3) -> int:
    """Write the state at its step (atomically: a temporary file, then a
    rename), then drop all but the newest `max_to_keep` checkpoints."""
    step = int(state.step)
    cpu = lambda d: None if d is None else {k: v.detach().cpu() for k, v in d.items()}
    blob = {
        "step": step,
        "params": cpu(state.params),
        "opt_count": int(state.opt_state.count),
        "mu": cpu(state.opt_state.mu),
        "nu": cpu(state.opt_state.nu),
        "ema_params": cpu(state.ema_params),
    }
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(step_dir, _STATE_FILE))
    for old in all_steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return step


def prune_after(directory: str, step: int) -> None:
    """Delete the checkpoints newer than `step` (the trainer's divergence
    fallback: a periodic checkpoint written after the explosion must not
    outrank the good snapshot)."""
    for s in all_steps(directory):
        if s > step:
            shutil.rmtree(os.path.join(directory, str(s)))


def _load(directory: str, step: Optional[int]):
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return torch.load(os.path.join(directory, str(step), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(directory: str, device=None, step: Optional[int] = None) -> TrainState:
    """The whole TrainState of `step` (default the latest) on `device`: the
    card unless the caller names another (`config.resolve_device`)."""
    device = resolve_device(device)
    blob = _load(directory, step)
    on = lambda d: None if d is None else {k: v.to(device) for k, v in d.items()}
    params = {k: v.requires_grad_(True) for k, v in on(blob["params"]).items()}
    return TrainState(step=int(blob["step"]), params=params,
                      opt_state=OptState(int(blob["opt_count"]), on(blob["mu"]), on(blob["nu"])),
                      ema_params=on(blob["ema_params"]))


def restore_params(directory: str, step: Optional[int] = None, prefer_ema: bool = True):
    """(parameters, step) for inference, on the CPU: the EMA weights when
    the checkpoint has them and `prefer_ema`, else the raw parameters.
    Load them with `model.load_state_dict(params)`."""
    blob = _load(directory, step)
    params = blob["ema_params"] if prefer_ema and blob["ema_params"] is not None else blob["params"]
    return params, int(blob["step"])
