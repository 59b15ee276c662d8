"""Metric logging to stdout and CSV (`diffab_pytorch_tpu/utils/logging.py`).

Same metric names and line format as the JAX package's MetricLogger.
Under `torch.distributed` only rank 0 writes.  wandb is used only when it
is importable and asked for.
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, Optional

import torch


def is_primary() -> bool:
    """True on the process that writes files: rank 0 of the default group,
    or a process with no group."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    def __init__(
        self,
        csv_path: Optional[str] = None,
        use_wandb: bool = False,
        wandb_project: str = "diffab-pytorch-tpu",
        config: Optional[dict] = None,
        print_every: int = 1,
        file=None,
    ):
        self.csv_path = csv_path
        self._csv_file = None
        self._csv_writer = None
        self.print_every = print_every
        self._file = sys.stdout if file is None else file
        self._t0 = time.time()
        self._wandb = None
        self._primary = is_primary()
        if use_wandb and self._primary:
            try:
                import wandb  # type: ignore
            except ImportError as e:
                print(f"[logging] wandb unavailable ({e}); continuing without", file=self._file)
            else:
                self._wandb = wandb
                wandb.init(project=wandb_project, config=config or {})

    def log(self, step: int, metrics: Dict[str, torch.Tensor | float]) -> None:
        """Write one step's scalars; tensors are read (a sync with the card)."""
        if not self._primary:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        if self.csv_path:
            if self._csv_writer is None:
                os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
                self._csv_file = open(self.csv_path, "a", newline="")
                self._csv_writer = csv.DictWriter(
                    self._csv_file, fieldnames=["step", "wall_time"] + sorted(scalars),
                    extrasaction="ignore")
                if self._csv_file.tell() == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow({"step": step, "wall_time": time.time() - self._t0,
                                       **scalars})
            self._csv_file.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self.print_every and step % self.print_every == 0:
            msg = "  ".join(f"{k}={v:.4f}" for k, v in sorted(scalars.items()))
            print(f"[step {step}] {msg}", file=self._file, flush=True)

    def close(self):
        if self._csv_file:
            self._csv_file.close()
        if self._wandb is not None:
            self._wandb.finish()
