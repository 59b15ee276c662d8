"""The training loop (`diffab_pytorch_tpu/train/trainer.py`): batches ->
train steps -> metrics -> checkpoints, with periodic validation and the
divergence guard.

`fit` takes any iterable of ProteinBatch: a list is replayed for `epochs`
epochs, a one-shot iterator runs once.  Each step's random numbers come
from a generator on the harness's device seeded with (seed, step), so a
resumed run draws what the uninterrupted one would have.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from diffab_pytorch_tpu_torch.train.harness import DiffAb, OptState, TrainState
from diffab_pytorch_tpu_torch.utils.logging import MetricLogger


def _copy_state(state: TrainState) -> TrainState:
    """A detached copy of `state` on its device (the guard's snapshots: a
    few copies of the parameters and moments, and no wait for the card)."""
    on = lambda d: None if d is None else {k: v.detach().clone() for k, v in d.items()}
    params = {k: v.requires_grad_(True) for k, v in on(state.params).items()}
    opt = OptState(state.opt_state.count, on(state.opt_state.mu), on(state.opt_state.nu))
    return TrainState(state.step, params, opt, on(state.ema_params))


def _step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    return generator.manual_seed(seed * 1_000_003 + step)


def fit(
    harness: DiffAb,
    train_batches: Iterable[ProteinBatch],
    val_batches: Optional[Iterable[ProteinBatch]] = None,
    *,
    epochs: Optional[int] = None,
    max_steps: Optional[int] = None,
    seed: Optional[int] = None,
    logger: Optional[MetricLogger] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    state: Optional[TrainState] = None,
) -> TrainState:
    """Train and return the final TrainState.  `state` continues a run in
    memory; otherwise the state is initialized from `seed` (default
    TrainConfig.seed) or, with `resume`, restored from `checkpoint_dir`.
    Validation over `val_batches` runs at every epoch boundary (when the
    training iterable has a length)."""
    cfg = harness.config.train
    dev = harness.device
    seed = cfg.seed if seed is None else seed
    epochs = cfg.epochs if epochs is None else epochs
    logger = logger or MetricLogger(print_every=cfg.log_every)
    gen = torch.Generator(device=dev)

    if state is None:
        state = harness.init(seed)
        if checkpoint_dir and resume and ckpt_lib.latest_step(checkpoint_dir) is not None:
            state = ckpt_lib.restore_checkpoint(checkpoint_dir, dev)
            print(f"[trainer] resumed from step {state.step}")
    if checkpoint_dir:
        ckpt_lib.save_model_config(checkpoint_dir, harness.config.model)
    steps_per_epoch = max(1, len(train_batches)) if hasattr(train_batches, "__len__") else None

    # Divergence guard, read at logging points only (each read waits for
    # the card).  A loss is "good" while within 3x of the best seen (+1).
    # The logged loss is computed on the pre-update parameters, so a
    # snapshot taken at step N stays pending until the next logging
    # window's loss (which includes update N) also passes.
    state_good, step_good = _copy_state(state), state.step
    best_loss, last_ok_step = float("inf"), step_good
    pending = None
    near_best = lambda v: np.isfinite(v) and v <= 3.0 * best_loss + 1.0
    t_last = time.time()

    def run_eval(params):
        if val_batches is None:
            return
        ms = []
        for i, vb in enumerate(val_batches):
            vb = vb.to(dev)
            ms.append(harness.eval_step(
                params, vb, harness.draw(vb, _step_generator(gen, seed + 1 + i, state.step))))
        if ms:
            logger.log(state.step, {k: float(np.mean([float(m[k]) for m in ms]))
                                    for k in ms[0]})

    done = False
    for _ in range(epochs):
        for batch in train_batches:
            if max_steps is not None and state.step >= max_steps:
                done = True
                break
            batch = batch.to(dev)
            draws = harness.draw(batch, _step_generator(gen, seed, state.step))
            state, metrics = harness.train_step(state, batch, draws)
            step = state.step
            if step % cfg.log_every == 0:
                now = time.time()
                metrics = dict(metrics, steps_per_sec=cfg.log_every / max(now - t_last, 1e-9))
                t_last = now
                logger.log(step, metrics)
                loss = float(metrics["train/loss"])
                if near_best(loss):
                    best_loss = min(best_loss, loss)
                    last_ok_step = step
                    if pending is not None:
                        state_good, step_good = pending
                    pending = (_copy_state(state), step)
                else:
                    pending = None
            if checkpoint_dir and step % cfg.checkpoint_every == 0:
                if last_ok_step >= step - cfg.log_every:
                    ckpt_lib.save_checkpoint(checkpoint_dir, state)
                else:
                    print(f"[trainer] step {step}: loss diverged from best "
                          f"{best_loss:.4g}; not overwriting the checkpoint")
            if steps_per_epoch and step % steps_per_epoch == 0:
                run_eval(state.params)
        if done:
            break

    if state.step > last_ok_step + cfg.log_every:
        print(f"[trainer] final state diverged (best {best_loss:.4g}, validated "
              f"snapshot at step {step_good}); falling back")
        state = state_good
        if checkpoint_dir:
            ckpt_lib.prune_after(checkpoint_dir, step_good)
    if checkpoint_dir:
        ckpt_lib.save_checkpoint(checkpoint_dir, state)
    return state
