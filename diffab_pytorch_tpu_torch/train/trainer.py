"""The training loop (`diffab_pytorch_tpu/train/trainer.py`): data ->
train steps -> metrics -> checkpoints, with validation at epoch ends and
the divergence guard.

`fit` takes a `PatchDataset`, as the JAX `fit` does: its shuffled host
batches go through `PrefetchLoader` to the card, or, with
device_pool=True, the whole dataset is put on the card once and each step
gathers its rows there (`DiffAb.make_pool_train_step`).  It also takes any
iterable of ProteinBatch: a list is replayed for `epochs` epochs, a
one-shot iterator runs once.  Every input goes through one loop body.
Each step's random numbers come from a generator on the harness's device
seeded with (seed, step), so the loader path, the pool path and a resumed
run draw the same numbers at the same step.  On a CUDA device the single-device
steps (train, pool and validation) replay captured graphs
(`DiffAb.make_train_step`, `make_pool_train_step`, `make_eval_step`); each
batch is copied into the step's static inputs.  Each step trains at its
state's step, which the self-conditioning schedule reads; validation runs
at the schedule's full rate.

Data parallelism (`dp_group`, the counterpart of the JAX fit's
`sharding`): every rank reads the same global batches and keeps its rows
(`parallel.mesh.batch_sharding`; the loader pins and copies only those),
draws them from its rank's stream (`parallel.dp.rank_seed` of the step's
seed: rank 0 draws the single-device numbers) and trains with
`make_dp_train_step`.  Only rank 0 validates, on the global batches (the
single-device numbers), and writes checkpoints, model_config.json and
logs; every rank restores the same checkpoint on resume.

Tensor parallelism (`mesh`, a `parallel.mesh.Mesh`): rows and rank streams
over `mesh.dp_group` as above (every tp rank of a dp row trains on the
same rows with the same draws), the state sharded over tp
(`parallel.tp.shard_state`; restored sharded on resume), the step
`make_sharded_train_step`; dp row 0's tp ranks validate together on their
parts with the tp model, and every rank joins each checkpoint's gather
while rank 0 writes the full state, in the one format `cli.sample` reads.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
from diffab_pytorch_tpu_torch.data.loader import PrefetchLoader
from diffab_pytorch_tpu_torch.parallel.dp import make_dp_train_step, rank_seed
from diffab_pytorch_tpu_torch.parallel.mesh import batch_sharding, put_global
from diffab_pytorch_tpu_torch.parallel.tp import (
    head_shard,
    make_sharded_train_step,
    shard_state,
    tp_harness,
)
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from diffab_pytorch_tpu_torch.train.harness import DiffAb, OptState, TrainState
from diffab_pytorch_tpu_torch.utils.logging import MetricLogger, is_primary
from diffab_pytorch_tpu_torch.utils.profiling import counters, span

Data = Union[PatchDataset, Iterable[ProteinBatch]]
_END = object()


def _copy_state(state: TrainState) -> TrainState:
    """A detached copy of `state` on its device (the guard's snapshots: a
    few copies of the parameters and moments, and no wait for the card)."""
    on = lambda d: None if d is None else {k: v.detach().clone() for k, v in d.items()}
    params = {k: v.requires_grad_(True) for k, v in on(state.params).items()}
    opt = OptState(state.opt_state.count, on(state.opt_state.mu), on(state.opt_state.nu))
    return TrainState(state.step, params, opt, on(state.ema_params))


def _step_generator(generator: torch.Generator, seed: int, step: int,
                    rank: int = 0) -> torch.Generator:
    return generator.manual_seed(rank_seed(seed * 1_000_003 + step, rank))


def fit(
    harness: DiffAb,
    train_data: Data,
    val_data: Optional[Data] = None,
    *,
    epochs: Optional[int] = None,
    max_steps: Optional[int] = None,
    seed: Optional[int] = None,
    logger: Optional[MetricLogger] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    state: Optional[TrainState] = None,
    train_step=None,
    device_pool: bool = False,
    dp_group=None,
    mesh=None,
) -> TrainState:
    """Train and return the final TrainState.  `state` continues a run in
    memory; otherwise the state is initialized from `seed` (default
    TrainConfig.seed) or, with `resume`, restored from `checkpoint_dir`.
    Validation over `val_data` (a PatchDataset in order, or batches) runs
    at every epoch boundary: every len(train_data) // batch_size steps for
    a dataset, every len(train_data) for a list of batches.
    `train_step(state, batch, draws) -> (state, metrics)` replaces
    `harness.make_train_step()`; it cannot be combined with device_pool, whose
    step gathers the rows itself.  `dp_group`: train data-parallel over
    that process group (each batch's rows split over its ranks; the
    default step is then `make_dp_train_step(harness, dp_group)`).  `mesh`:
    train tensor-parallel over that (dp, tp) mesh (`state`, when given, is
    this rank's part; the default step `make_sharded_train_step(harness,
    mesh)`)."""
    cfg = harness.config.train
    dev = harness.device
    seed = cfg.seed if seed is None else seed
    epochs = cfg.epochs if epochs is None else epochs
    logger = logger or MetricLogger(print_every=cfg.log_every)
    gen = torch.Generator(device=dev)
    primary = is_primary()
    loader0 = counters()  # the loader's counters before its batches
    shard, rank = None, 0
    eval_harness, evaluates = harness, primary
    if mesh is not None:
        if dp_group is not None:
            raise ValueError("give the mesh or a dp_group, not both: the mesh has its dp group")
        dp_group = mesh.dp_group
        heads = head_shard(harness.config.model, mesh)
        eval_harness = harness if heads is None else tp_harness(harness, heads)
        evaluates = mesh.dp_rank == 0
    if dp_group is not None:
        if device_pool:
            raise ValueError("device_pool uses the single-device pool step; it cannot be "
                             "combined with data parallelism")
        shard = batch_sharding(dp_group)
        rank = shard.rank
        shard.rows(cfg.batch_size)  # the batch must split evenly over the ranks

    if state is None:
        state = harness.init(seed)
        if checkpoint_dir and resume and ckpt_lib.latest_step(checkpoint_dir) is not None:
            state = ckpt_lib.restore_checkpoint(checkpoint_dir, dev, mesh=mesh)
            print(f"[trainer] resumed from step {state.step}")
        elif mesh is not None:
            state = shard_state(state, mesh)
    if checkpoint_dir and primary:
        ckpt_lib.save_model_config(checkpoint_dir, harness.config.model)
    saves = bool(checkpoint_dir) and (primary or mesh is not None)

    if train_step is None and mesh is not None:
        train_step = make_sharded_train_step(harness, mesh)
    elif train_step is None and dp_group is not None:
        train_step = make_dp_train_step(harness, dp_group)
    step_fn = train_step or harness.make_train_step()
    loader = None
    if device_pool:
        if train_step is not None or not isinstance(train_data, PatchDataset):
            raise ValueError("device_pool runs DiffAb.pool_train_step on a PatchDataset; it "
                             "cannot take an injected train_step or a list of batches")
        host_pool, _ = train_data.device_pool()
        n_rows = host_pool.batch_size
        if n_rows < cfg.batch_size:
            raise ValueError(f"dataset ({n_rows} usable samples) smaller than "
                             f"batch_size={cfg.batch_size}")
        pool = host_pool.to(dev)
        pool_step = harness.make_pool_train_step()
        n_res = pool.seq_idx.shape[1]
        total = epochs * max(1, n_rows // cfg.batch_size) - state.step
        source = itertools.islice(train_data.epoch_indices(
            cfg.batch_size, n_rows=n_rows, shuffle=True, seed=seed), max(total, 0))

        def draw(rows, generator):
            idx = torch.from_numpy(rows.astype(np.int64))
            if dev.type == "cuda":  # from pageable memory the copy would wait for the card
                idx = idx.pin_memory().to(dev, non_blocking=True)
            return idx, harness.draw_for(len(rows), n_res, generator, dev)

        def run_step(state, idx, draws):
            return pool_step(state, pool, idx, draws)
    else:
        if isinstance(train_data, PatchDataset):
            loader = PrefetchLoader(train_data.batches(
                cfg.batch_size, shuffle=True, seed=seed, epochs=epochs), dev, sharding=shard)
            source = (batch for batch, _ in loader)
        else:
            source = itertools.chain.from_iterable(itertools.repeat(train_data, epochs))
            if shard is not None:
                source = (put_global(batch, shard) for batch in source)

        def draw(batch, generator):
            batch = batch.to(dev)
            return batch, harness.draw(batch, generator)

        run_step = step_fn
    if isinstance(train_data, PatchDataset):
        steps_per_epoch = max(1, len(train_data) // cfg.batch_size)
    else:
        steps_per_epoch = max(1, len(train_data)) if hasattr(train_data, "__len__") else None

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

    eval_step = (eval_harness.make_eval_step() if eval_harness is harness
                 else eval_harness.eval_step)

    def run_eval(params):
        if val_data is None or not evaluates:
            return
        batches = val_data
        if isinstance(val_data, PatchDataset):
            batches = (b for b, _ in val_data.batches(cfg.batch_size, shuffle=False, epochs=1,
                                                       drop_last=False))
        ms = []
        for i, vb in enumerate(batches):
            vb = vb.to(dev)
            ms.append(eval_step(
                params, vb, harness.draw(vb, _step_generator(gen, seed + 1 + i, state.step))))
        if ms:
            logger.log(state.step, {k: float(np.mean([float(m[k]) for m in ms]))
                                    for k in ms[0]})

    # spans (`utils/profiling.py`) of each step, whose call is the step
    # trained: the wait on the source, the draws, the step, the logging point
    source = iter(source)
    try:
        while True:
            trained = state.step
            with span("fit.loader_wait", call=trained):
                item = next(source, _END)
            if item is _END or (max_steps is not None and trained >= max_steps):
                break
            with span("fit.draw", call=trained):
                data, draws = draw(item, _step_generator(gen, seed, trained, rank))
            with span("fit.step", call=trained):
                state, metrics = run_step(state, data, draws)
            step = state.step
            if step % cfg.log_every == 0:
                with span("fit.log", call=trained):
                    now = time.time()
                    metrics = dict(metrics,
                                   steps_per_sec=cfg.log_every / max(now - t_last, 1e-9))
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
            if saves and step % cfg.checkpoint_every == 0:
                if last_ok_step >= step - cfg.log_every:
                    ckpt_lib.save_checkpoint(checkpoint_dir, state, mesh=mesh)
                elif primary:
                    print(f"[trainer] step {step}: loss diverged from best "
                          f"{best_loss:.4g}; not overwriting the checkpoint")
            if steps_per_epoch and step % steps_per_epoch == 0:
                run_eval(state.params)
    finally:
        if loader is not None:
            loader.close()
            now = counters()
            n = now.get("loader.batches", 0) - loader0.get("loader.batches", 0)
            if n:
                ms = 1e3 * (now["loader.batch_s"] - loader0.get("loader.batch_s", 0.0)) / n
                print(f"[trainer] loader: {n} batches, host ms per batch: mean {ms:.2f}")

    if state.step > last_ok_step + cfg.log_every:
        print(f"[trainer] final state diverged (best {best_loss:.4g}, validated "
              f"snapshot at step {step_good}); falling back")
        state = state_good
        if checkpoint_dir and primary:
            ckpt_lib.prune_after(checkpoint_dir, step_good)
    if saves:
        ckpt_lib.save_checkpoint(checkpoint_dir, state, mesh=mesh)
    if dp_group is not None:  # every rank returns after the checkpoint is written
        dist.barrier(group=dp_group if mesh is None else mesh.group)
    return state
