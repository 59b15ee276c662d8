"""Data-parallel training and the sharded design fan-out and scoring
(`diffab_pytorch_tpu/parallel/dp.py`).

One process per card; every function takes the process group to work
over (None: the default group) and returns its result on every rank, or
with `to_rank0=True` on rank 0 only (None elsewhere).

  * `make_dp_train_step`: each rank runs the loss and its gradients on its
    rows of the global batch with its own draws, then ONE all_reduce of a
    flat bucket holding every gradient and the metrics, divided by the
    world size (the shards weighted equally, as the JAX step's `pmean`
    weights them), and the same update on every rank, EMA included
    (`DiffAb.apply_gradients`).  A self-conditioned model runs its two
    passes inside `DiffAb.loss_and_grads`, so it is data-parallel too.
  * `sample_fanout_sharded`: n designs of the (replicated) targets, n / world
    on each rank; `score_fanout_sharded`: each rank scores its block of
    design rows.
  * `sample_sharded`: the batch's b targets, b / world on each rank, one
    design each (each rank's rows carry their own context, so its pair
    biases are one per target); `replicate_batch` tiles a batch's rows.
    Rows come device-major (the ranks' blocks in rank order), each block
    design-major over the targets, as the JAX functions return them.
    Gloo has no all_gather for tensors on the card, so on a gloo group
    they are gathered through host memory.

Tensor parallelism (JAX's `make_sharded_train_step`, `shard_state`) is
`parallel/tp.py`; its step runs this module's gradient all-reduce over the
mesh's dp group.

Random streams.  JAX folds the device index into the key.  Here rank r
draws from its own generator: rank 0 from the generator it was given, rank
r > 0 from a fresh generator on the same device seeded with
`rank_seed(generator.initial_seed(), r)`, where rank_seed(s, r) = (s + r *
0x9E3779B97F4A7C15) mod 2^64 (an odd 64-bit stride, so ranks never share
a seed).  Rank 0's stream is therefore the single-device stream: a
one-rank run is, bit for bit, the single-device `train_step` / `fit` /
`sample` / `score_designs` with the same seed.  Give a freshly seeded
generator: ranks r > 0 start from its seed, not from its current state.
Every draw can still be injected (`draws` of the train step; `init_noise`,
`step_noise` and `draws` through the keyword arguments, per rank), which
is how tests feed each rank the numbers JAX draws on its device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.parallel.mesh import (
    batch_sharding,
    put_global,
    replicated,
)
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
from diffab_pytorch_tpu_torch.sampling.scoring import DesignScores
from diffab_pytorch_tpu_torch.train.harness import DiffAb, StepDraws, TrainState

_RANK_STRIDE = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s stream for a run seeded with `seed`;
    rank 0 keeps `seed`."""
    return (seed + rank * _RANK_STRIDE) % 2**64


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """Rank `rank`'s generator: `generator` itself on rank 0, else a new
    one on its device seeded with rank_seed(generator.initial_seed(), rank)."""
    if rank == 0:
        return generator
    return torch.Generator(device=generator.device).manual_seed(
        rank_seed(generator.initial_seed(), rank))


def _flatten(grads: dict, metrics: dict) -> torch.Tensor:
    """One float32 bucket: every gradient, then the metrics."""
    return torch.cat([g.reshape(-1) for g in grads.values()]
                     + [torch.stack([m.detach().to(torch.float32) for m in metrics.values()])])


def _unflatten(bucket: torch.Tensor, grads: dict, metrics: dict):
    """`bucket` back into `grads` (copied into the gradient tensors
    themselves, so the update reads tensors laid out as the single-device
    step's) and the metrics (views, in their dtypes)."""
    parts = bucket.split([g.numel() for g in grads.values()] + [len(metrics)])
    torch._foreach_copy_(list(grads.values()),
                         [p.view(g.shape) for p, g in zip(parts, grads.values())])
    return grads, {k: parts[-1][i].to(v.dtype) for i, (k, v) in enumerate(metrics.items())}


def make_dp_train_step(harness: DiffAb, group=None):
    """The data-parallel train step over `group`: step(state, batch, draws)
    -> (state, {"train/...": 0-dim tensor}), with this rank's rows of the
    global batch (`put_global(global_batch, batch_sharding(group))`) and
    this rank's draws for them.  The state must be the same on every rank:
    its parameters are checked on the first call.  Every rank leaves with
    the same state and metrics."""
    world = dist.get_world_size(group)
    checked = False

    def step(state: TrainState, batch: ProteinBatch, draws: StepDraws):
        nonlocal checked
        if not checked:
            put_global(state.params, replicated(group))
            checked = True
        _, metrics, grads = harness.loss_and_grads(state.params, batch, draws, state.step)
        bucket = _flatten(grads, metrics)
        dist.all_reduce(bucket, group=group)
        bucket /= world
        grads, metrics = _unflatten(bucket, grads, metrics)
        state = harness.apply_gradients(state, grads)
        return state, {f"train/{k}": v for k, v in metrics.items()}

    return step


def host_dp_loss_and_grads(harness: DiffAb, params, batches, draws, step: int):
    """The averaged gradients and metrics of len(batches) ranks computed in
    one process, rank by rank: each shard's loss and gradients on the same
    parameters, summed in rank order and divided by the rank count."""
    total = None
    for batch, d in zip(batches, draws):
        _, metrics, grads = harness.loss_and_grads(params, batch, d, step)
        flat = _flatten(grads, metrics)
        total = flat if total is None else total + flat
    return _unflatten(total / len(batches), grads, metrics)


def host_dp_train_step(harness: DiffAb, state: TrainState, batches, draws):
    """The data-parallel step of len(batches) ranks computed in one process
    (the reference the collective step is held to): the averaged gradients
    (`host_dp_loss_and_grads`), then one update."""
    grads, metrics = host_dp_loss_and_grads(harness, state.params, batches, draws, state.step)
    state = harness.apply_gradients(state, grads)
    return state, {f"train/{k}": v for k, v in metrics.items()}


def _gather_rows(x: torch.Tensor, group, dim: int, to_rank0: bool):
    """The ranks' x concatenated along `dim` in rank order, on every rank
    (on rank 0 only with to_rank0; None elsewhere)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    y = (x.cpu() if via_host else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(world)] if rank == 0 or not to_rank0 else None
    if to_rank0:
        dist.gather(y, parts, dst=dist.get_global_rank(group or dist.group.WORLD, 0),
                    group=group)
        if rank != 0:
            return None
    else:
        dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if via_host else out


def _gather_result(result: SampleResult, group, to_rank0: bool):
    """A SampleResult's rows gathered: the final fields on axis 0, the
    (T, b, ...) trajectories on axis 1."""
    fields = {}
    for name, x in result._asdict().items():
        fields[name] = (None if x is None else
                        _gather_rows(x, group, 1 if name.endswith("_trajectory") else 0, to_rank0))
    if to_rank0 and dist.get_rank(group) != 0:
        return None
    return SampleResult(**fields)


def _check_params(harness: DiffAb, params, group) -> None:
    """The sampling parameters (the model's own for None) replicated."""
    put_global(params if params is not None else dict(harness.model.state_dict()),
               replicated(group))


def sample_fanout_sharded(harness: DiffAb, params, batch: ProteinBatch,
                          generator: torch.Generator, group, n_designs: int, *,
                          to_rank0: bool = False, **sample_kwargs):
    """n_designs designs of each of the batch's targets (the batch
    replicated on every rank), n_designs / world on each rank, sharing one
    context per rank.  With b targets, row ((r b) + i) n_local + j is
    design j of target i on rank r; for one target, n_designs rows."""
    world = dist.get_world_size(group)
    if n_designs % world:
        raise ValueError(f"n_designs={n_designs} not divisible by dp={world}")
    _check_params(harness, params, group)
    local = harness.sample(params, batch, rank_generator(generator, dist.get_rank(group)),
                           n_designs=n_designs // world, **sample_kwargs)
    return _gather_result(local, group, to_rank0)


def score_fanout_sharded(harness: DiffAb, params, batch: ProteinBatch, designs,
                         generator: torch.Generator, group=None, *, to_rank0: bool = False,
                         **score_kwargs) -> DesignScores | None:
    """Score the design rows `sample_fanout_sharded` returns: each rank its
    block of rows (device-major blocks, design-major within) against the
    replicated targets, with its own stream; the scores line up row for
    row with the designs."""
    world = dist.get_world_size(group)
    bn, b = designs.seq_idx.shape[0], batch.batch_size
    if bn % (b * world):
        raise ValueError(f"design rows {bn} not divisible by targets*dp = {b * world}")
    _check_params(harness, params, group)
    shard = batch_sharding(group)
    local = SampleResult(*(put_global(x, shard) for x in
                           (designs.seq_idx, designs.translations, designs.orientations)))
    scores = harness.score_designs(params, batch, local,
                                   rank_generator(generator, shard.rank), **score_kwargs)
    out = [_gather_rows(x, group, 0, to_rank0) for x in scores]
    return None if out[0] is None else DesignScores(*out)


def sample_sharded(harness: DiffAb, params, batch: ProteinBatch, generator: torch.Generator,
                   group=None, *, to_rank0: bool = False, **sample_kwargs):
    """The batch's b targets sampled with their rows sharded over the group:
    rank r samples its b / world rows (the block `batch_sharding` gives it,
    moved to the harness's device) from its rank generator, and the
    results are gathered in rank order, the trajectories on axis 1.  For n
    designs of one target prefer `sample_fanout_sharded`, which shares each
    rank's context over its designs."""
    world = dist.get_world_size(group)
    if batch.batch_size % world:
        raise ValueError(f"batch size {batch.batch_size} not divisible by dp={world}")
    _check_params(harness, params, group)
    shard = batch_sharding(group)
    rows = put_global(batch, shard).to(harness.device)
    local = harness.sample(params, rows, rank_generator(generator, shard.rank), **sample_kwargs)
    return _gather_result(local, group, to_rank0)


def replicate_batch(batch: ProteinBatch, n: int) -> ProteinBatch:
    """Each row of the batch repeated n times in place (row i becomes rows
    i n .. i n + n - 1): a 1-complex batch tiled into n designs."""
    return batch._map(lambda x: torch.repeat_interleave(x, n, dim=0))
