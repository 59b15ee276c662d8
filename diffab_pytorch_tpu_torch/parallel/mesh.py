"""Process groups and the placement of batches and state
(`diffab_pytorch_tpu/parallel/mesh.py`).

JAX places arrays on a mesh of devices with NamedShardings.  The port runs
one process per card (`python -m torch.distributed.run`) and places by
hand, with the JAX module's names; the data-parallel axis is the process
group itself:

  * `batch_sharding(group)`: each of the group's n ranks keeps the
    contiguous rows [r b / n, (r + 1) b / n) of the same global host batch,
    the block `P(DP_AXIS)` gives device r;
  * `replicated(group)`: every rank holds the same full value.
    `put_global` checks that once (a checksum of each tensor's bytes,
    rank 0's broadcast and the ranks' disagreements all-reduced) and
    raises if any rank differs; it never overwrites a rank's tensors;
  * `init_distributed(device)`: the counterpart of
    `jax.distributed.initialize()`.  Under torchrun it joins the group the
    environment describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT)
    and each rank takes cuda:LOCAL_RANK; without that environment it makes
    a one-rank group on the device it was given.  NCCL on the card, gloo
    on the CPU.

Every function takes the process group it should use (None: the default
group), so a caller can also hand it a gloo group whose tensors live on the
card.  Tensor parallelism (JAX's `make_mesh(tp=...)`, `param_sharding`) is
not ported (ROADMAP A14b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from diffab_pytorch_tpu_torch.config import resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _group_device(group) -> torch.device:
    """Where the group's collectives run: the card for NCCL, else host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class BatchSharding(NamedTuple):
    """Rank `rank` of `world` keeps the rank-th of world equal blocks of
    rows (axis 0) of a global batch."""

    rank: int
    world: int

    def rows(self, b: int) -> slice:
        if b % self.world:
            raise ValueError(f"batch size {b} not divisible by dp={self.world}")
        n = b // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


class Replicated(NamedTuple):
    """Every rank of `group` holds the same full value."""

    group: object = None


def batch_sharding(group=None) -> BatchSharding:
    """Shard the leading (batch) axis of every tensor over the group."""
    return BatchSharding(dist.get_rank(group), dist.get_world_size(group))


def replicated(group=None) -> Replicated:
    return Replicated(group)


def tree_map(fn, tree):
    """fn on every tensor of a tree of dataclasses, dicts, named tuples,
    tuples and lists; other leaves (None, numbers) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list[torch.Tensor]:
    leaves = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


def check_replicated(tree, group=None) -> None:
    """Raise unless every rank of `group` holds bit-identical tensors in
    `tree`: each rank's per-tensor checksums (element count, and a
    position-weighted sum of the bytes) against rank 0's broadcast, the
    count of differing tensors all-reduced so that every rank raises."""
    leaves = [t.detach() for t in tree_leaves(tree)]
    dev = _group_device(group)
    sums = []
    for t in leaves:
        raw = t.contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
        weight = torch.arange(raw.numel(), device=raw.device) % 251 + 1
        sums.append((raw * weight).sum().to(dev))
    numels = torch.tensor([t.numel() for t in leaves], dtype=torch.int64, device=dev)
    mine = torch.stack([numels, torch.stack(sums) if sums else numels], dim=1)
    first = mine.clone()
    dist.broadcast(first, src=dist.get_global_rank(group or dist.group.WORLD, 0), group=group)
    bad = (mine != first).any(dim=1).sum().reshape(1)
    dist.all_reduce(bad, group=group)
    if int(bad) > 0:
        raise RuntimeError(f"replicated state differs across ranks: {int(bad)} rank-tensor "
                           f"pairs differ from rank 0's of {len(leaves)} tensors")


def put_global(tree, sharding):
    """Place a tree on the group: under a `BatchSharding` the rank's rows of
    every tensor (views of the global batch; nothing is copied), under
    `Replicated` the tree itself, once checked to be bit-identical on every
    rank (`check_replicated`)."""
    if isinstance(sharding, BatchSharding):
        return tree_map(lambda t: t[sharding.rows(t.shape[0])], tree)
    if isinstance(sharding, Replicated):
        check_replicated(tree, sharding.group)
        return tree
    raise TypeError(f"unknown sharding {sharding!r}")


@contextlib.contextmanager
def init_distributed(device=None):
    """Join the process group for a data-parallel run and yield this rank's
    device; a group this call made is destroyed on exit.  Under torchrun
    the group is the one its environment describes and the card is
    cuda:LOCAL_RANK (a card index the caller names must be that one);
    without torchrun's environment, a one-rank group on a TCP store at a
    free local port, on the device given.  NCCL for a card, gloo for the
    CPU.  An initialized default group is used as it is."""
    device = resolve_device(device)
    torchrun = all(k in os.environ for k in _TORCHRUN_ENV)
    if device.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", 0)) if torchrun else device.index
        if index is None:
            index = torch.cuda.current_device()
        if device.index is not None and device.index != index:
            raise ValueError(f"--device {device} conflicts with this rank's card cuda:{index} "
                             f"(torchrun's LOCAL_RANK); name the card without an index")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        yield device
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if torchrun:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        yield device
    finally:
        dist.destroy_process_group()
