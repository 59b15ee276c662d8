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
card.

Tensor parallelism (JAX's `make_mesh(tp=...)` and `param_sharding`):

  * `make_mesh(tp, group)`: the group's n ranks as a (dp, tp) grid, rank =
    dp index x tp + tp index (JAX's device order), with a process group for
    this rank's dp column and one for its tp row; `mesh_layout` is the
    arithmetic alone;
  * `param_sharding(params, mesh)`: which axis of each torch parameter is
    split over tp (`Split`), or None: JAX's Megatron split of the IPA
    layers, by head (see its docstring);
  * `HeadShard`, `copy_to_tp_region` and `reduce_from_tp_region`: what an
    IPA layer built for its rank's heads needs (`models/ipa.py`).
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
DP_AXIS = "dp"
TP_AXIS = "tp"


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
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        raise RuntimeError(f"replicated state differs across ranks of the group of global "
                           f"ranks {ranks}: {int(bad)} rank-tensor pairs differ from its "
                           f"rank 0's of {len(leaves)} tensors")


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


# ---- the (dp, tp) mesh ---------------------------------------------------------------


class Layout(NamedTuple):
    """The ranks of an n-rank group as a (dp, tp) grid: `rows` are the tp
    groups (dp index d holds ranks d tp ... d tp + tp - 1), `columns` the dp
    groups (tp index t holds ranks t, t + tp, ...)."""

    dp: int
    tp: int

    @property
    def rows(self) -> list[list[int]]:
        return [[d * self.tp + t for t in range(self.tp)] for d in range(self.dp)]

    @property
    def columns(self) -> list[list[int]]:
        return [[d * self.tp + t for d in range(self.dp)] for t in range(self.tp)]

    def coords(self, rank: int) -> tuple[int, int]:
        """(dp index, tp index) of a rank."""
        return divmod(rank, self.tp)


def mesh_layout(n: int, tp: int = 1) -> Layout:
    """The (n / tp, tp) grid of JAX's `make_mesh(n, tp)`: device (or rank)
    i sits at dp index i // tp and tp index i % tp."""
    if tp < 1 or n % tp:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    return Layout(n // tp, tp)


class Mesh(NamedTuple):
    """One rank's view of a (dp, tp) mesh: the whole group, the process
    groups of its dp column (the ranks that hold the same parameter
    shards) and of its tp row (the ranks that split one model), its
    coordinates, and `shape` {"dp": n / tp, "tp": tp} as JAX's Mesh.shape."""

    group: object
    dp_group: object
    tp_group: object
    dp_rank: int
    tp_rank: int
    shape: dict


def make_mesh(tp: int = 1, group=None) -> Mesh:
    """The (dp, tp) mesh over `group`'s ranks (None: the default group),
    ranked as JAX ranks devices (`mesh_layout`).  Every rank of the default
    group must call it, in the same order as its other group creations: it
    creates every dp and every tp subgroup (`dist.new_group`, on the
    group's backend) and keeps its own two."""
    layout = mesh_layout(dist.get_world_size(group), tp)
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    backend = dist.get_backend(group)
    dp_index, tp_index = layout.coords(dist.get_rank(group))
    made = {}
    for kind, sets in (("dp", layout.columns), ("tp", layout.rows)):
        for i, members in enumerate(sets):
            g = dist.new_group([ranks[r] for r in members], backend=backend)
            if i == (tp_index if kind == "dp" else dp_index):
                made[kind] = g
    return Mesh(group, made["dp"], made["tp"], dp_index, tp_index,
                {DP_AXIS: layout.dp, TP_AXIS: layout.tp})


# ---- the split of the parameters over tp ------------------------------------------------

# JAX's Megatron patterns (parallel/mesh.py _COL_PARALLEL / _ROW_PARALLEL)
_COL_PARALLEL = ("to_q_scalar", "to_k_scalar", "to_v_scalar", "to_q_point", "to_k_point",
                 "to_v_point", "to_pair_bias")
_ROW_PARALLEL = "to_out"


class Split(NamedTuple):
    """A parameter split over tp along axis `dim`: the axis is cut into
    consecutive blocks of the sizes `blocks` (of the tensor the split was
    read from), and each block into tp equal parts; rank t keeps part t of
    every block, concatenated in block order."""

    dim: int
    blocks: tuple[int, ...]

    def shard(self, t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
        """Rank `rank`'s part of the full tensor t (differentiable; a view
        for one block)."""
        parts = [blk.chunk(tp, self.dim)[rank] for blk in t.split(list(self.blocks), self.dim)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every rank's part in rank order (the split
        read from a part)."""
        pieces = [p.split(list(self.blocks), self.dim) for p in parts]
        return torch.cat([torch.cat([pc[i] for pc in pieces], self.dim)
                          for i in range(len(self.blocks))], self.dim)


def _layer_of(name: str) -> tuple[str, str]:
    """("<layer>.", module) of a parameter name "<layer>.<module>.weight"."""
    parts = name.split(".")
    prefix = ".".join(parts[:-2])
    return (prefix + "." if prefix else ""), (parts[-2] if len(parts) > 1 else "")


def param_sharding(params: dict, mesh) -> dict:
    """{name: Split or None}: how each parameter of a DiffAb state dict
    (full or one rank's part; `mesh` a Mesh, or the tp size) is split over
    tp.  JAX's Megatron split of every IPA layer, wherever it sits (`ipa`,
    `geo_ipa`):

      * column-parallel: the weights of to_{q,k,v}_{scalar,point} and
        to_pair_bias, flax (in, out) `P(None, "tp")`, are split along their
        output features, torch dim 0: head-major, so rank t keeps heads
        [t h / tp, (t + 1) h / tp);
      * row-parallel: to_out's weight, flax `P("tp", None)`, along its
        input features, torch dim 1.  Its inputs are the four blocks
        [scalar h ds | pair h dp | points h P 3 | norms h P] (no pair block
        without the pair bias), each head-major, and each is split by head,
        so a rank keeps its heads' slice of every block.  JAX cuts the axis
        in tp contiguous pieces instead, which do not line up with the heads
        (GSPMD moves the data as it needs); the layer's numbers are the same;
      * everything else is replicated, gamma and to_out's bias included, as
        in JAX.

    Where the layer's head count h does not divide by tp, the port
    replicates the whole layer (every rank runs every head, and the layer
    needs no collective); JAX replicates only the leaves whose axis does not
    divide and lets GSPMD split the rest.  The numbers are the same."""
    tp = mesh if isinstance(mesh, int) else mesh.shape[TP_AXIS]
    out = {}
    for name, t in params.items():
        prefix, module = _layer_of(name)
        split = None
        gamma = params.get(prefix + "gamma")
        if (tp > 1 and name.endswith(".weight") and gamma is not None
                and gamma.shape[0] % tp == 0):
            if module in _COL_PARALLEL:
                split = Split(0, (t.shape[0],))
            elif module == _ROW_PARALLEL:
                blocks = [params[prefix + "to_q_scalar.weight"].shape[0]]
                pair = params.get(prefix + "to_pair_bias.weight")
                if pair is not None:
                    blocks.append(pair.shape[0] * pair.shape[1])
                vp = params[prefix + "to_v_point.weight"].shape[0]
                split = Split(1, (*blocks, vp, vp // 3))
        out[name] = split
    return out


# ---- the collectives of a layer split by head --------------------------------------------


class HeadShard(NamedTuple):
    """One tp rank's heads of an IPA layer: heads [rank h / size,
    (rank + 1) h / size).  `group` is the tp process group; None means no
    collectives: one process runs every rank's heads and sums them (the
    reference `parallel.tp.host_tp_loss_and_grads`)."""

    rank: int
    size: int
    group: object = None

    def heads(self, h: int) -> slice:
        if h % self.size:
            raise ValueError(f"n_head={h} not divisible by tp={self.size}")
        n = h // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, taken in float32 and cast back (one
    rounding of a bf16 sum, and gloo never sees a bf16 tensor)."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """The sum over the group forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp_region(x: torch.Tensor, shard: HeadShard | None) -> torch.Tensor:
    """x as an input of a layer split by head: unchanged forward, its
    gradient (each rank's heads' part) summed over the tp group backward,
    so that every rank's parameters upstream get the whole gradient.
    Identity without a group."""
    if shard is None or shard.group is None:
        return x
    return _CopyToRegion.apply(x, shard.group)


def reduce_from_tp_region(x: torch.Tensor, shard: HeadShard | None) -> torch.Tensor:
    """The layer's partial output summed over the tp group (float32 sum, one
    cast back); the gradient passes through unchanged.  Identity without a
    group."""
    if shard is None or shard.group is None:
        return x
    return _ReduceFromRegion.apply(x, shard.group)
