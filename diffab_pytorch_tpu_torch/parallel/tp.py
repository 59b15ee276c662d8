"""Tensor-parallel training (`diffab_pytorch_tpu/parallel/dp.py`
`make_sharded_train_step`, `shard_state`).

JAX jits the step with the parameters placed by `param_sharding` and lets
GSPMD insert the collectives, with the Pallas kernel turned off (GSPMD
cannot split an opaque kernel).  The port splits every IPA layer by head
instead, so each tp rank runs the kernel (K1, or K2 at
`fuse_ipa_layer=False`, or the plain branch) on its own h / tp heads:

  * `tp_harness(harness, heads)`: a shallow clone of the harness whose
    model's IPA layers (`ipa`, and `geo_ipa` of the split trunk) are built
    for one rank's heads (`models/ipa.py`); one all-reduce of the (b, L, d)
    partial output closes each layer, the gradients of the layer's input
    and of the pair embedding (once a step) are summed over tp, and the
    schedule, tables and optimizer settings are shared;
  * `shard_state` / `gather_state`: a TrainState's params, Adam moments and
    EMA cut to this rank's parts by `param_sharding`, and back
    (`gather_params` for any trees keyed like the params);
  * `make_sharded_train_step(harness, mesh)`: the step on the tp-sharded
    state and this dp rank's rows: the loss and gradients on the rank's
    heads, the data-parallel step's all-reduce over `mesh.dp_group` (the
    sharded gradients differ across tp ranks, so do their buckets), then
    the update, whose two norms are those of the full parameters;
  * `host_tp_harness(harness, tp)`: the one-process reference, every IPA
    layer run as its tp ranks' parts in a host loop and summed.

Draws: every tp rank of a dp row takes the rows and draws of its dp rank
(`parallel.dp.rank_generator(generator, mesh.dp_rank)`), so at dp = 1
every rank draws the single-device stream.  At tp = 1, or where tp does
not divide the heads (every layer replicated), the step is
`parallel.dp.make_dp_train_step` over the dp group, and at tp = 1 on one
rank bit for bit the single-device `train_step`.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch.func import functional_call

from diffab_pytorch_tpu_torch.config import ModelConfig
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.models.ipa import InvariantPointAttentionLayer
from diffab_pytorch_tpu_torch.parallel.dp import (
    _flatten,
    _gather_rows,
    _unflatten,
    make_dp_train_step,
)
from diffab_pytorch_tpu_torch.parallel.mesh import (
    DP_AXIS,
    TP_AXIS,
    HeadShard,
    Mesh,
    check_replicated,
    param_sharding,
)
from diffab_pytorch_tpu_torch.train.harness import DiffAb, OptState, TrainState


def head_shard(cfg: ModelConfig, mesh: Mesh) -> HeadShard | None:
    """This rank's heads of every IPA layer, or None where the layers are
    not split: at tp = 1, or where tp does not divide the head count."""
    tp = mesh.shape[TP_AXIS]
    if tp == 1 or cfg.n_head % tp:
        return None
    if cfg.ipa_block != "ipa":
        raise ValueError("tensor parallelism splits the bare IPA layer's four to_out blocks; "
                         "the GA block is not split")
    return HeadShard(mesh.tp_rank, tp, mesh.tp_group)


def tp_harness(harness: DiffAb, heads: HeadShard) -> DiffAb:
    """A shallow clone of `harness` whose model is built for `heads`."""
    clone = copy.copy(harness)
    clone.model = DiffAbModel(harness.config.model, device=harness.device, heads=heads)
    return clone


def _parts(tree: dict | None, splits: dict, rank: int, tp: int, grad: bool = False):
    if tree is None:
        return None
    out = {}
    for k, v in tree.items():
        v = v.detach() if splits[k] is None else splits[k].shard(v.detach(), rank, tp)
        out[k] = v.clone(memory_format=torch.contiguous_format).requires_grad_(grad)
    return out


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's part of a full TrainState (JAX `shard_state`): params,
    Adam moments and EMA cut by `param_sharding`, the replicated leaves
    copied; fresh tensors, so the state given is never updated through
    them."""
    splits = param_sharding(state.params, mesh)
    cut = lambda d, grad=False: _parts(d, splits, mesh.tp_rank, mesh.shape[TP_AXIS], grad)
    return TrainState(state.step, cut(state.params, True),
                      OptState(state.opt_state.count, cut(state.opt_state.mu),
                               cut(state.opt_state.nu)),
                      cut(state.ema_params))


def gather_params(trees: list[dict], mesh: Mesh) -> list[dict]:
    """Full trees (params, or anything keyed and split like them: moments,
    EMA, gradients) from every tp rank's parts, in one all_gather over
    `mesh.tp_group` of all their split leaves.  Replicated leaves are the
    trees' own tensors."""
    splits = param_sharding(trees[0], mesh)
    names = [k for k, s in splits.items() if s is not None]
    if not names:
        return [dict(t) for t in trees]
    flat = torch.cat([t[k].detach().reshape(-1) for t in trees for k in names])
    sizes = [t[k].numel() for t in trees for k in names]
    every = _gather_rows(flat, mesh.tp_group, 0, to_rank0=False)  # the ranks' buckets in order
    pieces = [p.split(sizes) for p in every.chunk(mesh.shape[TP_AXIS])]
    full, i = [], 0
    for t in trees:
        d = dict(t)
        for k in names:
            d[k] = splits[k].gather([p[i].view(t[k].shape) for p in pieces])
            i += 1
        full.append(d)
    return full


def gather_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The full TrainState from every tp rank's part (the inverse of
    `shard_state`; a collective over `mesh.tp_group`)."""
    ema = state.ema_params
    trees = [state.params, state.opt_state.mu, state.opt_state.nu] + ([ema] if ema else [])
    full = gather_params(trees, mesh)
    params = {k: v if v.requires_grad else v.requires_grad_(True) for k, v in full[0].items()}
    return TrainState(state.step, params, OptState(state.opt_state.count, full[1], full[2]),
                      full[3] if ema else None)


def _check_placement(params: dict, mesh: Mesh) -> None:
    """Raise unless the state sits on the mesh as `shard_state` places it:
    the replicated parameters bit-identical over the whole group, the
    split ones over this rank's dp group (`check_replicated`)."""
    splits = param_sharding(params, mesh)
    check_replicated([v for k, v in params.items() if splits[k] is None], mesh.group)
    check_replicated([v for k, v in params.items() if splits[k] is not None], mesh.dp_group)


def _full_norms(split_names: set, heads: HeadShard):
    """`apply_gradients`'s leaf_norms hook on a tp-sharded state: a split
    leaf's norm is the square root of its parts' squared norms summed over
    tp (one all-reduce of them all), its element count the full one."""
    def leaf_norms(names, tensors):
        norms = list(torch._foreach_norm(tensors))
        idx = [i for i, k in enumerate(names) if k in split_names]
        if idx:
            sq = torch.stack([norms[i] for i in idx]).square()
            dist.all_reduce(sq, group=heads.group)
            for i, n in zip(idx, sq.sqrt()):
                norms[i] = n
        return norms, [t.numel() * (heads.size if k in split_names else 1)
                       for k, t in zip(names, tensors)]
    return leaf_norms


def make_sharded_train_step(harness: DiffAb, mesh: Mesh):
    """The tensor-parallel train step over `mesh`: step(state, batch, draws)
    -> (state, {"train/...": 0-dim tensor}) with this rank's part of the
    state (`shard_state`), this dp rank's rows of the global batch
    (`put_global(batch, batch_sharding(mesh.dp_group))`) and its dp rank's
    draws.  The placement is checked on the first call (`_check_placement`).
    Every rank leaves with its part of the same state, and the same
    metrics."""
    heads = head_shard(harness.config.model, mesh)
    if heads is None:
        dp_step = make_dp_train_step(harness, mesh.dp_group)
        if mesh.shape[TP_AXIS] == 1:
            return dp_step
        checked = False

        def replicated_step(state, batch, draws):
            nonlocal checked
            if not checked:
                check_replicated(state.params, mesh.group)
                checked = True
            return dp_step(state, batch, draws)
        return replicated_step

    local = tp_harness(harness, heads)
    dp = mesh.shape[DP_AXIS]
    leaf_norms = None

    def step(state: TrainState, batch, draws):
        nonlocal leaf_norms
        if leaf_norms is None:
            _check_placement(state.params, mesh)
            splits = param_sharding(state.params, mesh)
            leaf_norms = _full_norms({k for k, s in splits.items() if s is not None}, heads)
        _, metrics, grads = local.loss_and_grads(state.params, batch, draws, state.step)
        if dp > 1:
            bucket = _flatten(grads, metrics)
            dist.all_reduce(bucket, group=mesh.dp_group)
            bucket /= dp
            grads, metrics = _unflatten(bucket, grads, metrics)
        state = local.apply_gradients(state, grads, leaf_norms=leaf_norms)
        return state, {f"train/{k}": v.detach() for k, v in metrics.items()}

    return step


# ---- the one-process reference ------------------------------------------------------------


class _HostSplitLayer(InvariantPointAttentionLayer):
    """A whole IPA layer (its parameters full) computed as its tp ranks'
    parts one after another in this process: each part is the layer built
    for that rank's heads, run on its slices of the parameters (cut by
    `param_sharding`, differentiably, so the gradients reach the full
    parameters), and the parts are summed; the to_out bias row enters once,
    with rank 0's part."""

    def __init__(self, cfg: ModelConfig, tp: int):
        super().__init__(cfg)
        self.tp = tp
        self._ranks = tuple(InvariantPointAttentionLayer(cfg, HeadShard(r, tp)) for r in range(tp))

    def forward(self, x, pair, rot, trans, residue_mask=None, pair_bias=None,
                kernel_weights=None):
        if kernel_weights is not None:
            raise ValueError("the host reference packs each rank's weights itself")
        own = dict(self.named_parameters())
        splits = param_sharding(own, self.tp)
        out = None
        for r, part in enumerate(self._ranks):
            local = {k: v if splits[k] is None else splits[k].shard(v, r, self.tp)
                     for k, v in own.items()}
            if r:
                local["to_out.bias"] = torch.zeros_like(own["to_out.bias"])
            bias = (None if pair_bias is None
                    else pair_bias[:, part.heads.heads(self.cfg.n_head)])
            y = functional_call(part, local, (x, pair, rot, trans, residue_mask, bias))
            out = y if out is None else out + y
        return out


def host_tp_harness(harness: DiffAb, tp: int) -> DiffAb:
    """A shallow clone of `harness` whose model runs every IPA layer as its
    tp ranks' parts in a host loop (the reference the collective step is
    held to); it takes the full parameters, and its gradients are theirs."""
    clone = copy.copy(harness)
    cfg = harness.config.model
    clone.model = DiffAbModel(cfg, device=harness.device)
    den = clone.model.denoiser
    for stack in (den.ipa, getattr(den, "geo_ipa", None)):
        for i in range(cfg.n_ipa_layers if stack is not None else 0):
            setattr(stack, f"layer_{i}", _HostSplitLayer(cfg, tp))
    clone.model.to(harness.device)
    return clone
