"""Debug-mode numerical checking (`diffab_pytorch_tpu/utils/debug.py`).

`checked_fn(fn)` is the counterpart of JAX's checkify-wrapped step: the
wrapped call runs `fn` under a `TorchDispatchMode` that looks at every
aten op as it runs (forward and backward) and raises at the first one that
goes wrong, naming it:

  * "float": an op whose floating output holds a NaN or an Inf raises
    `FloatingPointError`;
  * "index": an indexing op (index, index_put, index_select, gather,
    scatter, index_add, embedding, one_hot) given an index outside its
    dimension raises `IndexError` before the op runs (on the card an
    out-of-range index is a device-side assert that ends the process);
  * "div": an integer division or remainder by zero raises
    `ZeroDivisionError` before the op runs.

Factory ops (`empty` and kin, whose outputs hold garbage until written)
and views are not checked.  The CUDA kernels are launched through ctypes,
which the mode does not see: their wrappers report each launch's outputs
(`ops._build.launched`) and the mode checks them there, naming the kernel.
Each check reads its result back to the host, so a checked call runs
slower; its results are the unchecked call's bit for bit.  The whole call
runs eagerly (`utils.graphs.disabled()`): the mode cannot see the ops a
CUDA graph replays.  Wrap only debug runs:

    step = checked_fn(harness.train_step)
    state, metrics = step(state, batch, draws)   # raises on NaN / Inf / OOB
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.utils import graphs

CHECKS = frozenset({"float", "index", "div"})

_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_", "set_"})
# op -> (position of the indexed tensor, of the dim argument (None: the
# index list's own positions; embedding: rows), of the index or index
# list), and whether negative indices count from the end
_INDEXING = {
    "index": (0, None, 1, True),
    "_unsafe_index": (0, None, 1, True),
    "index_put": (0, None, 1, True),
    "index_put_": (0, None, 1, True),
    "_index_put_impl_": (0, None, 1, True),
    "index_select": (0, 1, 2, False),
    "gather": (0, 1, 2, False),
    "scatter": (0, 1, 2, False),
    "scatter_": (0, 1, 2, False),
    "scatter_add": (0, 1, 2, False),
    "scatter_add_": (0, 1, 2, False),
    "scatter_reduce": (0, 1, 2, False),
    "scatter_reduce_": (0, 1, 2, False),
    "index_add": (0, 1, 2, False),
    "index_add_": (0, 1, 2, False),
    "embedding": (0, None, 1, False),  # weight (rows, d), indices: rows
}
_DIVISION = frozenset({"div", "div_", "floor_divide", "floor_divide_", "remainder",
                       "remainder_", "fmod", "fmod_"})


def _integral(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, (int, bool))


def _non_finite(t: torch.Tensor) -> str | None:
    """None when every entry is finite, else "nan" or "inf"."""
    if bool(torch.isfinite(t).all()):
        return None
    return "nan" if bool(torch.isnan(t).any()) else "inf"


class _CheckMode(TorchDispatchMode):
    def __init__(self, checks: frozenset):
        super().__init__()
        self.checks = checks

    def check_outputs(self, where: str, outputs) -> None:
        for t in outputs:
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                bad = _non_finite(t)
                if bad:
                    raise FloatingPointError(f"{bad} produced by {where}")

    def _check_indices(self, name: str, func, args) -> None:
        at, dim_at, index_at, negative = _INDEXING[name]
        src = args[at]
        if name == "embedding":
            pairs = [(src.shape[0], args[index_at])]
        elif dim_at is None:  # a list of optional index tensors, one per dim
            pairs = [(src.shape[d], ix) for d, ix in enumerate(args[index_at])
                     if ix is not None and ix.dtype != torch.bool]
        else:
            dim = args[dim_at]
            pairs = [(src.shape[dim] if src.dim() else 1, args[index_at])]
        for n, ix in pairs:
            if ix.numel() == 0:
                continue
            lo, hi = int(ix.min()), int(ix.max())
            if hi >= n or lo < (-n if negative else 0):
                raise IndexError(f"out-of-bounds index in {func}: indices span [{lo}, {hi}] "
                                 f"for a dimension of size {n}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if "index" in self.checks:
            if name in _INDEXING:
                self._check_indices(name, func, args)
            elif name == "one_hot" and len(args) > 1 and args[1] >= 0 and args[0].numel():
                lo, hi = int(args[0].min()), int(args[0].max())
                if lo < 0 or hi >= args[1]:
                    raise IndexError(f"out-of-bounds index in {func}: classes span "
                                     f"[{lo}, {hi}] for {args[1]} classes")
        if ("div" in self.checks and name in _DIVISION and len(args) > 1
                and _integral(args[0]) and _integral(args[1])):
            divisor = args[1]
            zero = (bool((divisor == 0).any()) if isinstance(divisor, torch.Tensor)
                    else divisor == 0)
            if zero:
                raise ZeroDivisionError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if ("float" in self.checks and name not in _UNCHECKED
                and not getattr(func, "is_view", False)):
            self.check_outputs(str(func), out if isinstance(out, (tuple, list)) else (out,))
        return out


def checked_fn(fn: Callable, checks=CHECKS) -> Callable:
    """`fn` whose calls raise at the first op that produces a NaN or Inf
    (FloatingPointError), indexes out of bounds (IndexError) or divides
    integers by zero (ZeroDivisionError), for the checks named in `checks`."""
    checks = frozenset(checks)
    unknown = checks - CHECKS
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; known: {sorted(CHECKS)}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = _CheckMode(checks)

        def kernel_check(name, outputs):
            with _disable_current_modes():  # the check's own ops are not checked
                mode.check_outputs(f"the {name} kernel", outputs)
        if "float" in checks:
            _build.launch_checks.append(kernel_check)
        try:
            with graphs.disabled(), mode:
                return fn(*args, **kwargs)
        finally:
            if "float" in checks:
                _build.launch_checks.remove(kernel_check)

    return wrapped


def _floating_leaves(tree, path=()):
    """(path, tensor) of every floating tensor in nested dicts, lists,
    tuples, named tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _floating_leaves(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floating_leaves(v, path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _floating_leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _floating_leaves(v, path + (i,))


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming up to 5 paths of `tree` whose
    floating tensors hold a NaN or an Inf (for tests and debug loops)."""
    bad = [path for path, t in _floating_leaves(tree)
           if not bool(torch.isfinite(t.detach()).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
