"""Captured CUDA graphs of the port's step bodies: the counterpart of
`jax.jit` around the JAX package's step functions and of its `lax.scan`
bodies (`sampling/sampler.py`'s reverse scan, `train/harness.py`'s
`make_train_step`, `make_pool_train_step` and `make_eval_step`).

A step body is one function over static buffers: it reads its inputs and
its carry from them and writes the carry back in place.  `StepGraphs` runs
a body once eagerly on a side stream (the warm-up, which is the step
itself), then captures it, and replays the capture on every later step and
call.  All the captures of one `GraphCache` (a body's variants, such as
Heun's step with and without its corrector, and the bodies of other keys)
share one memory pool.  The wrappers of the CUDA kernels count
each replay's launches (`ops._build.count_launch`).  Each capture is a
span, `graphs.capture`, and its seconds go into the counter
`graphs.capture_s` (`utils/profiling.py`); no span opens inside a body.

`GraphCache` keys the captures by what JAX would retrace on: the structure,
shapes and dtypes of the inputs and the static flags, and also by the
addresses of the tensors a body reads outside its inputs (the model's
parameters and buffers; a training state's tensors, which the step
updates in place as JAX's donated state is; a device pool), since a graph
reads memory by address.  Each call copies its inputs into the
cached static buffers, so a cached graph never reads an earlier call's
weights or target.

On a CUDA device the entry points take this path unless asked not to:
`graphs=False` on `sample()`, the eager methods `train_step`,
`pool_train_step` and `eval_step`, or any call inside `disabled()` (the
counterpart of `jax.disable_jit`; `utils.debug.checked_fn` runs under it,
because a dispatch mode cannot see the ops a replay runs), runs the same
bodies eagerly.  A capture that fails raises; nothing falls back to eager.

`capture_safe(fn, ...)` runs fn under a dispatch mode that raises at an op
that a capture cannot hold: a read of a value back to the host
(`aten._local_scalar_dense`: `.item()`, `float(t)`, `bool(t)`, indexing
with a 0-dim tensor), an op whose output shape depends on the data
(`nonzero`, `masked_select`, boolean-mask indexing, `unique`), a copy
between devices, or a tensor of several values made from host data
(`torch.tensor`, `torch.as_tensor`: a copy from the host on the card).  The
CPU tests run it over every body (on the CPU a copy to the host,
`.tolist()`, `.numpy()` and a one-value tensor made on the host dispatch no
op that tells them apart, and stay unseen).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.utils.profiling import count, span

_disabled = 0


@contextlib.contextmanager
def disabled():
    """Every step body inside runs eagerly (JAX's `disable_jit`)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def use_graphs(device, graphs: bool | None = None) -> bool:
    """Whether a call on `device` replays captured graphs: by default on a
    CUDA device; never under `disabled()` or with graphs=False."""
    device = torch.device(device)
    if graphs and device.type != "cuda":
        raise ValueError(f"graphs=True needs a CUDA device, got {device}")
    if graphs is None:
        graphs = device.type == "cuda"
    return bool(graphs) and not _disabled


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """`F.one_hot(idx, n).to(dtype)` without its host read: on a CPU tensor
    F.one_hot reads the indices' range back, which `capture_safe` rejects.
    The same values (an index outside [0, n) gives a zero row)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# ---------------------------------------------------------------------------
# the CPU check of a body


class CaptureUnsafe(RuntimeError):
    """An op that a CUDA graph capture cannot hold."""


_DATA_SHAPED = frozenset({"nonzero", "nonzero_numpy", "masked_select", "unique_dim",
                          "_unique", "_unique2", "unique_consecutive", "unique_dim_consecutive"})
_MASK_INDEXING = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})


class _CaptureSafeMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense":
            raise CaptureUnsafe(f"{func} reads a value back to the host (.item(), float(t), "
                                "bool(t) or indexing by a 0-dim tensor)")
        if name in _DATA_SHAPED or (name == "repeat_interleave" and isinstance(
                args[0], torch.Tensor) and kwargs.get("output_size") is None):
            raise CaptureUnsafe(f"{func}: its output shape depends on the data")
        if name in _MASK_INDEXING and any(
                isinstance(ix, torch.Tensor) and ix.dtype in (torch.bool, torch.uint8)
                for ix in args[1] if ix is not None):
            raise CaptureUnsafe(f"{func} with a boolean mask: its output shape depends on "
                                "the data")
        if name in ("lift_fresh", "lift_fresh_copy") and args[0].numel() > 1:
            raise CaptureUnsafe(f"{func}: a tensor made from host data inside a body is a "
                                "copy from the host on the card; make it outside")
        if name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            dst = args[0].device if name == "copy_" else torch.device(
                kwargs.get("device") or src.device)
            if src.device != dst:
                raise CaptureUnsafe(f"{func} copies from {src.device} to {dst}")
        return func(*args, **kwargs)


def capture_safe(fn, *args, **kwargs):
    """fn(*args, **kwargs), raising `CaptureUnsafe` at the first op a CUDA
    graph capture cannot hold (see the module docstring)."""
    with _CaptureSafeMode():
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# static buffers, captures and their cache


def signature(tree) -> tuple:
    """What a capture over `tree` is specialised to: its structure, and each
    tensor's shape, dtype and device or each other leaf's value."""
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec), tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                             else x for x in leaves))


def mode() -> tuple:
    """The process settings that choose which kernels a body's ops run
    (deterministic algorithms, TF32 matmuls): part of every cache key, as
    JAX's jit cache keys on its configuration."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def addresses(tensors) -> tuple:
    """The data addresses of tensors a captured body reads outside its
    inputs: part of the cache key, since a graph reads memory by address."""
    return tuple(t.data_ptr() for t in tensors)


def _tensor_leaves(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class StepGraphs:
    """The captured variants of one step body over one set of static input
    buffers (a clone of `inputs`, plus the body's own `buffers()`), their
    captures allocated from the pool of `cache`."""

    def __init__(self, inputs: dict, cache: "GraphCache", buffers=None):
        self.inputs = pytree.tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, inputs)
        if buffers is not None:
            self.inputs.update(buffers())
        self.device = _tensor_leaves(self.inputs)[0].device
        self.cache = cache
        self.graphs: dict = {}  # variant -> (graph, launch tally, captured outputs)
        self.pool_bytes = 0  # device memory the pool grew by in this entry's captures
        self.replays = 0

    def load(self, inputs: dict) -> None:
        """Copy a call's inputs into their static buffers."""
        fresh = _tensor_leaves(inputs)
        static = _tensor_leaves({k: self.inputs[k] for k in inputs})
        for buf, value in zip(static, fresh):
            buf.copy_(value)

    def run(self, variant, body):
        """One step: replay the capture of `variant`, or (the first time) run
        `body(static inputs)` eagerly on a side stream and capture it.
        Returns the body's outputs, which the next step overwrites."""
        entry = self.graphs.get(variant)
        if entry is not None:
            graph, tally, outputs = entry
            graph.replay()
            _build.replayed(tally)
            self.replays += 1
            return outputs
        current = torch.cuda.current_stream(self.device)
        side = self.cache.side_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outputs = body(self.inputs)
        current.wait_stream(side)
        for t in _tensor_leaves(outputs):
            t.record_stream(current)
        # entering the capture synchronises the card anyway; waiting here
        # keeps the eager warm-up's drain out of the capture's seconds
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with span("graphs.capture"):
            graph = torch.cuda.CUDAGraph()
            with _build.capturing() as tally, torch.cuda.graph(
                    graph, pool=self.cache.pool(), capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                captured = body(self.inputs)
                grown = torch.cuda.memory_reserved(self.device) - reserved
        self.pool_bytes += grown
        self.cache.pool_bytes += grown
        self.graphs[variant] = (graph, dict(tally), captured)
        count("graphs.capture_s", time.perf_counter() - t0)
        return outputs


class GraphCache:
    """The most recent `size` `StepGraphs` by key (least recently used
    first out, which frees their buffers), every capture in one memory
    pool: the steps replay one after another on one stream, and what a
    caller keeps is copied out of the pool, so a capture may reuse what
    another one's temporaries used."""

    def __init__(self, size: int = 4):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self._pool = self._side = None
        self.pool_bytes = 0  # device memory the pool grew by over all captures

    def pool(self):
        """The pool's handle, made at the first capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def side_stream(self, device) -> torch.cuda.Stream:
        """The stream of every warm-up: the allocator keeps what a stream
        freed for that stream, so one stream reuses the last warm-up's
        memory."""
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        return self._side

    def get(self, key, inputs: dict, buffers=None) -> StepGraphs:
        """The entry of `key` with `inputs` loaded into its static buffers;
        a new entry also holds `buffers()`, the buffers the body writes
        (made once; the caller resets what it must)."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = StepGraphs(inputs, self, buffers)
            while len(self.entries) > self.size:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
            entry.load(inputs)
        return entry
