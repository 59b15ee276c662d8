"""Tracing and timing helpers (`diffab_pytorch_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace (host ops and, where there is a
card, its kernels) and writes it as a Chrome trace; `StepTimer` and
`block_and_time` time steps on the wall clock, waiting for the card first.

Spans and counters mark the port's layer boundaries (`sample()` and its
steps, scoring, relax, `fit()` and its loader, graph captures, kernel
builds):

  * `span(name)` is a context manager; `named_scope(name)` its decorator
    form.  While a torch profiler records, a span opens
    `torch.profiler.record_function(name)`, so it sits in the profiler's
    trace on the same clock as the ops and kernels under it, and appends a
    `SpanRecord` to a bounded in-memory buffer (`records()`): its name,
    start and end on `time.perf_counter`, its parent span on the same
    thread and the call it belongs to.  With no profiler recording, a span
    costs one check and does nothing else.
  * `count(name, value)` adds to a process-wide counter (`counters()`),
    always on; it marks rare boundaries only (captures, builds, loader
    batches).

    with trace("runs/trace"):             # open the .json in chrome://tracing or Perfetto
        run_steps(...)

    @named_scope("denoiser")
    def denoise(...): ...
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# records kept at most; the oldest go first and are counted in `dropped()`
SPAN_BUFFER = 65536


def _sync() -> None:
    """Wait for the current card's queued work (nothing without a card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, file_name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """Profile the body (CPU ops, and CUDA kernels where there is a card)
    and write a Chrome trace to `log_dir`/`file_name` on exit, also when
    the body raises.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, file_name))


# ---------------------------------------------------------------------------
# spans and counters


class SpanRecord(NamedTuple):
    """One closed span: `start` and `end` in `time.perf_counter` seconds;
    `parent` the id of the span open around it on the same thread (None
    at the top); `call` the call it belongs to (a `sample()`,
    `score_designs()` or `relax_ca()` call's number, or the training
    step), which its children share."""

    id: int
    name: str
    start: float
    end: float
    parent: Optional[int]
    call: Optional[int]
    thread: int


_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_dropped = 0
_counters: dict = {}
_ids = itertools.count()
_calls = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "call", "id", "parent", "start", "_rf")

    def __init__(self, name: str, call: Optional[int]):
        self.name, self.call = name, call

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.id
        if self.call is None:
            self.call = next(_calls) if up is None else up.call
        self.id = next(_ids)
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        record = SpanRecord(self.id, self.name, self.start, end, self.parent, self.call,
                            threading.get_ident())
        global _dropped
        with _lock:
            if len(_records) == _records.maxlen:
                _dropped += 1
            _records.append(record)
        return False


class _Off:
    """The span with no profiler recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, call: Optional[int] = None):
    """A named span around the body (see the module docstring).  `call`:
    the call the span belongs to; by default its parent's, or at the top a
    new number."""
    # the profiler's process-wide flag: `torch.autograd._profiler_enabled()`
    # is per thread and stays false on a thread the profiler was not started
    # from, such as the loader's worker
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, call)


def named_scope(name: str) -> Callable:
    """Decorator: the function's body runs inside `span(name)`, a named
    span in traces."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def count(name: str, value: float = 1) -> None:
    """Add `value` to counter `name` (always on, from any thread)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def counters() -> dict:
    """{name: total} of every counter so far."""
    with _lock:
        return dict(_counters)


def records() -> list:
    """The buffered `SpanRecord`s, oldest first (in the order they closed)."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records the full buffer let go."""
    return _dropped


def reset() -> None:
    """Empty the buffer and the counters."""
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0


# ---------------------------------------------------------------------------
# wall-clock timers


class StepTimer:
    """Wall-clock steps/s between ticks, each tick after waiting for the card."""

    def __init__(self):
        self._t = None
        self._steps = 0

    def tick(self, n: int = 1) -> Optional[float]:
        """Count n steps; returns steps/s since the last tick, or None on
        the first call."""
        _sync()
        now = time.perf_counter()
        if self._t is None:
            self._t, self._steps = now, 0
            return None
        self._steps += n
        dt = now - self._t
        if dt <= 0:
            return None
        rate = self._steps / dt
        self._t, self._steps = now, 0
        return rate


def block_and_time(fn: Callable, *args, iters: int = 3, **kwargs) -> float:
    """One warm-up call, then the seconds per call over `iters` calls, the
    card waited for after the warm-up and after the last call."""
    fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters
