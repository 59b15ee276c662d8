"""Tracing and timing helpers (`diffab_pytorch_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace (host ops and, where there is a
card, its kernels) and writes it as a Chrome trace; `named_scope` labels a
function's ops in it; `StepTimer` and `block_and_time` time steps on the
wall clock, waiting for the card first.

    with trace("runs/trace"):             # open the .json in chrome://tracing or Perfetto
        run_steps(...)

    @named_scope("denoiser")
    def denoise(...): ...
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterator, Optional

import torch


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


def named_scope(name: str) -> Callable:
    """Decorator: the function's ops run inside
    `torch.profiler.record_function(name)`, a named span in traces."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


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
