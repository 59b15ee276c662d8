"""Build the port's CUDA kernels from the sources in `csrc/` at first use.

Each `csrc/<name>.cu` becomes one shared library with a plain C
interface, compiled by `nvcc` for `sm_90a` and loaded with `ctypes`.  The
output goes to `build/kernels/` at the repository root, keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is reused.  `build_all` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}
# callables (kernel name, output tensors) that every wrapper runs after a
# launch: the debug mode's check of the kernels' outputs (`utils/debug.py`)
launch_checks: list = []
# {counted wrapper: launches, counter name: value} of the CUDA graph being
# captured, None outside a capture (`utils/graphs.py` opens it with
# `capturing`)
_tally: dict | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # .cu and shared .cuh headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is already built.
    Returns (library path, process or None, temporary output path)."""
    lib = _library_path(name)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, proc, tmp


def _finish(name: str, lib: Path, proc, tmp) -> None:
    if proc is not None:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)


def build_all() -> float:
    """Build (or reuse) every csrc/*.cu library in parallel; returns the
    seconds taken."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    for n, job in started.items():
        _finish(n, *job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        lib, proc, tmp = _start(name)
        _finish(name, lib, proc, tmp)
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]


def launched(name: str, *outputs) -> None:
    """Run the launch checks on a kernel's outputs (none outside a debug run).
    Inside a capture none runs: a check reads the outputs back, which a
    capture cannot do, and nothing has run yet."""
    if _tally is not None:
        return
    for check in launch_checks:
        check(name, outputs)


def count_launch(counted, name: str, *outputs) -> None:
    """Book one launch of kernel `name` by the wrapper `counted`: outside a
    capture `counted.launches` += 1, then the launch checks; inside one the
    launch goes into the graph's tally, which each replay adds to the
    counts (`replayed`)."""
    if _tally is not None:
        _tally[counted] = _tally.get(counted, 0) + 1
        return
    counted.launches += 1
    launched(name, *outputs)


def count(name: str, value: float = 1) -> None:
    """Book `value` to the port's counter `name` (`utils/profiling.py
    count`) for a launch, as `count_launch` books the launch: outside a
    capture at once; inside one into the graph's tally, which each replay
    adds to the counter (`replayed`)."""
    if _tally is not None:
        _tally[name] = _tally.get(name, 0) + value
        return
    from diffab_pytorch_tpu_torch.utils import profiling

    profiling.count(name, value)


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured: yields the {wrapper: launches,
    counter name: value} tally that `count_launch` and `count` fill."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a graph capture is already in progress")
    _tally = {}
    try:
        yield _tally
    finally:
        _tally = None


def replayed(tally: dict) -> None:
    """Count the launches and counters of one replay of a graph captured
    with `tally`."""
    for counted, n in tally.items():
        if isinstance(counted, str):
            count(counted, n)
        else:
            counted.launches += n
