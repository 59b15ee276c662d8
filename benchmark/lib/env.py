"""The run's surroundings: cache directories, the card, forbidden modules.

Every build and kernel cache lives at a fixed path inside the checkout
(`build/`, which git ignores): the port's own kernel and native builds go
to `build/kernels/` and `build/native/`, and PyTorch's and Triton's caches
are pointed at `build/bench-cache/`.  Scratch data goes to a directory
under `TMPDIR` that the run deletes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "bench-cache"

# top-level module names that may not be loaded (JAX, its libraries and the
# JAX package the port was made from), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffab_pytorch_tpu")


def set_cache_dirs() -> None:
    """Point PyTorch's extension and Triton's kernel caches into the checkout
    (before torch is imported)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names that `sys.modules` holds."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi gave nothing"


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
