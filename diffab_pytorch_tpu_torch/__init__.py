"""diffab_pytorch_tpu_torch — the PyTorch and CUDA port of diffab_pytorch_tpu.

The JAX package beside it is the reference this port is held against; the
port imports torch and numpy only, never JAX or the JAX package.  Entry
points run on the CUDA card unless the caller passes device="cpu".

    from diffab_pytorch_tpu_torch import DiffAbModel, default_config, sample
    from diffab_pytorch_tpu_torch import DiffAb, PatchDataset, fit, production_config

The names below are imported on first use, so that a process that needs
only the numpy structure layer (the preprocessing workers) does not import
torch.
"""

import importlib

__version__ = "0.1.0"

# public name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("DataConfig", "DiffAbConfig", "DiffusionConfig", "ModelConfig",
                     "TrainConfig", "default_config", "production_config", "resolve_device",
                     "tiny_config"), "config"),
    "ProteinBatch": "data.batch",
    "synthetic_batch": "data.batch",
    "PatchDataset": "data.dataset",
    "DiffAbModel": "models.diffab",
    "SampleResult": "sampling.sampler",
    "sample": "sampling.sampler",
    "DiffAb": "train.harness",
    "TrainState": "train.harness",
    "fit": "train.trainer",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
