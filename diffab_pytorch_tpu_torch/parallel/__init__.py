"""Data and tensor parallelism over processes, one per card
(`diffab_pytorch_tpu/parallel/`): `mesh` places batches and state on a
process group and lays out the (dp, tp) mesh and the split of the
parameters over tp, `dp` holds the data-parallel train step and the
sharded sampling, design fan-out and scoring, `tp` the tensor-parallel
train step and the sharded state.

The JAX package's names are importable from here too, loaded on first use
(so that importing one of the modules does not import the others)."""

import importlib

# public name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("DP_AXIS", "TP_AXIS", "batch_sharding", "make_mesh", "param_sharding",
                     "put_global", "replicated"), "mesh"),
    **dict.fromkeys(("make_dp_train_step", "replicate_batch", "sample_fanout_sharded",
                     "sample_sharded", "score_fanout_sharded"), "dp"),
    **dict.fromkeys(("make_sharded_train_step", "shard_state"), "tp"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
