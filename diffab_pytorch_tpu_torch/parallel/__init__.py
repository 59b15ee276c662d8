"""Data and tensor parallelism over processes, one per card
(`diffab_pytorch_tpu/parallel/`): `mesh` places batches and state on a
process group and lays out the (dp, tp) mesh and the split of the
parameters over tp, `dp` holds the data-parallel train step and the
sharded design fan-out and scoring, `tp` the tensor-parallel train step
and the sharded state.  Import them from those modules."""
