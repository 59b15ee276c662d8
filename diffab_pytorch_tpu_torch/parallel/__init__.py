"""Data parallelism over processes, one per card
(`diffab_pytorch_tpu/parallel/`): `mesh` places batches and state on a
process group, `dp` holds the data-parallel train step and the sharded
design fan-out and scoring.  Import them from those modules."""
