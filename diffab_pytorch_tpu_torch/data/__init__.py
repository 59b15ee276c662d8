"""Batch schema and synthetic batches, the patch dataset, the prefetch
loader and the synthetic family corpus."""
