"""Batch schema and synthetic batches."""
