"""Command-line entry points: `python -m diffab_pytorch_tpu_torch.cli.<name>`
for preprocess, train, sample and evaluate."""
