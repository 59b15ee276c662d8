"""Command-line entry points: `python -m diffab_pytorch_tpu_torch.cli.sample`
and `python -m diffab_pytorch_tpu_torch.cli.evaluate`."""
