"""Training: losses, the harness (optimizer, train/eval steps), checkpoints
and the training loop."""
