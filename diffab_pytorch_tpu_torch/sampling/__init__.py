"""The reverse-diffusion sampler."""
