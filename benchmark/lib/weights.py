"""Random weights from the run's seed, made on the device in a few calls.

One standard normal draw fills every parameter at once; each is then
scaled by its kind: dense kernels by 1/sqrt(fan in) (LeCun), embedding
tables by 1/sqrt(width), biases by 0.02, and the IPA layers' point weight
gamma sits at softplus^-1(1) = log(e - 1) with a spread of 0.1.  The
weights are float32, as the port keeps its parameters (products run in
the configuration's compute dtype).  Both the port and the reference are
given these tensors.
"""

from __future__ import annotations

import math

import torch

_GAMMA = math.log(math.e - 1.0)


def _kind(name: str, shape) -> tuple[float, float]:
    """(scale, offset) of a parameter's standard normal draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return 0.1, _GAMMA
    if leaf == "bias":
        return 0.02, 0.0
    if len(shape) == 2:  # dense (out, in) or an embedding table (rows, width)
        return 1.0 / math.sqrt(shape[1]), 0.0
    raise ValueError(f"no weight rule for parameter {name} of shape {tuple(shape)}")


def make_params(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor of shapes[name]} on `device` from `seed`."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    rules = [_kind(n, shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).normal_(generator=g)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor([r[0] for r in rules], device=device), counts)
    offset = torch.repeat_interleave(torch.tensor([r[1] for r in rules], device=device), counts)
    flat = flat * scale + offset
    return {n: t.view(shapes[n]) for n, t in zip(names, torch.split(flat, sizes))}
