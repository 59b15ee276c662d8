"""Random weights for the official DiffAb network (`lib/weights.py`'s, plus
its LayerNorms): every parameter as `weights.make_params` draws it from the
seed, and each LayerNorm's scale (the one kind of vector that rule has no
entry for) 1 + 0.1 N(0, 1), drawn in one call from a seed of its own."""

from __future__ import annotations

import math

import torch

from benchmark.lib import inputs, weights


def is_norm_scale(name: str) -> bool:
    return ".layer_norm_" in name and name.endswith(".weight")


def make_params(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor of shapes[name]} on `device` from `seed`."""
    scales = [n for n in shapes if is_norm_scale(n)]
    out = weights.make_params({n: s for n, s in shapes.items() if n not in scales}, seed, device)
    sizes = [math.prod(shapes[n]) for n in scales]
    g = torch.Generator(device=device).manual_seed(inputs.derive("layer_norm", seed))
    flat = 1.0 + 0.1 * torch.empty(sum(sizes), device=device).normal_(generator=g)
    out.update({n: t.view(shapes[n]) for n, t in zip(scales, torch.split(flat, sizes))})
    return {n: out[n] for n in shapes}
