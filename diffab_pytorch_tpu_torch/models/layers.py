"""Dense and embedding layers with the JAX package's dtype rule: the
parameters stay float32 and are cast, with the input, to the compute dtype
at use (flax `Dense(dtype=...)` / `Embed(dtype=...)`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """`nn.Linear` computed in `compute_dtype`.  The weight is (out, in),
    the transpose of a flax Dense kernel."""

    def __init__(self, d_in: int, d_out: int, compute_dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The (in, out) matrix in `dtype`."""
        return self.weight.t().to(dtype)


class Embedding(nn.Embedding):
    """`nn.Embedding` whose rows come out in `compute_dtype`."""

    def __init__(self, n: int, d: int, compute_dtype: torch.dtype):
        super().__init__(n, d)
        self.compute_dtype = compute_dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.to(self.compute_dtype))


class MLPHead(nn.Module):
    """3-layer ReLU MLP head (dense_0, dense_1, dense_2)."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, dt: torch.dtype):
        super().__init__()
        self.dense_0 = Linear(d_in, d_hidden, dt)
        self.dense_1 = Linear(d_hidden, d_hidden, dt)
        self.dense_2 = Linear(d_hidden, d_out, dt)

    def forward(self, x):
        x = torch.relu(self.dense_0(x))
        x = torch.relu(self.dense_1(x))
        return self.dense_2(x)
