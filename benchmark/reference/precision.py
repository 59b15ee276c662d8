"""The precision of the reference's products.

The reference computes in float32 with TF32 off.  The controls of the
correctness check are the same reference one precision lower: every matrix
product (`Precision.mm`) rounds its operands first, and so do the two
products of its backward, the incoming gradient rounded too; everything
else stays float32.

  f32   float32 operands, TF32 off (the reference itself)
  tf32  operands rounded to TF32's 10-bit mantissa, products in float32
  fp8   operands scaled per tensor into float8 e4m3 and back, products in
        bfloat16
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on a 10-bit mantissa (ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3, returned in bfloat16."""
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / _E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(torch.bfloat16)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """t summed over the dimensions that broadcasting added to `shape`."""
    while t.dim() > len(shape):
        t = t.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and t.shape[i] != 1:
            t = t.sum(i, keepdim=True)
    return t


class _RoundedMM(torch.autograd.Function):
    """a @ b on operands rounded by `rnd`, in the dtype `rnd` returns; the
    backward's products round the incoming gradient the same way."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        qa, qb = rnd(a.detach()), rnd(b.detach())
        ctx.save_for_backward(qa, qb)
        ctx.rnd, ctx.shapes = rnd, (a.shape, b.shape)
        return (qa @ qb).float()

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.rnd(g)
        ga = (qg @ qb.transpose(-1, -2)).float()
        gb = (qa.transpose(-1, -2) @ qg).float()
        return _sum_to(ga, ctx.shapes[0]), _sum_to(gb, ctx.shapes[1]), None


_ROUND = {"tf32": lambda x: _round_tf32(x.float()), "fp8": _round_fp8}


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """x at this precision; gradients pass the rounding unchanged."""
        x = x.float()
        if self.mode == "tf32":
            return x + (_round_tf32(x.detach()) - x.detach())
        if self.mode == "fp8":
            xb = x.to(torch.bfloat16)
            return xb + (_round_fp8(x.detach()) - xb.detach())
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched) with both operands at this precision, and the
        backward's products too; float32 out."""
        if self.mode == "f32":
            return a.float() @ b.float()
        return _RoundedMM.apply(a.float(), b.float(), _ROUND[self.mode])

    def linear(self, x, weight, bias=None):
        """x @ weight^T + bias, weight (out, in) as nn.Linear stores it."""
        out = self.mm(x, weight.t())
        return out if bias is None else out + bias.float()

    def __repr__(self) -> str:
        return f"Precision({self.mode!r})"


def f32_matmuls():
    """A context in which float32 products run in float32 (TF32 off)."""
    return _TF32Off()


class _TF32Off:
    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
