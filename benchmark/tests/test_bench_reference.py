"""The reference follows the port: at tiny size on the CPU in float32 the
check's numbers sit at float32 rounding, far under any limit; and the
control precisions round as they say."""

from __future__ import annotations

import pytest
import torch

from benchmark.reference.precision import Precision


@pytest.mark.parametrize("cell", ["production-t100-fan128", "codesign-t100-fan128"])
def test_the_design_reference_is_the_port_in_float32(run_cell, cell):
    rc, result = run_cell(cell, seed=2 ** 31 + 7)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["seq_gap"] == 0.0
    assert checks["x_gap"] < 1e-4 and checks["r_gap"] < 1e-4
    assert checks["designs_off"] == 0 and checks["jobs_unfollowed"] == 0


def test_the_training_reference_is_the_port_in_float32(run_cell):
    rc, result = run_cell("production-train-b32", seed=2 ** 31 + 9)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["rows_off"] == 0
    assert checks["loss_gap"] < 1e-5
    assert checks["grad_gap"] < 1e-4 and checks["change_gap"] < 1e-4


def test_the_precisions_round_their_operands():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -8, 3.0, -0.1])
    assert torch.equal(Precision("f32").operand(x), x)
    assert Precision("tf32").operand(x)[0] == 1.0  # below TF32's 10-bit mantissa
    assert Precision("tf32").operand(x)[1] == 1.0 + 2 ** -8
    assert Precision("fp8").operand(x).dtype == torch.bfloat16  # products in bfloat16
    fp8 = Precision("fp8").operand(x).float()
    assert fp8[2] == 3.0  # the largest entry maps onto e4m3's largest, 448, exactly
    assert ((fp8 - x).abs() <= x.abs() * 2 ** -4).all()  # 3 mantissa bits: half a step
    assert fp8[1] != x[1]  # 1 + 2^-8 lies between two e4m3 steps at this scale
    w = torch.randn(8, 8, requires_grad=True)
    Precision("fp8").linear(torch.randn(4, 8), w).sum().backward()
    assert w.grad.abs().sum() > 0  # gradients pass the rounding
