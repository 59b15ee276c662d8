"""With the timed path broken underneath, `correct` comes out false.

Each test drives a whole run of a cell on the CPU at tiny size and float32
(the look for a card skipped), under the cell's own limits, with one fault
planted in the port: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced, one design's
coordinates moved, a leaf's gradient left out of the steps after the first
(the graph's replays on the card).  A sound run of the
same size passes.  (One card per cell: no exchange between chips to leave
out.)
"""

from __future__ import annotations

import pytest
import torch

DESIGN_CELLS = ["production-t100-fan128", "codesign-t100-fan128", "codesign-chord10-ranked"]


@pytest.mark.parametrize("cell", DESIGN_CELLS + ["production-train-b32"])
def test_a_sound_run_is_correct(run_cell, cell):
    rc, result = run_cell(cell)
    assert rc == 0 and result["correct"], result["checks"]


def _unchanged_state(monkeypatch):
    from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence

    def keep(_, state, *a, **k):
        return state

    for module in (coordinate, orientation, sequence):
        monkeypatch.setattr(module, "reverse_step", keep)


def _half_of_the_designs(monkeypatch):
    """The second half of each call's designs is never denoised: its
    predicted noise is zero and its p(s_0) uniform."""
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel

    real = DiffAbModel.denoise

    def denoise(self, seq, *a, **k):
        out = real(self, seq, *a, **k)
        h = seq.shape[0] // 2
        out["translations_eps"] = torch.cat([out["translations_eps"][:h],
                                             torch.zeros_like(out["translations_eps"][h:])])
        p = out["seq_posterior"]
        out["seq_posterior"] = torch.cat([p[:h], torch.full_like(p[h:], 1.0 / p.shape[-1])])
        return out
    monkeypatch.setattr(DiffAbModel, "denoise", denoise)


def _token_altered(monkeypatch):
    """One generated residue's type moved by one where the step draws it."""
    from diffab_pytorch_tpu_torch.diffusion import sequence

    real = sequence.reverse_step

    def reverse_step(sched, seq_t, s0_probs, t, generation_mask, **k):
        out = real(sched, seq_t, s0_probs, t, generation_mask, **k).clone()
        i = int(generation_mask[0].nonzero()[0, 0])
        out[0, i] = (out[0, i] + 1) % s0_probs.shape[-1]
        return out
    monkeypatch.setattr(sequence, "reverse_step", reverse_step)


@pytest.mark.parametrize("cell", DESIGN_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_of_the_designs, _token_altered],
                         ids=["unchanged-state", "half-the-designs", "token-altered"])
def test_a_fault_in_the_design_job_is_caught(run_cell, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", DESIGN_CELLS)
def test_one_design_moved_is_caught(run_cell, monkeypatch, cell):
    """Design 0's generated translations moved at every step by twice the
    cell's x_gap limit: read per design, not diluted over the designs."""
    import json

    from benchmark.run import HERE
    from diffab_pytorch_tpu_torch.diffusion import coordinate

    shift = 2 * json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]["x_gap"]
    real = coordinate.reverse_step

    def reverse_step(sched, translations_t, eps_hat, t, generation_mask, **k):
        out = real(sched, translations_t, eps_hat, t, generation_mask, **k).clone()
        out[0, :, 0] += shift * generation_mask[0].to(out.dtype)
        return out
    monkeypatch.setattr(coordinate, "reverse_step", reverse_step)
    rc, result = run_cell(cell)
    assert rc == 0 and not result["correct"], result["checks"]
    assert result["checks"]["x_gap"]["value"] > result["checks"]["x_gap"]["limit"]


def _ranks_reversed(monkeypatch):
    """The ranking answered worst first."""
    from diffab_pytorch_tpu_torch.sampling import scoring

    real = scoring.rank_per_target
    monkeypatch.setattr(scoring, "rank_per_target",
                        lambda scores, n: real(scores, n).flip(-1))


def _relax_skipped(monkeypatch):
    """The relaxation returns the designs as it was given them."""
    from diffab_pytorch_tpu_torch.structure import relax

    monkeypatch.setattr(relax, "relax_ca", lambda translations, *a, **k: translations)


@pytest.mark.parametrize("fault", [_ranks_reversed, _relax_skipped],
                         ids=["ranks-reversed", "relax-skipped"])
def test_a_fault_in_the_ranked_job_is_caught(run_cell, monkeypatch, fault):
    fault(monkeypatch)
    rc, result = run_cell("codesign-chord10-ranked")
    assert rc == 0 and not result["correct"], result["checks"]


def _no_update(monkeypatch):
    from diffab_pytorch_tpu_torch.train import harness

    monkeypatch.setattr(harness.DiffAb, "apply_gradients",
                        lambda self, state, grads, **k: harness._advanced(state, 1))


def _half_of_the_batch(monkeypatch):
    """The loss is the mean over the batch's first half only."""
    from diffab_pytorch_tpu_torch.train import harness

    real = harness.DiffAb.loss_fn

    def loss_fn(self, params, batch, draws, *a, **k):
        h = batch.batch_size // 2
        half = batch._map(lambda v: v[:h])
        d = harness.StepDraws(*(x[:h] for x in draws[:4]),
                              harness.AxisAngleNoise(*(x[:h] for x in draws.orientation)))
        return real(self, params, half, d, *a, **k)
    monkeypatch.setattr(harness.DiffAb, "loss_fn", loss_fn)


def _loss_altered(monkeypatch):
    """The step's reported loss is off by 1% where the step computes it."""
    from diffab_pytorch_tpu_torch.train import harness

    real = harness.DiffAb.loss_fn

    def loss_fn(self, *a, **k):
        loss, metrics = real(self, *a, **k)
        return loss, dict(metrics, loss=metrics["loss"] * 1.01)
    monkeypatch.setattr(harness.DiffAb, "loss_fn", loss_fn)


def _leaf_left_out_after_the_first_step(monkeypatch):
    """From the second step on (the graph's replays on the card), the
    largest leaf's gradient is left out of the update."""
    from diffab_pytorch_tpu_torch.train import harness

    real = harness.DiffAb.apply_gradients
    calls = []

    def apply_gradients(self, state, grads, *a, **k):
        calls.append(1)
        if len(calls) > 1:
            big = max(grads, key=lambda n: grads[n].numel())
            grads = dict(grads, **{big: torch.zeros_like(grads[big])})
        return real(self, state, grads, *a, **k)
    monkeypatch.setattr(harness.DiffAb, "apply_gradients", apply_gradients)


@pytest.mark.parametrize("fault", [_no_update, _half_of_the_batch, _loss_altered,
                                   _leaf_left_out_after_the_first_step],
                         ids=["unchanged-state", "half-the-batch", "loss-altered",
                              "leaf-left-out-after-step-0"])
def test_a_fault_in_the_training_step_is_caught(run_cell, monkeypatch, fault):
    fault(monkeypatch)
    rc, result = run_cell("production-train-b32")
    assert rc == 0 and not result["correct"], result["checks"]
