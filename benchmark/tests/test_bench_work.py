"""The yardstick's arithmetic: model FLOPs, rooflines, mfu, window statistics."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import readers, stats, work
from benchmark.lib.weights import make_params
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision
from benchmark.tests.conftest import TINY_MODEL


def _tiny_conf():
    import json

    from benchmark.run import ROOT

    with open(ROOT / "benchmark/configs/diffab-codesign.json") as fh:
        conf = json.load(fh)
    conf["model"].update(TINY_MODEL)
    return conf


def _batch(b, L, c, seed=0):
    """A random, internally consistent batch of the reference's inputs."""
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch_numpy

    arrays = synthetic_batch_numpy(seed, batch_size=b, n_residues=L, n_atoms=c["n_atoms"])
    out = {}
    for k, v in arrays.items():
        if v is None:
            continue
        t = torch.as_tensor(v)
        out[k] = t.long() if t.dtype in (torch.int32, torch.int16, torch.uint8, torch.int8) \
            else t
    return out


def _params(c, seed=0):
    from diffab_pytorch_tpu_torch.config import ModelConfig
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel

    model = DiffAbModel(ModelConfig(**c), device="cpu")
    return make_params({n: tuple(p.shape) for n, p in model.named_parameters()}, seed, "cpu")


@pytest.mark.parametrize("b,bp", [(2, 2), (6, 2)])
def test_denoiser_flops_equal_the_counted_products_of_the_reference(b, bp):
    c = _tiny_conf()["model"]
    L = 24
    P = _params(c)
    batch = _batch(bp, L, c)
    prec = Precision("f32")
    with FlopCounterMode(display=False) as fc:
        res, pair = ref_model.encode_context(P, c, batch, prec)
    assert fc.get_total_flops() == work.context_flops(c, bp, L)
    rep = lambda a: torch.repeat_interleave(a, b // bp, 0)
    with FlopCounterMode(display=False) as fc:
        ref_model.denoise(P, c, rep(batch["seq_idx"]), rep(batch["xyz"][:, :, 1]),
                          rep(batch["orientations"]), res, pair, torch.full((b,), 0.1),
                          rep(batch["residue_mask"]), prec)
    assert fc.get_total_flops() == work.denoiser_flops(c, b, bp, L)
    hoisted = work.denoiser_flops(c, b, bp, L, pair_bias=False) + work.pair_bias_flops(c, bp, L)
    assert hoisted == work.denoiser_flops(c, b, bp, L)


def test_job_and_step_flops_compose_the_parts():
    c = _tiny_conf()["model"]
    assert work.sample_job_flops(c, 8, 16, 10) == (
        work.context_flops(c, 1, 16) + work.pair_bias_flops(c, 1, 16)
        + 10 * work.denoiser_flops(c, 8, 1, 16, pair_bias=False))
    assert work.train_step_flops(c, 4, 16) == 3 * (work.context_flops(c, 4, 16)
                                                   + work.denoiser_flops(c, 4, 4, 16))


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert work.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12, "float32") == pytest.approx(1.0)
    assert work.bound_s(494.7e12 / 3, 0.0, "float32") == pytest.approx(1.0)


def _sample_record(k1_s, units=2, window_s=10.0, jobs_ok=20):
    c = _tiny_conf()["model"]
    kernels = {"void ipa::layer_heads_kernel<float>(...)": [units * 10 * 2, k1_s * 0.75],
               "void ipa::out_proj_kernel<float>(...)": [units * 10 * 2, k1_s * 0.25],
               "Memcpy DtoH": [3, 0.5], "elementwise": [100, 1.0]}
    prof = dict(kernels=kernels, units=units, busy_s=2.0, window_s=4.0)
    jobs = [dict(t0=0.0, t_sample=0.1, t_end=0.2, ok=True)] * jobs_ok + [
        dict(t0=0.0, t_sample=0.1, t_end=0.2, ok=False)]
    return dict(kind="sample", model=c, dtype="float32", n_designs=8, L=16,
                denoiser_calls=10, profile=prof, jobs=jobs, window_s=window_s,
                job_flops=1e12, peak_window_bytes=3 * 2 ** 30)


def test_k1_roofline_is_the_applications_bound_over_k1_time():
    rec = _sample_record(k1_s=0.5)
    c = rec["model"]
    flops, n_bytes = work.ipa_layer_flops_bytes(8, 1, 16, c["d_residue_emb"], c["n_head"],
                                                c["d_scalar_per_head"],
                                                c["n_value_point_per_head"], 4, 4)
    apps = 2 * 10 * c["n_ipa_layers"]
    names = ("layer_heads_kernel", "out_proj_kernel", "attend_kernel")
    assert readers.k1_roofline(rec, names) == pytest.approx(
        100 * apps * work.bound_s(flops, n_bytes, "float32") / 0.5)
    rec["profile"]["kernels"] = {"elementwise": [1, 1.0]}
    assert readers.k1_roofline(rec, names) is None  # no K1 time: nothing, never 0


def test_mfu_idle_kernels_and_memory():
    rec = _sample_record(k1_s=0.5)
    assert readers.mfu(rec) == pytest.approx(100 * 20e12 / (10.0 * 494.7e12 / 3))
    assert readers.idle_share(rec) == pytest.approx(50.0)
    assert readers.kernels_per_unit(rec) == pytest.approx((40 + 40 + 100) / 2)
    assert readers.peak_gib(rec) == pytest.approx(3.0)
    train = dict(kind="train", step_flops=2e9, steps=100, window_s=2.0, dtype="bfloat16")
    assert readers.mfu(train) == pytest.approx(100 * 2e11 / (2.0 * 989e12))


def _e2e(latencies, gap=0.0, n=128):
    """A closed loop's record: jobs back to back, `gap` host seconds between."""
    from benchmark.drivers.design_jobs import Run

    jobs, t = [], 0.0
    for lat in latencies:
        ok = math.isfinite(lat)
        d = lat if ok else 0.3
        jobs.append(dict(t0=t, t_sample=t + d * 0.9, t_end=t + d, ok=ok))
        t += d + gap
    return Run.e2e(SimpleNamespace(jobs=jobs, n=n, window_s=jobs[-1]["t_end"], mix={}))


def test_a_stall_moves_both_the_rate_and_the_p90():
    steady = _e2e([0.27] * 8)
    stalled = _e2e([0.27] * 7 + [2.27])
    assert stalled["designs_per_s"] < 0.6 * steady["designs_per_s"]
    assert stalled["design_job_p90_ms"] == pytest.approx(2270.0)
    assert steady["design_job_p90_ms"] == pytest.approx(270.0)
    assert steady["designs_per_s"] == pytest.approx(128 / 0.27)


def test_a_failed_job_is_missing_from_the_rate_and_slowest_in_the_tail():
    out = _e2e([0.27] * 9 + [math.inf])
    assert out["designs_per_s"] == pytest.approx(9 * 128 / (9 * 0.27 + 0.3))
    assert out["design_job_p90_ms"] == pytest.approx(270.0)
    assert stats.percentile([1.0] * 9 + [math.inf], 95) == math.inf
