"""`pool_train_step(steps_per_call=k)`, the debug mode (`utils/debug.py`)
and the profiling helpers (`utils/profiling.py`) of the port, on the CPU.

k steps a call are the chain of k one-step calls bit for bit, and that
chain follows JAX `make_pool_train_step(steps_per_call=2)` fed the draws
JAX takes from its key at each step (tests/test_torch_train.py
`jax_draws`), held as tests/test_torch_parallel.py holds whole steps
against JAX: the metrics within 1e-3, the parameters and the EMA within
1e-3 of each leaf's largest entry, at lr 3e-2 so that the two steps move
every leaf by more than ten times that.

`checked_fn` is held to JAX's checkify on the same inputs (a finite
result passes with the same value; a NaN raises, naming the op; an
out-of-range index and an integer division by zero raise), to the
unchecked call bit for bit on a clean training step and a clean denoiser
forward (no false alarm), and names the first op a NaN parameter reaches.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb
from diffab_pytorch_tpu.utils import debug as jdebug
from diffab_pytorch_tpu.utils import profiling as jprofiling

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.train.harness import DiffAb, TrainState
from diffab_pytorch_tpu_torch.utils import debug as tdebug
from diffab_pytorch_tpu_torch.utils import profiling as tprofiling
from diffab_pytorch_tpu_torch.weights import opt_state_from_jax, params_from_jax
from test_torch_train import DIFFUSION, jax_batch, jax_draws, port_config

N_POOL, L = 5, 24
IDX = np.array([[3, 0], [1, 4]])  # (k, b): two steps of two rows


@pytest.fixture(scope="module")
def setup():
    arrays = synthetic_batch_numpy(1, N_POOL, L, 15, n_generate=6)
    jcfg = dataclasses.replace(
        jconfig.tiny_config(), diffusion=jconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(jconfig.tiny_config().train, batch_size=2, mode_dropout=0.3,
                                  lr=3e-2, grad_clip_norm=1.0, update_clip_rms=1.0,
                                  ema_decay=0.9))
    jh = JaxDiffAb(jcfg)
    jpool = jax_batch(arrays)
    jstate = jh.init(jax.random.key(0), jax.tree.map(lambda x: x[:2], jpool))
    harness = DiffAb(port_config(jcfg), device="cpu")
    host = jax.device_get(jstate)

    def port_state():
        params = params_from_jax(host.params)
        return TrainState(0, {k: v.requires_grad_(True) for k, v in params.items()},
                          opt_state_from_jax(host.opt_state), params_from_jax(host.ema_params))
    return dict(jh=jh, jpool=jpool, jstate=jstate, harness=harness, port_state=port_state,
                pool=ProteinBatch.from_numpy(arrays))


def leaf_err(actual: dict, expected: dict) -> float:
    """max over leaves of max |actual - expected| over 1e-3 of the leaf's
    scale (max |expected|, at least 1): at most 1 within the tolerance."""
    return max(float((actual[k].detach() - v).abs().max())
               / (1e-3 * max(float(v.abs().max()), 1.0)) for k, v in expected.items())


def test_steps_per_call_is_the_one_step_chain(setup):
    harness, pool = setup["harness"], setup["pool"]
    idx = torch.from_numpy(IDX)
    draws = [harness.draw(pool.gather_rows(i), torch.Generator().manual_seed(7 + s))
             for s, i in enumerate(idx)]
    chain, metrics = setup["port_state"](), []
    for i, d in zip(idx, draws):
        chain, m = harness.pool_train_step(chain, pool, i, d)
        metrics.append(m)
    multi, stacked = harness.pool_train_step(setup["port_state"](), pool, idx, draws,
                                             steps_per_call=2)
    assert multi.step == chain.step == 2 and multi.opt_state.count == 2
    assert set(stacked) == set(metrics[0])
    for k, v in stacked.items():
        assert v.shape == (2,)
        assert torch.equal(v, torch.stack([m[k] for m in metrics])), k
    for k in chain.params:
        assert torch.equal(multi.params[k], chain.params[k]), k
        assert torch.equal(multi.ema_params[k], chain.ema_params[k]), k
        assert torch.equal(multi.opt_state.mu[k], chain.opt_state.mu[k]), k
        assert torch.equal(multi.opt_state.nu[k], chain.opt_state.nu[k]), k
    with pytest.raises(ValueError, match="steps_per_call=3"):
        harness.pool_train_step(setup["port_state"](), pool, idx, draws, steps_per_call=3)


def test_steps_per_call_follows_jax(setup):
    jh, harness = setup["jh"], setup["harness"]
    key = jax.random.key(5)
    step = jh.make_pool_train_step(donate=False, steps_per_call=2)
    jstate, jm = step(setup["jstate"], setup["jpool"], jnp.asarray(IDX, jnp.int32), key)
    # JAX's train step folds the state's step into the key, then draws
    draws = [jax_draws(jax.random.fold_in(key, s), IDX.shape[1], L) for s in range(2)]
    state, m = harness.pool_train_step(setup["port_state"](), setup["pool"],
                                       torch.from_numpy(IDX), draws, steps_per_call=2)
    assert int(jstate.step) == state.step == 2
    jm = jax.device_get(jm)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), jm[k], atol=1e-3, rtol=1e-4, err_msg=k)
    want = params_from_jax(jax.device_get(jstate.params))
    assert leaf_err(state.params, want) <= 1
    assert leaf_err(state.ema_params, params_from_jax(jax.device_get(jstate.ema_params))) <= 1
    p0 = setup["port_state"]().params
    assert min(leaf_err({k: p0[k]}, {k: v}) for k, v in want.items()) > 10


# ---- the debug mode ------------------------------------------------------------------


def test_checked_fn_matches_checkify_on_a_log():
    f_t = tdebug.checked_fn(lambda x: torch.log(x).sum())
    f_j = jdebug.checked_fn(lambda x: jnp.log(x).sum())
    assert float(f_t(torch.ones(3))) == float(f_j(jnp.ones(3))) == 0.0
    with pytest.raises(FloatingPointError, match="nan produced by aten.log"):
        f_t(torch.tensor([-1.0, 1.0, 2.0]))
    with pytest.raises(Exception, match="nan"):
        f_j(jnp.array([-1.0, 1.0, 2.0]))


def test_checked_fn_index_and_division_checks_match_checkify():
    x, i = np.ones(3, np.float32), np.array([0, 3])
    with pytest.raises(IndexError, match="out-of-bounds index in aten.index"):
        tdebug.checked_fn(lambda x, i: x[i])(torch.from_numpy(x), torch.from_numpy(i))
    with pytest.raises(Exception, match="out-of-bounds"):
        jdebug.checked_fn(lambda x, i: x[i])(jnp.asarray(x), jnp.asarray(i))
    a, b = np.array([4, 5, 6]), np.array([2, 0, 3])
    with pytest.raises(ZeroDivisionError, match="division by zero in aten"):
        tdebug.checked_fn(lambda a, b: a // b)(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(Exception, match="division by zero"):
        jdebug.checked_fn(lambda a, b: a // b)(jnp.asarray(a), jnp.asarray(b))
    # in range and nonzero: the values pass unchanged
    got = tdebug.checked_fn(lambda x, i: torch.gather(x, 0, i))(torch.arange(4.0),
                                                                 torch.tensor([3, 1]))
    assert got.tolist() == [3.0, 1.0]
    with pytest.raises(IndexError, match="gather"):
        tdebug.checked_fn(lambda x, i: torch.gather(x, 0, i))(torch.arange(4.0),
                                                               torch.tensor([-1]))
    with pytest.raises(ValueError, match="unknown checks"):
        tdebug.checked_fn(lambda: None, checks={"float", "shape"})


def test_checked_fn_only_checks_what_it_is_asked():
    f = tdebug.checked_fn(lambda x: torch.log(x), checks={"index"})
    assert torch.isnan(f(torch.tensor([-1.0]))).all()


def test_checked_train_step_is_the_train_step_and_names_the_nan(setup):
    harness, pool = setup["harness"], setup["pool"]
    rows = pool.gather_rows(torch.tensor([0, 2]))
    draws = harness.draw(rows, torch.Generator().manual_seed(3))
    a, ma = harness.train_step(setup["port_state"](), rows, draws)
    b, mb = tdebug.checked_fn(harness.train_step)(setup["port_state"](), rows, draws)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    tdebug.assert_all_finite(b, "state")
    state = setup["port_state"]()
    name = "denoiser.ipa.layer_0.to_v_scalar.weight"
    assert name in state.params
    with torch.no_grad():
        state.params[name][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"nan produced by aten\.\w+"):
        tdebug.checked_fn(harness.train_step)(state, rows, draws)
    with pytest.raises(FloatingPointError, match=name):
        tdebug.assert_all_finite(state, "state")


def test_no_false_alarm_on_a_clean_denoiser_forward(setup):
    """The denoiser forward on the same parameters and inputs passes
    checkify in JAX and the debug mode in the port, with the unchecked
    outputs."""
    jh, harness, pool = setup["jh"], setup["harness"], setup["pool"]
    params = setup["jstate"].params
    jb = jax.tree.map(lambda x: x[:2], setup["jpool"])
    beta = jnp.full((2,), 0.1, jnp.float32)

    def jax_forward(p, batch, beta):
        return jh.model.apply(p, batch, batch.seq_idx, batch.translations, batch.orientations,
                              beta)
    j_out = jdebug.checked_fn(jax_forward)(params, jb, beta)
    model = harness.model
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tb = pool.gather_rows(torch.tensor([0, 1]))
    args = (tb, tb.seq_idx, tb.translations, tb.orientations, torch.full((2,), 0.1))
    with torch.no_grad():
        plain = model(*args)
        checked = tdebug.checked_fn(model)(*args)
    assert set(plain) == set(checked)
    for k in plain:
        assert torch.equal(plain[k], checked[k]), k
    np.testing.assert_allclose(checked["translations_eps"].numpy(),
                               np.asarray(j_out["translations_eps"]), atol=1e-3)


def test_kernel_outputs_are_checked_where_the_wrappers_report_them():
    """The CUDA wrappers report each launch's outputs (`_build.launched`);
    inside a checked call a non-finite one raises naming the kernel, and
    outside it nothing is checked."""
    bad = torch.tensor([1.0, float("inf")])
    _build.launched("ipa_fused_layer", torch.ones(2), bad)  # no check outside
    with pytest.raises(FloatingPointError, match="inf produced by the ipa_fused_layer kernel"):
        tdebug.checked_fn(lambda: _build.launched("ipa_fused_layer", torch.ones(2), bad))()
    assert _build.launch_checks == []
    tdebug.checked_fn(lambda: _build.launched("ipa_attention", torch.ones(2)))()


def test_assert_all_finite_matches_jax():
    tdebug.assert_all_finite({"a": torch.ones(3), "n": 3, "i": torch.tensor([1])})
    jdebug.assert_all_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError, match="non-finite values in bad"):
        tdebug.assert_all_finite({"bad": torch.tensor([float("nan")])}, name="bad")
    with pytest.raises(FloatingPointError, match="non-finite values in bad"):
        jdebug.assert_all_finite({"bad": jnp.array([jnp.nan])}, name="bad")
    tree = {f"x{i}": (torch.tensor([float("inf")]), [torch.ones(1)]) for i in range(7)}
    with pytest.raises(FloatingPointError) as err:
        tdebug.assert_all_finite(tree)
    assert str(err.value) == ("non-finite values in tree: [('x0', 0), ('x1', 0), ('x2', 0), "
                              "('x3', 0), ('x4', 0)]")


# ---- profiling -------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_the_scopes(tmp_path):
    @tprofiling.named_scope("denoiser")
    def work(x):
        return (x @ x).sum()

    with tprofiling.trace(str(tmp_path / "t")):
        work(torch.ones(8, 8))
    events = json.load(open(tmp_path / "t" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "denoiser" for e in events)
    assert any("aten::mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="body failed"):
        with tprofiling.trace(str(tmp_path / "u")):
            work(torch.ones(2, 2))
            raise RuntimeError("body failed")
    assert os.path.exists(tmp_path / "u" / "trace.json")
    assert work.__name__ == "work"


def test_step_timer_matches_jax_s_contract():
    for timer in (tprofiling.StepTimer(), jprofiling.StepTimer()):
        assert timer.tick() is None
        time.sleep(0.05)
        rate = timer.tick(5)
        assert 0 < rate <= 5 / 0.05
        time.sleep(0.02)
        assert 0 < timer.tick() <= 1 / 0.02


def test_block_and_time():
    calls = []

    def fn(x, scale=1):
        calls.append(x)
        time.sleep(0.01 * scale)
        return torch.ones(1)
    s = tprofiling.block_and_time(fn, 3, iters=4, scale=2)
    assert calls == [3] * 5  # one warm-up and 4 timed calls
    assert 0.02 <= s < 1.0
    assert tprofiling.block_and_time(fn, 1, iters=2) >= 0.01
