"""The port's compiled step bodies (`utils/graphs.py`, the sampler's reverse
body, `DiffAb.train_step_impl` and the `make_*_step` factories) on the CPU.

On a CUDA device these bodies are captured once and replayed as CUDA graphs
(`chip_smoke.py` [graph] holds the replays bitwise against the eager runs);
on the CPU the same bodies run eagerly, which is what is held here:

  * the body-based `sample()` against the JAX `sample()` with its draws
    injected, for the posterior and DDIM coordinate steps, Heun, AB2 and a
    self-conditioned chain, at the tolerances of tests/test_torch_fewstep.py
    and tests/test_torch_selfcond.py (sequences exactly, coordinates and
    frames to 1e-3), with each step run under `capture_safe`;
  * the update with its per-step scalars on the device (`step_scalars`, the
    form a captured step reads) against optax, at tests/test_torch_train.py's
    tolerance (1e-6);
  * `make_pool_train_step(steps_per_call=3)` (eager here) bitwise three
    `train_step`s;
  * `capture_safe` over the training and evaluation bodies at both
    `fuse_ipa_layer` flags, and raising on a deliberate host read;
  * the kernel launch counters' bookkeeping under a capture, the launch
    faked.

Small sizes: tiny_config() (2 IPA layers, d = 32), L <= 24, T <= 12.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_selfcond as sc_tests
from diffab_pytorch_tpu.sampling import sampler as jsampler
from test_torch_fewstep import check_result, models, run_chain, scheds, tables  # noqa: F401
from test_torch_train import RECIPES, _optimizer_harness, _small_harness, close, t_

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from diffab_pytorch_tpu_torch.train.harness import OptState, TrainState, _pool_steps
from diffab_pytorch_tpu_torch.utils import debug, graphs

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def checked_bodies(monkeypatch):
    """Every reverse step of `sample()` runs under `capture_safe`; yields the
    number of steps run."""
    ran = []
    real = tsampler._reverse_body

    def checked(model, opts):
        body = real(model, opts)

        def step(c, *variant):
            ran.append(variant)
            return graphs.capture_safe(body, c, *variant)
        return step
    monkeypatch.setattr(tsampler, "_reverse_body", checked)
    return ran


# ---- the sampler's body ------------------------------------------------------------

BODY_CHAINS = {
    "posterior": dict(orientation_reverse="posterior", n_steps=5),
    "ddim": dict(coord_ddim_t_min=3, noise_scale=0.5, n_steps=5),
    "heun": dict(coord_solver="heun", coord_solver_t_min=2, n_steps=4),
    "ab2": dict(coord_solver="ab2", n_steps=5),
    "ab2-trajectory": dict(coord_solver="ab2", n_steps=4, return_trajectory=True,
                           noise_t_max=3),
}


@pytest.mark.parametrize("name", list(BODY_CHAINS))
def test_body_sample_matches_jax(models, scheds, tables, checked_bodies, name):
    opts = dict(BODY_CHAINS[name])
    got, want, n_steps = run_chain(models, scheds, tables, opts)
    check_result(got, want)
    assert len(checked_bodies) == n_steps
    if opts.get("coord_solver") == "heun":  # the corrector on active steps only
        assert [v[0] for v in checked_bodies] == [True] * (n_steps - 1) + [False]
    if opts.get("return_trajectory"):
        assert got.translations_trajectory.shape[0] == n_steps
        close(got.translations_trajectory, want.translations_trajectory, atol=1e-3)
        np.testing.assert_array_equal(got.seq_trajectory.numpy(),
                                      np.asarray(want.seq_trajectory))


def test_body_sample_self_conditioned_matches_jax(checked_bodies):
    """The split trunk with sc_t_max and Heun: the estimate carried in the
    body's buffers from step to step, gated on the device."""
    arrays = synthetic_batch_numpy(0, sc_tests.B, sc_tests.L, 15, n_generate=6)
    _, jm, params, tm = sc_tests.models(arrays, "split")
    js, ts = sc_tests.jsched(sc_tests.T, s=0.01), sc_tests.tsched(sc_tests.T, s=0.01)
    jt = sc_tests.jorient.make_orientation_tables(js, **sc_tests.TABLES)
    tt = sc_tests.torient.make_orientation_tables(ts, **sc_tests.TABLES)
    opts = dict(coord_solver="heun", coord_solver_t_min=2, sc_t_max=6, n_steps=5)
    key = jax.random.key(11)
    want = jsampler.sample(jm, params, js, jt, sc_tests.jax_batch(arrays), key,
                           n_designs=sc_tests.N, **opts)
    t_seq = tsampler.timestep_schedule(sc_tests.T, opts["n_steps"])
    init, steps = sc_tests.jax_sample_draws(key, t_seq, sc_tests.B * sc_tests.N)
    got = tsampler.sample(tm, ts, tt, ProteinBatch.from_numpy(arrays), device="cpu",
                          n_designs=sc_tests.N, init_noise=init, step_noise=steps.__getitem__,
                          **opts)
    np.testing.assert_array_equal(got.seq_idx.numpy(), np.asarray(want.seq_idx))
    close(got.translations, want.translations, atol=1e-3)
    close(got.orientations, want.orientations, atol=1e-3)
    assert len(checked_bodies) == len(t_seq)


def test_sample_drawn_from_a_generator_repeats(models, scheds, tables):
    """Without injected draws every step draws into the body's noise
    buffers from the generator: the same seed gives the same chain, another
    seed another."""
    _, _, _, tm, tb = models
    ts, tt = scheds[1], tables[1]
    run = lambda seed: tsampler.sample(tm, ts, tt, tb, device="cpu", n_designs=2, n_steps=4,
                                       generator=torch.Generator().manual_seed(seed))
    a, b, c = run(3), run(3), run(4)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not torch.equal(a.translations, c.translations)


# ---- the training bodies -----------------------------------------------------------


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_device_scalar_update_matches_optax(recipe):
    """tests/test_torch_train.py's optimizer comparison, with the learning
    rate and the bias corrections read from one (7, 4) block of device
    scalars, as a seven-step captured pool step reads them."""
    harness, optimizer = _optimizer_harness(**RECIPES[recipe])
    rng = np.random.default_rng(4)
    shapes = {"a.weight": (5, 3), "a.bias": (5,), "b.gamma": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    zeros = lambda: {k: torch.zeros(s) for k, s in shapes.items()}
    state = TrainState(0, {k: t_(v).requires_grad_(True) for k, v in p0.items()},
                       OptState(0, zeros(), zeros()))
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    jstate = optimizer.init(jp)
    update = jax.jit(optimizer.update)
    scalars = harness.step_scalars(0, 0, 7)
    assert scalars.shape == (7, 4) and scalars.dtype == torch.float32
    for step in range(7):
        scale = 10.0 if step % 2 else 0.3
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = update({k: jax.numpy.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        state = harness.apply_gradients(state, {k: t_(v) for k, v in g.items()},
                                        scalars=scalars[step])
        for k in shapes:
            close(state.params[k].detach(), jp[k], atol=1e-6, rtol=1e-6)
    assert state.opt_state.count == state.step == 7
    t = harness.config.train
    np.testing.assert_allclose(scalars[:, 0].numpy(), [harness.learning_rate(c) for c in range(7)],
                               rtol=1e-6)
    np.testing.assert_allclose(scalars[:, 1].numpy(),
                               [1 / (1 - t.betas[0] ** (c + 1)) for c in range(7)], rtol=1e-6)


def _pool_case(fuse, k):
    harness = _small_harness(fuse, lr=1e-3, ema_decay=0.9)
    pool = ProteinBatch.from_numpy(synthetic_batch_numpy(0, 6, 20, 15, n_generate=6))
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 6, (k, 2), generator=gen)
    draws = [harness.draw_for(2, 20, gen, "cpu") for _ in range(k)]
    return harness, pool, idx, draws


@pytest.mark.parametrize("fuse", [None, False])
def test_pool_step_of_three_is_three_train_steps(fuse):
    """make_pool_train_step(steps_per_call=3), eager on the CPU, is bit for
    bit the chain of three train_step calls on the gathered rows; its
    metrics come back stacked (3,)."""
    harness, pool, idx, draws = _pool_case(fuse, 3)
    step = harness.make_pool_train_step(steps_per_call=3)
    pooled, metrics = step(harness.init(0), pool, idx, draws)
    chain, ms = harness.init(0), []
    for j in range(3):
        chain, m = harness.train_step(chain, pool.gather_rows(idx[j]), draws[j])
        ms.append(m)
    assert pooled.step == chain.step == 3 and pooled.opt_state.count == 3
    for name in chain.params:
        assert torch.equal(pooled.params[name], chain.params[name]), name
        assert torch.equal(pooled.ema_params[name], chain.ema_params[name]), name
        assert torch.equal(pooled.opt_state.nu[name], chain.opt_state.nu[name]), name
    for name, v in metrics.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([m[name] for m in ms])), name
    with pytest.raises(ValueError, match="steps_per_call=3"):
        step(harness.init(0), pool, idx[:2], draws[:2])


def test_step_factories_run_the_eager_bodies_off_the_card():
    """Off a CUDA device the factories give the eager methods (JAX's jit on
    the CPU is the same function); sample(graphs=True) needs a card."""
    harness, pool, idx, draws = _pool_case(None, 1)
    batch = pool.gather_rows(idx[0])
    assert harness.make_train_step() == harness.train_step
    assert harness.make_eval_step() == harness.eval_step
    a, ma = harness.make_train_step()(harness.init(0), batch, draws[0])
    b, mb = harness.train_step(harness.init(0), batch, draws[0])
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    p, _ = harness.make_pool_train_step()(harness.init(0), pool, idx[0], draws[0])
    assert all(torch.equal(a.params[k], p.params[k]) for k in a.params)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        harness.sample(None, batch, torch.Generator().manual_seed(0), n_designs=2, n_steps=3,
                       graphs=True)


@pytest.mark.parametrize("fuse", [None, False])
def test_bodies_are_capture_safe(fuse, checked_bodies):
    """The training step body, the evaluation body and the sampler's body
    at both flags hold no op a capture cannot take."""
    harness, pool, idx, draws = _pool_case(fuse, 2)
    state = harness.init(0)
    batch = pool.gather_rows(idx[0])
    scalars = harness.step_scalars(0, 0, 2)
    graphs.capture_safe(harness.train_step_impl, state, batch, draws[0], scalars[0])
    graphs.capture_safe(harness.eval_step, state.params, batch, draws[0])
    graphs.capture_safe(_pool_steps, harness, state, pool, idx, draws, 2, scalars)
    harness.sample(None, batch, torch.Generator().manual_seed(0), n_designs=2, n_steps=3,
                   coord_solver="heun")
    assert len(checked_bodies) == 3


def test_capture_safe_raises_on_host_reads():
    """The check itself can fail: a host read, a data-shaped op and a copy
    across devices raise; the same arithmetic without them passes."""
    x = torch.arange(6.0)

    def body(read):
        y = x * 2.0
        if read == "item":
            return y.sum().item()
        if read == "float":
            return float(y.max())
        if read == "mask":
            return y[y > 3.0]
        if read == "nonzero":
            return torch.nonzero(y)
        if read == "index0d":
            return y[torch.tensor(2)]
        if read == "device":
            return y.to("meta")
        if read == "host":
            return y + torch.as_tensor(np.arange(6.0, dtype=np.float32))
        return torch.where(y > 3.0, y, 0.0)

    for read in ("item", "float", "mask", "nonzero", "index0d", "device", "host"):
        with pytest.raises(graphs.CaptureUnsafe):
            graphs.capture_safe(body, read)
    assert torch.equal(graphs.capture_safe(body, None), torch.where(x * 2 > 3, x * 2, 0.0))


def test_one_hot_is_f_one_hot():
    idx = torch.tensor([[0, 3, 20], [7, 7, 1]])
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(graphs.one_hot(idx, 21, dtype), F.one_hot(idx, 21).to(dtype))
    graphs.capture_safe(graphs.one_hot, idx, 21, torch.float32)
    with pytest.raises(graphs.CaptureUnsafe):
        graphs.capture_safe(lambda: F.one_hot(idx, 21))


# ---- the bookkeeping ----------------------------------------------------------------


def test_launch_counts_count_replays():
    """A launch outside a capture counts once and runs the launch checks;
    inside one it goes into the graph's tally and runs no check (nothing
    has run); each replay adds the tally to the counts."""
    kernel = lambda: None
    kernel.launches = 0
    seen = []
    check = lambda name, outputs: seen.append(name)
    _build.launch_checks.append(check)
    try:
        _build.count_launch(kernel, "fake", torch.ones(2))
        assert kernel.launches == 1 and seen == ["fake"]
        with _build.capturing() as tally:
            for _ in range(6):
                _build.count_launch(kernel, "fake", torch.ones(2))
            _build.launched("fake", torch.ones(2))
            with pytest.raises(RuntimeError, match="already in progress"):
                with _build.capturing():
                    pass
        assert kernel.launches == 1 and seen == ["fake"] and tally == {kernel: 6}
        for _ in range(3):
            _build.replayed(tally)
        assert kernel.launches == 1 + 18
        _build.count_launch(kernel, "fake", torch.ones(2))
        assert kernel.launches == 20 and seen == ["fake", "fake"]
    finally:
        _build.launch_checks.remove(check)


def test_use_graphs_and_disabled():
    assert graphs.use_graphs("cuda") and not graphs.use_graphs("cpu")
    assert not graphs.use_graphs("cuda", graphs=False)
    with pytest.raises(ValueError):
        graphs.use_graphs("cpu", graphs=True)
    with graphs.disabled():
        assert not graphs.use_graphs("cuda") and not graphs.use_graphs("cuda", graphs=True)
    assert graphs.use_graphs("cuda")
    # a checked call runs eagerly: the dispatch mode cannot see a replay
    assert debug.checked_fn(lambda: graphs.use_graphs("cuda"))() is False


def test_signature_keys_what_a_capture_is_specialised_to():
    a = dict(x=torch.zeros(2, 3), clip=1.5, opt=None)
    assert graphs.signature(a) == graphs.signature(dict(x=torch.ones(2, 3), clip=1.5, opt=None))
    for other in (dict(x=torch.zeros(2, 4), clip=1.5, opt=None),
                  dict(x=torch.zeros(2, 3, dtype=torch.float64), clip=1.5, opt=None),
                  dict(x=torch.zeros(2, 3), clip=2.0, opt=None),
                  dict(x=torch.zeros(2, 3), clip=1.5, opt=torch.zeros(1))):
        assert graphs.signature(a) != graphs.signature(other)
    t = torch.zeros(3)
    assert graphs.addresses([t, t[1:]]) == (t.data_ptr(), t.data_ptr() + 4)


def test_graph_cache_loads_inputs_and_keeps_its_buffers():
    """An entry clones its inputs once and makes the body's buffers once; a
    later call with the same key copies only its inputs in (the buffers
    keep what the body wrote); the oldest entry goes first; no memory pool
    is made before a capture."""
    cache = graphs.GraphCache(size=2)
    made = []

    def buffers():
        made.append(1)
        return dict(carry=torch.zeros(3))
    first = torch.ones(3)
    a = cache.get("k", dict(x=first, clip=1.5), buffers)
    assert made == [1] and torch.equal(a.inputs["x"], first) and a.inputs["x"] is not first
    a.inputs["carry"].add_(5.0)
    fresh = torch.full((3,), 2.0)
    assert cache.get("k", dict(x=fresh, clip=1.5), buffers) is a and made == [1]
    assert torch.equal(a.inputs["x"], fresh) and torch.equal(a.inputs["carry"],
                                                             torch.full((3,), 5.0))
    cache.get("k2", dict(x=first, clip=1.5))
    cache.get("k3", dict(x=first, clip=1.5))
    assert list(cache.entries) == ["k2", "k3"] and cache._pool is None
    assert cache.pool_bytes == 0 and a.cache is cache


def test_chain_graphs_go_with_the_model():
    """The sampler's captures are cached per model and dropped with it."""
    import gc

    net = torch.nn.Linear(2, 2)
    cache = tsampler.chain_graphs(net)
    assert tsampler.chain_graphs(net) is cache
    assert tsampler.chain_graphs(torch.nn.Linear(2, 2)) is not cache
    n = len(tsampler._CHAINS)
    del net
    gc.collect()
    assert len(tsampler._CHAINS) == n - 1


def test_fit_runs_the_factories_steps(monkeypatch):
    """fit() trains through make_train_step and validates through
    make_eval_step (the eager methods here; graphs on a card)."""
    from diffab_pytorch_tpu_torch.train.trainer import fit

    harness = _small_harness(lr=1e-3, log_every=1)
    made = []
    for name in ("make_train_step", "make_eval_step"):
        real = getattr(harness, name)
        monkeypatch.setattr(harness, name, lambda *a, _r=real, _n=name, **k: (
            made.append(_n), _r(*a, **k))[1])
    batches = [ProteinBatch.from_numpy(synthetic_batch_numpy(0, 2, 20, 15, n_generate=6))]
    state = fit(harness, batches, batches, max_steps=2)
    assert state.step == 2 and sorted(made) == ["make_eval_step", "make_train_step"]
    assert all(torch.isfinite(v).all() for v in state.params.values())
