"""The port's data-parallel layer (`parallel/mesh.py`, `parallel/dp.py`) and
the IPA layer's plain branch against the JAX package, on the CPU.

JAX runs its shard_map functions on a 2-device mesh of the faked 8-device
CPU mesh (tests/conftest.py).  The port's counterpart is a host loop over
the 2 ranks, fed each rank's JAX draws (device d folds d into the key):
`host_dp_train_step` for `make_dp_train_step`, and each rank's `sample` /
`score_designs` for the fan-out and the scores, concatenated in rank
order.  Then two real processes on gloo (tests/torch_parallel_worker.py,
no jax in them) run the collective functions with the same draws, and
both CLIs run under `torch.distributed.run --nproc-per-node 2`.

Tolerances: the host loop against JAX as tests/test_torch_train.py (1e-3
on the loss and metrics, 1e-3 of each gradient and parameter leaf's
largest entry) and
tests/test_torch_fewstep.py / test_torch_scoring.py (sequences equal,
coordinates and frames 1e-3, scores 1e-5); the two processes against the
host loop 1e-6 relative (the same float32 operations; the gradient sum
of 2 ranks is exact in either order) and row for row equal designs and
scores; the two ranks' parameters bitwise equal after every step.  The
IPA branch against the JAX layer: 5e-4, as tests/test_torch_models.py.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.models import ipa as jipa
from diffab_pytorch_tpu.parallel import dp as jdp
from diffab_pytorch_tpu.parallel import mesh as jmesh
from diffab_pytorch_tpu.sampling.sampler import SampleResult as JaxResult
from diffab_pytorch_tpu.structure.testing import make_synthetic_antibody_pdb
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb

from diffab_pytorch_tpu_torch.cli import preprocess as tpreprocess
from diffab_pytorch_tpu_torch.cli import train as ttrain
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models import ipa as tipa
from diffab_pytorch_tpu_torch.parallel import dp as tdp
from diffab_pytorch_tpu_torch.parallel import mesh as tmesh
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from diffab_pytorch_tpu_torch.sampling.scoring import DesignScores, ScoreDraws
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train.harness import DiffAb, TrainState
from diffab_pytorch_tpu_torch.weights import load_jax_params, opt_state_from_jax, params_from_jax
from test_torch_models import _layer_case, perturbed, port_model_config
from test_torch_train import DIFFUSION, T, jax_batch, jax_draws, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
B, L, K, WORLD, N_STEPS = 4, 24, 21, 2, 3
N_DESIGNS = 4  # of one target, 2 on each rank
SAMPLE_OPTS = dict(n_steps=4)
SCORE_OPTS = dict(t_grid=(1, 3), n_draws=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in each worker process: the in-process host loop
    then sums in the workers' order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=rtol)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group, destroyed afterwards."""
    dist.init_process_group("gloo", store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# ---- the mesh and the row blocks ---------------------------------------------------


def test_init_distributed_one_rank_on_the_cpu():
    """Outside torchrun, a one-rank gloo group on the CPU, gone afterwards."""
    with tmesh.init_distributed("cpu") as device:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert not dist.is_initialized()


TORCHRUN = dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT="1")


@pytest.mark.parametrize("env, asked, card", [
    ({}, "cuda:1", 1),  # outside torchrun the card asked for
    (dict(TORCHRUN, LOCAL_RANK="1"), "cuda", 1),  # under torchrun cuda:LOCAL_RANK
    (dict(TORCHRUN, LOCAL_RANK="1"), "cuda:1", 1),
    (dict(TORCHRUN, LOCAL_RANK="0"), "cuda:1", None),  # a conflicting index raises
    (dict(TORCHRUN, LOCAL_RANK="1"), "cuda:0", None),
])
def test_init_distributed_takes_the_rank_card(env, asked, card, monkeypatch):
    """The card a rank takes, with the group set-up recorded (no card here):
    NCCL, torchrun's env:// rendezvous under torchrun, else a one-rank
    store; never a silent swap of the card asked for."""
    for k in (*TORCHRUN, "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **k: calls.append((backend, k.get("init_method"))))
    monkeypatch.setattr(dist, "destroy_process_group", lambda: calls.append("destroy"))
    if card is None:
        with pytest.raises(ValueError, match="LOCAL_RANK"):
            with tmesh.init_distributed(asked):
                pass
        assert calls == []
        return
    with tmesh.init_distributed(asked) as device:
        assert device == torch.device("cuda", card)
    rendezvous = "env://" if env else None
    assert calls == [("set_device", device), ("nccl", rendezvous), "destroy"]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_rank_rows_are_the_jax_shards(world):
    """Rank r's rows are the block P(DP_AXIS) places on the mesh's device r,
    for a tensor and for every field of a batch."""
    mesh = jmesh.make_mesh(n_devices=world)
    order = list(mesh.devices.reshape(-1))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax.device_put(x, jmesh.batch_sharding(mesh))
    arrays = synthetic_batch_numpy(0, 8, 12, 15, n_generate=4)
    batch = ProteinBatch.from_numpy(arrays)
    for shard in placed.addressable_shards:
        rank = order.index(shard.device)
        sharding = tmesh.BatchSharding(rank, world)
        np.testing.assert_array_equal(
            tmesh.put_global(torch.from_numpy(x), sharding).numpy(), np.asarray(shard.data))
        rows = tmesh.put_global(batch, sharding)
        for f in dataclasses.fields(batch):
            v = getattr(batch, f.name)
            if v is not None:
                assert torch.equal(getattr(rows, f.name), v[sharding.rows(8)]), f.name
    with pytest.raises(ValueError, match="divisible"):
        tmesh.BatchSharding(0, 3).rows(8)


def test_replicated_state_is_checked(one_rank_group, monkeypatch):
    """put_global(replicated) returns the tree itself after the check, and
    raises when a rank's checksums differ from rank 0's broadcast."""
    tree = {"a": torch.arange(6.0), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    assert tmesh.put_global(tree, tmesh.replicated()) is tree

    def other_rank0(t, src, group=None):  # rank 0 broadcasts other checksums
        t.add_(1)
    monkeypatch.setattr(dist, "broadcast", other_rank0)
    with pytest.raises(RuntimeError, match="differs across ranks"):
        tmesh.put_global(tree, tmesh.replicated())


def test_rank_streams():
    assert tdp.rank_seed(5, 0) == 5
    assert len({tdp.rank_seed(5, r) for r in range(64)}) == 64
    g = torch.Generator().manual_seed(3)
    assert tdp.rank_generator(g, 0) is g
    g1 = tdp.rank_generator(g, 1)
    assert g1.initial_seed() == tdp.rank_seed(3, 1)


# ---- the host loop over 2 ranks against JAX's shard_map functions -----------------


@pytest.fixture(scope="module")
def setup():
    arrays = synthetic_batch_numpy(0, B, L, 15, n_generate=6)
    jcfg = dataclasses.replace(
        jconfig.tiny_config(), diffusion=jconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(jconfig.tiny_config().train, batch_size=B, mode_dropout=0.3,
                                  lr=1e-2, grad_clip_norm=1.0, update_clip_rms=1.0,
                                  ema_decay=0.9))
    jh = JaxDiffAb(jcfg)
    jb = jax_batch(arrays)
    jstate = jh.init(jax.random.key(0), jb)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, perturbed(
        jax.device_get(jstate.params), 6)))
    harness = DiffAb(port_config(jcfg), device="cpu")
    host = jax.device_get(jstate)
    params = params_from_jax(host.params)

    def port_state():
        return TrainState(0, {k: v.clone().requires_grad_(True) for k, v in params.items()},
                          opt_state_from_jax(host.opt_state),
                          {k: v.clone() for k, v in params_from_jax(host.ema_params).items()})
    return dict(arrays=arrays, jh=jh, jb=jb, jstate=jstate, harness=harness,
                port_state=port_state, params=params, mesh=jmesh.make_mesh(n_devices=WORLD))


def rank_rows(batch, rank):
    return tmesh.put_global(batch, tmesh.BatchSharding(rank, WORLD))


def jax_dp_grads(jh, mesh):
    """The pmean'd gradients JAX make_dp_train_step applies for a state: its
    per-device function up to the update, with the same key folds."""
    def per_device(params, step, batch, key):
        key = jax.random.fold_in(jax.random.fold_in(key, step), jax.lax.axis_index(jmesh.DP_AXIS))
        grads = jax.grad(lambda p: jh.loss_fn(p, key, batch, step=step)[0])(params)
        return jax.lax.pmean(grads, jmesh.DP_AXIS)
    fn = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=(P(), P(), P(jmesh.DP_AXIS), P()),
                               out_specs=P(), check_vma=False))
    return lambda state, batch, key: params_from_jax(jax.device_get(fn(
        state.params, state.step, jmesh.put_global(batch, jmesh.batch_sharding(mesh)), key)))


@pytest.fixture(scope="module")
def dp_run(setup):
    """JAX make_dp_train_step for N_STEPS steps with the gradients it
    applies, and the port's host loop fed each (step, device) JAX draw:
    host_dp_loss_and_grads, then host_dp_train_step; rank 0's gradients
    alone at the first step (what a step that skipped the average would
    apply)."""
    step = jdp.make_dp_train_step(setup["jh"], setup["mesh"], donate=False)
    grads_of = jax_dp_grads(setup["jh"], setup["mesh"])
    key = jax.random.key(5)
    jstate, want = setup["jstate"], []
    for _ in range(N_STEPS):
        grads = grads_of(jstate, setup["jb"], key)
        jstate, m = step(jstate, setup["jb"], key)
        want.append((jax.device_get(m), grads,
                     params_from_jax(jax.device_get(jstate.params))))
    draws = [[jax_draws(jax.random.fold_in(jax.random.fold_in(key, s), d), B // WORLD, L)
              for s in range(N_STEPS)] for d in range(WORLD)]
    batch = ProteinBatch.from_numpy(setup["arrays"])
    harness = setup["harness"]
    state, got = setup["port_state"](), []
    shards = [rank_rows(batch, r) for r in range(WORLD)]
    local = harness.loss_and_grads(state.params, shards[0], draws[0][0], 0)[2]
    for s in range(N_STEPS):
        grads, _ = tdp.host_dp_loss_and_grads(harness, state.params, shards,
                                              [draws[r][s] for r in range(WORLD)], state.step)
        grads = {k: v.clone() for k, v in grads.items()}
        state, m = tdp.host_dp_train_step(harness, state, shards,
                                          [draws[r][s] for r in range(WORLD)])
        got.append(({k: v.clone() for k, v in m.items()}, grads,
                    {k: v.detach().clone() for k, v in state.params.items()}))
    return dict(draws=draws, batch=batch, want=want, got=got, local=local)


def leaf_err(actual: dict, expected: dict) -> float:
    """max over leaves of max |actual - expected| over 1e-3 of the leaf's
    scale (max |expected|, at least 1): at most 1 within the tolerance."""
    return max(float((actual[k].detach() - v).abs().max())
               / (1e-3 * max(float(v.abs().max()), 1.0)) for k, v in expected.items())


def test_dp_train_step_matches_jax(dp_run, setup):
    """Each step's metrics (1e-3), the averaged gradients it applies and the
    parameters (1e-3 of each leaf's largest entry, at least 1, as
    tests/test_torch_train.py holds gradients and parameters).  At lr 1e-2
    the steps move every leaf by more than 10 times its tolerance, and the
    gradients of rank 0 alone miss JAX's average by more than 10 times:
    a step that applied no update, or no average, fails."""
    p0 = setup["params"]
    for s, ((m_t, g_t, p_t), (m_j, g_j, p_j)) in enumerate(zip(dp_run["got"], dp_run["want"])):
        assert set(m_t) == set(m_j)
        for k in m_j:
            close(m_t[k], m_j[k], atol=1e-3, rtol=1e-4)
        assert leaf_err(g_t, g_j) <= 1, f"step {s + 1}: gradients"
        assert leaf_err(p_t, p_j) <= 1, f"step {s + 1}: parameters"
    assert min(leaf_err({k: p0[k]}, {k: v}) for k, v in p_j.items()) > 10
    assert leaf_err(dp_run["local"], dp_run["want"][0][1]) > 10


def sample_draws(key, t_seq, bn):
    """The numbers the JAX sampler's key schedule draws for a prior-start
    chain over t_seq (tests/test_torch_fewstep.py `jax_draws`)."""
    k_init, k_loop = jax.random.split(key)
    ks, kx, kr = jax.random.split(k_init, 3)
    normal = lambda k, *s: t_(jax.random.normal(k, (bn, L) + s))

    def axis_angle(k):
        k_axis, k_theta = jax.random.split(k)
        k_bin, k_gauss = jax.random.split(k_theta)
        return AxisAngleNoise(normal(k_axis, 3), t_(jax.random.uniform(k_bin, (bn, L))),
                              normal(k_gauss))
    init = tsampler.InitNoise(seq=t_(jax.random.randint(ks, (bn, L), 0, K)).long(),
                              coord=normal(kx, 3), rot_prior=normal(kr, 4))
    steps = {}
    for t in t_seq:
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_loop, int(t)), 3)
        steps[int(t)] = tsampler.StepNoise(gumbel=t_(jax.random.gumbel(k1, (bn, L, K))),
                                           coord=normal(k2, 3), orientation=axis_angle(k3))
    return init, steps


def score_draws(key, grid, n_draws, bn):
    """The numbers JAX score_designs(key) draws (tests/test_torch_scoring.py)."""
    parts = [[] for _ in range(5)]
    for t in grid:
        for d in range(n_draws):
            ks, kx, kr = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, t), d), 3)
            k_axis, k_theta = jax.random.split(kr)
            k_bin, k_gauss = jax.random.split(k_theta)
            for out, x in zip(parts, (jax.random.gumbel(ks, (bn, L, K)),
                                      jax.random.normal(kx, (bn, L, 3)),
                                      jax.random.normal(k_axis, (bn, L, 3)),
                                      jax.random.uniform(k_bin, (bn, L)),
                                      jax.random.normal(k_gauss, (bn, L)))):
                out.append(x)
    st = [t_(np.stack(p)) for p in parts]
    return ScoreDraws(st[0], st[1], AxisAngleNoise(*st[2:]))


@pytest.fixture(scope="module")
def fanout_run(setup):
    """JAX sample_fanout_sharded and score_fanout_sharded on one target, and
    the port's rank-by-rank host loop with each device's JAX draws."""
    jh, params = setup["jh"], setup["jstate"].params
    one_j = jax.tree.map(lambda a: a[:1], setup["jb"])
    key_s, key_c = jax.random.key(9), jax.random.key(11)
    want = jdp.sample_fanout_sharded(jh, params, one_j, key_s, setup["mesh"],
                                     n_designs=N_DESIGNS, **SAMPLE_OPTS)
    fields = ("seq_idx", "translations", "orientations")
    want = JaxResult(*(np.asarray(getattr(want, f)) for f in fields))
    want_scores = jdp.score_fanout_sharded(
        jh, params, one_j, JaxResult(*(jnp.asarray(getattr(want, f)) for f in fields)), key_c,
        setup["mesh"], **SCORE_OPTS)

    n_local = N_DESIGNS // WORLD
    t_seq = tsampler.timestep_schedule(T, SAMPLE_OPTS["n_steps"])
    noise = [sample_draws(jax.random.fold_in(key_s, d), t_seq, n_local) for d in range(WORLD)]
    scores = [score_draws(jax.random.fold_in(key_c, d), SCORE_OPTS["t_grid"],
                          SCORE_OPTS["n_draws"], n_local) for d in range(WORLD)]
    harness = setup["harness"]
    one = ProteinBatch.from_numpy({k: v[:1] for k, v in setup["arrays"].items()})
    parts = [harness.sample(setup["params"], one, n_designs=n_local, init_noise=init,
                            step_noise=steps.__getitem__, **SAMPLE_OPTS)
             for init, steps in noise]
    got = tsampler.SampleResult(*(torch.cat([getattr(p, f) for p in parts])
                                  for f in ("seq_idx", "translations", "orientations")))
    got_scores = [harness.score_designs(setup["params"], one, rank_rows(got, r),
                                        draws=scores[r], **SCORE_OPTS) for r in range(WORLD)]
    got_scores = DesignScores(*(torch.cat(x) for x in zip(*got_scores)))
    return dict(one=one, noise=noise, score_draws=scores, want=want, got=got,
                want_scores=want_scores, got_scores=got_scores)


def test_sample_fanout_matches_jax(fanout_run):
    got, want = fanout_run["got"], fanout_run["want"]
    assert tuple(got.seq_idx.shape) == (N_DESIGNS, L)
    np.testing.assert_array_equal(got.seq_idx.numpy(), want.seq_idx)
    close(got.translations, want.translations, atol=1e-3)
    close(got.orientations, want.orientations, atol=1e-3)
    # the ranks' draws differ, so do their designs
    assert not torch.equal(got.translations[0], got.translations[N_DESIGNS // WORLD])


def test_score_fanout_matches_jax(fanout_run):
    for k in DesignScores._fields:
        got = getattr(fanout_run["got_scores"], k).numpy()
        assert got.shape == (N_DESIGNS,)
        np.testing.assert_allclose(got, np.asarray(getattr(fanout_run["want_scores"], k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_one_rank_is_the_single_device_run(setup, fanout_run, one_rank_group):
    """On one rank the collective functions are the single-device ones, bit
    for bit: the train step (3 steps), the fan-out from the same generator
    and the scores; the divisibility errors are JAX's."""
    harness, batch = setup["harness"], ProteinBatch.from_numpy(setup["arrays"])
    dp_state, state = setup["port_state"](), setup["port_state"]()
    step = tdp.make_dp_train_step(harness)
    for s in range(3):
        draws = harness.draw(batch, torch.Generator().manual_seed(s))
        dp_state, m_dp = step(dp_state, batch, draws)
        state, m = harness.train_step(state, batch, draws)
        assert all(torch.equal(m_dp[k], m[k]) for k in m)
        for k in state.params:
            assert torch.equal(dp_state.params[k], state.params[k])
            assert torch.equal(dp_state.ema_params[k], state.ema_params[k])
    one, params = fanout_run["one"], setup["params"]
    a = tdp.sample_fanout_sharded(harness, params, one, torch.Generator().manual_seed(4), None,
                                  3, **SAMPLE_OPTS)
    b = harness.sample(params, one, torch.Generator().manual_seed(4), n_designs=3,
                       **SAMPLE_OPTS)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    sa = tdp.score_fanout_sharded(harness, params, one, a, torch.Generator().manual_seed(5),
                                  **SCORE_OPTS)
    sb = harness.score_designs(params, one, b, torch.Generator().manual_seed(5), **SCORE_OPTS)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    two = ProteinBatch.from_numpy({k: v[:2] for k, v in setup["arrays"].items()})
    with pytest.raises(ValueError, match="not divisible by targets"):
        tdp.score_fanout_sharded(harness, params, two, a, torch.Generator(), **SCORE_OPTS)


# ---- two processes over gloo ------------------------------------------------------


def test_two_processes_equal_the_host_loop(setup, dp_run, fanout_run, tmp_path):
    """The collective DP step, fan-out and scores in two worker processes
    against the in-process host loop, with every draw injected."""
    inputs = str(tmp_path / "inputs.pt")
    torch.save(dict(
        config=setup["harness"].config, state=setup["port_state"](), batch=dp_run["batch"],
        step_draws=dp_run["draws"], params=setup["params"], target=fanout_run["one"],
        n_designs=N_DESIGNS, sample_noise=fanout_run["noise"], sample_opts=SAMPLE_OPTS,
        score_draws=fanout_run["score_draws"], score_opts=SCORE_OPTS), inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), inputs,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for s, (m_want, _, p_want) in enumerate(dp_run["got"]):
        for r in ranks:
            for k, v in m_want.items():
                close(r["metrics"][s][k], v, atol=0, rtol=1e-6)
            for k, v in p_want.items():
                close(r["params"][s][k], v, atol=1e-6 * max(float(v.abs().max()), 1.0), rtol=0)
        assert all(torch.equal(ranks[0]["params"][s][k], ranks[1]["params"][s][k])
                   for k in p_want), f"ranks' parameters differ after step {s + 1}"
    got = fanout_run["got"]
    for r in ranks:
        assert all(torch.equal(x, y) for x, y in zip(r["designs"][:3], got[:3]))
        assert all(torch.equal(x, y) for x, y in zip(r["scores"], fanout_run["got_scores"]))


def test_clis_under_torchrun(setup, tmp_path):
    """cli.train --data-parallel and cli.sample --data-parallel --rank on 2
    gloo ranks.  The checkpoint is the host loop's replay of the same run:
    the loader's global batches split in rank order, each rank's draws from
    rank_seed of the step's seed."""
    patches = tmp_path / "patches"
    patches.mkdir()
    for i in range(4):
        pdb = tmp_path / f"c{i}.pdb"
        pdb.write_text(make_synthetic_antibody_pdb(seed=40 + i))
        tpreprocess.process_one(str(pdb), str(patches / f"c{i}.npz"), "H", "L", "A", 48)
    argv = ["--data-dir", str(patches), "--tiny", "--device", "cpu", "--max-steps", "2",
            "-b", "2", "--val-pct", "0", "--checkpoint-dir", str(tmp_path / "ck")]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(WORLD), "-m"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(run + ["diffab_pytorch_tpu_torch.cli.train", *argv, "--data-parallel"],
                         env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "data-parallel over 2 ranks" in out.stdout

    args = ttrain.parse_args(argv)
    harness = DiffAb(ttrain.build_config(args, horizon=2), device="cpu")
    seed = args.seed
    ds = PatchDataset.from_dir(str(patches))
    order = np.random.default_rng(seed).permutation(len(ds.paths))
    train_ds = PatchDataset([ds.paths[i] for i in order])
    state = harness.init(seed)
    for s, (batch, _) in zip(range(2), train_ds.batches(2, shuffle=True, seed=seed, epochs=1)):
        shards = [rank_rows(batch, r) for r in range(WORLD)]
        draws = [harness.draw(x, torch.Generator().manual_seed(
            tdp.rank_seed(seed * 1_000_003 + s, r))) for r, x in enumerate(shards)]
        state, _ = tdp.host_dp_train_step(harness, state, shards, draws)
    got = ckpt.restore_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert got.step == 2
    for k, v in state.params.items():
        v = v.detach()
        close(got.params[k].detach(), v, atol=1e-6 * max(float(v.abs().max()), 1.0), rtol=0)

    designs = tmp_path / "designs"
    out = subprocess.run(run + ["diffab_pytorch_tpu_torch.cli.sample", "--patch",
                                str(patches / "c0.npz"), "--checkpoint-dir", str(tmp_path / "ck"),
                                "-n", "4", "--rank", "-o", str(designs), "--device", "cpu",
                                "--data-parallel"],
                         env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert sorted(os.listdir(designs)) == [f"design_{i:04d}.pdb" for i in range(4)] + [
        "designs.fasta", "scores.json"]
    assert out.stdout.count("wrote 4 designs") == 1  # only rank 0 writes


# ---- A6: the IPA layer without the kernels' preconditions ---------------------------


IPA_CASES = {  # (use_pair_bias, n_query_point_per_head, n_value_point_per_head)
    "no_pair_bias": (False, 4, 4),
    "pq_ne_pv": (True, 4, 3),
    "no_pair_bias_pq_ne_pv": (False, 3, 5),
}


@pytest.mark.parametrize("case", list(IPA_CASES))
def test_plain_ipa_branch_matches_jax(case):
    """The JAX layer's XLA branch (use_pallas_attention=False) against the
    port's plain branch, 2 designs of each of 2 targets, weights through
    the transplant."""
    pair_bias, pq, pv = IPA_CASES[case]
    jcfg, args = _layer_case(7, b=4, bp=2)
    jcfg = dataclasses.replace(jcfg, use_pair_bias=pair_bias, n_query_point_per_head=pq,
                               n_value_point_per_head=pv, use_pallas_attention=False)
    layer = jipa.InvariantPointAttentionLayer(jcfg)
    params = perturbed(jax.device_get(
        layer.init(jax.random.key(1), *(jnp.asarray(a) for a in args))), 2)
    assert ("to_pair_bias" in params["params"]) == pair_bias
    out_j = layer.apply(params, *(jnp.asarray(a) for a in args))
    tl = load_jax_params(tipa.InvariantPointAttentionLayer(port_model_config(jcfg)), params)
    assert not tl.use_kernel
    with torch.no_grad():
        out_t = tl(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(out_t).all()
    close(out_t, out_j, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("fuse", [None, False])
@pytest.mark.parametrize("case", [(True, 4, 4)] + list(IPA_CASES.values()))
def test_kernel_is_chosen_where_jax_chooses_it(case, fuse, monkeypatch):
    """K1 (or K2 at fuse_ipa_layer=False) runs exactly when use_pair_bias
    and pq == pv (JAX models/ipa.py:237); otherwise neither does."""
    pair_bias, pq, pv = case
    jcfg, args = _layer_case(8, b=2, bp=1)
    cfg = dataclasses.replace(port_model_config(jcfg), use_pair_bias=pair_bias,
                              n_query_point_per_head=pq, n_value_point_per_head=pv,
                              fuse_ipa_layer=fuse)
    calls = []
    for name in ("fused_ipa_layer_packed", "fused_ipa_attention_raw"):
        real = getattr(tipa, name)
        monkeypatch.setattr(tipa, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    with torch.no_grad():
        out = tipa.InvariantPointAttentionLayer(cfg)(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(out).all()
    kernel = "fused_ipa_layer_packed" if fuse is None else "fused_ipa_attention_raw"
    assert calls == ([kernel] if pair_bias and pq == pv else [])
