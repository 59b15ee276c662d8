"""The port's `sample_sharded` and `replicate_batch` (`parallel/dp.py`)
against the JAX package and against `sample()` per rank, on the CPU.

JAX runs `sample_sharded` on a 2-device mesh of the faked 8-device CPU
mesh (tests/conftest.py); each device folds its index into the key.  The
port's counterpart is the host loop over the 2 ranks, each `sample()` on
its rows fed that device's JAX draws, concatenated in rank order.  Then
one gloo rank in this process and two worker processes
(tests/torch_rest_worker.py, no jax in them) run the collective function:
with the injected draws, and with a seeded generator against the host
loop of `sample()` with each rank's generator (`rank_generator`).

Tolerances: the host loop against JAX as tests/test_torch_parallel.py
holds the fan-out (sequences equal, coordinates and frames 1e-3); the
collective runs against the host loop bitwise (the same float32
operations on the same rows).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffab_pytorch_tpu.parallel import dp as jdp
from diffab_pytorch_tpu.parallel import mesh as jmesh
from diffab_pytorch_tpu.sampling.sampler import SampleResult as JaxResult

from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.parallel import dp as tdp
from diffab_pytorch_tpu_torch.parallel import mesh as tmesh
from diffab_pytorch_tpu_torch.parallel import replicate_batch, sample_sharded
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from test_torch_parallel import B, WORLD, close, one_rank_group, rank_rows, sample_draws, setup
from test_torch_train import T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rest_worker.py")
SAMPLE_OPTS = dict(n_steps=4)
FIELDS = ("seq_idx", "translations", "orientations")
TRAJ = ("seq_trajectory", "translations_trajectory", "orientations_trajectory")

__all__ = ["one_rank_group", "setup"]  # fixtures shared with tests/test_torch_parallel.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in each worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded_run(setup):
    """JAX sample_sharded over the B targets, and the port's host loop over
    the ranks with each device's JAX draws."""
    key = jax.random.key(13)
    want = jdp.sample_sharded(setup["jh"], setup["jstate"].params, setup["jb"], key,
                              setup["mesh"], **SAMPLE_OPTS)
    want = JaxResult(*(np.asarray(getattr(want, f)) for f in FIELDS))
    t_seq = tsampler.timestep_schedule(T, SAMPLE_OPTS["n_steps"])
    noise = [sample_draws(jax.random.fold_in(key, d), t_seq, B // WORLD) for d in range(WORLD)]
    batch = ProteinBatch.from_numpy(setup["arrays"])
    parts = [setup["harness"].sample(setup["params"], rank_rows(batch, r), init_noise=init,
                                     step_noise=steps.__getitem__, **SAMPLE_OPTS)
             for r, (init, steps) in enumerate(noise)]
    got = tsampler.SampleResult(*(torch.cat([getattr(p, f) for p in parts]) for f in FIELDS))
    return dict(batch=batch, noise=noise, want=want, got=got)


def host_loop(setup, batch, seed, world, **opts):
    """Each rank's sample() of its rows from its rank generator, in rank order."""
    gen = torch.Generator().manual_seed(seed)
    parts = [setup["harness"].sample(setup["params"],
                                     tmesh.put_global(batch, tmesh.BatchSharding(r, world)),
                                     tdp.rank_generator(gen, r), **SAMPLE_OPTS, **opts)
             for r in range(world)]
    return {f: torch.cat([getattr(p, f) for p in parts], dim=1 if f in TRAJ else 0)
            for f in FIELDS + (TRAJ if opts.get("return_trajectory") else ())}


def test_host_loop_matches_jax_sample_sharded(sharded_run):
    got, want = sharded_run["got"], sharded_run["want"]
    assert tuple(got.seq_idx.shape) == want.seq_idx.shape == (B, 24)
    np.testing.assert_array_equal(got.seq_idx.numpy(), want.seq_idx)
    close(got.translations, want.translations, atol=1e-3)
    close(got.orientations, want.orientations, atol=1e-3)


def test_one_rank_is_sample(setup, sharded_run, one_rank_group, monkeypatch):
    """On one rank sample_sharded is sample() on the whole batch, bit for
    bit, trajectories included.  A batch the ranks do not divide raises
    JAX's ValueError, before any collective."""
    batch = sharded_run["batch"]
    a = sample_sharded(setup["harness"], setup["params"], batch,
                       torch.Generator().manual_seed(4), None, return_trajectory=True,
                       **SAMPLE_OPTS)
    b = setup["harness"].sample(setup["params"], batch, torch.Generator().manual_seed(4),
                                return_trajectory=True, **SAMPLE_OPTS)
    for f in FIELDS + TRAJ:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.translations_trajectory.shape[1] == B
    with pytest.raises(ValueError) as j_err:
        jdp.sample_sharded(setup["jh"], setup["jstate"].params, setup["jb"], jax.random.key(0),
                           jmesh.make_mesh(n_devices=3))
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError) as t_err:
        sample_sharded(setup["harness"], setup["params"], batch, torch.Generator(), None)
    assert str(t_err.value) == str(j_err.value) == "batch size 4 not divisible by dp=3"


def test_two_processes_equal_the_host_loop(setup, sharded_run, tmp_path):
    inputs = str(tmp_path / "inputs.pt")
    torch.save(dict(config=setup["harness"].config, params=setup["params"],
                    batch=sharded_run["batch"], sample_noise=sharded_run["noise"],
                    sample_opts=SAMPLE_OPTS, seed=21), inputs)
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
    host = host_loop(setup, sharded_run["batch"], 21, WORLD, return_trajectory=True)
    for r in ranks:
        for f in FIELDS:
            assert torch.equal(getattr(r["injected"], f), getattr(sharded_run["got"], f)), f
        for f in FIELDS + TRAJ:
            assert torch.equal(getattr(r["drawn"], f), host[f]), f
    assert all(torch.equal(getattr(ranks[0]["to_rank0"], f), host[f]) for f in FIELDS)
    assert ranks[1]["to_rank0"] is None
    # the ranks drew apart: rank 1's rows are not rank 0's stream
    one = host_loop(setup, sharded_run["batch"], 21, 1)
    assert not torch.equal(one["translations"][B // 2:], host["translations"][B // 2:])


def test_replicate_batch_matches_jax(setup):
    jb = jax.tree.map(lambda x: x[:2], setup["jb"])
    want = jdp.replicate_batch(jb, 3)
    tb = ProteinBatch.from_numpy({k: (None if v is None else v[:2])
                                  for k, v in setup["arrays"].items()})
    got = replicate_batch(tb, 3)
    assert got.batch_size == 6
    for name, v in got.to_numpy().items():
        w = getattr(want, name)
        if v is None:
            assert w is None
            continue
        np.testing.assert_array_equal(v, np.asarray(w).astype(v.dtype), err_msg=name)
    assert torch.equal(got.seq_idx[1], tb.seq_idx[0]) and torch.equal(got.seq_idx[3],
                                                                       tb.seq_idx[1])
