"""The port's tensor parallelism (`parallel/mesh.py` make_mesh and
param_sharding, `parallel/tp.py`, the IPA layers split by head, the
sharded checkpoints) against the JAX package and the port's own
single-device step, on the CPU.

No processes: the (dp, tp) layout against JAX's `make_mesh` device grid,
`param_sharding` against JAX's for every leaf, the shards' shapes against
the layers built for a rank's heads, a JAX state placed by JAX's
`shard_state` carried across, and the one-process reference (every IPA
layer as its tp ranks' parts in a host loop, summed) against
`DiffAb.loss_and_grads`.  Then two and four gloo processes
(tests/torch_tp_worker.py, no jax in them), started once each, run
`make_sharded_train_step` on every case:

  * tp = 2 against JAX's `make_sharded_train_step` on `make_mesh(tp=2)`,
    fed JAX's draws, 3 steps at lr 1e-2 with both clips on: the metrics
    1e-3, the parameters 1e-3 of each leaf's largest entry (at least 1),
    as tests/test_torch_train.py; the 3 steps move every leaf by more
    than 10 times that;
  * tp = 2 at fuse_ipa_layer None and False, the plain branch (pq != pv;
    no pair bias), self-conditioning early and split trunk, both clips
    on, and tp = 4 (one head a rank), each 2 steps against `train_step`
    with the same draws: the gathered gradients 1e-5 of each leaf's
    largest entry, the loss and metrics 1e-6 relative, parameters, EMA
    and moments 1e-5 of each leaf's scale (at least 1); the tp ranks'
    replicated leaves bit-identical after every step.  These run at
    lr 1e-3: a step moves a parameter by about lr, and Adam divides a
    gradient by its own root mean square, so an element whose gradient is
    float32 rounding noise (~1e-11 apart between two summation orders)
    moves by up to lr in either direction; at lr 1e-2 that reads 1.8e-5;
  * dp = 2 x tp = 2 against `parallel.dp.host_dp_train_step`, 1e-5;
  * checkpoints: a replicated checkpoint restored into the tp = 2 parts
    bitwise, one step from it against `train_step` (1e-5), the sharded
    state saved and restored single-device equal to the gathered state
    bitwise, `fit(mesh=...)` writing a checkpoint `cli.sample --device
    cpu` reads.
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
from diffab_pytorch_tpu.parallel import dp as jdp
from diffab_pytorch_tpu.parallel import mesh as jmesh
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb

from diffab_pytorch_tpu_torch.cli import sample as tsample
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.parallel import dp as tdp
from diffab_pytorch_tpu_torch.parallel import mesh as tmesh
from diffab_pytorch_tpu_torch.parallel import tp as ttp
from diffab_pytorch_tpu_torch.structure import antibody
from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train.harness import DiffAb, TrainState
from diffab_pytorch_tpu_torch.weights import opt_state_from_jax, params_from_jax
from test_torch_models import perturbed
from test_torch_train import DIFFUSION, jax_batch, jax_draws, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
B, L, N_JAX_STEPS, N_STEPS = 8, 24, 3, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in each worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(actual, expected, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=rtol)


def leaf_err(actual: dict, expected: dict, floor: float = 1.0) -> float:
    """max over leaves of max |actual - expected| over the leaf's scale
    (max |expected|, at least `floor`)."""
    return max(float((actual[k].detach() - v.detach()).abs().max())
               / max(float(v.detach().abs().max()), floor) for k, v in expected.items())


def fake_mesh(tp: int, rank: int = 0, dp: int = 1) -> tmesh.Mesh:
    """A mesh with no process groups: what shard_state and param_sharding
    read (the tp rank and the shape)."""
    return tmesh.Mesh(None, None, None, 0, rank, {"dp": dp, "tp": tp})


# ---- the layout and the split, no processes ------------------------------------------


@pytest.mark.parametrize("n, tp", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (2, 2)])
def test_mesh_layout_is_jax_device_grid(n, tp):
    """Rank r sits where make_mesh puts device r: dp index r // tp, tp index
    r % tp; the tp groups are the grid's rows, the dp groups its columns."""
    jm = jmesh.make_mesh(n_devices=n, tp=tp)
    order = list(jax.devices())[:n]
    grid = [[order.index(d) for d in row] for row in jm.devices]
    layout = tmesh.mesh_layout(n, tp)
    assert dict(jm.shape) == {tmesh.DP_AXIS: layout.dp, tmesh.TP_AXIS: layout.tp}
    assert layout.rows == grid
    assert layout.columns == [list(c) for c in zip(*grid)]
    for r in range(n):
        d, t = layout.coords(r)
        assert grid[d][t] == r


def test_mesh_layout_not_divisible():
    for n, tp in ((8, 3), (2, 4)):
        with pytest.raises(ValueError, match="divisible") as port:
            tmesh.mesh_layout(n, tp)
        with pytest.raises(ValueError, match="divisible") as ref:
            jmesh.make_mesh(n_devices=n, tp=tp)
        assert str(port.value) == str(ref.value)


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def jax_cfg(**model):
    base = jconfig.tiny_config()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **model),
        diffusion=jconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(base.train, batch_size=B, mode_dropout=0.3, lr=1e-2,
                                  grad_clip_norm=1.0, update_clip_rms=1.0, ema_decay=0.9))


@pytest.fixture(scope="module")
def arrays():
    return synthetic_batch_numpy(0, B, L, 15, n_generate=6)


@pytest.fixture(scope="module")
def jax_split_trunk(arrays):
    """A JAX state of the split-trunk model (two IPA stacks, `ipa` and
    `geo_ipa`), perturbed."""
    jcfg = jax_cfg(self_conditioning=True, sc_split_trunk=True)
    jh = JaxDiffAb(jcfg)
    jstate = jh.init(jax.random.key(0), jax_batch(arrays))
    return jcfg, jstate.replace(params=jax.tree.map(jnp.asarray, perturbed(
        jax.device_get(jstate.params), 6)))


@pytest.mark.parametrize("tp", [2, 3])
def test_param_sharding_matches_jax(jax_split_trunk, tp):
    """Every leaf of a split-trunk state: JAX's column split P(None, "tp")
    is the port's dim 0, its row split P("tp", None) dim 1, P() None
    (both IPA stacks split).  At tp = 3 (h = 4) the port replicates every
    IPA layer where JAX still splits the leaves that divide."""
    _, jstate = jax_split_trunk
    n = 2 if tp == 2 else 6
    specs = jmesh.param_sharding(jstate.params, jmesh.make_mesh(n_devices=n, tp=tp))
    flat = jax.tree_util.tree_leaves(specs)
    names = list(params_from_jax(jax.device_get(jstate.params)))  # in the tree's leaf order
    assert len(flat) == len(names)
    ported = tmesh.param_sharding(params_from_jax(jax.device_get(jstate.params)), fake_mesh(tp))
    want = {P(None, "tp"): 0, P("tp", None): 1, P(): None}
    if tp == 2:
        got = {k: None if s is None else s.dim for k, s in ported.items()}
        assert got == {k: want[s.spec] for k, s in zip(names, flat)}
        assert sum(s is not None for s in ported.values()) == 2 * 2 * 8  # 2 stacks x 2 layers
        assert any(k.startswith("denoiser.geo_ipa.") and s for k, s in ported.items())
    else:
        assert all(s is None for s in ported.values())
        assert any(s.spec != P() for s in flat)  # JAX splits the point projections


def test_shards_fit_the_split_layers_and_gather_back(jax_split_trunk):
    """Each rank's part of every parameter has the shape the model built for
    that rank's heads registers, and the parts gather back to the full
    tensors bitwise, at tp = 2 and 4."""
    jcfg, jstate = jax_split_trunk
    params = params_from_jax(jax.device_get(jstate.params))
    cfg = port_config(jcfg).model
    for tp in (2, 4):
        splits = tmesh.param_sharding(params, tp)
        parts = [ttp.shard_state(TrainState(0, params, opt_state_from_jax(
            jax.device_get(jstate.opt_state)), None), fake_mesh(tp, r)).params
            for r in range(tp)]
        for r, part in enumerate(parts):
            model = DiffAbModel(cfg, device="cpu", heads=tmesh.HeadShard(r, tp))
            assert {k: tuple(v.shape) for k, v in part.items()} == {
                k: tuple(v.shape) for k, v in model.state_dict().items()}
        local = tmesh.param_sharding(parts[0], tp)
        assert {k: s and s.dim for k, s in local.items()} == {
            k: s and s.dim for k, s in splits.items()}
        for k, s in local.items():
            full = params[k] if s is None else s.gather([p[k] for p in parts])
            assert torch.equal(full, params[k]), k


def test_jax_sharded_state_carries_across(jax_split_trunk):
    """A JAX TrainState placed by JAX's shard_state on make_mesh(tp=2),
    read through np.asarray, goes through params_from_jax /
    opt_state_from_jax and the port's shard_state to each rank's part of
    the unplaced state, bitwise."""
    jcfg, jstate = jax_split_trunk
    placed = jdp.shard_state(jstate, jmesh.make_mesh(n_devices=2, tp=2))
    qk = placed.params["params"]["denoiser"]["geo_ipa"]["layer_0"]["to_q_scalar"]["kernel"]
    assert not qk.sharding.is_fully_replicated

    def port_state(s):
        host = jax.tree.map(np.asarray, s)
        return TrainState(0, params_from_jax(host.params), opt_state_from_jax(host.opt_state),
                          params_from_jax(host.ema_params))
    for r in range(2):
        a = ttp.shard_state(port_state(placed), fake_mesh(2, r))
        b = ttp.shard_state(port_state(jstate), fake_mesh(2, r))
        for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                     (a.opt_state.nu, b.opt_state.nu), (a.ema_params, b.ema_params)):
            assert all(torch.equal(x[k], y[k]) for k in y)


def test_one_rank_mesh(one_rank_group):
    """make_mesh over one rank; at tp = 1 the sharded step is the single-device
    train_step bit for bit, and shard_state / gather_state keep every value."""
    mesh = tmesh.make_mesh(1)
    assert mesh.shape == {"dp": 1, "tp": 1} and (mesh.dp_rank, mesh.tp_rank) == (0, 0)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_mesh(2)
    harness = DiffAb(port_config(jax_cfg()), device="cpu")
    batch = ProteinBatch.from_numpy(synthetic_batch_numpy(0, B, L, 15, n_generate=6))
    sharded, state = ttp.shard_state(harness.init(0), mesh), harness.init(0)
    step = ttp.make_sharded_train_step(harness, mesh)
    for s in range(2):
        draws = harness.draw(batch, torch.Generator().manual_seed(s))
        sharded, m_tp = step(sharded, batch, draws)
        state, m = harness.train_step(state, batch, draws)
        assert all(torch.equal(m_tp[k], m[k]) for k in m)
        assert all(torch.equal(sharded.params[k], state.params[k]) for k in state.params)
        assert all(torch.equal(sharded.ema_params[k], state.ema_params[k]) for k in state.params)
    back = ttp.gather_state(sharded, mesh)
    assert all(torch.equal(back.params[k], state.params[k]) for k in state.params)


# ---- the one-process reference --------------------------------------------------------


CASES = {  # name: (tp, model fields, train fields)
    "fused": (2, {}, {}),
    "attention_core": (2, dict(fuse_ipa_layer=False), {}),
    "plain_pq_ne_pv": (2, dict(n_value_point_per_head=3), {}),
    "plain_no_pair_bias": (2, dict(use_pair_bias=False), {}),
    "sc_early": (2, dict(self_conditioning=True), {}),
    "sc_split_trunk": (2, dict(self_conditioning=True, sc_split_trunk=True), {}),
    "clipped": (2, {}, dict(grad_clip_norm=1.0, update_clip_rms=1.0)),
    "tp4": (4, {}, {}),
}


def case_config(name):
    """The tiny float32 config of a case: lr 1e-3, clips off unless the case
    turns them on, EMA 0.9, mode dropout 0.3."""
    _, model, train = CASES[name]
    cfg = port_config(jax_cfg())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, **dict(
            dict(lr=1e-3, grad_clip_norm=0.0, update_clip_rms=0.0), **train)))


@pytest.mark.parametrize("case", [c for c in CASES if c != "clipped"])
def test_host_loop_equals_loss_and_grads(case, arrays):
    """The tp ranks' parts of every IPA layer run one after another and
    summed: the loss 1e-6 relative, every gradient leaf 1e-5 of its
    largest entry, against `loss_and_grads` (the kernels' plain versions
    here)."""
    harness = DiffAb(case_config(case), device="cpu")
    state = harness.init(1)
    batch = ProteinBatch.from_numpy(arrays)
    draws = harness.draw(batch, torch.Generator().manual_seed(2))
    loss, metrics, grads = harness.loss_and_grads(state.params, batch, draws, 10)
    host = ttp.host_tp_harness(harness, CASES[case][0])
    loss_h, metrics_h, grads_h = host.loss_and_grads(state.params, batch, draws, 10)
    close(loss_h.detach(), loss.detach(), atol=0, rtol=1e-6)
    for k in metrics:
        close(metrics_h[k].detach(), metrics[k].detach(), atol=0, rtol=1e-6)
    assert leaf_err(grads_h, grads, floor=1e-30) <= 1e-5
    assert max(float(g.abs().max()) for g in grads.values()) > 0


# ---- the processes -----------------------------------------------------------------------


def case_state(name) -> TrainState:
    """A case's seeded initial state."""
    return DiffAb(case_config(name), device="cpu").init(7)


def port_state(jstate) -> TrainState:
    host = jax.device_get(jstate)
    return TrainState(0, {k: v.requires_grad_(True) for k, v in params_from_jax(
        host.params).items()}, opt_state_from_jax(host.opt_state),
        params_from_jax(host.ema_params))


def start_workers(world: int, jobs: list, out: str):
    os.makedirs(out, exist_ok=True)
    inputs = os.path.join(out, "inputs.pt")
    torch.save(jobs, inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), inputs, out], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish(procs, out: str) -> list:
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(logs)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def single_device_run(cfg, state, batch, draws):
    """`train_step` over the draws: each step's gradients (on the
    pre-step parameters), metrics and state."""
    harness = DiffAb(cfg, device="cpu")
    out = []
    for d in draws:
        _, _, grads = harness.loss_and_grads(state.params, batch, d, state.step)
        state, metrics = harness.train_step(state, batch, d)
        out.append(dict(grads={k: v.clone() for k, v in grads.items()}, metrics=metrics,
                        params={k: v.detach().clone() for k, v in state.params.items()},
                        ema={k: v.clone() for k, v in state.ema_params.items()},
                        mu={k: v.clone() for k, v in state.opt_state.mu.items()},
                        nu={k: v.clone() for k, v in state.opt_state.nu.items()}))
    return out


@pytest.fixture(scope="module")
def runs(arrays, tmp_path_factory):
    """Start the two gloo processes (tp = 2: the JAX job, the cases, the
    checkpoints) and the four (tp = 4; dp = 2 x tp = 2), then compute the
    references here while they run: JAX's make_sharded_train_step, the
    single-device steps, the host DP step."""
    root = tmp_path_factory.mktemp("tp")
    batch = ProteinBatch.from_numpy(arrays)
    jcfg = jax_cfg()
    jh = JaxDiffAb(jcfg)
    jb = jax_batch(arrays)
    jstate = jh.init(jax.random.key(0), jb)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, perturbed(
        jax.device_get(jstate.params), 6)))
    key = jax.random.key(5)
    jax_steps = [[jax_draws(jax.random.fold_in(key, s), B, L)] for s in range(N_JAX_STEPS)]
    state0 = port_state(jstate)

    def draws_for(cfg, seed, n_dp=1):
        h = DiffAb(cfg, device="cpu")
        shards = [tmesh.put_global(batch, tmesh.BatchSharding(r, n_dp)) for r in range(n_dp)]
        return [[h.draw(x, torch.Generator().manual_seed(100 * seed + 10 * s + r))
                 for r, x in enumerate(shards)] for s in range(N_STEPS)]

    ck_root = str(root / "ck")
    ckpt.save_checkpoint(os.path.join(ck_root, "replicated"), state0)
    pair_jobs = [dict(name="jax", config=port_config(jcfg), state=state0, batch=batch,
                      draws=jax_steps, tp=2)]
    quad_jobs, case_draws = [], {}
    for i, name in enumerate(CASES):
        cfg = case_config(name)
        case_draws[name] = draws_for(cfg, i)
        job = dict(name=name, config=cfg, state=case_state(name), batch=batch,
                   draws=case_draws[name], tp=CASES[name][0])
        (quad_jobs if CASES[name][0] == 4 else pair_jobs).append(job)
    dp_cfg = case_config("fused")
    case_draws["dp2_tp2"] = draws_for(dp_cfg, 20, n_dp=2)
    quad_jobs.append(dict(name="dp2_tp2", config=dp_cfg, state=case_state("fused"), batch=batch,
                          draws=case_draws["dp2_tp2"], tp=2))
    ck_cfg = case_config("fused")
    pair_jobs.append(dict(name="checkpoint", config=ck_cfg, state=state0, batch=batch,
                          draws=case_draws["fused"][:1], tp=2, checkpoint=ck_root))
    procs = {2: start_workers(2, pair_jobs, str(root / "pair")),
             4: start_workers(4, quad_jobs, str(root / "quad"))}
    try:
        mesh = jmesh.make_mesh(n_devices=2, tp=2)
        step = jdp.make_sharded_train_step(jh, mesh, donate=False)
        js = jdp.shard_state(jstate, mesh)
        jb_placed = jax.device_put(jb, jmesh.batch_sharding(mesh))
        want_jax = []
        for _ in range(N_JAX_STEPS):
            js, m = step(js, jb_placed, key)
            want_jax.append((jax.device_get(m), params_from_jax(jax.device_get(js.params))))
        singles = {name: single_device_run(case_config(name), case_state(name), batch,
                                           [d[0] for d in case_draws[name]])
                   for name in CASES}
        h = DiffAb(dp_cfg, device="cpu")
        shards = [tmesh.put_global(batch, tmesh.BatchSharding(r, 2)) for r in range(2)]
        st, host_dp = case_state("fused"), []
        for d in case_draws["dp2_tp2"]:
            st, m = tdp.host_dp_train_step(h, st, shards, d)
            host_dp.append((m, {k: v.detach().clone() for k, v in st.params.items()},
                            {k: v.clone() for k, v in st.ema_params.items()}))
    finally:
        ranks = {w: finish(p, str(root / ("pair" if w == 2 else "quad")))
                 for w, p in procs.items()}
    return dict(ranks=ranks, want_jax=want_jax, singles=singles, host_dp=host_dp,
                params0=state0.params, case_params0={n: case_state(n).params for n in CASES},
                ck_root=ck_root, ck_cfg=ck_cfg, batch=batch,
                draws=case_draws)


def test_tp_step_matches_jax(runs):
    """Two processes at tp = 2 against JAX's GSPMD step on make_mesh(tp=2),
    3 steps at lr 1e-2 with both clips on, fed JAX's draws."""
    got = runs["ranks"][2][0]["jax"]["steps"]
    for s, ((m_j, p_j), g) in enumerate(zip(runs["want_jax"], got)):
        assert set(g["metrics"]) == set(m_j)
        for k in m_j:
            close(g["metrics"][k], m_j[k], atol=1e-3, rtol=1e-4)
        assert leaf_err(g["params"], p_j) <= 1e-3, f"step {s + 1}: parameters"
    p0 = runs["params0"]
    assert min(leaf_err({k: p0[k]}, {k: v}) for k, v in p_j.items()) > 1e-2


@pytest.mark.parametrize("case", list(CASES) + ["dp2_tp2"])
def test_tp_step_matches_single_device(runs, case):
    """A case's steps on tp ranks against `train_step` (dp x tp: against the
    host DP step): gradients, metrics, parameters, EMA and moments; the
    ranks' replicated leaves bit-identical after every step; every
    parameter leaf moves by more than 10 times its tolerance."""
    world = 4 if case in ("tp4", "dp2_tp2") else 2
    ranks = [r[case] for r in runs["ranks"][world]]
    got = ranks[0]["steps"]
    if case == "dp2_tp2":
        want = [dict(metrics=m, params=p, ema=e) for m, p, e in runs["host_dp"]]
    else:
        want = runs["singles"][case]
    for s, (g, w) in enumerate(zip(got, want)):
        for k, v in w["metrics"].items():
            close(g["metrics"][k], v.detach(), atol=0, rtol=1e-6)
        if "grads" in w:
            assert leaf_err(g["grads"], w["grads"], floor=1e-30) <= 1e-5, f"step {s + 1}"
            assert leaf_err(g["mu"], w["mu"], floor=1e-30) <= 1e-5
            assert leaf_err(g["nu"], w["nu"], floor=1e-30) <= 2e-5
        assert leaf_err(g["params"], w["params"]) <= 1e-5, f"step {s + 1}: parameters"
        assert leaf_err(g["ema"], w["ema"]) <= 1e-5, f"step {s + 1}: EMA"
        for r in ranks[1:]:
            rep = r["steps"][s]["replicated"]
            assert rep.keys() == g["replicated"].keys()
            assert all(torch.equal(rep[k], v) for k, v in g["replicated"].items()), (
                f"step {s + 1}: replicated leaves differ across ranks")
    p0 = runs["case_params0"]["fused" if case == "dp2_tp2" else case]
    reached = [k for k, v in runs["singles"]["fused" if case == "dp2_tp2" else case][0][
        "grads"].items() if float(v.abs().max()) > 0]
    assert min(leaf_err({k: p0[k]}, {k: want[-1]["params"][k]}) for k in reached) > 1e-4
    tp = 2 if case == "dp2_tp2" else CASES[case][0]
    n_split = sum(s is not None for s in tmesh.param_sharding(p0, tp).values())
    assert len(g["replicated"]) == len(ranks[0]["local_shapes"]) - n_split


def test_checkpoints_round_trip(runs, tmp_path):
    """A replicated checkpoint restores into each rank's part bitwise; one
    step from it equals train_step; the sharded state saved and restored
    single-device is the gathered state bitwise; fit under the mesh writes
    a checkpoint cli.sample --device cpu reads."""
    root, cfg = runs["ck_root"], runs["ck_cfg"]
    full = ckpt.restore_checkpoint(os.path.join(root, "replicated"), "cpu")
    for r, rank in enumerate(runs["ranks"][2]):
        got = rank["checkpoint"]["restored"]
        want = ttp.shard_state(full, fake_mesh(2, r))
        assert (got["step"], got["count"]) == (full.step, full.opt_state.count)
        for a, b in ((got["params"], want.params), (got["mu"], want.opt_state.mu),
                     (got["nu"], want.opt_state.nu), (got["ema"], want.ema_params)):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in b)
    ck = runs["ranks"][2][0]["checkpoint"]
    harness = DiffAb(cfg, device="cpu")
    state, m = harness.train_step(full, runs["batch"], runs["draws"]["fused"][0][0])
    for k, v in m.items():
        close(ck["ckpt_metrics"][k], v, atol=0, rtol=1e-6)
    assert leaf_err(ck["ckpt_state"]["params"], state.params) <= 1e-5
    back = ckpt.restore_checkpoint(os.path.join(root, "sharded"), "cpu")
    saved = ck["ckpt_state"]
    assert (back.step, back.opt_state.count) == (saved["step"], saved["count"]) == (1, 1)
    for a, b in ((back.params, saved["params"]), (back.opt_state.mu, saved["mu"]),
                 (back.opt_state.nu, saved["nu"]), (back.ema_params, saved["ema"])):
        assert a.keys() == b.keys() and all(torch.equal(a[k].detach(), b[k]) for k in b)

    fit_dir = os.path.join(root, "fit")
    assert ck["fit_step"] == 2 and ckpt.latest_step(fit_dir) == 2
    assert ckpt.load_model_config(fit_dir) == cfg.model
    c = antibody.from_pdb(os.path.join(REPO, "tests", "fixtures", "ab1_chothia.pdb"), "H", "L",
                          ["A"], keep_fv_only=True)
    patch = str(tmp_path / "p.npz")
    save_patch(patch, featurize_patch(c, 64))
    out = tmp_path / "designs"
    assert tsample.main(["--patch", patch, "--checkpoint-dir", fit_dir, "-n", "2",
                         "-o", str(out), "--device", "cpu"]) in (0, None)
    assert sorted(os.listdir(out)) == ["design_0000.pdb", "design_0001.pdb", "designs.fasta"]
