"""The port's design scorer and ranking against the JAX package, on the
CPU in float32: `score_designs` with tiny_config() weights transplanted
from a JAX init, 2 targets x 3 designs (and x 1), the numbers the JAX key
schedule draws at each (t, draw) grid point injected as `ScoreDraws`.

Tolerance: 1e-5 on every score (absolute, and relative to scores of a
few units): the same denoiser on the same noised designs, float32 sums in
another order.  Ranks exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion.schedule import cosine_variance_schedule as jsched
from diffab_pytorch_tpu.geometry import so3 as jso3
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.sampling import scoring as jscoring
from diffab_pytorch_tpu.sampling.sampler import SampleResult as JaxResult

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.diffusion import orientation as torient
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling import scoring as tscoring
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
from diffab_pytorch_tpu_torch.train.harness import DiffAb
from diffab_pytorch_tpu_torch.weights import load_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

T, B, L, K = 40, 2, 24, 21
TABLES = dict(n_bins=256, n_terms=128)
MODES = {"codesign": (True, True), "fix-sequence": (True, False),
         "fix-structure": (False, True)}
KEY = 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one worker process per core: torch's own thread pool
    in each would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a):
    return torch.from_numpy(np.array(a))


def jax_score_draws(grid, n_draws, bn):
    """The numbers JAX score_designs(key) draws: per (t, d), k =
    fold_in(fold_in(key, t), d) split into the sequence, coordinate and
    orientation keys."""
    key = jax.random.key(KEY)
    gumbel, coord, axis, uniform, normal = [], [], [], [], []
    for t in grid:
        for d in range(n_draws):
            ks, kx, kr = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, t), d), 3)
            k_axis, k_theta = jax.random.split(kr)
            k_bin, k_gauss = jax.random.split(k_theta)
            gumbel.append(jax.random.gumbel(ks, (bn, L, K)))
            coord.append(jax.random.normal(kx, (bn, L, 3)))
            axis.append(jax.random.normal(k_axis, (bn, L, 3)))
            uniform.append(jax.random.uniform(k_bin, (bn, L)))
            normal.append(jax.random.normal(k_gauss, (bn, L)))
    st = lambda xs: t_(np.stack(xs))
    return tscoring.ScoreDraws(st(gumbel), st(coord), AxisAngleNoise(st(axis), st(uniform),
                                                                     st(normal)))


@pytest.fixture(scope="module")
def setup():
    arrays = synthetic_batch_numpy(0, B, L, 15, n_generate=6)
    jb = JaxBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
                     for k, v in arrays.items()})
    jcfg = jconfig.tiny_config().model
    jm = JaxModel(jcfg)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx, jb.translations,
                                             jb.orientations, jnp.zeros((B,))))
    js = jsched(T, s=0.01)
    ts = tsched(T, s=0.01)
    return dict(arrays=arrays, jb=jb, jcfg=jcfg, jm=jm, params=params, js=js,
                jt=jorient.make_orientation_tables(js, **TABLES), ts=ts,
                tt=torient.make_orientation_tables(ts, **TABLES))


def make_designs(arrays, n, seed=1):
    """n designs of each target, design-major: the target's rows with
    random types, moved CAs and random frames at its generated positions."""
    rng = np.random.default_rng(seed)
    rep = lambda a: np.repeat(a, n, axis=0)
    gen = rep(arrays["generation_mask"] & arrays["residue_mask"])
    seq = np.where(gen, rng.integers(0, 20, gen.shape), rep(arrays["seq_idx"]))
    x = rep(arrays["xyz"][:, :, 1])
    x = np.where(gen[..., None], x + rng.normal(size=x.shape) * 0.5, x).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(seed), gen.shape))
    rot = np.where(gen[..., None, None], rot, rep(arrays["orientations"])).astype(np.float32)
    return seq, x, rot


def port_model(setup, fuse):
    cfg = dataclasses.replace(tconfig.ModelConfig(**{
        f.name: getattr(setup["jcfg"], f.name) for f in dataclasses.fields(tconfig.ModelConfig)
        if f.name != "fuse_ipa_layer"}), fuse_ipa_layer=fuse)
    return load_jax_params(DiffAbModel(cfg, device="cpu"), setup["params"])


_jax_cache = {}


def jax_scores(setup, mode, n):
    if (mode, n) not in _jax_cache:
        seq, x, rot = make_designs(setup["arrays"], n)
        gs, gq = MODES[mode]
        fn = jax.jit(lambda p, b, d: jscoring.score_designs(
            setup["jm"], p, setup["js"], setup["jt"], b, d, jax.random.key(KEY),
            generate_structure=gs, generate_sequence=gq))
        out = fn(setup["params"], setup["jb"],
                 JaxResult(jnp.asarray(seq, jnp.int32), jnp.asarray(x), jnp.asarray(rot)))
        _jax_cache[(mode, n)] = {k: np.asarray(getattr(out, k))
                                 for k in tscoring.DesignScores._fields}
    return _jax_cache[(mode, n)]


@pytest.mark.parametrize("fuse", [None, False])
@pytest.mark.parametrize("mode,n", [("codesign", 3), ("fix-sequence", 3), ("fix-structure", 3),
                                    ("codesign", 1)])
def test_scores_match_jax(setup, mode, n, fuse):
    seq, x, rot = make_designs(setup["arrays"], n)
    grid = tscoring.default_t_grid(T)
    assert len(grid) == 8
    draws = jax_score_draws(grid.tolist(), 2, B * n)
    gs, gq = MODES[mode]
    out = tscoring.score_designs(
        port_model(setup, fuse), setup["ts"], setup["tt"],
        ProteinBatch.from_numpy(setup["arrays"]), SampleResult(t_(seq), t_(x), t_(rot)),
        device="cpu", draws=draws, generate_structure=gs, generate_sequence=gq)
    want = jax_scores(setup, mode, n)
    for k in tscoring.DesignScores._fields:
        got = getattr(out, k).numpy()
        assert got.shape == (B * n,)
        np.testing.assert_allclose(got, want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    if not gs:
        assert float(out.translations_score.abs().max()) == 0.0
    if not gq:
        assert float(out.seq_score.abs().max()) == 0.0


def test_default_grid_is_the_jax_grid():
    for t_max in (1, 4, 8, 40, 100, 1000):
        want = np.unique(np.round(np.linspace(1, max(t_max // 4, 1), num=8)).astype(np.int64))
        np.testing.assert_array_equal(tscoring.default_t_grid(t_max), want)


def test_harness_wrapper_and_own_draws(setup):
    """DiffAb.score_designs loads the parameters and runs the scorer; with
    no injected draws the generator draws them, on the device, and one seed
    gives one score."""
    seq, x, rot = make_designs(setup["arrays"], 3)
    designs = SampleResult(t_(seq), t_(x), t_(rot))
    batch = ProteinBatch.from_numpy(setup["arrays"])
    cfg = tconfig.DiffAbConfig(model=port_model(setup, None).cfg,
                               diffusion=tconfig.DiffusionConfig(T=T, igso3_n_bins=256,
                                                                 igso3_n_terms=128))
    harness = DiffAb(cfg, device="cpu")
    params = port_model(setup, None).state_dict()
    grid = [2, 5]
    draws = jax_score_draws(grid, 1, B * 3)
    via = harness.score_designs(params, batch, designs, t_grid=grid, n_draws=1, draws=draws)
    direct = tscoring.score_designs(port_model(setup, None), harness.sched,
                                    harness.orientation_tables, batch, designs, device="cpu",
                                    t_grid=grid, n_draws=1, draws=draws)
    for a, b in zip(via, direct):
        assert torch.equal(a, b)
    own = [harness.score_designs(None, batch, designs, generator=torch.Generator().manual_seed(s))
           for s in (3, 3, 4)]
    assert torch.equal(own[0].score, own[1].score)
    assert not torch.equal(own[0].score, own[2].score)
    assert bool(torch.isfinite(own[0].score).all())


def test_rank_per_target_matches_jax():
    scores = np.array([3.0, 1.0, 2.0, 0.5, 0.1, 0.9, 2.0, 2.0, 1.0], np.float32)
    got = tscoring.rank_per_target(t_(scores), 3).numpy()
    want = np.asarray(jscoring.rank_per_target(jnp.asarray(scores), 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 2, 0], [1, 0, 2], [2, 0, 1]])


def test_bad_inputs(setup):
    """The JAX scorer's errors, and a draw count that does not fit the
    grid."""
    seq, x, rot = make_designs(setup["arrays"], 3)
    model = port_model(setup, None)
    batch = ProteinBatch.from_numpy(setup["arrays"])
    run = lambda d, **kw: tscoring.score_designs(model, setup["ts"], setup["tt"], batch, d,
                                                 device="cpu", **kw)
    full = SampleResult(t_(seq), t_(x), t_(rot))
    with pytest.raises(ValueError, match="not a multiple"):
        run(SampleResult(*(a[:B * 3 - 1] for a in full[:3])))
    with pytest.raises(ValueError, match="nothing was generated"):
        run(full, generate_structure=False, generate_sequence=False)
    with pytest.raises(ValueError, match="t_grid"):
        run(full, t_grid=(0, 5))
    with pytest.raises(ValueError, match="t_grid"):
        run(full, t_grid=(T + 1,))
    with pytest.raises(ValueError, match="grid points"):
        run(full, t_grid=(1, 2), draws=jax_score_draws([1], 2, B * 3))
