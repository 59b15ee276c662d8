"""The port's few-step recipes and t-restart (the JAX `sample()` options
beyond the main path) against the JAX package, on the CPU in float32.

The JAX side is the package's own `sample()` / `optimize()` with a key;
the port runs `sample()` with every number that key schedule draws
injected (`InitNoise` for the initialization, `StepNoise` per step), from
the same weights and batch.  The pieces the options run through
(`timestep_schedule`, the anchor chords, the single-step sequence
forward, the DDIM coordinate step, the step from an explicit x0 and the
continuous-sigma IGSO(3) sampler) are compared one by one first.

Tolerances: the schedules and sampled sequences exactly; float32
elementwise pieces to 1e-5 (frames to 3e-5: the matrix logarithm and
exponential round differently in the last bits); sampler chains to 1e-3
on coordinates and frames (float32 sums in another order, compounded
through the chain), as tests/test_torch_sampler.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.diffusion import coordinate as jcoord
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion import sequence as jseq
from diffab_pytorch_tpu.diffusion.schedule import cosine_variance_schedule as jsched
from diffab_pytorch_tpu.geometry import igso3 as jigso3
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.sampling import sampler as jsampler

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.diffusion import coordinate as tcoord
from diffab_pytorch_tpu_torch.diffusion import sequence as tseq
from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry import igso3 as tigso3
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from diffab_pytorch_tpu_torch.weights import load_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T, L, N, K = 8, 20, 2, 21


def t_(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, atol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=1e-5)


def axis_angle(key, shape):
    """The numbers jax igso3.sample_axis_angle(_continuous)(key, ...) draws."""
    k_axis, k_theta = jax.random.split(key)
    k_bin, k_gauss = jax.random.split(k_theta)
    return tigso3.AxisAngleNoise(axis=t_(jax.random.normal(k_axis, shape + (3,))),
                                 uniform=t_(jax.random.uniform(k_bin, shape)),
                                 normal=t_(jax.random.normal(k_gauss, shape)))


# ---- the pieces ------------------------------------------------------------------

SCHEDULES = [  # (t_start, n_steps, schedule, p, n_fine_tail)
    (100, None, "uniform", 0.5, None), (100, 100, "uniform", 0.5, None),
    (100, 25, "uniform", 0.5, None), (60, 10, "uniform", 0.5, None),
    (60, 22, "uniform", 0.5, 12), (100, 25, "hight", 0.5, None),
    (100, 25, "hight", 0.25, None), (7, 3, "uniform", 0.5, None), (8, 5, "uniform", 0.5, 2),
    (8, 7, "uniform", 0.5, 6), (60, 13, "hight", 0.8, None), (1, 3, "uniform", 0.5, None),
]


@pytest.mark.parametrize("args", SCHEDULES)
def test_timestep_schedule_matches_jax(args):
    got = tsampler.timestep_schedule(*args)
    want = jsampler.timestep_schedule(*args)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 1 and np.all(np.diff(got) < 0)


@pytest.mark.parametrize("args", [(60, 10, "hight", 0.5, 3), (60, 10, "uniform", 0.5, 10),
                                  (60, 10, "uniform", 0.5, 12)])
def test_timestep_schedule_rejects_what_jax_rejects(args):
    with pytest.raises(ValueError):
        jsampler.timestep_schedule(*args)
    with pytest.raises(ValueError):
        tsampler.timestep_schedule(*args)


def chord_batch():
    """Two targets: the first one chain (both anchors flank the generated
    span), the second the synthetic two-chain layout (the span crosses the
    chain break: no anchor pair, the prior fallback)."""
    arrays = synthetic_batch_numpy(0, 2, L, 15, n_generate=6)
    arrays["chain_idx"][0] = 1
    return arrays


def test_anchor_chords_match_jax():
    a = chord_batch()
    gen = a["generation_mask"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, L, 3)).astype(np.float32)
    jargs = [jnp.asarray(a[k]) for k in ("residue_idx", "chain_idx", "residue_mask")]
    targs = [t_(a[k]) for k in ("residue_idx", "chain_idx", "residue_mask")]
    xj, hj = jsampler.anchor_chord(jnp.asarray(x), *jargs, jnp.asarray(gen))
    xt, ht = tsampler.anchor_chord(t_(x), *targs, t_(gen))
    close(xt, xj)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert bool(ht[0].any()) and not bool(ht[1].any())
    rj, hj = jsampler.anchor_chord_frames(jnp.asarray(a["orientations"]), *jargs,
                                          jnp.asarray(gen))
    rt, ht = tsampler.anchor_chord_frames(t_(a["orientations"]), *targs, t_(gen))
    close(rt, rj, atol=3e-5)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


@pytest.fixture(scope="module")
def scheds():
    return jsched(T, s=0.01), tsched(T, s=0.01)


def test_single_step_sequence_forward_matches_jax(scheds):
    js, ts = scheds
    rng = np.random.default_rng(4)
    seq = rng.integers(0, K, (3, L))
    t = np.array([1, 4, 8])
    gen = rng.random((3, L)) < 0.5
    jargs = (jnp.asarray(seq, jnp.int32), jnp.asarray(t, jnp.int32), jnp.asarray(gen))
    targs = (t_(seq), t_(t), t_(gen))
    close(tseq.forward_prob_single_step(ts, *targs), jseq.forward_prob_single_step(js, *jargs))
    key = jax.random.key(5)
    want = jseq.diffuse_single_step(key, js, *jargs)
    got = tseq.diffuse_single_step(ts, *targs, gumbel=t_(jax.random.gumbel(key, (3, L, K))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def coord_state(seed):
    rng = np.random.default_rng(seed)
    return dict(x=(rng.normal(size=(3, L, 3)) * 2).astype(np.float32),
                eps=rng.normal(size=(3, L, 3)).astype(np.float32),
                t=np.array([8, 5, 2]), s=np.array([4, 0, 1]),
                gen=rng.random((3, L)) < 0.6)


@pytest.mark.parametrize("noise_scale", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("clip", [None, "per_sample"])
def test_ddim_and_x0_steps_match_jax(scheds, noise_scale, clip):
    js, ts = scheds
    st = coord_state(6)
    x0_clip = None if clip is None else np.array([0.5, 2.0, 50.0], np.float32)
    jclip = None if clip is None else jnp.asarray(x0_clip)
    tclip = None if clip is None else t_(x0_clip)
    key = jax.random.key(7)
    z = t_(jax.random.normal(key, (3, L, 3)))
    jt, jsv = jnp.asarray(st["t"], jnp.int32), jnp.asarray(st["s"], jnp.int32)
    jx, jeps, jgen = jnp.asarray(st["x"]), jnp.asarray(st["eps"]), jnp.asarray(st["gen"])
    tx, teps, tt, tsv, tgen = (t_(st[k]) for k in ("x", "eps", "t", "s", "gen"))
    want = jcoord.reverse_step(key, js, jx, jeps, jt, jgen, x0_clip=jclip,
                               noise_scale=noise_scale, s=jsv, mode="ddim")
    got = tcoord.reverse_step(ts, tx, teps, tt, tgen, x0_clip=tclip, noise_scale=noise_scale,
                              s=tsv, mode="ddim", noise=z)
    close(got, want)
    x0 = jcoord.predicted_x0(js, jx, jeps, jt) * 0.9
    want = jcoord.reverse_step_from_x0(key, js, jx, x0, jt, jgen, x0_clip=jclip,
                                       noise_scale=noise_scale, s=jsv)
    got = tcoord.reverse_step_from_x0(ts, tx, t_(x0), tt, tgen, x0_clip=tclip,
                                      noise_scale=noise_scale, s=tsv, noise=z)
    close(got, want)
    # from the implied x0 it is the posterior step
    x0_t = tcoord.predicted_x0(ts, tx, teps, tt)
    close(tcoord.reverse_step_from_x0(ts, tx, x0_t, tt, tgen, x0_clip=tclip,
                                      noise_scale=noise_scale, s=tsv, noise=z),
          tcoord.reverse_step(ts, tx, teps, tt, tgen, x0_clip=tclip, noise_scale=noise_scale,
                              s=tsv, noise=z))
    with pytest.raises(ValueError):
        tcoord.reverse_step(ts, tx, teps, tt, tgen, mode="heun")


@pytest.fixture(scope="module")
def tables(scheds):
    js, ts = scheds
    return jorient.make_orientation_tables(js), make_orientation_tables(ts)


def test_continuous_igso3_sampler_matches_jax(tables):
    jt, tt = tables
    # below, between and above the table's rows, and across the threshold
    sigma = np.array([0.0, 0.003, 0.05, 0.09, 0.11, 0.5, 0.97, 1.2], np.float32)
    key = jax.random.key(9)
    want = jigso3.sample_axis_angle_continuous(key, jt.igso3, jnp.asarray(sigma), (L,))
    got = tigso3.sample_axis_angle_continuous(tt.igso3, t_(sigma), (L,),
                                              noise=axis_angle(key, (len(sigma), L)))
    close(got, want, atol=2e-5)


# ---- sampler chains --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.tiny_config().model
    jm = JaxModel(jcfg)
    a = chord_batch()
    jb = JaxBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
                     for k, v in a.items()})
    params = jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx, jb.translations,
                              jb.orientations, jnp.zeros((2,)))
    port_cfg = tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tconfig.ModelConfig)})
    tm = load_jax_params(DiffAbModel(port_cfg, device="cpu"), jax.device_get(params))
    return jm, params, jb, tm, ProteinBatch.from_numpy(a)


def jax_draws(key, opts, t_seq, bn):
    """The numbers the JAX sampler's key schedule draws for these options:
    (InitNoise, {t: StepNoise})."""
    k_init, k_loop = jax.random.split(key)
    ks, kx, kr = jax.random.split(k_init, 3)
    t_start = opts.get("t_start", T)
    prior_seq = lambda k: t_(jax.random.randint(k, (bn, L), 0, K)).long()
    normal = lambda k, *s: t_(jax.random.normal(k, (bn, L) + s))
    if opts.get("init", "prior") == "chord":
        kx1, kx2 = jax.random.split(kx)
        init = tsampler.InitNoise(seq=prior_seq(ks), coord=normal(kx1, 3),
                                  coord_prior=normal(kx2, 3), rot_prior=normal(kr, 4))
        if opts.get("chord_orientations"):
            kr1, kr2 = jax.random.split(kr)
            init = init._replace(rot=axis_angle(kr1, (bn, L)), rot_prior=normal(kr2, 4))
    elif t_start == T:
        init = tsampler.InitNoise(seq=prior_seq(ks), coord=normal(kx, 3),
                                  rot_prior=normal(kr, 4))
    else:
        init = tsampler.InitNoise(seq=t_(jax.random.gumbel(ks, (bn, L, K))),
                                  coord=normal(kx, 3), rot=axis_angle(kr, (bn, L)))
    steps = {}
    for t in t_seq:
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_loop, int(t)), 3)
        steps[int(t)] = tsampler.StepNoise(gumbel=t_(jax.random.gumbel(k1, (bn, L, K))),
                                           coord=normal(k2, 3),
                                           orientation=axis_angle(k3, (bn, L)))
    return init, steps


CHAINS = {
    "n_steps_uniform": dict(n_steps=4),
    "n_steps_hight": dict(n_steps=4, step_schedule="hight", step_schedule_p=0.5),
    "fine_tail_noise_t_max": dict(n_steps=5, n_fine_tail=2, noise_t_max=2),
    "chord": dict(init="chord", t_start=6, n_steps=4, noise_scale=0.0),
    "chord_orientations": dict(init="chord", chord_orientations=True, t_start=6, n_steps=4),
    "t_start": dict(t_start=5),
    "coord_ddim_t_min": dict(coord_ddim_t_min=3, noise_scale=0.5, n_steps=5),
    "heun": dict(coord_solver="heun", coord_solver_t_min=2, n_steps=4),
    "ab2": dict(coord_solver="ab2", n_steps=5),
    "posterior": dict(orientation_reverse="posterior", n_steps=5),
    "trajectory": dict(return_trajectory=True, n_steps=4, orientation_reverse="posterior"),
    "c2_defaults": dict(step_schedule="uniform", step_schedule_p=0.5, coord_solver_t_min=0),
}


def run_chain(models, scheds, tables, opts, optimize=False):
    jm, params, jb, tm, tb = models
    js, ts = scheds
    jt, tt = tables
    key = jax.random.key(11)
    if optimize:
        t_restart = opts.pop("t_start")
        want = jsampler.optimize(jm, params, js, jt, jb, key, t_restart, n_designs=N, **opts)
        opts["t_start"] = t_restart
    else:
        want = jsampler.sample(jm, params, js, jt, jb, key, n_designs=N, **opts)
    t_seq = tsampler.timestep_schedule(opts.get("t_start", T), opts.get("n_steps"),
                                       opts.get("step_schedule", "uniform"),
                                       opts.get("step_schedule_p", 0.5),
                                       opts.get("n_fine_tail"))
    init, steps = jax_draws(key, opts, t_seq, 2 * N)
    kw = dict(device="cpu", n_designs=N, init_noise=init, step_noise=steps.__getitem__)
    if optimize:
        t_restart = opts.pop("t_start")
        got = tsampler.optimize(tm, ts, tt, tb, t_restart, **kw, **opts)
    else:
        got = tsampler.sample(tm, ts, tt, tb, **kw, **opts)
    return got, want, len(t_seq)


def check_result(got, want):
    np.testing.assert_array_equal(got.seq_idx.numpy(), np.asarray(want.seq_idx))
    close(got.translations, want.translations, atol=1e-3)
    close(got.orientations, want.orientations, atol=1e-3)


@pytest.mark.parametrize("name", list(CHAINS))
def test_sampler_chain_matches_jax(models, scheds, tables, name):
    got, want, n_steps = run_chain(models, scheds, tables, dict(CHAINS[name]))
    check_result(got, want)
    assert torch.isfinite(got.translations).all()
    if name == "trajectory":
        for field in ("seq_trajectory", "translations_trajectory", "orientations_trajectory"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.shape[0] == n_steps and tuple(g.shape) == tuple(w.shape)
            if field == "seq_trajectory":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                close(g, w, atol=1e-3)
        assert torch.equal(got.translations_trajectory[-1], got.translations)
    else:
        assert got.seq_trajectory is None and want.seq_trajectory is None


def test_optimize_matches_jax(models, scheds, tables):
    got, want, _ = run_chain(models, scheds, tables, dict(t_start=4, n_steps=3), optimize=True)
    check_result(got, want)


def test_sampler_rejects_what_jax_rejects(models, scheds, tables):
    _, _, _, tm, tb = models
    ts, tt = scheds[1], tables[1]
    for bad in (dict(t_start=0), dict(t_start=T + 1), dict(coord_solver="rk4"),
                dict(coord_solver="heun", coord_ddim_t_min=3), dict(init="zeros"),
                dict(step_schedule="lowt"), dict(step_schedule="hight", n_fine_tail=2),
                dict(orientation_reverse="slerp")):
        with pytest.raises(ValueError):
            tsampler.sample(tm, ts, tt, tb, device="cpu", **bad)
