"""The PyTorch port's sampler: a k-step chain against the JAX package, and
the port's own contracts, on the CPU in float32.

The JAX chain is composed here from the package's public pieces
(`encode_context`, `precompute_pair_biases`, `denoise`, the three reverse
kernels) with the sampler's key schedule; the port runs `sample()` with
the same prior draws (`InitNoise`) and the numbers those keys draw
injected (`StepNoise`).
Tolerance: 1e-3 on coordinates and frames after 8 steps (float32 sums in
another order, compounded through the chain); sequences must be equal.
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

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.diffusion import coordinate as jcoord
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion import sequence as jseq
from diffab_pytorch_tpu.diffusion.schedule import cosine_variance_schedule as jsched
from diffab_pytorch_tpu.geometry import so3 as jso3
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.models.ipa import precompute_pair_biases
from diffab_pytorch_tpu.sampling import sampler as jsampler

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling.sampler import InitNoise, StepNoise, sample
from diffab_pytorch_tpu_torch.weights import init_parameters, load_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T, B, L, N = 8, 1, 20, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t_(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def arrays():
    return synthetic_batch_numpy(0, B, L, 15, n_generate=6)


@pytest.fixture(scope="module")
def port_setup():
    ts = tsched(T, s=0.01)
    return ts, make_orientation_tables(ts)


def test_chain_matches_jax(arrays, port_setup):
    jcfg = jconfig.tiny_config().model
    jm = JaxModel(jcfg)
    jb = JaxBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
                     for k, v in arrays.items()})
    params = jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx, jb.translations,
                              jb.orientations, jnp.zeros((B,)))
    js = jsched(T, s=0.01)
    jt = jorient.make_orientation_tables(js)

    # one numpy initial state for both sides: design-major rows i*N + d
    rng = np.random.default_rng(1)
    bn = B * N
    rep = lambda a: np.repeat(a, N, axis=0)
    gen = rep(arrays["generation_mask"] & arrays["residue_mask"])
    seq_draw = rng.integers(0, 21, (bn, L))
    x_draw = rng.normal(size=(bn, L, 3)).astype(np.float32)
    quat_draw = jax.random.normal(jax.random.key(2), (bn, L, 4))  # jso3.uniform's draw
    seq0 = np.where(gen, seq_draw, rep(arrays["seq_idx"]))
    x0 = np.where(gen[..., None], x_draw, rep(arrays["xyz"][:, :, 1])).astype(np.float32)
    r0 = np.where(gen[..., None, None], np.array(jso3.uniform(jax.random.key(2), (bn, L))),
                  rep(arrays["orientations"])).astype(np.float32)

    # --- JAX: the sampler's step body, composed from the package's pieces
    ctx = arrays["residue_mask"] & ~arrays["generation_mask"]
    clip = 1.5 * np.maximum(np.where(ctx[..., None], np.abs(arrays["xyz"][:, :, 1]), 0.0)
                            .max(axis=(1, 2)), 1.0)
    clip = jnp.asarray(rep(clip.astype(np.float32)))
    res_emb, pair_emb = jm.apply(params, jb, method="encode_context")
    biases = precompute_pair_biases(params["params"]["denoiser"]["ipa"], pair_emb)
    denoise = jax.jit(lambda s, x, r, beta: jm.apply(
        params, s, x, r, res_emb, pair_emb, beta, jnp.asarray(gen),
        jnp.asarray(rep(arrays["residue_mask"])), pair_biases=biases, method="denoise"))
    seq_t, x_t, r_t = jnp.asarray(seq0, jnp.int32), jnp.asarray(x0), jnp.asarray(r0)
    k_loop = jax.random.key(3)
    noise = {}
    jgen = jnp.asarray(gen)
    for t in range(T, 0, -1):
        tvec = jnp.full((bn,), t, jnp.int32)
        den = denoise(seq_t, x_t, r_t, js.beta[tvec])
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_loop, t), 3)
        k_axis, k_theta = jax.random.split(k3)
        k_bin, k_gauss = jax.random.split(k_theta)
        noise[t] = StepNoise(
            gumbel=t_(jax.random.gumbel(k1, (bn, L, 21))),
            coord=t_(jax.random.normal(k2, (bn, L, 3))),
            orientation=AxisAngleNoise(
                axis=t_(jax.random.normal(k_axis, (bn, L, 3))),
                uniform=t_(jax.random.uniform(k_bin, (bn, L))),
                normal=t_(jax.random.normal(k_gauss, (bn, L)))),
        )
        seq_n = jseq.reverse_step(k1, js, seq_t, den["seq_posterior"], tvec, jgen)
        r_n = jorient.reverse_step(k3, jt, r_t, den["orientations_t0"], tvec, jgen)
        x_n = jcoord.reverse_step(k2, js, x_t, den["translations_eps"], tvec, jgen,
                                  x0_clip=clip)
        seq_t, x_t, r_t = seq_n, x_n, r_n

    # --- the port's sampler, same weights, state and draws
    port_cfg = tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tconfig.ModelConfig)})
    tm = load_jax_params(DiffAbModel(port_cfg, device="cpu"), jax.device_get(params))
    ts, tt = port_setup
    out = sample(tm, ts, tt, ProteinBatch.from_numpy(arrays), device="cpu",
                 n_designs=N, init_noise=InitNoise(seq=torch.from_numpy(seq_draw),
                                                   coord=t_(x_draw), rot_prior=t_(quat_draw)),
                 step_noise=noise.__getitem__)
    np.testing.assert_array_equal(out.seq_idx.numpy(), np.asarray(seq_t))
    np.testing.assert_allclose(out.translations.numpy(), np.asarray(x_t), atol=1e-3)
    np.testing.assert_allclose(out.orientations.numpy(), np.asarray(r_t), atol=1e-3)


def test_port_sample_contracts(arrays, port_setup):
    """Design-major rows, unchanged context rows, orthonormal frames, finite
    values — with the port's own generator."""
    cfg = tconfig.tiny_config().model
    model = init_parameters(DiffAbModel(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ts, tt = port_setup
    batch = ProteinBatch.from_numpy(arrays)
    for k, v in ProteinBatch.from_numpy(batch.to_numpy()).to_numpy().items():
        np.testing.assert_array_equal(v, arrays[k])
    out = sample(model, ts, tt, batch, device="cpu", n_designs=N,
                 generator=torch.Generator().manual_seed(1))
    assert out.seq_idx.shape == (B * N, L)
    assert out.translations.shape == (B * N, L, 3)
    assert out.orientations.shape == (B * N, L, 3, 3)
    assert torch.isfinite(out.translations).all() and torch.isfinite(out.orientations).all()
    ctx = ~batch.generation_mask[0]
    for d in range(N):  # row i*N + d is design d of target i
        assert torch.equal(out.seq_idx[d, ctx], batch.seq_idx[0, ctx])
        assert torch.equal(out.translations[d, ctx], batch.translations[0, ctx])
        assert torch.equal(out.orientations[d, ctx], batch.orientations[0, ctx])
    gen = batch.generation_mask[0]
    assert not torch.equal(out.translations[0, gen], out.translations[1, gen])
    rtr = out.orientations.transpose(-1, -2) @ out.orientations
    torch.testing.assert_close(rtr, torch.eye(3).expand_as(rtr), atol=1e-4, rtol=0)


@pytest.mark.parametrize("gen_struct,gen_seq", [(True, False), (False, True)])
def test_port_sample_fixed_modality_is_kept(arrays, port_setup, gen_struct, gen_seq):
    cfg = tconfig.tiny_config().model
    model = init_parameters(DiffAbModel(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ts, tt = port_setup
    batch = ProteinBatch.from_numpy(arrays)
    out = sample(model, ts, tt, batch, device="cpu", generate_structure=gen_struct,
                 generate_sequence=gen_seq, generator=torch.Generator().manual_seed(2))
    gen = batch.generation_mask
    assert torch.equal(out.seq_idx, batch.seq_idx) != gen_seq
    assert torch.equal(out.translations, batch.translations) != gen_struct
    assert torch.equal(out.orientations, batch.orientations) != gen_struct
    assert bool(gen.any())


def test_sample_runs_on_the_card_by_default(arrays, port_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts, tt = port_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample(None, ts, tt, ProteinBatch.from_numpy(arrays))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffAbModel(tconfig.tiny_config().model)


@pytest.mark.parametrize("sc_t_max", [5])
def test_sc_t_max_matches_jax(arrays, port_setup, sc_t_max):
    """A self-conditioned model's chain gated by sc_t_max: the JAX
    `sample()` against the port's with the JAX draws injected (N designs;
    tests/test_torch_selfcond.py holds the other variants and options)."""
    jcfg = dataclasses.replace(jconfig.tiny_config().model, self_conditioning=True)
    jm = JaxModel(jcfg)
    jb = JaxBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
                     for k, v in arrays.items()})
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx,
                                             jb.translations, jb.orientations, jnp.zeros((B,))))
    js = jsched(T, s=0.01)
    key = jax.random.key(4)
    want = jsampler.sample(jm, params, js, jorient.make_orientation_tables(js), jb, key,
                           n_designs=N, sc_t_max=sc_t_max)
    # the JAX sampler's key schedule from the prior
    bn = B * N
    k_init, k_loop = jax.random.split(key)
    ks, kx, kr = jax.random.split(k_init, 3)
    init = InitNoise(seq=t_(jax.random.randint(ks, (bn, L), 0, 21)).long(),
                     coord=t_(jax.random.normal(kx, (bn, L, 3))),
                     rot_prior=t_(jax.random.normal(kr, (bn, L, 4))))
    noise = {}
    for t in range(T, 0, -1):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_loop, t), 3)
        k_axis, k_theta = jax.random.split(k3)
        k_bin, k_gauss = jax.random.split(k_theta)
        noise[t] = StepNoise(gumbel=t_(jax.random.gumbel(k1, (bn, L, 21))),
                             coord=t_(jax.random.normal(k2, (bn, L, 3))),
                             orientation=AxisAngleNoise(
                                 axis=t_(jax.random.normal(k_axis, (bn, L, 3))),
                                 uniform=t_(jax.random.uniform(k_bin, (bn, L))),
                                 normal=t_(jax.random.normal(k_gauss, (bn, L)))))
    tm = load_jax_params(DiffAbModel(tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tconfig.ModelConfig)}),
        device="cpu"), params)
    ts, tt = port_setup
    got = sample(tm, ts, tt, ProteinBatch.from_numpy(arrays), device="cpu", n_designs=N,
                 sc_t_max=sc_t_max, init_noise=init, step_noise=noise.__getitem__)
    np.testing.assert_array_equal(got.seq_idx.numpy(), np.asarray(want.seq_idx))
    np.testing.assert_allclose(got.translations.numpy(), np.asarray(want.translations),
                               atol=1e-3)
    np.testing.assert_allclose(got.orientations.numpy(), np.asarray(want.orientations),
                               atol=1e-3)


def test_reference_option_defaults_run(arrays, port_setup):
    """The options the JAX sample CLI passes on every call, at their
    defaults, give the default chain draw for draw."""
    cfg = tconfig.tiny_config().model
    model = init_parameters(DiffAbModel(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ts, tt = port_setup
    batch = ProteinBatch.from_numpy(arrays)
    run = lambda **kw: sample(model, ts, tt, batch, device="cpu",
                              generator=torch.Generator().manual_seed(3), **kw)
    base = run()
    out = run(step_schedule="uniform", step_schedule_p=0.5, coord_solver_t_min=0,
              coord_solver="none", noise_t_max=None, n_steps=None, n_fine_tail=None,
              coord_ddim_t_min=None, orientation_reverse="renoise", init="prior",
              chord_orientations=False, return_trajectory=False, sc_t_max=None)
    for a, b in zip(out, base):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(TypeError):
        run(n_step=3)


def test_import_pulls_in_no_jax():
    code = ("import sys, diffab_pytorch_tpu_torch.sampling.sampler, "
            "diffab_pytorch_tpu_torch.weights, diffab_pytorch_tpu_torch.train.trainer, "
            "diffab_pytorch_tpu_torch.train.checkpoint, "
            "diffab_pytorch_tpu_torch.diffusion.coordinate, "
            "diffab_pytorch_tpu_torch.diffusion.sequence, "
            "diffab_pytorch_tpu_torch.diffusion.orientation, "
            "diffab_pytorch_tpu_torch.geometry.igso3, "
            "diffab_pytorch_tpu_torch.ops.ipa_attention, "
            "diffab_pytorch_tpu_torch.ops.ipa_fused_layer, "
            "diffab_pytorch_tpu_torch.sampling.scoring, "
            "diffab_pytorch_tpu_torch.evaluation.metrics, "
            "diffab_pytorch_tpu_torch.structure.relax, "
            "diffab_pytorch_tpu_torch.structure.antibody, "
            "diffab_pytorch_tpu_torch.structure.patch, "
            "diffab_pytorch_tpu_torch.data.dataset, "
            "diffab_pytorch_tpu_torch.cli.sample, "
            "diffab_pytorch_tpu_torch.cli.evaluate, "
            "diffab_pytorch_tpu_torch.cli.preprocess, "
            "diffab_pytorch_tpu_torch.cli.train, "
            "diffab_pytorch_tpu_torch.data.loader, "
            "diffab_pytorch_tpu_torch.data.synthetic, "
            "diffab_pytorch_tpu_torch.structure.native, "
            "diffab_pytorch_tpu_torch.structure.testing; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.split('.')[0] in ('flax', 'optax', 'diffab_pytorch_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
