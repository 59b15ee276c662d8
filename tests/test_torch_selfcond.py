"""The port's self-conditioning against the JAX package, on the CPU in
float32 (mirrors tests/test_selfcond.py): the four denoiser variants
(early fusion, geometry-only, late fusion, split trunk) with an estimate,
the two-pass training loss and its gradients, the sampler's carry with
sc_t_max, heun and design fan-out, scoring a self-conditioned model, the
schedule, the flags and the recorded model config.

The JAX parameters (perturbed, so that no bias is trivially zero) are
carried into the port by name (`weights.load_jax_params`); the JAX side
is jitted; every random number the JAX keys draw is fed to the port
(`StepDraws.sc_u` is the uniform behind `jax.random.bernoulli(k_sc, ...)`).

Tolerances: 1e-5 on a denoiser forward (the same float32 model; the two
sides sum in other orders); 1e-5 on the sequence-weighted losses; 1e-3
on the whole loss and 1e-3 of each gradient leaf's largest entry (the
training tolerance of tests/test_torch_train.py: two models summing
float32 products in other orders, the port's IPA logits through the
kernels' |q|^2 + |k|^2 - 2 q.k expansion); sampled sequences exactly and
1e-3 on coordinates and frames after the chain (tests/test_torch_fewstep.py);
1e-5 on design scores (tests/test_torch_scoring.py); 2e-4 on SE(3)
equivariance (tests/test_selfcond.py).
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
from diffab_pytorch_tpu.models import ipa as jipa
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.sampling import sampler as jsampler
from diffab_pytorch_tpu.sampling import scoring as jscoring
from diffab_pytorch_tpu.train import checkpoint as jckpt
from diffab_pytorch_tpu.train import losses as jlosses
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.diffusion import orientation as torient
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models import ipa as tipa
from diffab_pytorch_tpu_torch.models.denoiser import sc_feature_width
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler
from diffab_pytorch_tpu_torch.sampling import scoring as tscoring
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train import losses as tlosses
from diffab_pytorch_tpu_torch.train.harness import DiffAb, StepDraws
from diffab_pytorch_tpu_torch.train.trainer import fit
from diffab_pytorch_tpu_torch.weights import load_jax_params, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False

T, B, L, K, N = 8, 4, 24, 21, 2
TABLES = dict(n_bins=256, n_terms=128)
VARIANTS = {
    "early": {},
    "geometry_only": dict(self_conditioning_sequence=False),
    "late": dict(sc_late_fusion=True),
    "split": dict(sc_split_trunk=True),
}


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


def close(actual, expected, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=rtol)


def jax_batch(arrays):
    return JaxBatch(**{k: (None if v is None else jnp.asarray(
        v.astype(np.int32) if v.dtype.kind in "iu" else v)) for k, v in arrays.items()})


def sc_model_config(variant, **extra):
    return dataclasses.replace(jconfig.tiny_config().model, self_conditioning=True,
                               **VARIANTS[variant], **extra)


def port_model_config(jcfg):
    return tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(tconfig.ModelConfig)
                                  if hasattr(jcfg, f.name)})


@pytest.fixture(scope="module")
def arrays():
    return synthetic_batch_numpy(0, B, L, 15, n_generate=6)


_models = {}


def models(arrays, variant):
    """(JAX config, JAX model, perturbed JAX params, port model with them)."""
    if variant not in _models:
        jcfg = sc_model_config(variant)
        jm = JaxModel(jcfg)
        jb = jax_batch(arrays)
        params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx,
                                                 jb.translations, jb.orientations,
                                                 jnp.zeros((B,))))
        rng = np.random.default_rng(1)
        params = jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, params)
        tm = load_jax_params(DiffAbModel(port_model_config(jcfg), device="cpu"), params)
        _models[variant] = (jcfg, jm, params, tm)
    return _models[variant]


def estimate(rng, x):
    """An estimate near x (b, L, 3), a p(s_0) and a mixed per-residue flag."""
    b, n_res = x.shape[:2]
    return ((x + rng.normal(size=x.shape)).astype(np.float32),
            rng.dirichlet(np.ones(K), (b, n_res)).astype(np.float32),
            (rng.random((b, n_res)) < 0.6).astype(np.float32))


# ---- the denoiser ----------------------------------------------------------------


@pytest.mark.parametrize("variant", [None, *VARIANTS])
def test_param_tree_matches_jax(arrays, variant):
    """Every JAX leaf has its port parameter by name and shape (the
    transplant leaves none out); self-conditioning off keeps the default
    tree: a 2d-wide fuse_0 and no geo_* modules."""
    jcfg = (jconfig.tiny_config().model if variant is None else sc_model_config(variant))
    jb = jax_batch(arrays)
    tree = jax.eval_shape(JaxModel(jcfg).init, jax.random.key(0), jb, jb.seq_idx,
                          jb.translations, jb.orientations, jnp.zeros((B,)))
    want = {k: tuple(v.shape) for k, v in params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    model = DiffAbModel(port_model_config(jcfg), device="cpu")
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == want
    d = jcfg.d_residue_emb
    sc_w = sc_feature_width(port_model_config(jcfg))
    early = variant in ("early", "geometry_only")
    assert got["denoiser.fuse_0.weight"] == (d, 2 * d + (sc_w if early else 0))
    assert got["denoiser.coordinate_head.dense_0.weight"][1] == d + 3 + (
        sc_w if variant == "late" else 0)
    assert got["denoiser.sequence_head.dense_0.weight"][1] == d + 3
    assert any(k.startswith("denoiser.geo_ipa.") for k in got) == (variant == "split")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_denoise_matches_jax(arrays, variant):
    """`denoise` with an estimate under design fan-out (n = 2 designs of
    each target sharing its context), a mixed per-residue flag; the split
    trunk's geo_ipa biases both projected in the layer and hoisted."""
    jcfg, jm, params, tm = models(arrays, variant)
    rng = np.random.default_rng(9)
    bn = B * N
    seq = rng.integers(0, K, (bn, L))
    x = rng.normal(size=(bn, L, 3)).astype(np.float32)
    r = np.array(jso3.uniform(jax.random.key(3), (bn, L)))
    beta = rng.random(bn).astype(np.float32)
    gen = np.repeat(arrays["generation_mask"], N, 0)
    rmask = np.repeat(arrays["residue_mask"], N, 0)
    sc_x, sc_p, sc_m = estimate(rng, x)

    @jax.jit
    def jax_denoise(p):
        res, pair = jm.apply(p, jax_batch(arrays), method="encode_context")
        biases = jipa.precompute_pair_biases(p["params"]["denoiser"]["ipa"], pair)
        return jm.apply(p, jnp.asarray(seq, jnp.int32), jnp.asarray(x), jnp.asarray(r), res,
                        pair, jnp.asarray(beta), jnp.asarray(gen), jnp.asarray(rmask),
                        pair_biases=biases, sc_translations_x0=jnp.asarray(sc_x),
                        sc_seq_probs=jnp.asarray(sc_p), sc_mask=jnp.asarray(sc_m),
                        method="denoise")

    want = jax_denoise(params)
    with torch.no_grad():
        res, pair = tm.encode_context(ProteinBatch.from_numpy(arrays))
        biases = tipa.precompute_pair_biases(tm.denoiser.ipa, pair)
        args = (t_(seq), t_(x), t_(r), res, pair, t_(beta), t_(gen), t_(rmask))
        sc = dict(sc_translations_x0=t_(sc_x), sc_seq_probs=t_(sc_p), sc_mask=t_(sc_m))
        got = tm.denoise(*args, pair_biases=biases, **sc)
        hoisted = tm.denoise(*args, **tsampler.hoist_denoiser_constants(tm, pair), **sc)
    for k in want:
        close(got[k], want[k])
        close(hoisted[k], want[k])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flag_gates_the_estimate(arrays, variant):
    """Flag 0 (per sample or per residue) equals no estimate; flag 1 per
    residue equals flag 1 per sample, and changes the prediction."""
    *_, tm = models(arrays, variant)
    batch = ProteinBatch.from_numpy(arrays)
    beta = torch.full((B,), 0.2)
    run = lambda **sc: tm(batch, batch.seq_idx, batch.translations, batch.orientations, beta,
                          **sc)
    sc = dict(sc_translations_x0=batch.translations + 3.0, sc_seq_probs=torch.full((B, L, K),
                                                                                   1.0 / K))
    with torch.no_grad():
        base = run()
        for mask in (torch.zeros(B), torch.zeros(B, L)):
            off = run(sc_mask=mask, **sc)
            for k in base:
                torch.testing.assert_close(off[k], base[k], atol=1e-6, rtol=0)
        on_rows = run(sc_mask=torch.ones(B, L), **sc)
        on = run(sc_mask=torch.ones(B), **sc)
    torch.testing.assert_close(on_rows["translations_eps"], on["translations_eps"], atol=1e-6,
                               rtol=0)
    assert float((on["translations_eps"] - base["translations_eps"]).abs().max()) > 1e-4


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_huge_estimate_stays_finite(arrays, variant):
    """The implied x0_hat at high t reaches O(1e4) model units: the
    saturated features keep every output finite."""
    *_, tm = models(arrays, variant)
    batch = ProteinBatch.from_numpy(arrays)
    with torch.no_grad():
        for scale in (1e4, 1e6):
            out = tm(batch, batch.seq_idx, batch.translations, batch.orientations,
                     torch.full((B,), 0.999), sc_translations_x0=batch.translations + scale,
                     sc_seq_probs=torch.full((B, L, K), 1.0 / K), sc_mask=torch.ones(B))
            assert all(bool(torch.isfinite(v).all()) for v in out.values())


@pytest.mark.parametrize("variant", ["early", "split"])
def test_se3_equivariance_with_conditioning(arrays, variant):
    """The estimate's features are invariant: the heads stay covariant
    under a global rotation with the estimate rotated along."""
    *_, tm = models(arrays, variant)
    batch = ProteinBatch.from_numpy(arrays)
    g = torch.Generator().manual_seed(4)
    x_t = batch.translations + 0.1 * torch.randn(B, L, 3, generator=g)
    sc_x = batch.translations + 0.2 * torch.randn(B, L, 3, generator=g)
    sc_p = torch.softmax(torch.randn(B, L, K, generator=g), dim=-1)
    beta = torch.linspace(0.01, 0.4, B)
    th = torch.tensor(1.1)
    q = torch.tensor([[torch.cos(th), -torch.sin(th), 0.0], [torch.sin(th), torch.cos(th), 0.0],
                      [0.0, 0.0, 1.0]])
    rot = dataclasses.replace(batch, xyz=batch.xyz @ q, orientations=batch.orientations @ q)
    with torch.no_grad():
        out = tm(batch, batch.seq_idx, x_t, batch.orientations, beta, sc_translations_x0=sc_x,
                 sc_seq_probs=sc_p, sc_mask=torch.ones(B))
        out_r = tm(rot, batch.seq_idx, x_t @ q, batch.orientations @ q, beta,
                   sc_translations_x0=sc_x @ q, sc_seq_probs=sc_p, sc_mask=torch.ones(B))
    torch.testing.assert_close(out_r["translations_eps"], out["translations_eps"] @ q,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(out_r["orientations_t0"], out["orientations_t0"] @ q,
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(out_r["seq_posterior"], out["seq_posterior"], atol=2e-4, rtol=0)


@pytest.mark.parametrize("variant", ["late", "split"])
def test_sequence_head_isolated_from_the_estimate(arrays, variant):
    """Late fusion and the split trunk: seq_posterior is bit-identical with
    and without an estimate; with the split trunk the geometry outputs'
    gradient does not reach the sequence trunk, and does reach geo_ipa."""
    *_, tm = models(arrays, variant)
    batch = ProteinBatch.from_numpy(arrays)
    beta = torch.full((B,), 0.2)
    sc = dict(sc_translations_x0=batch.translations + 0.5,
              sc_seq_probs=torch.full((B, L, K), 1.0 / K), sc_mask=torch.ones(B))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.named_parameters()}
    cold = torch.func.functional_call(tm, params, (batch, batch.seq_idx, batch.translations,
                                                   batch.orientations, beta))
    warm = torch.func.functional_call(tm, params, (batch, batch.seq_idx, batch.translations,
                                                   batch.orientations, beta), sc)
    assert torch.equal(cold["seq_posterior"], warm["seq_posterior"])
    assert float((warm["translations_eps"] - cold["translations_eps"]).detach().abs().max()) > 1e-6
    if variant == "split":
        geo = (warm["translations_eps"] ** 2).sum() + (warm["orientations_t0"] ** 2).sum()
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(geo, [params[k] for k in names],
                                                    allow_unused=True)))
        for prefix in ("denoiser.fuse_0.", "denoiser.fuse_1.", "denoiser.ipa.",
                       "denoiser.sequence_head."):
            assert all(g is None or not g.any() for k, g in grads.items()
                       if k.startswith(prefix)), prefix
        assert any(g is not None and g.abs().max() > 0 for k, g in grads.items()
                   if k.startswith("denoiser.geo_ipa."))


@pytest.mark.parametrize("flags", [dict(sc_late_fusion=True), dict(sc_split_trunk=True),
                                   dict(self_conditioning=True, sc_late_fusion=True,
                                        sc_split_trunk=True)])
def test_inconsistent_flags_raise(flags):
    cfg = dataclasses.replace(tconfig.tiny_config().model, **flags)
    match = "mutually exclusive" if len(flags) == 3 else "requires self_conditioning"
    with pytest.raises(ValueError, match=match):
        DiffAbModel(cfg, device="cpu")


def test_sc_inputs_rejected_when_off_or_incomplete(arrays):
    batch = ProteinBatch.from_numpy(arrays)
    args = (batch, batch.seq_idx, batch.translations, batch.orientations, torch.full((B,), 0.2))
    off = DiffAbModel(tconfig.tiny_config().model, device="cpu")
    with pytest.raises(ValueError, match="self_conditioning is off"):
        off(*args, sc_translations_x0=batch.translations, sc_seq_probs=torch.ones(B, L, K),
            sc_mask=torch.ones(B))
    *_, tm = models(arrays, "early")
    with pytest.raises(ValueError, match="requires sc_seq_probs"):
        tm(*args, sc_translations_x0=batch.translations)


# ---- training --------------------------------------------------------------------


def igso3_draw(key, out_shape):
    """The numbers jax igso3.sample_axis_angle(key, ...) draws."""
    k_axis, k_theta = jax.random.split(key)
    k_bin, k_gauss = jax.random.split(k_theta)
    return AxisAngleNoise(axis=t_(jax.random.normal(k_axis, out_shape + (3,))),
                          uniform=t_(jax.random.uniform(k_bin, out_shape)),
                          normal=t_(jax.random.normal(k_gauss, out_shape)))


def jax_draws(key, per_residue):
    """The numbers JAX DiffAb.loss_fn(key) draws, as the port's StepDraws."""
    k_t, k_noise, k_sc, k_mode = jax.random.split(key, 4)
    k_seq, k_coord, k_orient = jax.random.split(k_noise, 3)
    return StepDraws(
        t=t_(jax.random.randint(k_t, (B,), 1, T + 1)).long(),
        mode_u=t_(jax.random.uniform(k_mode, (B,))),
        gumbel=t_(jax.random.gumbel(k_seq, (B, L, K))),
        coord=t_(jax.random.normal(k_coord, (B, L, 3))),
        orientation=igso3_draw(k_orient, (B, L)),
        sc_u=t_(jax.random.uniform(k_sc, (B, L) if per_residue else (B,))))


def harnesses(jmodel, **train):
    """(JAX DiffAb, port DiffAb) of one configuration."""
    jcfg = jconfig.DiffAbConfig(
        model=jmodel, diffusion=jconfig.DiffusionConfig(T=T, igso3_n_bins=256,
                                                       igso3_n_terms=128),
        train=dataclasses.replace(jconfig.TrainConfig(), **train))
    names = lambda cls: {f.name for f in dataclasses.fields(cls)}
    tcfg = tconfig.DiffAbConfig(
        model=port_model_config(jmodel),
        diffusion=tconfig.DiffusionConfig(**{k: getattr(jcfg.diffusion, k)
                                             for k in names(tconfig.DiffusionConfig)}),
        train=tconfig.TrainConfig(**{k: getattr(jcfg.train, k)
                                     for k in names(tconfig.TrainConfig)}))
    return JaxDiffAb(jcfg), DiffAb(tcfg, device="cpu")


def test_sc_rate_matches_jax():
    for train in (dict(sc_rate=0.5, sc_onset_steps=100, sc_rate_warmup=200),
                  dict(sc_rate=0.5, sc_onset_steps=100), dict(sc_rate=0.3, sc_rate_warmup=7),
                  dict()):
        jh, th = harnesses(jconfig.tiny_config().model, **train)
        for step in (0, 1, 3, 7, 99, 100, 101, 200, 250, 300, 10_000):
            assert th.sc_rate_at(step) == pytest.approx(float(jh._sc_rate(step)), abs=1e-7)
        assert th.sc_rate_at(None) == jh._sc_rate(None) == train.get("sc_rate", 0.5)


SC_TRAIN = {  # (variant, per_residue, sequence-loss weight)
    "early": ("early", False, 1.0),
    "early-per-residue": ("early", True, 0.25),
    "geometry_only": ("geometry_only", False, 0.25),
    "geometry_only-per-residue": ("geometry_only", True, 1.0),
    "late": ("late", False, 1.0),
    "late-per-residue": ("late", True, 0.25),
    "split": ("split", False, 0.25),
    "split-per-residue": ("split", True, 1.0),
}


@pytest.mark.parametrize("case", list(SC_TRAIN))
def test_loss_fn_and_gradients_match_jax(arrays, case):
    """The two-pass loss under mode dropout, mid-way through the rate's
    warm-up (step 5: rate 0.375), and every gradient, against JAX
    DiffAb.loss_fn with its draws; the gradients reach the hoisted
    to_pair_bias (and geo_ipa with the split trunk)."""
    variant, per_residue, w = SC_TRAIN[case]
    jcfg, _, params, _ = models(arrays, variant)
    jh, th = harnesses(jcfg, mode_dropout=0.3, sc_onset_steps=2, sc_rate_warmup=4,
                       sc_per_residue=per_residue, sc_seq_loss_weight=w)
    key, step = jax.random.key(2), 5
    jb = jax_batch(arrays)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jh.loss_fn(p, key, jb, step=step), has_aux=True))(params)

    draws = jax_draws(key, per_residue)
    u = draws.mode_u.numpy()
    assert (u < 0.3).any() and ((u >= 0.3) & (u < 0.6)).any() and (u >= 0.6).any()
    cond = (draws.sc_u < th.sc_rate_at(step)).numpy()
    assert cond.any() and not cond.all()
    tparams = {k: v.requires_grad_(True) for k, v in params_from_jax(params).items()}
    loss_t, metrics_t, grads_t = th.loss_and_grads(tparams, ProteinBatch.from_numpy(arrays),
                                                   draws, step)
    close(loss_t.detach(), loss_j, atol=1e-3, rtol=1e-4)
    for k in metrics_j:
        close(metrics_t[k].detach(), metrics_j[k], atol=1e-3, rtol=1e-4)
    expected = params_from_jax(jax.device_get(grads_j))
    assert set(grads_t) == set(expected)
    for name, g in expected.items():
        close(grads_t[name], g, atol=1e-3 * max(float(g.abs().max()), 1.0), rtol=0)
    reached = [k for k, g in grads_t.items() if "to_pair_bias" in k and g.abs().max() > 0]
    assert any(k.startswith("denoiser.ipa.") for k in reached)
    if variant == "split":
        assert any(k.startswith("denoiser.geo_ipa.") for k in reached)


def test_onset_step_trains_cold(arrays):
    """Before sc_onset_steps the loss is the rate-0 loss with the same
    draws; after it the conditioned mask fires and the loss differs."""
    jcfg, *_, tm = models(arrays, "early")
    params = {k: v.detach().requires_grad_(False) for k, v in tm.named_parameters()}
    _, onset = harnesses(jcfg, sc_onset_steps=1000)
    _, rate0 = harnesses(jcfg, sc_rate=0.0)
    batch = ProteinBatch.from_numpy(arrays)
    gen = torch.Generator().manual_seed(5)
    draws = [onset.draw(batch, gen) for _ in range(4)]
    with torch.no_grad():
        for d in draws:
            torch.testing.assert_close(onset.loss_fn(params, batch, d, 3)[0],
                                       rate0.loss_fn(params, batch, d, 3)[0], atol=0, rtol=0)
        diffs = [abs(float(onset.loss_fn(params, batch, d, 2000)[0])
                     - float(rate0.loss_fn(params, batch, d, 2000)[0])) for d in draws]
    assert max(diffs) > 1e-6


def test_fit_runs_the_schedule_from_the_state_step(arrays, monkeypatch):
    """fit() trains each step at its own state.step (loader-free list
    path); the validation pass runs at the full rate (no step)."""
    jcfg, *_ = models(arrays, "early")
    _, th = harnesses(jcfg, sc_onset_steps=1, sc_rate_warmup=2, lr=1e-3, log_every=1)
    seen = []
    real = th.loss_fn

    def recording(params, batch, draws, step=None):
        seen.append((torch.is_grad_enabled(), step, draws.sc_u.shape))
        return real(params, batch, draws, step)

    monkeypatch.setattr(th, "loss_fn", recording)
    batches = [ProteinBatch.from_numpy(arrays)]
    state = fit(th, batches, batches, max_steps=3)
    assert state.step == 3
    assert [(g, s) for g, s, _ in seen] == [(True, 0), (False, None), (True, 1), (False, None),
                                            (True, 2), (False, None)]
    assert all(shape == (B,) for *_, shape in seen)
    assert all(torch.isfinite(v).all() for v in state.params.values())


@pytest.mark.parametrize("per_residue", [False, True])
def test_seq_sample_weight_matches_jax(arrays, per_residue):
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    rot = lambda: np.array(jso3.uniform(jax.random.key(int(rng.integers(1 << 30))), (B, L)))
    probs = lambda: rng.dirichlet(np.ones(K), (B, L)).astype(np.float32)
    den = {"translations_eps": f(B, L, 3), "orientations_t0": rot(), "seq_logits": f(B, L, K)}
    args = [np.log(probs()), probs(), f(B, L, 3), rot(), arrays["generation_mask"],
            arrays["residue_mask"]]
    w = np.where(rng.random((B, L) if per_residue else (B,)) < 0.5, 0.25, 1.0).astype(np.float32)
    jx = lambda v: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
    want = jlosses.diffab_losses({k: jnp.asarray(v) for k, v in den.items()},
                                 *(jx(a) for a in args), seq_sample_weight=jnp.asarray(w),
                                 seq_idx_t0_true=jx(arrays["seq_idx"]), seq_ce_weight=1.0)
    port = lambda **kw: tlosses.diffab_losses({k: t_(v) for k, v in den.items()},
                                              *(t_(a) for a in args),
                                              seq_idx_t0_true=t_(arrays["seq_idx"]),
                                              seq_ce_weight=1.0, **kw)
    got, plain = port(seq_sample_weight=t_(w)), port()
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    assert float(got["translations_loss"]) == float(plain["translations_loss"])
    assert float(got["seq_loss"]) != float(plain["seq_loss"])


# ---- sampling and scoring --------------------------------------------------------


@pytest.fixture(scope="module")
def scheds():
    js, ts = jsched(T, s=0.01), tsched(T, s=0.01)
    return js, ts, jorient.make_orientation_tables(js, **TABLES), torient.make_orientation_tables(
        ts, **TABLES)


def jax_sample_draws(key, t_seq, bn):
    """The numbers JAX sample(key) draws from the prior at t_start = T:
    (InitNoise, {t: StepNoise})."""
    k_init, k_loop = jax.random.split(key)
    ks, kx, kr = jax.random.split(k_init, 3)
    normal = lambda k, *s: t_(jax.random.normal(k, (bn, L) + s))
    init = tsampler.InitNoise(seq=t_(jax.random.randint(ks, (bn, L), 0, K)).long(),
                              coord=normal(kx, 3), rot_prior=normal(kr, 4))
    steps = {}
    for t in t_seq:
        k1, k2, k3 = jax.random.split(jax.random.fold_in(k_loop, int(t)), 3)
        steps[int(t)] = tsampler.StepNoise(gumbel=t_(jax.random.gumbel(k1, (bn, L, K))),
                                           coord=normal(k2, 3),
                                           orientation=igso3_draw(k3, (bn, L)))
    return init, steps


SC_CHAINS = {
    "early": ("early", dict()),
    "early-sc_t_max": ("early", dict(sc_t_max=5)),
    "geometry_only-few-step": ("geometry_only", dict(n_steps=4)),
    "late-sc_t_max": ("late", dict(sc_t_max=4, n_steps=5)),
    "split-heun-sc_t_max": ("split", dict(coord_solver="heun", coord_solver_t_min=2,
                                          sc_t_max=6, n_steps=5)),
}


@pytest.mark.parametrize("case", list(SC_CHAINS))
def test_sample_matches_jax(arrays, scheds, case):
    """JAX sample() against the port's with its draws injected: N = 2
    designs of each of the B targets, the estimate carried from step to
    step and gated by sc_t_max, heun's corrector fed the same estimate."""
    variant, opts = SC_CHAINS[case]
    _, jm, params, tm = models(arrays, variant)
    js, ts, jt, tt = scheds
    key = jax.random.key(11)
    want = jsampler.sample(jm, params, js, jt, jax_batch(arrays), key, n_designs=N, **opts)
    t_seq = tsampler.timestep_schedule(T, opts.get("n_steps"))
    init, steps = jax_sample_draws(key, t_seq, B * N)
    got = tsampler.sample(tm, ts, tt, ProteinBatch.from_numpy(arrays), device="cpu",
                          n_designs=N, init_noise=init, step_noise=steps.__getitem__, **opts)
    np.testing.assert_array_equal(got.seq_idx.numpy(), np.asarray(want.seq_idx))
    close(got.translations, want.translations, atol=1e-3)
    close(got.orientations, want.orientations, atol=1e-3)


def test_sc_t_max_zero_is_the_cold_chain(arrays, scheds):
    """sc_t_max = 0 never conditions: the chain of the same model fed no
    estimate; sc_t_max >= T is the ungated chain."""
    *_, tm = models(arrays, "early")
    _, ts, _, tt = scheds
    batch = ProteinBatch.from_numpy(arrays)
    run = lambda **kw: tsampler.sample(tm, ts, tt, batch, device="cpu", n_steps=4,
                                       generator=torch.Generator().manual_seed(3), **kw)
    full, gated_all, cold = run(), run(sc_t_max=T), run(sc_t_max=0)
    assert torch.equal(full.translations, gated_all.translations)
    assert not torch.equal(full.translations, cold.translations)
    real = tm.denoise
    calls = []

    def no_estimate(*args, **kw):
        calls.append(kw.pop("sc_mask"))
        kw.pop("sc_translations_x0"), kw.pop("sc_seq_probs")
        return real(*args, **kw)

    tm.denoise = no_estimate
    try:
        unfed = run(sc_t_max=0)
    finally:
        del tm.denoise
    assert len(calls) == 4 and all(not c.any() for c in calls)
    assert torch.equal(unfed.translations, cold.translations)


def jax_score_draws(key, grid, bn):
    """The numbers JAX score_designs(key) draws at n_draws = 1."""
    gumbel, coord, axis, uniform, normal = [], [], [], [], []
    for t in grid:
        ks, kx, kr = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, t), 0), 3)
        noise = igso3_draw(kr, (bn, L))
        gumbel.append(jax.random.gumbel(ks, (bn, L, K)))
        coord.append(jax.random.normal(kx, (bn, L, 3)))
        axis.append(noise.axis), uniform.append(noise.uniform), normal.append(noise.normal)
    st = lambda xs: t_(np.stack([np.asarray(x) for x in xs]))
    return tscoring.ScoreDraws(st(gumbel), st(coord), AxisAngleNoise(st(axis), st(uniform),
                                                                     st(normal)))


@pytest.mark.parametrize("variant", ["early", "split"])
def test_score_designs_matches_jax(arrays, scheds, variant):
    """A self-conditioned model scores cold, as the JAX scorer does."""
    _, jm, params, tm = models(arrays, variant)
    js, ts, jt, tt = scheds
    rng = np.random.default_rng(2)
    bn, grid = B * N, (1, 5)
    gen = np.repeat(arrays["generation_mask"], N, 0)
    seq = np.where(gen, rng.integers(0, 20, gen.shape), np.repeat(arrays["seq_idx"], N, 0))
    x = (np.repeat(arrays["xyz"][:, :, 1], N, 0) + rng.normal(size=(bn, L, 3)) * 0.3 * gen[
        ..., None]).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(4), (bn, L)))
    key = jax.random.key(7)
    want = jscoring.score_designs(
        jm, params, js, jt, jax_batch(arrays),
        jsampler.SampleResult(jnp.asarray(seq, jnp.int32), jnp.asarray(x), jnp.asarray(rot)),
        key, t_grid=grid, n_draws=1)
    got = tscoring.score_designs(tm, ts, tt, ProteinBatch.from_numpy(arrays),
                                 tsampler.SampleResult(t_(seq), t_(x), t_(rot)), device="cpu",
                                 draws=jax_score_draws(key, grid, bn), t_grid=grid, n_draws=1)
    for k in tscoring.DesignScores._fields:
        close(getattr(got, k), getattr(want, k))


# ---- the recorded model config ---------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_config_round_trips_and_reads_jax(tmp_path, variant):
    """model_config.json: the port's round-trips the sc fields; a JAX-written
    one loads into the same ModelConfig."""
    jcfg = sc_model_config(variant, compute_dtype="bfloat16", d_pair_emb=48)
    want = port_model_config(jcfg)
    ckpt.save_model_config(str(tmp_path / "port"), want)
    assert ckpt.load_model_config(str(tmp_path / "port")) == want
    jckpt.save_model_config(str(tmp_path / "jax"), jcfg)
    assert ckpt.load_model_config(str(tmp_path / "jax")) == want
