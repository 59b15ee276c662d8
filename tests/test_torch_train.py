"""The port's training slice against the JAX package, on the CPU in float32:
the forward diffusions, the losses, the optimizer chain against optax, the
optimizer-state transplant, one whole loss and its gradients against
`DiffAb.loss_fn`, checkpoints and a short `fit`.

Random draws differ between the frameworks, so the port is fed the very
numbers the JAX functions draw from their keys (the same splits and the
same jax.random calls).  Tolerances: 1e-5 for elementwise float32 math;
1e-6 relative on optimizer states (the same float32 operations, the
schedule and bias corrections evaluated in float64 on the port's side);
1e-3 on the whole loss and 1e-3 of each gradient leaf's largest entry
(two models summing float32 products in other orders, the port's IPA
logits through the kernels' |q|^2 + |k|^2 - 2 q.k expansion).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.diffusion import coordinate as jcoord
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion import sequence as jseq
from diffab_pytorch_tpu.diffusion.schedule import cosine_variance_schedule as jsched
from diffab_pytorch_tpu.geometry import so3 as jso3
from diffab_pytorch_tpu.train import losses as jlosses
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.diffusion import coordinate as tcoord
from diffab_pytorch_tpu_torch.diffusion import orientation as torient
from diffab_pytorch_tpu_torch.diffusion import sequence as tseq
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train import losses as tlosses
from diffab_pytorch_tpu_torch.train.harness import DiffAb, OptState, StepDraws, TrainState
from diffab_pytorch_tpu_torch.train.trainer import fit
from diffab_pytorch_tpu_torch.weights import opt_state_from_jax, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T, B, L, K = 8, 4, 24, 21
# small IGSO(3) tables keep the set-up fast; both sides build the same ones
DIFFUSION = dict(T=T, igso3_n_bins=256, igso3_n_terms=128)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=rtol)


def igso3_draw(key, out_shape):
    """The numbers jax igso3.sample_axis_angle(key, ...) draws."""
    k_axis, k_theta = jax.random.split(key)
    k_bin, k_gauss = jax.random.split(k_theta)
    return AxisAngleNoise(axis=t_(jax.random.normal(k_axis, out_shape + (3,))),
                          uniform=t_(jax.random.uniform(k_bin, out_shape)),
                          normal=t_(jax.random.normal(k_gauss, out_shape)))


def jax_draws(key, b, n_res):
    """The numbers JAX DiffAb.loss_fn(key) draws, as the port's StepDraws."""
    k_t, k_noise, _, k_mode = jax.random.split(key, 4)
    k_seq, k_coord, k_orient = jax.random.split(k_noise, 3)
    return StepDraws(
        t=t_(jax.random.randint(k_t, (b,), 1, T + 1)).long(),
        mode_u=t_(jax.random.uniform(k_mode, (b,))),
        gumbel=t_(jax.random.gumbel(k_seq, (b, n_res, K))),
        coord=t_(jax.random.normal(k_coord, (b, n_res, 3))),
        orientation=igso3_draw(k_orient, (b, n_res)))


def jax_batch(arrays):
    return JaxBatch(**{k: (None if v is None else jnp.asarray(
        v.astype(np.int32) if v.dtype.kind in "iu" else v)) for k, v in arrays.items()})


def port_config(jcfg, **model):
    """The port's DiffAbConfig with every field it shares with `jcfg`."""
    def sub(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: getattr(obj, k) for k in names if hasattr(obj, k)})
    return tconfig.DiffAbConfig(
        model=dataclasses.replace(sub(tconfig.ModelConfig, jcfg.model), **model),
        diffusion=sub(tconfig.DiffusionConfig, jcfg.diffusion),
        data=sub(tconfig.DataConfig, jcfg.data),
        train=sub(tconfig.TrainConfig, jcfg.train))


@pytest.fixture(scope="module")
def arrays():
    return synthetic_batch_numpy(0, B, L, 15, n_generate=6)


@pytest.fixture(scope="module")
def scheds():
    js = jsched(T, s=0.01)
    ts = tsched(T, s=0.01)
    small = dict(n_bins=DIFFUSION["igso3_n_bins"], n_terms=DIFFUSION["igso3_n_terms"])
    return (js, ts, jorient.make_orientation_tables(js, **small),
            torient.make_orientation_tables(ts, **small))


def test_configs_match_jax():
    for jc, tc in ((jconfig.production_config(), tconfig.production_config()),
                   (jconfig.tiny_config(), tconfig.tiny_config())):
        assert port_config(jc) == tc
    dropped = {f.name for f in dataclasses.fields(jconfig.TrainConfig)} - {
        f.name for f in dataclasses.fields(tconfig.TrainConfig)}
    assert dropped == set()


@pytest.mark.parametrize("modality", ["sequence", "coordinate", "orientation"])
def test_forward_diffusion_matches_jax(scheds, arrays, modality):
    js, ts, jt, tt = scheds
    key = jax.random.key(11)
    t = np.random.default_rng(1).integers(1, T + 1, B)
    jt_, tt_ = jnp.asarray(t), torch.from_numpy(t)
    gen = arrays["generation_mask"]
    jgen, tgen = jnp.asarray(gen), torch.from_numpy(gen)
    if modality == "sequence":
        s0 = arrays["seq_idx"]
        seq_j, post_j = jseq.diffuse_from_t0(key, js, jnp.asarray(s0, jnp.int32), jt_, jgen)
        seq_t, post_t = tseq.diffuse_from_t0(
            ts, torch.from_numpy(s0), tt_, tgen, gumbel=t_(jax.random.gumbel(key, (B, L, K))))
        np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
        assert bool((seq_t[~tgen] == torch.from_numpy(s0)[~tgen]).all())
        close(post_t, post_j)
        close(tseq.forward_prob_from_t0(ts, torch.from_numpy(s0), tt_, tgen),
              jseq.forward_prob_from_t0(js, jnp.asarray(s0, jnp.int32), jt_, jgen))
        probs = np.random.default_rng(2).dirichlet(np.ones(K), (B, L)).astype(np.float32)
        close(tseq.log_posterior_from_predicted_t0(ts, seq_t, t_(probs), tt_, tgen),
              jseq.log_posterior_from_predicted_t0(js, seq_j, jnp.asarray(probs), jt_, jgen))
    elif modality == "coordinate":
        x0 = arrays["xyz"][:, :, 1]
        x_j, eps_j = jcoord.diffuse_from_t0(key, js, jnp.asarray(x0), jt_, jgen)
        x_t, eps_t = tcoord.diffuse_from_t0(ts, torch.from_numpy(x0), tt_, tgen,
                                            noise=t_(jax.random.normal(key, (B, L, 3))))
        close(x_t, x_j)
        close(eps_t, eps_j)
    else:
        r0 = arrays["orientations"]
        r_j = jax.jit(jorient.diffuse_from_t0)(key, jt, jnp.asarray(r0), jt_, jgen)
        r_t = torient.diffuse_from_t0(tt, torch.from_numpy(r0), tt_, tgen,
                                      noise=igso3_draw(key, (B, L)))
        close(r_t, r_j, atol=1e-5)
        assert torch.equal(r_t[~tgen], torch.from_numpy(r0)[~tgen])


@pytest.mark.parametrize("ce_weight,per_modality", [(0.0, False), (1.0, True)])
def test_losses_match_jax(arrays, ce_weight, per_modality):
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    rot = lambda s: np.array(jso3.uniform(jax.random.key(int(rng.integers(1 << 30))), s))
    probs = lambda: rng.dirichlet(np.ones(K), (B, L)).astype(np.float32)
    den = {"translations_eps": f(B, L, 3), "orientations_t0": rot((B, L)),
           "seq_logits": f(B, L, K)}
    args = [np.log(probs()), probs(), f(B, L, 3), rot((B, L)),
            arrays["generation_mask"], arrays["residue_mask"].copy()]
    args[-1][:, -2:] = False
    kw = dict(seq_idx_t0_true=arrays["seq_idx"], seq_ce_weight=ce_weight)
    if per_modality:
        kw["seq_gen_mask"] = arrays["generation_mask"] & (np.arange(B) != 1)[:, None]
        kw["struct_gen_mask"] = arrays["generation_mask"] & (np.arange(B) != 2)[:, None]
    jx = lambda v: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
    out_j = jlosses.diffab_losses({k: jnp.asarray(v) for k, v in den.items()},
                                  *(jx(a) for a in args),
                                  **{k: jx(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()})
    out_t = tlosses.diffab_losses({k: t_(v) for k, v in den.items()}, *(t_(a) for a in args),
                                  **{k: t_(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()})
    assert set(out_t) == set(out_j)
    for k in out_j:
        close(out_t[k], out_j[k])
    close(tlosses.kl_divergence_from_logits(t_(den["seq_logits"]), t_(args[1])),
          jlosses.kl_divergence_from_logits(jnp.asarray(den["seq_logits"]),
                                            jnp.asarray(args[1])))


def _optimizer_harness(**train):
    cfg = dataclasses.replace(
        tconfig.tiny_config(), diffusion=tconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(tconfig.tiny_config().train, **train))
    jcfg = jconfig.DiffAbConfig(train=dataclasses.replace(jconfig.TrainConfig(), **train))
    optimizer = JaxDiffAb._make_optimizer(types.SimpleNamespace(config=jcfg))
    return DiffAb(cfg, device="cpu"), optimizer


RECIPES = {
    "robust": dict(lr=1e-2, lr_warmup_steps=2, lr_decay_steps=7, lr_min_ratio=0.1,
                   grad_clip_norm=4.0, update_clip_rms=0.5, weight_decay=0.01,
                   ema_decay=0.9, betas=(0.8, 0.95), adam_eps=1e-6),
    "warmup_only": dict(lr=3e-3, lr_warmup_steps=3, ema_decay=0.5),
    "plain_adam": dict(lr=1e-3),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_optimizer_chain_matches_optax(recipe):
    """Seven steps: across the warmup boundary, with the global-norm clip
    active on the large-gradient steps only, the update-RMS cap active,
    weight decay and EMA on."""
    harness, optimizer = _optimizer_harness(**RECIPES[recipe])
    rng = np.random.default_rng(4)
    shapes = {"a.weight": (5, 3), "a.bias": (5,), "b.gamma": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    state = TrainState(0, {k: t_(v).requires_grad_(True) for k, v in p0.items()},
                       OptState(0, {k: torch.zeros(s) for k, s in shapes.items()},
                                {k: torch.zeros(s) for k, s in shapes.items()}),
                       {k: t_(v) for k, v in p0.items()} if harness.config.train.ema_decay else None)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate, jema = optimizer.init(jp), dict(jp)
    update = jax.jit(optimizer.update)
    d = harness.config.train.ema_decay
    clip_hits = 0
    for step in range(7):
        scale = 10.0 if step % 2 else 0.3  # global norm above / below the clip
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        clip_hits += float(optax.global_norm(g)) > harness.config.train.grad_clip_norm
        updates, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        jema = {k: d * jema[k] + (1 - d) * jp[k] for k in jp}
        state = harness.apply_gradients(state, {k: t_(v) for k, v in g.items()})
        for k in shapes:
            close(state.params[k].detach(), jp[k], atol=1e-6, rtol=1e-6)
            if d:
                close(state.ema_params[k], jema[k], atol=1e-6, rtol=1e-6)
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    assert state.opt_state.count == int(adam.count) == state.step == 7
    for k in shapes:
        close(state.opt_state.mu[k], adam.mu[k], atol=1e-7, rtol=1e-6)
        close(state.opt_state.nu[k], adam.nu[k], atol=1e-7, rtol=1e-6)
    if recipe == "robust":
        assert 0 < clip_hits < 7
        lrs = [harness.learning_rate(c) for c in range(9)]
        assert lrs[0] == 0.0 and lrs[2] == pytest.approx(1e-2) and lrs[8] == pytest.approx(1e-3)


def test_opt_state_from_jax_continues_the_run():
    """An optax state moved into the port gives, from the same parameters
    and gradients, the same next step on both sides."""
    train = RECIPES["robust"]
    harness, optimizer = _optimizer_harness(**train)
    rng = np.random.default_rng(5)
    tree = {"params": {"dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                                 "bias": rng.normal(size=(3,)).astype(np.float32)},
                       "emb": {"embedding": rng.normal(size=(6, 2)).astype(np.float32)},
                       "layer": {"gamma": rng.normal(size=(2,)).astype(np.float32)}}}
    grads = lambda: jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = optimizer.init(jp)
    update = jax.jit(optimizer.update)
    for _ in range(3):
        updates, jstate = update(grads(), jstate, jp)
        jp = optax.apply_updates(jp, updates)
    opt = opt_state_from_jax(jax.device_get(jstate))
    assert opt.count == 3 and set(opt.mu) == {"dense.weight", "dense.bias", "emb.weight",
                                              "layer.gamma"}
    state = TrainState(3, {k: v.requires_grad_(True) for k, v in
                           params_from_jax(jax.device_get(jp)).items()}, opt)
    g = grads()
    updates, _ = update(g, jstate, jp)
    jp = optax.apply_updates(jp, updates)
    state = harness.apply_gradients(state, params_from_jax(g))
    for k, v in params_from_jax(jax.device_get(jp)).items():
        close(state.params[k].detach(), v, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        opt_state_from_jax((optax.EmptyState(),))


@pytest.fixture(scope="module")
def jax_setup(arrays):
    jcfg = dataclasses.replace(
        jconfig.tiny_config(), diffusion=jconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(jconfig.tiny_config().train, mode_dropout=0.3))
    jb = jax_batch(arrays)
    params = JaxDiffAb(jcfg).init(jax.random.key(0), jb).params
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
        np.float32) * 0.05, jax.device_get(params))
    return jcfg, jb, params


@pytest.mark.parametrize("fuse", [None, False])
def test_loss_fn_and_gradients_match_jax(arrays, jax_setup, fuse):
    """One mode-dropout loss on tiny_config and every gradient, against JAX
    DiffAb.loss_fn with its draws reproduced from the key splits.  The JAX
    model runs its XLA path (fuse None) or the attention-core Pallas kernel
    in interpret mode (fuse False)."""
    jcfg, jb, params = jax_setup
    jmodel = dataclasses.replace(jcfg.model, use_pallas_attention=fuse is False,
                                 fuse_ipa_layer=fuse)
    jh = JaxDiffAb(dataclasses.replace(jcfg, model=jmodel))
    key = jax.random.key(2)  # mode draws cover codesign, fix-structure, fix-sequence
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jh.loss_fn(p, key, jb), has_aux=True))(params)

    draws = jax_draws(key, B, L)
    u = draws.mode_u.numpy()
    assert (u < 0.3).any() and ((u >= 0.3) & (u < 0.6)).any() and (u >= 0.6).any()
    harness = DiffAb(port_config(jcfg, fuse_ipa_layer=fuse), device="cpu")
    tparams = {k: v.requires_grad_(True) for k, v in params_from_jax(params).items()}
    assert set(tparams) == {k for k, _ in harness.model.named_parameters()}
    loss_t, metrics_t, grads_t = harness.loss_and_grads(
        tparams, ProteinBatch.from_numpy(arrays), draws)
    close(loss_t.detach(), loss_j, atol=1e-3, rtol=1e-4)
    for k in metrics_j:
        close(metrics_t[k].detach(), metrics_j[k], atol=1e-3, rtol=1e-4)
    expected = params_from_jax(jax.device_get(grads_j))
    for name, g in expected.items():
        close(grads_t[name], g, atol=1e-3 * max(float(g.abs().max()), 1.0), rtol=0)


def _small_harness(fuse=None, **train):
    cfg = tconfig.tiny_config()
    return DiffAb(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fuse_ipa_layer=fuse),
        diffusion=tconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(cfg.train, **train)), device="cpu")


def test_checkpoint_round_trip(arrays, tmp_path):
    harness = _small_harness(ema_decay=0.9, lr=1e-3)
    batch = ProteinBatch.from_numpy(arrays)
    state = harness.init(0)
    gen = torch.Generator().manual_seed(0)
    d = str(tmp_path / "ckpt")
    for _ in range(4):
        state, _ = harness.train_step(state, batch, harness.draw(batch, gen))
        ckpt.save_checkpoint(d, state, max_to_keep=3)
    assert ckpt.all_steps(d) == [2, 3, 4] and ckpt.latest_step(d) == 4
    back = ckpt.restore_checkpoint(d, device="cpu")
    assert back.step == 4 and back.opt_state.count == 4
    for a, b in ((state.params, back.params), (state.opt_state.mu, back.opt_state.mu),
                 (state.opt_state.nu, back.opt_state.nu), (state.ema_params, back.ema_params)):
        assert set(a) == set(b) and all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(v.requires_grad for v in back.params.values())
    params, step = ckpt.restore_params(d)
    assert step == 4 and all(torch.equal(params[k], state.ema_params[k]) for k in params)
    raw, _ = ckpt.restore_params(d, step=3, prefer_ema=False)
    assert not torch.equal(raw["denoiser.fuse_0.weight"], params["denoiser.fuse_0.weight"])
    harness.model.load_state_dict(params)  # loads into a model for sampling
    ckpt.prune_after(d, 2)
    assert ckpt.all_steps(d) == [2]
    ckpt.save_model_config(d, harness.config.model)
    assert ckpt.load_model_config(d) == harness.config.model
    assert ckpt.load_model_config(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_restore_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    """Like the other entry points, restore_checkpoint lands on the card
    unless told otherwise: with no card and no device it raises, and with
    device="cpu" it restores."""
    harness = _small_harness()
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, harness.init(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_checkpoint(d)
    back = ckpt.restore_checkpoint(d, device="cpu")
    assert back.step == 0
    assert all(v.device.type == "cpu" for v in back.params.values())


@pytest.mark.parametrize("fuse", [None, False])
def test_fit_three_steps_and_resume(arrays, tmp_path, fuse, capsys):
    harness = _small_harness(fuse, ema_decay=0.9, lr=1e-3, grad_clip_norm=1.0,
                             update_clip_rms=1.0, mode_dropout=0.15, log_every=1,
                             checkpoint_every=2)
    batches = [ProteinBatch.from_numpy(arrays)] * 2
    d = str(tmp_path / "run")
    init = {k: v.detach().clone() for k, v in harness.init(42).params.items()}
    state = fit(harness, batches, batches[:1], max_steps=3, checkpoint_dir=d)
    out = capsys.readouterr().out
    assert state.step == 3 and ckpt.all_steps(d) == [2, 3]
    assert "[step 3]" in out and "train/translations_loss=" in out and "val/loss=" in out
    moved = [not torch.equal(state.params[k].detach(), init[k]) for k in init]
    assert all(moved)
    assert any(not torch.equal(state.params[k].detach(), state.ema_params[k]) for k in init)
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert ckpt.load_model_config(d) == harness.config.model
    resumed = fit(harness, batches, max_steps=4, checkpoint_dir=d)
    assert "resumed from step 3" in capsys.readouterr().out and resumed.step == 4
    # the same seed and steps give the same run
    again = fit(harness, batches, max_steps=3)
    assert all(torch.equal(again.params[k], state.params[k]) for k in init)


def test_fit_divergence_guard_falls_back(arrays, tmp_path, monkeypatch, capsys):
    """A loss that explodes after step 4 (logged every 2 steps): the run
    returns, and keeps on disk, the last snapshot a later window validated."""
    harness = _small_harness(lr=1e-3, log_every=2, checkpoint_every=2)
    losses = iter([1.0, 0.9, 0.8, 0.7, 50.0, 60.0, 70.0, 80.0])
    real_step = harness.train_step

    def exploding_step(state, batch, draws):
        state, metrics = real_step(state, batch, draws)
        return state, dict(metrics, **{"train/loss": torch.tensor(next(losses))})

    monkeypatch.setattr(harness, "train_step", exploding_step)
    d = str(tmp_path / "run")
    state = fit(harness, [ProteinBatch.from_numpy(arrays)], max_steps=8, checkpoint_dir=d)
    assert "falling back" in capsys.readouterr().out
    assert state.step == 2 and ckpt.latest_step(d) == 2
