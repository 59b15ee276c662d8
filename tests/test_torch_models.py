"""Parity of the PyTorch port's model modules with the JAX package, on the
CPU in float32.

Both sides get the same numpy-made inputs and the same parameters (the JAX
tree, perturbed so that no bias or table is trivially zero, transplanted
into the port by name).  The JAX fused IPA layer runs as its own tests run
it here: the Pallas kernel in interpret mode (`use_pallas_attention=True`,
both `BATCHED_LAYER_KERNEL` values) and the XLA path.

Tolerances: 2e-4 absolute (scaled by the output's magnitude where it is
large) for float32 — the two frameworks sum the same products in another
order, and the port's logits use the kernel's |q|^2+|k|^2-2qk expansion
where the XLA path differences coordinates of magnitude ~5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.geometry import so3 as jso3
from diffab_pytorch_tpu.models import ipa as jipa
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.ops import ipa_pallas

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch_numpy
from diffab_pytorch_tpu_torch.models import ipa as tipa
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as tops
from diffab_pytorch_tpu_torch.weights import load_jax_params, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, L = 2, 24
ATOL = 2e-4


def port_model_config(jcfg):
    """The port's ModelConfig with every field it shares with `jcfg`."""
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    return tconfig.ModelConfig(**{k: getattr(jcfg, k) for k in names if hasattr(jcfg, k)})


def jax_batch(arrays):
    return JaxBatch(**{
        k: (None if v is None else jnp.asarray(
            v.astype(np.int32) if v.dtype.kind in "iu" else v))
        for k, v in arrays.items()
    })


def perturbed(tree, seed):
    """Every leaf plus N(0, 0.05^2) noise, so biases and tables are not 0."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05,
        tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def arrays():
    return synthetic_batch_numpy(0, B, L, 15, n_generate=6)


@pytest.fixture(scope="module")
def models(arrays):
    """(jax config, jax params, port model with the same weights)."""
    jcfg = jconfig.tiny_config().model
    jm = JaxModel(jcfg)
    jb = jax_batch(arrays)
    params = jax.jit(jm.init)(jax.random.key(0), jb, jb.seq_idx, jb.translations,
                     jb.orientations, jnp.zeros((B,)))
    params = perturbed(jax.device_get(params), 1)
    tm = load_jax_params(DiffAbModel(port_model_config(jcfg), device="cpu"), params)
    return jcfg, params, tm


def test_params_from_jax_uses_every_key(models):
    jcfg, params, tm = models
    state = params_from_jax(params)
    n_leaves = len(jax.tree.leaves(params))
    assert len(state) == n_leaves == len(tm.state_dict())
    assert set(state) == set(tm.state_dict())
    bad = dict(params["params"])
    bad["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(tm, {"params": bad})


@pytest.mark.parametrize("gen_struct,gen_seq", [(True, True), (True, False),
                                                (False, True), (False, False)])
def test_encode_context_all_modes(models, arrays, gen_struct, gen_seq):
    jcfg, params, tm = models
    res_j, pair_j = JaxModel(jcfg).apply(params, jax_batch(arrays), gen_struct,
                                         gen_seq, method="encode_context")
    with torch.no_grad():
        res_t, pair_t = tm.encode_context(ProteinBatch.from_numpy(arrays),
                                          gen_struct, gen_seq)
    close(res_t, res_j)
    close(pair_t, pair_j)


def test_embeddings_with_derived_dihedrals(models, arrays):
    """ResidueEmbedding without masks and PairEmbedding deriving the
    inter-residue dihedrals from xyz."""
    from diffab_pytorch_tpu.models.embedding import PairEmbedding, ResidueEmbedding

    jcfg, params, tm = models
    p = params["params"]
    jb = jax_batch(arrays)
    tb = ProteinBatch.from_numpy(arrays)
    res_j = ResidueEmbedding(jcfg).apply(
        {"params": p["residue_context_embedding"]}, jb.seq_idx, jb.xyz,
        jb.orientations, jb.backbone_dihedrals, jb.chain_idx, jb.atom_mask)
    pair_j = PairEmbedding(jcfg).apply(
        {"params": p["pair_context_embedding"]}, jb.seq_idx, jb.xyz, None,
        jb.residue_idx, jb.chain_idx, jb.atom_mask)
    with torch.no_grad():
        res_t = tm.residue_context_embedding(
            tb.seq_idx, tb.xyz, tb.orientations, tb.backbone_dihedrals,
            tb.chain_idx, tb.atom_mask)
        pair_t = tm.pair_context_embedding(
            tb.seq_idx, tb.xyz, None, tb.residue_idx, tb.chain_idx, tb.atom_mask)
    close(res_t, res_j)
    close(pair_t, pair_j)


def _layer_inputs(seed, b=2, bp=1, h=4, d=32, ds=8, p=4, dtype=np.float32):
    """Inputs of one fused layer: fan-out b designs over bp targets, the
    last 5 keys masked, translations of magnitude ~5."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(seed), (b, L)))
    mask = np.ones((b, L), np.float32)
    mask[:, -5:] = 0.0
    w = lambda n_in, n_out: f(n_in, n_out) / np.sqrt(n_in)
    return dict(
        x=f(b, L, d), rot=rot, trans=f(b, L, 3) * 5, mask=mask,
        w_qs=w(d, h * ds), w_ks=w(d, h * ds), w_vs=w(d, h * ds),
        w_qp=w(d, h * p * 3), w_kp=w(d, h * p * 3), w_vp=w(d, h * p * 3),
        w_os=w(h * ds, d), w_op=w(h * p * 3, d), w_on=w(h * p, d),
        bias=f(bp, h, L, L), gamma=np.abs(f(h)) + 0.5,
    ), (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)


@pytest.mark.parametrize("batched", [True, False])
def test_fused_layer_reference_matches_pallas_interpret(monkeypatch, batched):
    monkeypatch.setattr(ipa_pallas, "BATCHED_LAYER_KERNEL", batched)
    inp, scales = _layer_inputs(3)
    acc_j, attn_j = ipa_pallas.fused_ipa_layer(
        *(jnp.asarray(v) for v in inp.values()), *scales)
    acc_t, attn_t = tops.fused_ipa_layer_reference(
        *(torch.from_numpy(v) for v in inp.values()), *scales)
    close(attn_t, attn_j, atol=1e-5)
    assert float(attn_t[..., -5:].abs().max()) == 0.0  # padded keys get exactly 0
    close(acc_t, acc_j, atol=5e-4)
    # on a CPU tensor the wrapper is the plain version
    acc_w, attn_w = tops.fused_ipa_layer(
        *(torch.from_numpy(v) for v in inp.values()), *scales)
    assert torch.equal(acc_w, acc_t) and torch.equal(attn_w, attn_t)


def test_fused_layer_wrapper_checks_its_inputs():
    inp, scales = _layer_inputs(11)
    args = {k: torch.from_numpy(v) for k, v in inp.items()}
    bad_dtype = dict(args, trans=args["trans"].double())
    bad_shape = dict(args, bias=args["bias"][..., :-1])
    strided = dict(args, x=args["x"].transpose(0, 1).contiguous().transpose(0, 1))
    for bad in (bad_dtype, bad_shape, strided):
        with pytest.raises(ValueError):
            tops.fused_ipa_layer(*bad.values(), *scales)


def test_fused_layer_reference_matches_layer_core_jnp():
    inp, scales = _layer_inputs(4)
    acc_j, attn_j = ipa_pallas._layer_core_jnp(
        *(jnp.asarray(v) for v in inp.values()), *scales)
    acc_t, attn_t = tops.fused_ipa_layer_reference(
        *(torch.from_numpy(v) for v in inp.values()), *scales)
    close(attn_t, attn_j, atol=1e-5)
    close(acc_t, acc_j, atol=5e-4)


def test_fused_layer_reference_bf16_matches_pallas_interpret():
    """In bfloat16 the plain version rounds where the Pallas kernel does.
    Tolerance: one bf16 step (2^-8 relative) of the output's scale — the
    float32 sums feeding each rounding differ in order between the two."""
    inp, scales = _layer_inputs(5)
    acc_j, attn_j = ipa_pallas.fused_ipa_layer(
        *(jnp.asarray(v, jnp.float32 if k == "bias" else jnp.bfloat16)
          for k, v in inp.items()), *scales)
    acc_t, attn_t = tops.fused_ipa_layer_reference(
        *(torch.from_numpy(v).to(torch.float32 if k == "bias" else torch.bfloat16)
          for k, v in inp.items()), *scales)
    attn_j = np.asarray(attn_j.astype(jnp.float32))
    acc_j = np.asarray(acc_j.astype(jnp.float32))
    close(attn_t.float(), attn_j, atol=2 ** -8, rtol=2 ** -7)
    scale = float(np.abs(acc_j).max())
    close(acc_t.float(), acc_j, atol=2 ** -7 * scale, rtol=2 ** -7)


def _layer_case(seed, b, bp):
    jcfg = jconfig.tiny_config().model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, jcfg.d_residue_emb)).astype(np.float32)
    pair = rng.normal(size=(bp, L, L, jcfg.d_pair_emb)).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(seed), (b, L)))
    trans = (rng.normal(size=(b, L, 3)) * 5).astype(np.float32)
    mask = np.ones((b, L), bool)
    mask[:, -4:] = False
    rot[:, -1] = np.nan  # garbage in padding must not leak
    return jcfg, [x, pair, rot, trans, mask]


@pytest.mark.parametrize("pallas", [True, False])
def test_ipa_layer_matches_jax(pallas):
    jcfg, args = _layer_case(6, b=2, bp=1)
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=pallas)
    layer = jipa.InvariantPointAttentionLayer(jcfg)
    params = perturbed(jax.device_get(
        layer.init(jax.random.key(1), *(jnp.asarray(a) for a in args))), 2)
    out_j = layer.apply(params, *(jnp.asarray(a) for a in args))
    tl = load_jax_params(tipa.InvariantPointAttentionLayer(port_model_config(jcfg)), params)
    with torch.no_grad():
        out_t = tl(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(out_t).all()
    close(out_t, out_j, atol=5e-4)


def test_ipa_module_matches_jax():
    jcfg, args = _layer_case(7, b=4, bp=2)
    module = jipa.InvariantPointAttentionModule(jcfg)
    params = perturbed(jax.device_get(
        module.init(jax.random.key(2), *(jnp.asarray(a) for a in args))), 3)
    out_j = module.apply(params, *(jnp.asarray(a) for a in args))
    biases_j = jipa.precompute_pair_biases(params["params"], jnp.asarray(args[1]))
    tm = load_jax_params(tipa.InvariantPointAttentionModule(port_model_config(jcfg)), params)
    with torch.no_grad():
        out_t = tm(*(torch.from_numpy(a) for a in args))
        biases_t = tipa.precompute_pair_biases(tm, torch.from_numpy(args[1]))
        out_pre = tm(*(torch.from_numpy(a) for a in args), pair_biases=biases_t,
                     kernel_weights=tm.kernel_weights())
    close(out_t, out_j, atol=1e-3)
    close(out_pre, out_t, atol=1e-5)
    for bt, bj in zip(biases_t, biases_j):
        close(bt, bj, atol=1e-5)


def test_frames_apply_and_inverse_match_jax():
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(2, L, 4, 5, 3)).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(10), (2, L)))
    trans = (rng.normal(size=(2, L, 3)) * 5).astype(np.float32)
    for jf, tf in ((jipa.frames_apply, tipa.frames_apply),
                   (jipa.frames_apply_inverse, tipa.frames_apply_inverse)):
        close(tf(t_(pts), t_(rot), t_(trans)),
              jf(jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans)), atol=1e-5)
    back = tipa.frames_apply_inverse(tipa.frames_apply(t_(pts), t_(rot), t_(trans)),
                                     t_(rot), t_(trans))
    close(back, pts, atol=1e-4)


def test_attended_pair_rows_matches_jax():
    rng = np.random.default_rng(8)
    attn = rng.random((6, 4, L, L)).astype(np.float32)
    pair = rng.normal(size=(2, L, L, 16)).astype(np.float32)
    for n in (1, 3):
        a = attn if n == 3 else attn[:2]
        out_j = jipa.attended_pair_rows(jnp.asarray(a), jnp.asarray(pair), n)
        out_t = tipa.attended_pair_rows(torch.from_numpy(a), torch.from_numpy(pair), n)
        close(out_t, out_j, atol=1e-4)


@pytest.mark.parametrize("pallas", [True, False])
def test_denoise_matches_jax(models, arrays, pallas):
    jcfg, params, tm = models
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=pallas)
    n = 2
    rng = np.random.default_rng(9)
    bn = B * n
    seq = rng.integers(0, 21, (bn, L))
    x = rng.normal(size=(bn, L, 3)).astype(np.float32)
    r = np.array(jso3.uniform(jax.random.key(3), (bn, L)))
    beta = rng.random(bn).astype(np.float32)
    gen = np.repeat(arrays["generation_mask"], n, 0)
    rmask = np.repeat(arrays["residue_mask"], n, 0)
    jm = JaxModel(jcfg)
    res_j, pair_j = jm.apply(params, jax_batch(arrays), method="encode_context")
    biases_j = jipa.precompute_pair_biases(params["params"]["denoiser"]["ipa"], pair_j)
    out_j = jm.apply(params, jnp.asarray(seq, jnp.int32), jnp.asarray(x), jnp.asarray(r),
                     res_j, pair_j, jnp.asarray(beta), jnp.asarray(gen),
                     jnp.asarray(rmask), pair_biases=biases_j, method="denoise")
    with torch.no_grad():
        res_t, pair_t = tm.encode_context(ProteinBatch.from_numpy(arrays))
        biases_t = tipa.precompute_pair_biases(tm.denoiser.ipa, pair_t)
        out_t = tm.denoise(torch.from_numpy(seq), torch.from_numpy(x),
                           torch.from_numpy(r), res_t, pair_t, torch.from_numpy(beta),
                           torch.from_numpy(gen), torch.from_numpy(rmask),
                           pair_biases=biases_t)
    for key in ("translations_eps", "orientations_t0", "seq_posterior", "seq_logits"):
        close(out_t[key], out_j[key], atol=1e-3)
