"""The port's IPA attention core (K2) and its IPA layer under
`fuse_ipa_layer=False`, against the JAX package on the CPU in float32.

The JAX side runs the Pallas kernel as its own tests run it here
(`_pallas_raw` in interpret mode) and its jnp mirror
`_attention_core_raw_jnp`; the port runs its plain version (what its
wrapper runs on a CPU tensor).  Gradients are compared with `jax.grad`
through the JAX custom VJPs, after the transplant map of
`weights.params_from_jax`.

Tolerances (float32): 1e-5 on attention weights and 1e-4 on the weighted
sums against the Pallas kernel, which builds the same augmented operands
(only the summation order differs); 1e-4 against the jnp mirror, which
differences point coordinates of magnitude ~5 where the kernel expands
|q|^2 + |k|^2 - 2 q.k; 5e-4 on layer outputs (as tests/test_torch_models.py);
gradients to 1e-3 of each leaf's largest entry (the squared-output loss
amplifies the float32 differences of both formulations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.geometry import so3 as jso3
from diffab_pytorch_tpu.models import ipa as jipa
from diffab_pytorch_tpu.ops import ipa_pallas

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.models import ipa as tipa
from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as k1
from diffab_pytorch_tpu_torch.ops._recompute import recompute_grads
from diffab_pytorch_tpu_torch.weights import load_jax_params, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L = 24
LONG_L = (129, 136, 200, 256, 384)  # patches beyond one 128-key chunk
SCALES = (8 ** -0.5, (4.5 * 4) ** -0.5, 3 ** -0.5)


def close(actual, expected, atol, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=rtol)


def port_model_config(jcfg):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    return tconfig.ModelConfig(**{k: getattr(jcfg, k) for k in names if hasattr(jcfg, k)})


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, tree)


def core_inputs(seed, b, bp, n_masked, h=4, ds=8, p=4, dp=16):
    """Attention-core inputs: projections, global-frame points of magnitude
    ~3, bias logits at bp targets, the last n_masked keys padded."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = np.ones((b, L), np.float32)
    if n_masked:
        mask[:, -n_masked:] = 0.0
    return dict(
        q_s=f(b, L, h, ds), k_s=f(b, L, h, ds), v_s=f(b, L, h, ds),
        q_p=f(b, L, h, p, 3) * 3, k_p=f(b, L, h, p, 3) * 3, v_p=f(b, L, h, p, 3) * 3,
        pair=f(bp, L, L, dp), bias=f(bp, h, L, L), gamma=np.abs(f(h)) + 0.5, mask=mask,
    )


CASES = [(2, 1, 5), (4, 2, 0), (3, 3, 4)]  # (b, bp, masked keys): fan-out and bp = b


@pytest.mark.parametrize("b,bp,n_masked", CASES)
def test_core_matches_pallas_interpret_and_jnp(b, bp, n_masked):
    inp = core_inputs(b * 10 + n_masked, b, bp, n_masked)
    raw = {k: v for k, v in inp.items() if k != "pair"}
    jx = {k: jnp.asarray(v) for k, v in raw.items()}
    tx = {k: torch.from_numpy(v) for k, v in raw.items()}
    os_pl, op_pl, attn_pl = ipa_pallas._pallas_raw(*jx.values(), *SCALES)
    os_j, attn_j, op_j = ipa_pallas._attention_core_raw_jnp(*jx.values(), *SCALES)
    os_t, attn_t, op_t = k2.fused_ipa_attention_raw_reference(*tx.values(), *SCALES)

    ops = k2.augmented_operands(*(tx[k] for k in ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p",
                                                 "gamma", "mask")), *SCALES)
    assert ops[0].shape[2] % 16 == 0 and ops[0].shape == ops[1].shape
    core_s, core_p, core_a = k2.ipa_attention_core_reference(*ops, tx["bias"], SCALES[2])
    close(core_a, attn_pl, atol=1e-5)
    close(core_s, os_pl, atol=1e-4)
    close(core_p, op_pl, atol=1e-4)
    close(attn_t, attn_j, atol=1e-4)
    close(os_t, os_j, atol=1e-4)
    close(op_t, op_j, atol=1e-4)
    if n_masked:  # padded keys get exactly zero weight
        assert float(attn_t[..., -n_masked:].abs().max()) == 0.0
    # on CPU tensors the wrapper is the plain version
    for w, r in zip(k2.ipa_attention_core(*ops, tx["bias"], SCALES[2]),
                    (core_s, core_p, core_a)):
        assert torch.equal(w, r)


def test_entry_with_pair_rows_matches_jax():
    inp = core_inputs(5, 4, 2, 3)
    out_j = ipa_pallas.fused_ipa_attention(*(jnp.asarray(v) for v in inp.values()), *SCALES)
    out_t = k2.fused_ipa_attention(*(torch.from_numpy(v) for v in inp.values()), *SCALES)
    for t, j in zip(out_t, out_j):
        assert t.shape == j.shape
        close(t, j, atol=1e-4)


def test_core_checks_its_inputs():
    inp = core_inputs(6, 2, 1, 0)
    tx = {k: torch.from_numpy(v) for k, v in inp.items()}
    ops = k2.augmented_operands(*(tx[k] for k in ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p",
                                                 "gamma", "mask")), *SCALES)
    bias = tx["bias"]
    with pytest.raises(ValueError):
        k2.ipa_attention_core(ops[0], ops[1][..., :-1].contiguous(), *ops[2:], bias, 1.0)
    with pytest.raises(ValueError):
        k2.ipa_attention_core(*ops, bias[:, :-1].contiguous(), 1.0)
    with pytest.raises(ValueError):
        k2.ipa_attention_core(ops[0].transpose(2, 3).contiguous().transpose(2, 3), *ops[1:],
                              bias, 1.0)
    with pytest.raises(TypeError):
        k2.ipa_attention_core(*ops, bias.double(), 1.0)


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
    away from zero, 10 mantissa bits), on the int32 view: half an ulp added
    to the magnitude bits, the 13 low bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(products):
    """An einsum as the float32 kernels take it: each operand split into
    big = tf32(x) and small = tf32(x - big), and a b summed in float32 as
    a_small b_big + a_big b_small + a_big b_big (products=3, 3xTF32) or
    a_big b_big alone (products=1, plain TF32)."""
    def product(eq, a, b):
        a_big, b_big = _tf32(a), _tf32(b)
        out = torch.einsum(eq, a_big, b_big)
        if products == 3:
            out = (torch.einsum(eq, _tf32(a - a_big), b_big)
                   + torch.einsum(eq, a_big, _tf32(b - b_big)) + out)
        return out
    return product


def _tf32_core(q_aug, k_aug, v_s, v_p, bias, scale_total, products):
    """The kernel's float32 design in plain PyTorch: each of the two
    products as `_tf32_product` takes it."""
    product = _tf32_product(products)
    b, h, _, n = q_aug.shape
    bp = bias.shape[0]
    logit = product("bhfi,bhfj->bhij", q_aug, k_aug)
    logit = (logit.reshape(bp, b // bp, h, n, n) + bias[:, None]).reshape(b, h, n, n)
    attn = torch.softmax(logit * scale_total, dim=-1)
    out = product("bhcj,bhij->bhci", torch.cat([v_s, v_p], dim=2), attn)
    return out[:, :, :v_s.shape[2]], out[:, :, v_s.shape[2]:], attn


@pytest.mark.parametrize("products", [3, 1])
def test_tf32_split_products_meet_the_float32_rule_only_as_three(products):
    """The float32 kernel's 3xTF32 arithmetic at chip_smoke.py's magnitudes
    (L=128, ds=32, P=8, points x5, 16 padded keys) stays within its float32
    rule against the plain version (1e-4 on weights, 1e-4 of the output
    scale; padded keys exactly 0); one TF32 product per product does not."""
    n, n_masked, h, ds, p = 128, 16, 2, 32, 8
    rng = np.random.default_rng(50)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    mask = torch.ones(2, n)
    mask[:, -n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    ops = k2.augmented_operands(f(2, n, h, ds), f(2, n, h, ds), f(2, n, h, ds),
                                f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5,
                                f(h).abs() + 0.5, mask, *scales)
    bias = f(1, h, n, n)
    ref = k2.ipa_attention_core_reference(*ops, bias, scales[2])
    got = _tf32_core(*ops, bias, scales[2], products)
    worst = max(float((g - r).abs().max()) / (1.0 if i == 2 else max(1.0, float(r.abs().max())))
                for i, (g, r) in enumerate(zip(got, ref)))
    if products == 3:
        assert worst <= 1e-4
        assert float(got[2][..., -n_masked:].abs().max()) == 0.0
    else:
        assert worst > 1e-4


def _attention_shapes():
    """(L, F, ds, 3P) of every attention-core shape the port's configs reach
    (the tiny, default and production configs at L = 24, 32, 77 and the
    patch size), F as `augmented_operands` builds it."""
    out = set()
    for cfg in (tconfig.tiny_config(), tconfig.default_config(), tconfig.production_config()):
        m = cfg.model
        h, ds, p = m.n_head, m.d_scalar_per_head, m.n_query_point_per_head
        z = lambda *s: torch.zeros(*s)
        q_aug, _, v_s, v_p = k2.augmented_operands(
            z(1, 2, h, ds), z(1, 2, h, ds), z(1, 2, h, ds), z(1, 2, h, p, 3), z(1, 2, h, p, 3),
            z(1, 2, h, p, 3), torch.ones(h), torch.ones(1, 2), *SCALES)
        out |= {(n, q_aug.shape[2], v_s.shape[2], v_p.shape[2])
                for n in (24, 32, 77, cfg.data.patch_size, *LONG_L)}
    return sorted(out)


@pytest.mark.parametrize("shape", _attention_shapes())
def test_attention_shape_gate_accepts_the_port_shapes(shape):
    k2.check_attention_shape(*shape)


def _chunked_core(q_aug, k_aug, v_s, v_p, bias, scale_total, product, chunk=128):
    """The kernels' core beyond 128 keys (csrc/ipa_attention_tc.cuh
    chunked_attention) in plain PyTorch, in its chunk order and at its
    rounding points: pass 1 over key chunks keeps each row's running max m
    and sum l, rescaled by exp(m_old - m_new) when the max grows; pass 2
    recomputes each chunk's logits, rounds exp(logit - m) / l to the
    operands' dtype and accumulates the weighted sums in float32 (products
    by `product`: an exact einsum for bf16 operands, 3xTF32 for float32)."""
    dt = q_aug.dtype
    b, h, _, n = q_aug.shape
    q, k = q_aug.float(), k_aug.float()
    v = torch.cat([v_s, v_p], dim=2).float()
    bias_full = torch.repeat_interleave(bias.float(), b // bias.shape[0], dim=0)

    def chunk_logits(j0):
        s = product("bhfi,bhfj->bhij", q, k[..., j0:j0 + chunk])
        return (s + bias_full[..., j0:j0 + chunk]) * scale_total

    m = torch.full((b, h, n), -float("inf"))
    l = torch.zeros(b, h, n)
    for j0 in range(0, n, chunk):
        s = chunk_logits(j0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(m_new == -float("inf"), torch.zeros(()), m_new)
        l = l * torch.exp(m - base) + torch.exp(s - base[..., None]).sum(dim=-1)
        m = m_new
    inv_l = 1.0 / l
    attn = torch.empty(b, h, n, n)
    out = torch.zeros(b, h, v.shape[2], n)
    for j0 in range(0, n, chunk):
        w = (torch.exp(chunk_logits(j0) - m[..., None]) * inv_l[..., None]).to(dt).float()
        attn[..., j0:j0 + chunk] = w
        out = out + product("bhcj,bhij->bhci", v[..., j0:j0 + chunk], w)
    ds = v_s.shape[2]
    return out[:, :, :ds].to(dt), out[:, :, ds:].to(dt), attn.to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_core_meets_the_kernel_rules_at_L256(dtype):
    """The two-pass chunked core at L = 256 (two key chunks, 16 padded
    keys) at chip_smoke.py's magnitudes (ds=32, P=8, points x5) against
    the plain version, under chip_smoke.py's rules: float32 (3xTF32) within
    1e-4 on weights and 1e-4 of the output scale; bf16 at most 1e-4 of the
    elements beyond one bf16 step (2^-8 on weights, 2^-7 of the output
    scale); padded keys exactly 0 in both."""
    n, n_masked, h, ds, p = 256, 16, 2, 32, 8
    rng = np.random.default_rng(51)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
    mask = torch.ones(2, n, dtype=dtype)
    mask[:, -n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    ops = k2.augmented_operands(f(2, n, h, ds), f(2, n, h, ds), f(2, n, h, ds),
                                f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5,
                                (f(h).abs() + 0.5).float(), mask, *scales)
    bias = f(1, h, n, n)
    ref = k2.ipa_attention_core_reference(*ops, bias, scales[2])
    product = _tf32_product(3) if dtype == torch.float32 else torch.einsum
    got = _chunked_core(*ops, bias, scales[2], product)
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = 1.0 if i == 2 else max(1.0, float(r.float().abs().max()))
        d = (g.float() - r.float()).abs()
        if dtype == torch.float32:
            assert float(d.max()) <= 1e-4 * scale
        else:
            step = 2 ** -8 if i == 2 else 2 ** -7 * scale
            assert float((d > step).float().mean()) <= 1e-4
    assert float(got[2][..., -n_masked:].float().abs().max()) == 0.0


def _onepass_core(q_aug, k_aug, v_s, v_p, bias, scale_total, product, chunk=32):
    """K1 float32's core beyond 128 keys in one pass (csrc/ipa_attention_tc.cuh
    chunked_attention_onepass) in plain PyTorch, in its chunk order: each
    chunk's logits once; the running max m and sum l, l and the weighted sums
    rescaled by exp(m_old - m_new) when m grows; p = exp(logit - m_new) kept
    with that chunk's m; at the end attn = p exp(m_chunk - m) / l and the
    sums over l (the products 3xTF32 by `product`)."""
    b, h, _, n = q_aug.shape
    q, k = q_aug.float(), k_aug.float()
    v = torch.cat([v_s, v_p], dim=2).float()
    bias_full = torch.repeat_interleave(bias.float(), b // bias.shape[0], dim=0)
    m = torch.full((b, h, n), -float("inf"))
    l = torch.zeros(b, h, n)
    out = torch.zeros(b, h, v.shape[2], n)
    strip = []
    for j0 in range(0, n, chunk):
        s = product("bhfi,bhfj->bhij", q, k[..., j0:j0 + chunk])
        s = (s + bias_full[..., j0:j0 + chunk]) * scale_total
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        out = out * alpha[:, :, None] + product("bhcj,bhij->bhci", v[..., j0:j0 + chunk], p)
        strip.append((p, m_new))
        m = m_new
    attn = torch.cat([p * (torch.exp(mc - m) / l)[..., None] for p, mc in strip], dim=-1)
    out = out / l[:, :, None]
    ds = v_s.shape[2]
    return out[:, :, :ds], out[:, :, ds:], attn


@pytest.mark.parametrize("n", [129, 200, 256])
def test_onepass_core_meets_the_float32_rule(n):
    """The one-pass core at L = 129 (a chunk of one key), 200 (a ragged
    chunk) and 256, 16 padded keys, at chip_smoke.py's magnitudes (ds=32,
    P=8, points x5) against the plain version within the float32 rule (1e-4
    on weights, 1e-4 of the output scale), padded keys exactly 0: the
    per-chunk maxima and the final factors lose nothing that the rule sees."""
    n_masked, h, ds, p = 16, 2, 32, 8
    rng = np.random.default_rng(52 + n)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    mask = torch.ones(2, n)
    mask[:, -n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    ops = k2.augmented_operands(f(2, n, h, ds), f(2, n, h, ds), f(2, n, h, ds),
                                f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5, f(2, n, h, p, 3) * 5,
                                f(h).abs() + 0.5, mask, *scales)
    bias = f(1, h, n, n)
    ref = k2.ipa_attention_core_reference(*ops, bias, scales[2])
    got = _onepass_core(*ops, bias, scales[2], _tf32_product(3))
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = 1.0 if i == 2 else max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= 1e-4 * scale
    assert float(got[2][..., -n_masked:].abs().max()) == 0.0


@pytest.mark.parametrize("shape", [(24, 64, -1, 24), (128, 80, 41, 24), (128, 56, 32, 24),
                                   (0, 64, 32, 24)])
def test_attention_shape_gate_rejects_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        k2.check_attention_shape(*shape)


def _layer_case(seed, b, bp, fuse):
    jcfg = dataclasses.replace(jconfig.tiny_config().model, use_pallas_attention=True,
                               fuse_ipa_layer=fuse)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, jcfg.d_residue_emb)).astype(np.float32)
    pair = rng.normal(size=(bp, L, L, jcfg.d_pair_emb)).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(seed), (b, L)))
    trans = (rng.normal(size=(b, L, 3)) * 5).astype(np.float32)
    mask = np.ones((b, L), bool)
    mask[:, -4:] = False
    rot[:, -1] = np.nan  # garbage in padding must not leak
    layer = jipa.InvariantPointAttentionLayer(jcfg)
    args = [x, pair, rot, trans, mask]
    params = perturbed(jax.device_get(
        layer.init(jax.random.key(seed), *(jnp.asarray(a) for a in args))), seed + 1)
    return jcfg, layer, params, args


@pytest.mark.parametrize("b,bp", [(2, 2), (4, 2)])  # bp = b (training), fan-out
def test_layer_fuse_off_matches_jax(b, bp):
    jcfg, layer, params, args = _layer_case(20 + b, b, bp, fuse=False)
    out_j = jax.jit(layer.apply)(params, *(jnp.asarray(a) for a in args))
    tl = load_jax_params(tipa.InvariantPointAttentionLayer(port_model_config(jcfg)), params)
    fused_cfg = dataclasses.replace(port_model_config(jcfg), fuse_ipa_layer=None)
    tl_fused = load_jax_params(tipa.InvariantPointAttentionLayer(fused_cfg), params)
    with torch.no_grad():
        out_t = tl(*(torch.from_numpy(a) for a in args))
        out_fused = tl_fused(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(out_t).all()
    close(out_t, out_j, atol=5e-4)
    close(out_t, out_fused, atol=5e-4)


@pytest.mark.parametrize("fuse", [None, False])
def test_layer_at_L256_matches_pallas_interpret(fuse):
    """The port's IPA layer at L = 256 (the reference kernel's pinned long
    patch, tests/test_ipa_pallas.py) against the JAX layer through its
    Pallas kernels in interpret mode, at tiny widths, 5e-4 as above."""
    n = 256
    jcfg = jconfig.ModelConfig(d_residue_emb=16, d_pair_emb=8, n_head=2, d_scalar_per_head=4,
                               n_query_point_per_head=2, n_value_point_per_head=2,
                               use_pallas_attention=True, fuse_ipa_layer=fuse)
    rng = np.random.default_rng(70)
    x = rng.normal(size=(2, n, 16)).astype(np.float32)
    pair = (rng.normal(size=(1, n, n, 8)) * 0.1).astype(np.float32)
    rot = np.array(jso3.uniform(jax.random.key(71), (2, n)))
    trans = (rng.normal(size=(2, n, 3)) * 3).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[:, -7:] = False
    args = [x, pair, rot, trans, mask]
    layer = jipa.InvariantPointAttentionLayer(jcfg)
    params = perturbed(jax.device_get(
        layer.init(jax.random.key(72), *(jnp.asarray(a) for a in args))), 73)
    out_j = jax.jit(layer.apply)(params, *(jnp.asarray(a) for a in args))
    tl = load_jax_params(tipa.InvariantPointAttentionLayer(port_model_config(jcfg)), params)
    with torch.no_grad():
        out_t = tl(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(out_t).all()
    close(out_t, out_j, atol=5e-4)


@pytest.mark.parametrize("fuse", [None, False])
def test_layer_gradients_match_jax(fuse):
    """Parameter and input gradients of sum(out^2) through the port's layer
    (plain versions, autograd) against jax.grad through the custom VJPs."""
    jcfg, layer, params, args = _layer_case(30, 2, 1, fuse=fuse)
    jargs = [jnp.asarray(a) for a in args]

    def loss(p, x):
        return jnp.sum(layer.apply(p, x, *jargs[1:]) ** 2)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jargs[0])
    tl = load_jax_params(tipa.InvariantPointAttentionLayer(port_model_config(jcfg)), params)
    x = torch.from_numpy(args[0]).requires_grad_(True)
    out = tl(x, *(torch.from_numpy(a) for a in args[1:]))
    (out ** 2).sum().backward()
    expected = params_from_jax(jax.device_get(g_params))
    got = dict(tl.named_parameters())
    assert set(expected) == set(got)
    for name, g in expected.items():
        scale = float(g.abs().max())
        close(got[name].grad, g, atol=1e-3 * max(scale, 1.0), rtol=0)
    close(x.grad, g_x, atol=1e-3 * max(float(np.abs(g_x).max()), 1.0), rtol=0)


def _recompute_case(kind):
    """(plain function, its tensor inputs, trailing args) of K1 or K2."""
    rng = np.random.default_rng(40)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    if kind == "k2":
        inp = core_inputs(41, 4, 2, 3)
        tx = {k: torch.from_numpy(v) for k, v in inp.items()}
        ops = k2.augmented_operands(*(tx[k] for k in ("q_s", "k_s", "v_s", "q_p", "k_p",
                                                     "v_p", "gamma", "mask")), *SCALES)
        return k2.ipa_attention_core_reference, [*ops, tx["bias"]], (SCALES[2],)
    b, d, h, ds, p = 2, 32, 4, 8, 4
    w = lambda n_in, n_out: f(n_in, n_out) / n_in ** 0.5
    wts = k1.pack_layer_weights(
        w(d, h * ds), w(d, h * ds), w(d, h * ds), w(d, h * p * 3), w(d, h * p * 3),
        w(d, h * p * 3), w(h * ds, d), w(h * p * 3, d), w(h * p, d),
        f(h).abs() + 0.5, *SCALES[:2], torch.float32)
    rot = torch.from_numpy(np.array(jso3.uniform(jax.random.key(42), (b, L))))
    mask = torch.ones(b, L)
    mask[:, -3:] = 0
    tensors = [f(b, L, d), rot, f(b, L, 3) * 5, mask, wts.w_qkv, wts.w_out, wts.g,
               f(1, h, L, L)]
    return k1._packed_reference, tensors, ((h, ds, p), SCALES[2])


@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_recompute_backward_matches_autograd(kind):
    """The kernels' autograd Functions backpropagate by recomputing their
    plain version; that backward equals autograd through the plain
    version itself (bit for bit: the same graph on the same inputs)."""
    fn, tensors, extra = _recompute_case(kind)
    # K1 takes no gradient for rot (index 1) and mask (index 3)
    needs = [kind == "k2" or i not in (1, 3) for i in range(len(tensors))]
    leaves = [t.clone().requires_grad_(n) for t, n in zip(tensors, needs)]
    outs = fn(*leaves, *extra)
    rng = np.random.default_rng(43)
    cot = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)) for o in outs]
    cot[-1] = None  # an output without a cotangent
    used = [(o, c) for o, c in zip(outs, cot) if c is not None]
    want = torch.autograd.grad([o for o, _ in used], [l for l, n in zip(leaves, needs) if n],
                               [c for _, c in used])
    got = recompute_grads(fn, tensors, needs, cot, *extra)
    it = iter(want)
    for g, n in zip(got, needs):
        if n:
            assert torch.equal(g, next(it))
        else:
            assert g is None
