"""The fused IPA layer's (K1) weight layout, plain version, shape gate and
float32 arithmetic, on the CPU.

`pack_layer_weights` makes one head-major layout, which both kernel routes
(bfloat16 and float32), the plain version and the backward read.  These
tests hold it to being a pure permutation of the native flax weights plus
zero padding, hold the plain version on it to the layer computed straight
from the native weights, check that gradients reach every native weight
through it, hold the wrapper's shape gate to the shapes the port uses, and
emulate the float32 kernel's 3xTF32 products.  The kernels themselves run
only on the card (`chip_smoke.py` holds them against the plain version
there).
"""

import numpy as np
import pytest
import torch

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as k1
from test_torch_attention import _tf32

# (d, h, ds, P): the port's tiny and default widths, and widths that are
# not multiples of 8 anywhere
WIDTHS = [(32, 4, 8, 4), (128, 8, 32, 8), (30, 3, 5, 3), (20, 2, 1, 21)]


def _native_weights(seed, d, h, ds, p, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    w = lambda n_in, n_out: (torch.randn(n_in, n_out, generator=g) / n_in ** 0.5).to(dtype)
    return (w(d, h * ds), w(d, h * ds), w(d, h * ds),
            w(d, h * p * 3), w(d, h * p * 3), w(d, h * p * 3),
            w(h * ds, d), w(h * p * 3, d), w(h * p, d),
            torch.rand(h, generator=g) + 0.5)


def _scales(ds, p):
    return ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5


def _pad8(n):
    return -(-n // 8) * 8


def _expected_layout(native, ds, p):
    """The head-major layout built element by element from the native flax
    column orders (point columns (h, P, 3)), float32."""
    w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op, w_on, gamma = native
    d, h = w_qs.shape[0], gamma.shape[0]
    scale_scalar, scale_point, _ = _scales(ds, p)
    g = torch.sqrt(0.5 * scale_point * gamma)
    fvp, fh = _pad8(ds + 3 * p), _pad8(ds + 4 * p)
    w_qkv = torch.zeros(h, d, 3 * fvp)
    w_out = torch.zeros(h * fh, _pad8(d))
    parts = ((w_qs * torch.tensor(scale_scalar), w_qp, g), (w_ks, w_kp, g),
             (w_vs, w_vp, None))
    for part, (w_s, w_p, g_p) in enumerate(parts):
        for hh in range(h):
            col = part * fvp
            w_qkv[hh, :, col:col + ds] = w_s[:, hh * ds:(hh + 1) * ds]
            for kc in range(3):
                for pp in range(p):
                    v = w_p[:, (hh * p + pp) * 3 + kc]
                    w_qkv[hh, :, col + ds + kc * p + pp] = v if g_p is None else v * g_p[hh]
    for hh in range(h):
        row = hh * fh
        w_out[row:row + ds, :d] = w_os[hh * ds:(hh + 1) * ds]
        for kc in range(3):
            for pp in range(p):
                w_out[row + ds + kc * p + pp, :d] = w_op[(hh * p + pp) * 3 + kc]
        w_out[row + ds + 3 * p:row + ds + 4 * p, :d] = w_on[hh * p:(hh + 1) * p]
    return w_qkv, w_out


@pytest.mark.parametrize("d,h,ds,p", WIDTHS)
def test_head_major_layout_is_a_permutation_plus_zero_padding(d, h, ds, p):
    native = _native_weights(0, d, h, ds, p)
    w_qkv, w_out = _expected_layout(native, ds, p)
    for dtype in (torch.float32, torch.bfloat16):
        wts = k1.pack_layer_weights(*native, *_scales(ds, p)[:2], dtype)
        assert wts.w_qkv.is_contiguous() and wts.w_out.is_contiguous()
        assert torch.equal(wts.w_qkv, w_qkv.to(dtype)) and torch.equal(wts.w_out, w_out.to(dtype))
    # every native element appears once: the padded arrays hold no more nonzeros
    assert int((wts.w_qkv != 0).sum()) == sum(int((w != 0).sum()) for w in native[:6])
    assert int((wts.w_out != 0).sum()) == sum(int((w != 0).sum()) for w in native[6:9])


def _layer_inputs(seed, b, bp, L, d, h, n_masked, bias_dtype=torch.float32):
    """Seeded layer inputs at chip_smoke.py's magnitudes: orthonormal frames,
    translations of magnitude ~5, the last n_masked keys padded."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, _ = torch.linalg.qr(f(b, L, 3, 3))
    q = q * torch.det(q)[..., None, None].sign()
    mask = torch.ones(b, L)
    mask[:, L - n_masked:] = 0.0
    return dict(x=f(b, L, d), rot=q.contiguous(), trans=f(b, L, 3) * 5, mask=mask,
                bias=f(bp, h, L, L).to(bias_dtype))


def _native_layer(x, rot, trans, mask, native, bias, scales):
    """The layer straight from the native weights in float64: IPA logits in
    their distance form, the flax point orders (h, P, 3) kept throughout."""
    w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op, w_on, gamma = (t.double() for t in native)
    x, rot, trans, mask, bias = (t.double() for t in (x, rot, trans, mask, bias))
    b, L, _ = x.shape
    h, bp = gamma.shape[0], bias.shape[0]
    ds, p = w_qs.shape[1] // h, w_qp.shape[1] // (3 * h)
    scalar = lambda w: (x @ w).reshape(b, L, h, ds)
    # frames: global = local @ R + t, per point
    points = lambda w: (torch.einsum("blhpi,blic->blhpc", (x @ w).reshape(b, L, h, p, 3), rot)
                        + trans[:, :, None, None, :])
    qs, ks, vs = scalar(w_qs), scalar(w_ks), scalar(w_vs)
    qg, kg, vg = points(w_qp), points(w_kp), points(w_vp)
    dist = ((qg[:, :, None] - kg[:, None]) ** 2).sum(dim=(-2, -1))  # (b, i, j, h)
    logit = (scales[0] * torch.einsum("bihd,bjhd->bhij", qs, ks)
             - 0.5 * scales[1] * gamma[:, None, None] * dist.permute(0, 3, 1, 2))
    logit = logit + torch.repeat_interleave(bias, b // bp, dim=0)
    logit = logit + ((mask - 1.0) * 1e9)[:, None, None, :] / scales[2]
    attn = torch.softmax(logit * scales[2], dim=-1)
    os_ = torch.einsum("bhij,bjhd->bihd", attn, vs)
    og = torch.einsum("bhij,bjhpc->bihpc", attn, vg)
    # inverse frames: local = (global - t) @ R^T
    loc = torch.einsum("bihpk,bick->bihpc", og - trans[:, :, None, None, :], rot)
    nrm = torch.sqrt((loc ** 2).sum(-1) + 1e-8)
    acc = (os_.reshape(b, L, -1) @ w_os + loc.reshape(b, L, -1) @ w_op
           + nrm.reshape(b, L, -1) @ w_on)
    return acc, attn


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_plain_version_on_the_pack_matches_an_einsum_on_the_native_weights(bias_dtype):
    """The plain version (float32, on the head-major pack) against the layer
    computed in float64 from the native weights, within the float32 rule
    (1e-4 on weights, 1e-4 of the output scale): the augmented-operand
    expansion sums |q'|^2 and |k'|^2 terms of ~10^2 in float32.  A wrong
    permutation misses by orders of magnitude."""
    b, bp, L, d, h, ds, p = 4, 2, 20, 32, 4, 8, 4
    native = _native_weights(1, d, h, ds, p)
    wts = k1.pack_layer_weights(*native, *_scales(ds, p)[:2], torch.float32)
    args = _layer_inputs(2, b, bp, L, d, h, 3, bias_dtype)
    acc, attn = k1.fused_ipa_layer_packed_reference(wts=wts, scale_total=_scales(ds, p)[2],
                                                    **args)
    acc_n, attn_n = _native_layer(native=native, scales=_scales(ds, p), **args)
    assert float((attn.double() - attn_n).abs().max()) <= 1e-4
    assert float((acc.double() - acc_n).abs().max()) <= 1e-4 * max(1.0, float(acc_n.abs().max()))
    assert float(attn[..., -3:].abs().max()) == 0.0
    if bias_dtype == torch.float32:  # the CPU wrapper is the plain version
        acc_w, attn_w = k1.fused_ipa_layer_packed(wts=wts, scale_total=_scales(ds, p)[2], **args)
        assert torch.equal(acc_w, acc) and torch.equal(attn_w, attn)


def test_pack_gives_one_layout_and_gradients_reach_every_native_weight():
    d, h, ds, p = 32, 4, 8, 4
    native = _native_weights(3, d, h, ds, p)
    for dtype in (torch.float32, torch.bfloat16):
        wts = k1.pack_layer_weights(*native, *_scales(ds, p)[:2], dtype)
        assert wts._fields == ("w_qkv", "w_out", "g", "n_head", "d_scalar", "n_point")
        assert wts.w_qkv.shape == (h, d, 3 * _pad8(ds + 3 * p)) and wts.w_qkv.dtype == dtype
        assert wts.w_out.shape == (h * _pad8(ds + 4 * p), _pad8(d)) and wts.w_out.dtype == dtype
        assert wts.g.dtype == torch.float32 and wts.w_qkv.device.type == "cpu"

    def packed(*weights):
        wts = k1.pack_layer_weights(*weights, *_scales(ds, p)[:2], torch.float64)
        return wts.w_qkv, wts.w_out, wts.g

    leaves = [t.double().requires_grad_(True) for t in native]
    assert torch.autograd.gradcheck(packed, leaves, fast_mode=True)
    rng = np.random.default_rng(4)
    outs = packed(*leaves)
    sum((o * torch.from_numpy(rng.normal(size=o.shape))).sum() for o in outs).backward()
    assert all(t.grad is not None and bool((t.grad != 0).any()) for t in leaves)


def test_wrapper_rejects_a_pack_of_the_wrong_shape():
    b, L, d, h, ds, p = 2, 16, 32, 4, 8, 4
    wts = k1.pack_layer_weights(*_native_weights(4, d, h, ds, p), *_scales(ds, p)[:2],
                                torch.bfloat16)
    args = dict(x=torch.zeros(b, L, d).bfloat16(), rot=torch.eye(3).expand(b, L, 3, 3)
                .contiguous().bfloat16(), trans=torch.zeros(b, L, 3).bfloat16(),
                mask=torch.ones(b, L).bfloat16(), bias=torch.zeros(1, h, L, L).bfloat16(),
                scale_total=3 ** -0.5)
    k1.fused_ipa_layer_packed(wts=wts, **args)
    # the head-major arrays cut, in another dtype, flattened to the old
    # (d, 3 h FVP) packing, and a g of the wrong length
    for bad in (wts._replace(w_qkv=wts.w_qkv[..., :-8].contiguous()),
                wts._replace(w_out=wts.w_out.float()),
                wts._replace(w_qkv=wts.w_qkv.transpose(0, 1).reshape(d, -1).contiguous()),
                wts._replace(w_out=wts.w_out[:, :d - 1].contiguous()),
                wts._replace(g=wts.g[:-1].contiguous())):
        with pytest.raises(ValueError):
            k1.fused_ipa_layer_packed(wts=bad, **args)


def _tf32_layer(x, rot, trans, mask, wts, bias, scale_total, products):
    """The float32 kernel's arithmetic in plain PyTorch: the plain version
    with every product (projection, logits, weighted sums, output
    projection) taken as the kernel takes it, each operand split into
    big = tf32(v) and small = tf32(v - big) and a b summed as a_small b_big
    + a_big b_small + a_big b_big (products=3, 3xTF32), or a_big b_big
    alone (products=1, plain TF32)."""
    def product(eq, a, b):
        a_big, b_big = _tf32(a), _tf32(b)
        out = torch.einsum(eq, a_big, b_big)
        if products == 3:
            out = (torch.einsum(eq, _tf32(a - a_big), b_big)
                   + torch.einsum(eq, a_big, _tf32(b - b_big)) + out)
        return out

    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    fv = ds + 3 * p
    proj = product("bld,hdn->blhn", x, wts.w_qkv).reshape(b, L, h, 3, -1)[..., :fv]

    def split(part, t):
        pt = proj[:, :, :, part, ds:].reshape(b, L, h, 3, p)
        return proj[:, :, :, part, :ds], torch.einsum("blhip,blic->blhcp", pt, rot) + t[..., None]

    t_g = trans[:, :, None, :] * wts.g[None, None, :, None]
    (qs, qg), (ks, kg), (vs, vg) = split(0, t_g), split(1, t_g), split(2, trans[:, :, None, :])
    q_sq = (qg * qg).sum(dim=(-2, -1))[..., None]
    k_sq = (kg * kg).sum(dim=(-2, -1))[..., None]
    ones = torch.ones_like(q_sq)
    nk = ((mask - 1.0) * (1e9 / scale_total))[:, :, None, None].expand(b, L, h, 1)
    q_aug = torch.cat([qs, 2.0 * qg.reshape(b, L, h, 3 * p), -q_sq, -ones, ones], dim=-1)
    k_aug = torch.cat([ks, kg.reshape(b, L, h, 3 * p), ones, k_sq, nk], dim=-1)
    logit = product("bihf,bjhf->bhij", q_aug, k_aug)
    bp = bias.shape[0]
    logit = (logit.reshape(bp, b // bp, h, L, L) + bias[:, None]).reshape(b, h, L, L)
    attn = torch.softmax(logit * scale_total, dim=-1)
    out = product("bhij,bjhf->bihf", attn, torch.cat([vs, vg.reshape(b, L, h, 3 * p)], -1))
    og = out[..., ds:].reshape(b, L, h, 3, p)
    loc = torch.einsum("blhkp,blck->blhcp", og - trans[:, :, None, :, None], rot)
    nrm = torch.sqrt((loc * loc).sum(dim=-2) + 1e-8)
    feat = torch.cat([out[..., :ds], loc.reshape(b, L, h, 3 * p), nrm], dim=-1)
    w_out = wts.w_out.reshape(h, -1, wts.w_out.shape[-1])[:, :ds + 4 * p, :d]
    return product("blhf,hfd->bld", feat, w_out), attn


@pytest.mark.parametrize("products", [3, 1])
def test_tf32_layer_products_meet_the_float32_rule_only_as_three(products):
    """The float32 kernel's 3xTF32 arithmetic through the whole layer at
    chip_smoke.py's magnitudes (main widths L=128, d=128, h=8, ds=32, P=8,
    b=2, translations x5, 16 padded keys) stays within its float32 rule
    against the plain version (1e-4 on weights, 1e-4 of the output scale;
    padded keys exactly 0); one TF32 product per product does not."""
    b, L, d, h, ds, p, n_masked = 2, 128, 128, 8, 32, 8, 16
    rng = np.random.default_rng(60)
    native = [torch.from_numpy(a.astype(np.float32)) for a in (
        *(rng.normal(size=(d, n)) / d ** 0.5 for n in (h * ds,) * 3 + (h * p * 3,) * 3),
        *(rng.normal(size=(n, d)) / n ** 0.5 for n in (h * ds, h * p * 3, h * p)),
        np.abs(rng.normal(size=h)) + 0.5)]
    wts = k1.pack_layer_weights(*native, *_scales(ds, p)[:2], torch.float32)
    args = _layer_inputs(61, b, 1, L, d, h, n_masked)
    acc, attn = k1.fused_ipa_layer_packed_reference(wts=wts, scale_total=_scales(ds, p)[2],
                                                    **args)
    acc_t, attn_t = _tf32_layer(wts=wts, scale_total=_scales(ds, p)[2], products=products,
                                **args)
    worst = max(float((attn_t - attn).abs().max()),
                float((acc_t - acc).abs().max()) / max(1.0, float(acc.abs().max())))
    if products == 3:
        assert worst <= 1e-4
        assert float(attn_t[..., -n_masked:].abs().max()) == 0.0
    else:
        assert worst > 1e-4


def _model_shapes():
    """(L, d, h, ds, P) of every fused-layer shape the port's configs and
    tests use: tests/test_torch_models.py (L=24 at the tiny widths), the
    tiny, default and production configs at the patch size, the card
    checks' L=77, and patches longer than 128 residues."""
    out = [(24, 32, 4, 8, 4)]
    for cfg in (tconfig.tiny_config(), tconfig.default_config(), tconfig.production_config()):
        m = cfg.model
        dims = (m.d_residue_emb, m.n_head, m.d_scalar_per_head, m.n_query_point_per_head)
        out += [(L, *dims) for L in (24, 32, 77, cfg.data.patch_size)]
    # patches beyond one 128-row chunk at the default widths
    return out + [(L, 128, 8, 32, 8) for L in (129, 136, 200, 256, 384)]


@pytest.mark.parametrize("shape", _model_shapes())
def test_shape_gate_accepts_the_port_shapes(shape):
    k1.check_kernel_shape(*shape)


@pytest.mark.parametrize("shape", [(24, 32, 0, 8, 4), (128, 128, 8, 32, 11),
                                   (24, 32, 4, 62, 1), (0, 32, 4, 8, 4), (24, 32, 4, 8, 0)])
def test_shape_gate_rejects_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        k1.check_kernel_shape(*shape)
