"""The fused IPA layer's (K1) bfloat16 weight layout and shape gate, on the
CPU.

The tensor-core kernel reads head-major copies of the packed weights
(`head_major_weights`, made by `pack_layer_weights` for bfloat16 weights on
the card); these tests hold them to being a pure permutation
of `pack_layer_weights`' output plus zero padding, so that the plain
version gives bit-identical outputs from either, and hold the wrapper's
shape gate to the shapes the port uses.  The kernel itself runs only on
the card (`chip_smoke.py` holds it against the plain version there).
"""

import numpy as np
import pytest
import torch

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as k1

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


def _with_heads(wts):
    """wts with the head-major copies the card's bfloat16 pack carries."""
    heads = k1.head_major_weights(wts.w_qkv, wts.w_out, wts.n_head, wts.d_scalar, wts.n_point)
    return wts._replace(w_qkv_heads=heads[0], w_out_heads=heads[1])


def _from_head_major(w_qkv_heads, w_out_heads, d, h, ds, p):
    """Undo `head_major_weights`: drop the zero padding and put every
    element back at its packed position (asserting the padding is 0)."""
    fv, fh = ds + 3 * p, w_out_heads.shape[0] // h
    blocks = w_qkv_heads.reshape(h, d, 3, -1)
    assert torch.equal(blocks[..., fv:], torch.zeros_like(blocks[..., fv:]))
    blocks = blocks[..., :fv].permute(1, 2, 0, 3)  # (d, 3, h, fv)
    w_qkv = torch.cat([blocks[..., :ds].reshape(d, 3, h * ds),
                       blocks[..., ds:].reshape(d, 3, h * 3 * p)], dim=-1).reshape(d, -1)
    rows = w_out_heads.reshape(h, fh, -1)
    assert torch.equal(rows[:, :, d:], torch.zeros_like(rows[:, :, d:]))
    assert torch.equal(rows[:, ds + 4 * p:], torch.zeros_like(rows[:, ds + 4 * p:]))
    rows = rows[:, :ds + 4 * p, :d]
    w_out = torch.cat([rows[:, :ds].reshape(h * ds, d), rows[:, ds:ds + 3 * p].reshape(-1, d),
                       rows[:, ds + 3 * p:].reshape(h * p, d)], dim=0)
    return w_qkv, w_out


@pytest.mark.parametrize("d,h,ds,p", WIDTHS)
def test_head_major_layout_is_a_permutation_plus_zero_padding(d, h, ds, p):
    wts = _with_heads(k1.pack_layer_weights(*_native_weights(0, d, h, ds, p), ds ** -0.5,
                                            (4.5 * p) ** -0.5, torch.bfloat16))
    fvp, fh, dp = (-(-n // 8) * 8 for n in (ds + 3 * p, ds + 4 * p, d))
    assert wts.w_qkv_heads.shape == (h, d, 3 * fvp) and wts.w_out_heads.shape == (h * fh, dp)
    assert wts.w_qkv_heads.is_contiguous() and wts.w_out_heads.is_contiguous()
    w_qkv, w_out = _from_head_major(wts.w_qkv_heads, wts.w_out_heads, d, h, ds, p)
    assert torch.equal(w_qkv, wts.w_qkv) and torch.equal(w_out, wts.w_out)
    # every element appears once: the padded arrays hold no more nonzeros
    assert int((wts.w_qkv_heads != 0).sum()) == int((wts.w_qkv != 0).sum())
    assert int((wts.w_out_heads != 0).sum()) == int((wts.w_out != 0).sum())


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_plain_version_identical_from_either_layout(bias_dtype):
    b, bp, L, d, h, ds, p = 4, 2, 20, 32, 4, 8, 4
    wts = _with_heads(k1.pack_layer_weights(*_native_weights(1, d, h, ds, p), ds ** -0.5,
                                            (4.5 * p) ** -0.5, torch.bfloat16))
    back = k1.LayerKernelWeights(*_from_head_major(wts.w_qkv_heads, wts.w_out_heads,
                                                   d, h, ds, p), wts.g, h, ds, p)
    rng = np.random.default_rng(2)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, _ = torch.linalg.qr(f(b, L, 3, 3))
    mask = torch.ones(b, L)
    mask[:, -3:] = 0
    args = dict(x=f(b, L, d).bfloat16(), rot=q.contiguous().bfloat16(), trans=(f(b, L, 3) * 5).bfloat16(),
                mask=mask.bfloat16(), bias=f(bp, h, L, L).to(bias_dtype), scale_total=3 ** -0.5)
    acc_a, attn_a = k1.fused_ipa_layer_packed_reference(wts=wts, **args)
    acc_b, attn_b = k1.fused_ipa_layer_packed_reference(wts=back, **args)
    assert torch.equal(acc_a, acc_b) and torch.equal(attn_a, attn_b)
    # the CPU wrapper is the plain version, whichever fields are filled
    for w in (wts, back):
        acc_w, attn_w = k1.fused_ipa_layer_packed(wts=w, **args)
        assert torch.equal(acc_w, acc_a) and torch.equal(attn_w, attn_a)


def test_head_major_copies_only_for_bfloat16_and_outside_autograd():
    native = [t.requires_grad_(True) for t in _native_weights(3, 32, 4, 8, 4)]
    f32 = k1.pack_layer_weights(*native, 8 ** -0.5, 18 ** -0.5, torch.float32)
    assert f32.w_qkv_heads is None and f32.w_out_heads is None
    bf = k1.pack_layer_weights(*native, 8 ** -0.5, 18 ** -0.5, torch.bfloat16)
    # on the CPU nothing reads them, so the pack makes none
    assert bf.w_qkv_heads is None and bf.w_out_heads is None
    heads = _with_heads(bf)
    assert bf.w_qkv.requires_grad and not heads.w_qkv_heads.requires_grad
    assert not heads.w_out_heads.requires_grad


def test_wrapper_rejects_head_major_copies_of_the_wrong_shape():
    b, L, d, h, ds, p = 2, 16, 32, 4, 8, 4
    wts = _with_heads(k1.pack_layer_weights(*_native_weights(4, d, h, ds, p), ds ** -0.5,
                                            (4.5 * p) ** -0.5, torch.bfloat16))
    args = dict(x=torch.zeros(b, L, d).bfloat16(), rot=torch.eye(3).expand(b, L, 3, 3)
                .contiguous().bfloat16(), trans=torch.zeros(b, L, 3).bfloat16(),
                mask=torch.ones(b, L).bfloat16(), bias=torch.zeros(1, h, L, L).bfloat16(),
                scale_total=3 ** -0.5)
    k1.fused_ipa_layer_packed(wts=wts, **args)
    for bad in (wts._replace(w_qkv_heads=wts.w_qkv_heads[..., :-8].contiguous()),
                wts._replace(w_out_heads=wts.w_out_heads.float()),
                wts._replace(w_out_heads=None)):
        with pytest.raises(ValueError):
            k1.fused_ipa_layer_packed(wts=bad, **args)


def _model_shapes():
    """(L, d, h, ds, P) of every fused-layer shape the port's configs and
    tests use: tests/test_torch_models.py (L=24 at the tiny widths), the
    tiny, default and production configs at the patch size, and the
    card checks' L=77."""
    out = [(24, 32, 4, 8, 4)]
    for cfg in (tconfig.tiny_config(), tconfig.default_config(), tconfig.production_config()):
        m = cfg.model
        dims = (m.d_residue_emb, m.n_head, m.d_scalar_per_head, m.n_query_point_per_head)
        out += [(L, *dims) for L in (24, 32, 77, cfg.data.patch_size)]
    return out


@pytest.mark.parametrize("shape", _model_shapes())
def test_shape_gate_accepts_the_port_shapes(shape):
    k1.check_kernel_shape(*shape)


@pytest.mark.parametrize("shape", [(129, 128, 8, 32, 8), (128, 128, 8, 32, 11),
                                   (24, 32, 4, 62, 1), (0, 32, 4, 8, 4), (24, 32, 4, 8, 0)])
def test_shape_gate_rejects_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        k1.check_kernel_shape(*shape)
