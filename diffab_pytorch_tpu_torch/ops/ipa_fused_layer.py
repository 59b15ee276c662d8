"""Fused IPA layer: the CUDA kernel's wrapper, its binding and its plain
PyTorch version.

Counterpart of `diffab_pytorch_tpu/ops/ipa_pallas.py fused_ipa_layer`
(`_pallas_layer` -> `_layer_kernel_batched` / `_layer_kernel`).  One call
computes a whole IPA layer without the pair term and the to_out bias row:
Q/K/V projections, rigid frames, augmented-operand logits with the key
mask riding the contraction, the per-target bias, a float32 softmax, the
attention weights written in the compute dtype, the weighted sums, the
inverse frames and point norms, and the W_s / W_p / W_n output
projections.  Returns (acc (b, L, d), attn (b, h, L, L)).

Weights enter in their native flax column orders; `pack_layer_weights`
reorders the point columns (h, P, 3) -> (h, 3, P), folds scale_scalar and
g = sqrt(0.5 * scale_point * gamma) into them, as the JAX wrapper does, and
lays them out head-major with zero padding: the one layout that both
kernel routes, the plain version and the backward read.  The sampler packs
once per `sample()` call.

On a CPU tensor the wrapper runs `fused_ipa_layer_packed_reference`; on a
CUDA tensor it launches the kernel in `csrc/ipa_fused_layer.cu` or raises.
Patches longer than 128 residues run in chunks of 128 rows and keys, with
the augmented operands in a device scratch the wrapper allocates
(`scratch_elems`).
Under autograd the launch sits in a `torch.autograd.Function` whose
backward differentiates the plain version on the saved inputs, as
`_bwd_layer` differentiates `_layer_core_jnp`; the weights are packed
outside it, so gradients reach the raw weights and gamma through
`pack_layer_weights`.  Under `no_grad` (the sampler) the kernel launches
directly and nothing is saved.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.ops._recompute import recompute_grads

_NEG_INF = -1e9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LayerKernelWeights(NamedTuple):
    """One layer's kernel operands in the compute dtype, head-major (FVP =
    ds + 3P and FH = ds + 4P rounded up to 8, dP = d rounded up to 8):

    w_qkv: (h, d, 3 FVP), per head and input row [q | k | v], each
        [scalar (ds) | points (3, P) | zeros], scale_scalar folded into the
        q scalar columns and g into the q/k point columns;
    w_out: (h FH, dP), per head the rows [W_s (ds) | W_p (3, P) | W_n (P) |
        zeros], its columns padded with zeros;
    g: (h,) float32, sqrt(0.5 * scale_point * gamma)."""

    w_qkv: torch.Tensor
    w_out: torch.Tensor
    g: torch.Tensor
    n_head: int
    d_scalar: int
    n_point: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad(t, pad):
    """F.pad with zeros, skipped where there is nothing to pad (the default
    widths): a pad by 0 would still copy t."""
    return F.pad(t, pad) if any(pad) else t


def check_kernel_shape(L: int, d: int, h: int, ds: int, p: int) -> None:
    """Raise ValueError for a layer shape the kernel does not take:
    ds + 3P <= 64 (one warp's values in registers); for those every L, d
    and h fit a block's shared memory (the budget is stated in
    csrc/ipa_fused_layer.cu).  Beyond L = 128 the kernel runs in chunks of
    128 rows and keys, with an operand scratch of `scratch_elems`."""
    if min(L, d, h, ds, p) < 1:
        raise ValueError(f"the kernel takes positive sizes, got L={L}, d={d}, h={h}, "
                         f"ds={ds}, P={p}")
    if ds + 3 * p > 64:
        raise ValueError(f"the kernel takes ds + 3P <= 64, got ds + 3P = {ds + 3 * p}")


def scratch_elems(dtype: torch.dtype, b: int, L: int, h: int, ds: int, p: int) -> int:
    """Elements (of the compute dtype) of the device scratch that holds the
    augmented operands for L > 128, 0 up to 128: q and k (b, h, FP, LS)
    and v (b, h, FVP, LS), LS = L rounded up to 16, FP = ds + 3P + 3 rounded
    up to 16 (bf16) or 8 (float32), FVP = ds + 3P rounded up to 8.  The same
    count as `ipa_fused_layer_scratch_elems` in csrc/ipa_fused_layer.cu."""
    if L <= 128:
        return 0
    fv = ds + 3 * p
    fp = _round_up(fv + 3, 16 if dtype == torch.bfloat16 else 8)
    return b * h * (2 * fp + _round_up(fv, 8)) * _round_up(L, 16)


def pack_layer_weights(
    w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op, w_on,
    gamma, scale_scalar: float, scale_point: float, dtype: torch.dtype,
) -> LayerKernelWeights:
    """Reorder and pre-scale the native weights (ipa_pallas.py _pallas_layer,
    the weight block) into the head-major layout of `LayerKernelWeights`:
    products are taken in the weights' own dtype, then cast to `dtype`.  A
    permutation plus zero padding, differentiable: gradients reach the
    native weights and gamma through it."""
    d = w_qs.shape[0]
    h = gamma.shape[0]
    ds = w_qs.shape[1] // h
    p = w_qp.shape[1] // (h * 3)
    if w_vp.shape[1] // (h * 3) != p:
        raise ValueError("fused layer kernel assumes equal q/v point counts")
    fv = ds + 3 * p
    fvp, fh, dp = _round_up(fv, 8), _round_up(ds + 4 * p, 8), _round_up(d, 8)
    g = torch.sqrt(0.5 * scale_point * gamma.to(torch.promote_types(gamma.dtype, torch.float32)))

    def heads(w_s, w_p, scale_points):  # -> (h, d, FVP) [scalar | points (3, P) | zeros]
        pts = w_p.reshape(d, h, p, 3).transpose(2, 3)
        if scale_points:
            pts = pts * g.to(w_p.dtype)[None, :, None, None]
        block = torch.cat([w_s.reshape(d, h, ds), pts.reshape(d, h, 3 * p)], dim=-1)
        return _pad(block.to(dtype), (0, fvp - fv)).transpose(0, 1)

    w_qkv = torch.cat([heads(w_qs * torch.tensor(scale_scalar, dtype=w_qs.dtype), w_qp, True),
                       heads(w_ks, w_kp, True), heads(w_vs, w_vp, False)], dim=-1)
    rows = torch.cat([w_os.reshape(h, ds, d),
                      w_op.reshape(h, p, 3, d).transpose(1, 2).reshape(h, 3 * p, d),
                      w_on.reshape(h, p, d)], dim=1).to(dtype)
    w_out = _pad(rows, (0, dp - d, 0, fh - ds - 4 * p)).reshape(h * fh, dp)
    return LayerKernelWeights(w_qkv.contiguous(), w_out.contiguous(), g.contiguous(), h, ds, p)


def fused_ipa_layer_packed_reference(x, rot, trans, mask, wts: LayerKernelWeights,
                                     bias, scale_total: float):
    """Plain PyTorch version of the kernel: the same augmented-operand
    expansion and the same rounding points (augmented operands, attention
    weights and output-projection operands in the compute dtype; the rest
    in float32).  Differentiable."""
    f32 = torch.float32
    dt = x.dtype
    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    fv = ds + 3 * p
    bp = bias.shape[0]
    n = b // bp
    # per head [q | k | v], the zero padding dropped
    proj = torch.einsum("bld,hdn->blhn", x.to(f32), wts.w_qkv.to(f32))
    proj = proj.reshape(b, L, h, 3, -1)[..., :fv]
    R = rot.to(f32)  # (b, L, 3, 3), values in the compute dtype
    trv = trans.to(f32)
    trg = (trans[:, :, None, :] * wts.g.to(dt)[None, None, :, None]).to(f32)

    def split(part, t):
        pr = proj[:, :, :, part]
        sc = pr[..., :ds]
        pt = pr[..., ds:].reshape(b, L, h, 3, p)
        # frames: out_c = sum_i pt_i R[i, c] + t_c
        pg = (pt[:, :, :, 0:1] * R[:, :, None, 0, :, None]
              + pt[:, :, :, 1:2] * R[:, :, None, 1, :, None]
              + pt[:, :, :, 2:3] * R[:, :, None, 2, :, None]) + t[..., None]
        return sc, pg  # (b, L, h, ds), (b, L, h, 3, P)

    qs, qg = split(0, trg)
    ks, kg = split(1, trg)
    vs, vg = split(2, trv[:, :, None, :])
    q_sq = (qg * qg).sum(dim=(-2, -1))[..., None]
    k_sq = (kg * kg).sum(dim=(-2, -1))[..., None]
    ones = torch.ones_like(q_sq)
    nk = ((mask.to(f32) - 1.0) * (-_NEG_INF / float(scale_total))).to(dt).to(f32)
    nk = nk[:, :, None, None].expand(b, L, h, 1)
    q_aug = torch.cat([qs, 2.0 * qg.reshape(b, L, h, 3 * p), -q_sq, -ones, ones],
                      dim=-1).to(dt).to(f32)
    k_aug = torch.cat([ks, kg.reshape(b, L, h, 3 * p), ones, k_sq, nk],
                      dim=-1).to(dt).to(f32)
    logit = torch.einsum("bihf,bjhf->bhij", q_aug, k_aug)
    logit = logit.reshape(bp, n, h, L, L) + bias.to(f32)[:, None]
    attn = torch.softmax(logit.reshape(b, h, L, L) * scale_total, dim=-1)
    at = attn.to(dt)
    atf = at.to(f32)
    os_ = torch.einsum("bhij,bjhd->bihd", atf, vs.to(dt).to(f32))
    og = torch.einsum("bhij,bjhcp->bihcp", atf, vg.to(dt).to(f32))
    dd = og - trv[:, :, None, :, None]
    # inverse frames: loc_c = sum_k dd_k R[c, k]
    loc = (dd[:, :, :, None, 0] * R[:, :, None, :, 0, None]
           + dd[:, :, :, None, 1] * R[:, :, None, :, 1, None]
           + dd[:, :, :, None, 2] * R[:, :, None, :, 2, None])  # (b, L, h, 3, P)
    nrm = torch.sqrt((loc * loc).sum(dim=-2) + 1e-8)  # (b, L, h, P)
    feat = torch.cat([os_, loc.reshape(b, L, h, 3 * p), nrm], dim=-1).to(dt).to(f32)
    w_out = wts.w_out.reshape(h, -1, wts.w_out.shape[-1])[:, :ds + 4 * p, :d]
    acc = torch.einsum("blhf,hfd->bld", feat, w_out.to(f32)).to(dt)
    return acc, at


def _check(x, rot, trans, mask, wts, bias):
    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"unsupported compute dtype {dt}")
    fvp, fh = _round_up(ds + 3 * p, 8), _round_up(ds + 4 * p, 8)
    expect = {
        "rot": (rot, (b, L, 3, 3), dt), "trans": (trans, (b, L, 3), dt),
        "mask": (mask, (b, L), dt),
        "w_qkv": (wts.w_qkv, (h, d, 3 * fvp), dt),
        "w_out": (wts.w_out, (h * fh, _round_up(d, 8)), dt),
        "g": (wts.g, (h,), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {(tuple(t.shape), t.dtype)}")
    bp = bias.shape[0]
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (h, L, L) or b % bp:
        raise ValueError(f"bias: expected (bp, {h}, {L}, {L}) with b % bp == 0, "
                         f"got {tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, dt):
        raise TypeError(f"bias dtype {bias.dtype} is neither float32 nor {dt}")
    tensors = (x, rot, trans, mask, bias, wts.w_qkv, wts.w_out, wts.g)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused IPA layer inputs must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("ipa_fused_layer")
    if lib.ipa_fused_layer_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ipa_fused_layer_forward.argtypes = [i, i] + [p] * 12 + [i] * 7 + [f, f, p]
        lib.ipa_fused_layer_forward.restype = ctypes.c_int
        lib.ipa_fused_layer_scratch_elems.argtypes = [i] * 6
        lib.ipa_fused_layer_scratch_elems.restype = ctypes.c_longlong
        lib.ipa_fused_layer_error_string.argtypes = [ctypes.c_int]
        lib.ipa_fused_layer_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, rot, trans, mask, wts, bias, scale_total):
    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    check_kernel_shape(L, d, h, ds, p)
    dev, dt = x.device, x.dtype
    acc = torch.empty((b, L, d), dtype=dt, device=dev)
    attn = torch.empty((b, h, L, L), dtype=dt, device=dev)
    feat = torch.empty((b * L, h * _round_up(ds + 4 * p, 8)), dtype=dt, device=dev)
    lib = _library()
    args = [x, rot, trans, mask, wts.w_qkv, wts.w_out, wts.g, bias, feat, acc, attn]
    ptrs = [t.data_ptr() for t in args] + [None]
    if L > 128:  # the operand scratch of the chunked path
        n_scratch = scratch_elems(dt, b, L, h, ds, p)
        if n_scratch != lib.ipa_fused_layer_scratch_elems(_DTYPE_CODE[dt], b, L, h, ds, p):
            raise RuntimeError("operand scratch size disagrees with the kernel's")
        scratch = torch.empty(n_scratch, dtype=dt, device=dev)
        ptrs[-1] = scratch.data_ptr()
    with torch.cuda.device(dev):
        err = lib.ipa_fused_layer_forward(
            _DTYPE_CODE[dt], _DTYPE_CODE[bias.dtype], *ptrs,
            b, bias.shape[0], L, d, h, ds, p, float(scale_total),
            float(-_NEG_INF / float(scale_total)), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.ipa_fused_layer_error_string(err).decode()
        raise RuntimeError(f"ipa_fused_layer kernel launch failed: {msg} ({err})")
    fused_ipa_layer_packed.launches += 1
    return acc, attn


def _packed_reference(x, rot, trans, mask, w_qkv, w_out, g, bias, shape, scale_total):
    h, ds, p = shape
    wts = LayerKernelWeights(w_qkv, w_out, g, h, ds, p)
    return fused_ipa_layer_packed_reference(x, rot, trans, mask, wts, bias, scale_total)


class _FusedLayer(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version on the
    saved inputs and head-major weights."""

    @staticmethod
    def forward(ctx, x, rot, trans, mask, w_qkv, w_out, g, bias, shape, scale_total):
        ctx.save_for_backward(x, rot, trans, mask, w_qkv, w_out, g, bias)
        ctx.shape, ctx.scale_total = shape, scale_total
        wts = LayerKernelWeights(w_qkv, w_out, g, *shape)
        return _launch(x, rot, trans, mask, wts, bias, scale_total)

    @staticmethod
    def backward(ctx, g_acc, g_attn):
        grads = recompute_grads(_packed_reference, ctx.saved_tensors,
                                ctx.needs_input_grad[:8], (g_acc, g_attn),
                                ctx.shape, ctx.scale_total)
        return (*grads, None, None)


def fused_ipa_layer_packed(x, rot, trans, mask, wts: LayerKernelWeights, bias,
                           scale_total: float):
    """The fused layer on pre-packed weights.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in `.launches`),
    through the autograd Function when a gradient is wanted."""
    _check(x, rot, trans, mask, wts, bias)
    if x.device.type == "cpu":
        return fused_ipa_layer_packed_reference(x, rot, trans, mask, wts, bias,
                                                scale_total)
    if x.device.type != "cuda":
        raise ValueError(f"no fused IPA layer for device {x.device}")
    args = (x, rot, trans, mask, wts.w_qkv, wts.w_out, wts.g, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedLayer.apply(*args, (wts.n_head, wts.d_scalar, wts.n_point),
                                 float(scale_total))
    return _launch(x, rot, trans, mask, wts, bias, scale_total)


fused_ipa_layer_packed.launches = 0


def fused_ipa_layer(x, rot, trans, mask,
                    w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op, w_on,
                    bias, gamma, scale_scalar, scale_point, scale_total):
    """Signature and native weight orders of ipa_pallas.fused_ipa_layer."""
    wts = pack_layer_weights(w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op,
                             w_on, gamma, scale_scalar, scale_point, x.dtype)
    return fused_ipa_layer_packed(x, rot, trans, mask, wts, bias, scale_total)


def fused_ipa_layer_reference(x, rot, trans, mask,
                              w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op, w_on,
                              bias, gamma, scale_scalar, scale_point, scale_total):
    """The plain version with the native signature."""
    wts = pack_layer_weights(w_qs, w_ks, w_vs, w_qp, w_kp, w_vp, w_os, w_op,
                             w_on, gamma, scale_scalar, scale_point, x.dtype)
    return fused_ipa_layer_packed_reference(x, rot, trans, mask, wts, bias,
                                            scale_total)
