"""Fused IPA layer: the CUDA kernel's wrapper, its binding and its plain
PyTorch version.

Counterpart of `diffab_pytorch_tpu/ops/ipa_pallas.py fused_ipa_layer`
(`_pallas_layer` -> `_layer_kernel_batched` / `_layer_kernel`).  One call
computes a whole IPA layer without the pair term and the to_out bias row:
Q/K/V projections, rigid frames, augmented-operand logits with the key
mask riding the contraction, the per-target bias, a float32 softmax, the
attention weights written in the compute dtype, the weighted sums, the
inverse frames and point norms, and the W_s / W_p / W_n output
projections.  Returns (acc (b, L, d), attn (b, h, L, L)).  With direction
rows packed (`pack_layer_weights(..., w_od=...)`, the official DiffAb
block's point directions) the features gain each value point's unit
direction loc / (nrm + 1e-4) and W_d projects them; without, the kernels
compile the direction code out.

Weights enter in their native flax column orders; `pack_layer_weights`
reorders the point columns (h, P, 3) -> (h, 3, P), folds scale_scalar and
g = sqrt(0.5 * scale_point * gamma) into them, as the JAX wrapper does, and
lays them out head-major with zero padding: the one layout that both
kernel routes, the plain version and the backward read.  The sampler packs
once per `sample()` call.

On a CPU tensor the wrapper runs `fused_ipa_layer_packed_reference`; on a
CUDA tensor it launches the kernel in `csrc/ipa_fused_layer.cu` or raises.
Each launch is counted in `fused_ipa_layer_packed.launches`
(`_build.count_launch`): inside a CUDA graph capture the launch is booked to
the graph, and every replay adds it to the count.
Patches longer than 128 residues run in chunks of 128 rows and keys, with
the augmented operands in a device scratch the wrapper allocates
(`scratch_elems`).
In bf16 with many (head, design) items, launch 1 is a persistent kernel of
one block per SM (`takes_persistent`, `csrc/ipa_fused_layer_persistent.cuh`);
each such launch books `ipa_layer.items` and `ipa_layer.items_overlapped`
to the port's counters (`utils/profiling.py`), and each other bf16 call up
to 128 residues `ipa_layer.fallback_calls`, graph replays included.  A
float32 call beyond 128 residues runs its attention in one pass over the
keys where the kernel's shared-memory strip fits (`attend_path`) and books
`ipa_layer.attend_onepass_calls`, else in two and books
`ipa_layer.attend_twopass_calls`.
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
# the point directions loc / (nrm + DIR_EPS) (the official DiffAb
# normalize_vector's eps), on every branch of models/ipa.py
DIR_EPS = 1e-4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LayerKernelWeights(NamedTuple):
    """One layer's kernel operands in the compute dtype, head-major (FVP =
    ds + 3P and FH = ds + 4P, or ds + 7P with directions, rounded up to 8,
    dP = d rounded up to 8):

    w_qkv: (h, d, 3 FVP), per head and input row [q | k | v], each
        [scalar (ds) | points (3, P) | zeros], scale_scalar folded into the
        q scalar columns and g into the q/k point columns;
    w_out: (h FH, dP), per head the rows [W_s (ds) | W_p (3, P) | W_n (P) |
        zeros], with directions [W_s | W_p | W_n | W_d (3, P) | zeros], its
        columns padded with zeros;
    g: (h,) float32, sqrt(0.5 * scale_point * gamma)."""

    w_qkv: torch.Tensor
    w_out: torch.Tensor
    g: torch.Tensor
    n_head: int
    d_scalar: int
    n_point: int
    directions: bool = False


def feature_width(ds: int, p: int, directions: bool = False) -> int:
    """FH: a head's feature columns [out_s | loc | nrm (| dir)], rounded up
    to 8."""
    return _round_up(ds + (7 if directions else 4) * p, 8)


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


# The persistent launch 1 (csrc/ipa_fused_layer_persistent.cuh): built for
# ds = 32 scalar columns and P = 8 points a head (each q / k / v part and its
# three augmented columns in 64, each point's coordinates in one thread); its
# two items' shared memory fits a block's up to d = 128 (226,432 bytes,
# `tc_pp::persistent_dims`; the kernel's entry refuses wider rows)
PERSISTENT_WIDTHS = (32, 8)
PERSISTENT_MAX_D = 128
_sm_counts: dict = {}


def takes_persistent(dtype: torch.dtype, b: int, L: int, d: int, h: int, ds: int, p: int,
                     n_sm: int, x_aligned: bool = True, directions: bool = False) -> bool:
    """Whether launch 1 is the persistent kernel: bf16, L <= 128, the head
    widths it is built for, 16-byte rows of x (d % 8 == 0, x aligned) up to
    d = 128, no direction rows (its epilogue writes FH = 64), and at least
    two (head, design) items per SM, so that every block holds two in
    flight.  Otherwise it is one block per item.  The
    count is a floor, not the crossover: on an H100 at 256 items (training's
    b = 32) the persistent kernel took 0.024 ms against 0.041 (PERF.md
    section 6)."""
    return (dtype == torch.bfloat16 and L <= 128 and (ds, p) == PERSISTENT_WIDTHS
            and d % 8 == 0 and d <= PERSISTENT_MAX_D and x_aligned and not directions
            and b * h >= 2 * n_sm)


def persistent_counts(items: int, grid: int) -> tuple:
    """(ipa_layer.items, ipa_layer.items_overlapped) of one persistent
    launch: each block walks a contiguous range of the items
    (`tc_pp::block_items`), and every item but each block's first has a
    predecessor in its block."""
    return items, items - min(items, grid)


def book_path(persistent_blocks: int, items: int) -> None:
    """Book one bf16 call up to 128 residues to the port's counters, as its
    launch is booked (through a graph's tally inside a capture)."""
    if persistent_blocks:
        n, overlapped = persistent_counts(items, persistent_blocks)
        _build.count("ipa_layer.items", n)
        _build.count("ipa_layer.items_overlapped", overlapped)
    else:
        _build.count("ipa_layer.fallback_calls")


# The attention launch beyond 128 residues (csrc/ipa_fused_layer.cu): float32
# runs it in one pass over the keys (onepass_attend_kernel) where a block's
# shared memory holds its strip beside the other tiles (onepass_dims), else
# (bf16, longer float32 patches) in two (attend_kernel)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
ATTEND_TWOPASS, ATTEND_ONEPASS = 1, 2
_OP_KC, _OP_KROW, _OP_VROW = 32, 136, 80  # keys a ring stage, floats of its K and V rows


def onepass_smem(L: int, ds: int, p: int) -> int:
    """Bytes of shared memory of the one-pass attention block at L > 128
    (`onepass_dims`): the query rows' frames (12 x 128 floats), the strip
    of 128 rows x (LS + 8) floats, the chunks' row maxima (128 x LS / 32
    rounded up) and two ring stages of FP / 2 x 136 + FVP x 80 floats
    (K and V split into tf32 pairs), LS = L rounded up to 16."""
    fv = ds + 3 * p
    ls = _round_up(L, 16)
    stage = _round_up(fv + 3, 8) // 2 * _OP_KROW + _round_up(fv, 8) * _OP_VROW
    return 4 * (128 * 12 + 128 * (ls + 8) + 128 * -(-ls // _OP_KC) + 2 * stage)


def attend_path(dtype: torch.dtype, L: int, ds: int, p: int) -> int:
    """The attention launch of a call (`ipa_fused_layer_attend_path`): 0 up
    to 128 residues, ATTEND_ONEPASS for float32 where `onepass_smem` fits a
    block (L <= 272 at the default widths, 256 at ds + 3P = 64),
    ATTEND_TWOPASS otherwise."""
    if L <= 128:
        return 0
    if dtype == torch.float32 and onepass_smem(L, ds, p) <= SMEM_LIMIT:
        return ATTEND_ONEPASS
    return ATTEND_TWOPASS


def book_attend(path: int) -> None:
    """Book one float32 call beyond 128 residues to the port's counters by
    its attention path, as its launch is booked."""
    _build.count("ipa_layer.attend_onepass_calls" if path == ATTEND_ONEPASS
                 else "ipa_layer.attend_twopass_calls")


def _sm_count(dev: torch.device) -> int:
    """The card's SMs, read once per device."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sm_counts:
        _sm_counts[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sm_counts[i]


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
    gamma, scale_scalar: float, scale_point: float, dtype: torch.dtype, w_od=None,
) -> LayerKernelWeights:
    """Reorder and pre-scale the native weights (ipa_pallas.py _pallas_layer,
    the weight block) into the head-major layout of `LayerKernelWeights`:
    products are taken in the weights' own dtype, then cast to `dtype`.  A
    permutation plus zero padding, differentiable: gradients reach the
    native weights and gamma through it.  w_od (h P 3, d), the direction
    rows in W_p's order, packs after W_n; None packs none."""
    d = w_qs.shape[0]
    h = gamma.shape[0]
    ds = w_qs.shape[1] // h
    p = w_qp.shape[1] // (h * 3)
    if w_vp.shape[1] // (h * 3) != p:
        raise ValueError("fused layer kernel assumes equal q/v point counts")
    fv = ds + 3 * p
    directions = w_od is not None
    fvp, fh, dp = _round_up(fv, 8), feature_width(ds, p, directions), _round_up(d, 8)
    g = torch.sqrt(0.5 * scale_point * gamma.to(torch.promote_types(gamma.dtype, torch.float32)))

    def heads(w_s, w_p, scale_points):  # -> (h, d, FVP) [scalar | points (3, P) | zeros]
        pts = w_p.reshape(d, h, p, 3).transpose(2, 3)
        if scale_points:
            pts = pts * g.to(w_p.dtype)[None, :, None, None]
        block = torch.cat([w_s.reshape(d, h, ds), pts.reshape(d, h, 3 * p)], dim=-1)
        return _pad(block.to(dtype), (0, fvp - fv)).transpose(0, 1)

    w_qkv = torch.cat([heads(w_qs * torch.tensor(scale_scalar, dtype=w_qs.dtype), w_qp, True),
                       heads(w_ks, w_kp, True), heads(w_vs, w_vp, False)], dim=-1)
    coords = lambda w: w.reshape(h, p, 3, d).transpose(1, 2).reshape(h, 3 * p, d)
    rows = torch.cat([w_os.reshape(h, ds, d), coords(w_op), w_on.reshape(h, p, d)]
                     + ([coords(w_od)] if directions else []), dim=1).to(dtype)
    w_out = _pad(rows, (0, dp - d, 0, fh - rows.shape[1])).reshape(h * fh, dp)
    return LayerKernelWeights(w_qkv.contiguous(), w_out.contiguous(), g.contiguous(), h, ds, p,
                              directions)


def fused_ipa_layer_packed_reference(x, rot, trans, mask, wts: LayerKernelWeights,
                                     bias, scale_total: float):
    """Plain PyTorch version of the kernel: the same augmented-operand
    expansion and the same rounding points (augmented operands, attention
    weights and output-projection operands in the compute dtype; the rest
    in float32).  Differentiable.  Float64 inputs are computed in float64
    throughout (the card checks' exact version)."""
    dt = x.dtype
    f32 = torch.float64 if dt == torch.float64 else torch.float32
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
    parts = [os_, loc.reshape(b, L, h, 3 * p), nrm]
    if wts.directions:
        parts.append((loc / (nrm[..., None, :] + DIR_EPS)).reshape(b, L, h, 3 * p))
    feat = torch.cat(parts, dim=-1).to(dt).to(f32)
    w_out = wts.w_out.reshape(h, -1, wts.w_out.shape[-1])[:, :feat.shape[-1], :d]
    acc = torch.einsum("blhf,hfd->bld", feat, w_out.to(f32)).to(dt)
    return acc, at


def _check(x, rot, trans, mask, wts, bias):
    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"unsupported compute dtype {dt}")
    fvp, fh = _round_up(ds + 3 * p, 8), feature_width(ds, p, wts.directions)
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
    if bias.dtype != dt:
        raise TypeError(f"bias dtype {bias.dtype} is not the compute dtype {dt}")
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
        lib.ipa_fused_layer_forward.argtypes = [i] + [p] * 12 + [i] * 7 + [f, f, i, i, p]
        lib.ipa_fused_layer_forward.restype = ctypes.c_int
        lib.ipa_fused_layer_scratch_elems.argtypes = [i] * 6
        lib.ipa_fused_layer_scratch_elems.restype = ctypes.c_longlong
        lib.ipa_fused_layer_attend_path.argtypes = [i] * 4
        lib.ipa_fused_layer_attend_path.restype = ctypes.c_int
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
    feat = torch.empty((b * L, h * feature_width(ds, p, wts.directions)), dtype=dt, device=dev)
    lib = _library()
    args = [x, rot, trans, mask, wts.w_qkv, wts.w_out, wts.g, bias, feat, acc, attn]
    ptrs = [t.data_ptr() for t in args] + [None]
    path = attend_path(dt, L, ds, p)
    if L > 128:  # the operand scratch of the chunked path
        n_scratch = scratch_elems(dt, b, L, h, ds, p)
        if n_scratch != lib.ipa_fused_layer_scratch_elems(_DTYPE_CODE[dt], b, L, h, ds, p):
            raise RuntimeError("operand scratch size disagrees with the kernel's")
        if path != lib.ipa_fused_layer_attend_path(_DTYPE_CODE[dt], L, ds, p):
            raise RuntimeError("attention path disagrees with the kernel's")
        scratch = torch.empty(n_scratch, dtype=dt, device=dev)
        ptrs[-1] = scratch.data_ptr()
    persistent = 0
    if dt == torch.bfloat16 and L <= 128:
        n_sm = _sm_count(dev)
        if takes_persistent(dt, b, L, d, h, ds, p, n_sm, x.data_ptr() % 16 == 0,
                            wts.directions):
            persistent = n_sm
    with torch.cuda.device(dev):
        err = lib.ipa_fused_layer_forward(
            _DTYPE_CODE[dt], *ptrs,
            b, bias.shape[0], L, d, h, ds, p, float(scale_total),
            float(-_NEG_INF / float(scale_total)), persistent, int(wts.directions),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.ipa_fused_layer_error_string(err).decode()
        raise RuntimeError(f"ipa_fused_layer kernel launch failed: {msg} ({err})")
    _build.count_launch(fused_ipa_layer_packed, "ipa_fused_layer", acc, attn)
    if dt == torch.bfloat16 and L <= 128:
        book_path(persistent, b * h)
    elif dt == torch.float32 and path:
        book_attend(path)
    return acc, attn


def _packed_reference(x, rot, trans, mask, w_qkv, w_out, g, bias, shape, scale_total):
    wts = LayerKernelWeights(w_qkv, w_out, g, *shape)
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
        return _FusedLayer.apply(*args, (wts.n_head, wts.d_scalar, wts.n_point,
                                         wts.directions), float(scale_total))
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
