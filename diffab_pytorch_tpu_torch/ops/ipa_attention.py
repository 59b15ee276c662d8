"""IPA attention core: the CUDA kernel's wrapper, its binding, its plain
PyTorch version and its gradient.

Counterpart of `diffab_pytorch_tpu/ops/ipa_pallas.py` `_pallas_raw` ->
`_kernel` (entries `fused_ipa_attention_raw`, `fused_ipa_attention`), the
layer's path under `fuse_ipa_layer=False`.  The augmented operands are
assembled outside the kernel, in plain PyTorch, as the JAX wrapper
assembles them outside Pallas (`augmented_operands`): the point columns
scaled by g = sqrt(0.5 * scale_point * gamma), |q'|^2 and |k'|^2 folded
into the contraction, the key mask as a row pair carrying
-1e9 / scale_total on padded keys, the features padded to a multiple of 16.
The kernel (`csrc/ipa_attention.cu`, the tensor-core core in
`csrc/ipa_attention_tc.cuh`) computes the logits, the bias add, the
float32 softmax, the attention weights in the compute dtype and the two
weighted sums: bfloat16 on `mma.sync` bf16 tiles, float32 as 3xTF32
(split operands, float32-exact to the 1e-4 checks).  Patches longer than
128 residues run in chunks of 128 query rows and keys (two passes over
the keys: the rows' max and sum, then the weights and sums).

On a CPU tensor `ipa_attention_core` runs `ipa_attention_core_reference`;
on a CUDA tensor it launches the kernel (counted in `.launches`) or
raises.  Under autograd the launch sits in a `torch.autograd.Function`
whose backward differentiates the plain version, as `_bwd_raw`
differentiates `_attention_core_raw_jnp`.

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), each operand read and
each output written once: training shape b = bp = 32, L = 128, h = 8,
F = 64, bf16 bias: ~1.0 GFLOP, ~32.5 MB -> ~9.7 us, bytes-bound; sampling
shape b = 128, bp = 1: ~97 MB -> ~29 us.  The kernel reads each
(design, head)'s operands into shared memory once and keeps each warp's
16 query rows of logits in registers (see the source's note).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from diffab_pytorch_tpu_torch.ops import _build
from diffab_pytorch_tpu_torch.ops._recompute import recompute_grads

_NEG_INF = -1e9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _head_t(x, b, L, h):
    """(b, L, h, ...) -> the kernel's (b, h, features, L) layout."""
    return x.reshape(b, L, h, -1).permute(0, 2, 3, 1)


def augmented_operands(q_s, k_s, v_s, q_p, k_p, v_p, gamma, mask,
                       scale_scalar: float, scale_point: float, scale_total: float):
    """`_pallas_raw`'s operand assembly (ipa_pallas.py:236-271).  q_s, k_s,
    v_s (b, L, h, ds); q_p, k_p, v_p (b, L, h, P, 3) in the global frame;
    gamma (h,) after softplus; mask (b, L).  Returns q_aug, k_aug
    (b, h, F, L), v_s (b, h, ds, L), v_p (b, h, 3P, L), contiguous, in the
    compute dtype of q_s.  Differentiable."""
    b, L, h, _ = q_s.shape
    dt = q_s.dtype
    f32 = torch.float32
    g = torch.sqrt(0.5 * scale_point * gamma.to(f32)).to(dt)[None, :, None, None]
    qp_t = _head_t(q_p, b, L, h) * g
    kp_t = _head_t(k_p, b, L, h) * g
    q_sq = (qp_t.to(f32) ** 2).sum(dim=2, keepdim=True)  # (b, h, 1, L)
    k_sq = (kp_t.to(f32) ** 2).sum(dim=2, keepdim=True)
    ones = torch.ones_like(q_sq)
    neg_k = ((mask.to(f32) - 1.0) * (-_NEG_INF / float(scale_total)))[:, None, None, :]
    q_aug = torch.cat([_head_t(q_s, b, L, h) * torch.tensor(scale_scalar, dtype=dt),
                       2.0 * qp_t, (-q_sq).to(dt), (-ones).to(dt), ones.to(dt)], dim=2)
    k_aug = torch.cat([_head_t(k_s, b, L, h), kp_t, ones.to(dt), k_sq.to(dt),
                       neg_k.expand_as(ones).to(dt)], dim=2)
    pad = -(-q_aug.shape[2] // 16) * 16 - q_aug.shape[2]  # zero rows are inert
    q_aug = nnf.pad(q_aug, (0, 0, 0, pad))
    k_aug = nnf.pad(k_aug, (0, 0, 0, pad))
    return (q_aug.contiguous(), k_aug.contiguous(),
            _head_t(v_s, b, L, h).contiguous(), _head_t(v_p, b, L, h).contiguous())


def ipa_attention_core_reference(q_aug, k_aug, v_s, v_p, bias, scale_total: float):
    """Plain PyTorch version of the kernel (`_kernel`, ipa_pallas.py:123):
    float32 accumulation over operands in the compute dtype, float32
    softmax, attention weights and outputs rounded to the compute dtype.
    Returns out_s (b, h, ds, L), out_p (b, h, 3P, L), attn (b, h, L, L).
    Differentiable."""
    f32 = torch.float32
    dt = q_aug.dtype
    b, h, _, L = q_aug.shape
    bp = bias.shape[0]
    logit = torch.einsum("bhfi,bhfj->bhij", q_aug.to(f32), k_aug.to(f32))
    logit = (logit.reshape(bp, b // bp, h, L, L) + bias.to(f32)[:, None]).reshape(b, h, L, L)
    attn = torch.softmax(logit * scale_total, dim=-1).to(dt)
    a = attn.to(f32)
    out_s = torch.einsum("bhcj,bhij->bhci", v_s.to(f32), a).to(dt)
    out_p = torch.einsum("bhcj,bhij->bhci", v_p.to(f32), a).to(dt)
    return out_s, out_p, attn


def _check(q_aug, k_aug, v_s, v_p, bias):
    b, h, n_feat, L = q_aug.shape
    dt = q_aug.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"unsupported compute dtype {dt}")
    for name, t, shape in (("k_aug", k_aug, (b, h, n_feat, L)),
                           ("v_s", v_s, (b, h, v_s.shape[2], L)),
                           ("v_p", v_p, (b, h, v_p.shape[2], L))):
        if t.dim() != 4 or tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
    bp = bias.shape[0]
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (h, L, L) or b % bp:
        raise ValueError(f"bias: expected (bp, {h}, {L}, {L}) with b % bp == 0, "
                         f"got {tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, dt):
        raise TypeError(f"bias dtype {bias.dtype} is neither float32 nor {dt}")
    tensors = (q_aug, k_aug, v_s, v_p, bias)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("IPA attention inputs must be contiguous")


def check_attention_shape(L: int, F: int, ds: int, p3: int) -> None:
    """Raise ValueError for an operand shape the kernel does not take:
    ds + 3P <= 64 (one warp's values in registers) and ds + 3P < F <= 80,
    the augmented width that `augmented_operands` gives (ds + 3P + 3 padded
    to 16).  Every L >= 1: beyond 128 the kernel runs in query and key
    chunks of 128 with the shared memory of L = 128 (csrc/ipa_attention.cu)."""
    if min(L, ds + p3) < 1 or min(ds, p3) < 0:
        raise ValueError(f"the kernel takes positive sizes, got L={L}, ds={ds}, 3P={p3}")
    if ds + p3 > 64:
        raise ValueError(f"the kernel takes ds + 3P <= 64, got ds + 3P = {ds + p3}")
    if not ds + p3 < F <= 80:
        raise ValueError(f"the kernel takes ds + 3P < F <= 80 augmented features, got "
                         f"F={F}, ds + 3P = {ds + p3}")


def _library() -> ctypes.CDLL:
    lib = _build.load("ipa_attention")
    fn = lib.ipa_attention_forward
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i] + [p] * 8 + [i] * 7 + [f, p]
        fn.restype = ctypes.c_int
        lib.ipa_attention_error_string.argtypes = [ctypes.c_int]
        lib.ipa_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q_aug, k_aug, v_s, v_p, bias, scale_total):
    b, h, n_feat, L = q_aug.shape
    ds, p3 = v_s.shape[2], v_p.shape[2]
    check_attention_shape(L, n_feat, ds, p3)
    dev, dt = q_aug.device, q_aug.dtype
    out_s = torch.empty((b, h, ds, L), dtype=dt, device=dev)
    out_p = torch.empty((b, h, p3, L), dtype=dt, device=dev)
    attn = torch.empty((b, h, L, L), dtype=dt, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ipa_attention_forward(
            _DTYPE_CODE[dt], _DTYPE_CODE[bias.dtype],
            *(t.data_ptr() for t in (q_aug, k_aug, v_s, v_p, bias, out_s, out_p, attn)),
            b, bias.shape[0], L, h, n_feat, ds, p3, float(scale_total), stream,
        )
    if err:
        msg = lib.ipa_attention_error_string(err).decode()
        raise RuntimeError(f"ipa_attention kernel launch failed: {msg} ({err})")
    ipa_attention_core.launches += 1
    return out_s, out_p, attn


class _AttentionCore(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version on the
    saved operands."""

    @staticmethod
    def forward(ctx, q_aug, k_aug, v_s, v_p, bias, scale_total):
        ctx.save_for_backward(q_aug, k_aug, v_s, v_p, bias)
        ctx.scale_total = scale_total
        return _launch(q_aug, k_aug, v_s, v_p, bias, scale_total)

    @staticmethod
    def backward(ctx, g_out_s, g_out_p, g_attn):
        grads = recompute_grads(ipa_attention_core_reference, ctx.saved_tensors,
                                ctx.needs_input_grad[:5], (g_out_s, g_out_p, g_attn),
                                ctx.scale_total)
        return (*grads, None)


def ipa_attention_core(q_aug, k_aug, v_s, v_p, bias, scale_total: float):
    """The attention core on augmented operands.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, through the autograd Function
    when a gradient is wanted."""
    _check(q_aug, k_aug, v_s, v_p, bias)
    args = (q_aug, k_aug, v_s, v_p, bias)
    if q_aug.device.type == "cpu":
        return ipa_attention_core_reference(*args, scale_total)
    if q_aug.device.type != "cuda":
        raise ValueError(f"no IPA attention kernel for device {q_aug.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _AttentionCore.apply(*args, float(scale_total))
    return _launch(*args, scale_total)


ipa_attention_core.launches = 0


def _raw(core, q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma, mask,
         scale_scalar, scale_point, scale_total):
    b, L, h, _ = q_s.shape
    ops = augmented_operands(q_s, k_s, v_s, q_p, k_p, v_p, gamma, mask,
                             scale_scalar, scale_point, scale_total)
    out_s, out_p, attn = core(*ops, bias.contiguous(), scale_total)
    out_p = out_p.permute(0, 3, 1, 2).reshape(b, L, h, -1, 3)
    return out_s, attn, out_p


def fused_ipa_attention_raw(q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma, mask,
                            scale_scalar, scale_point, scale_total):
    """Signature and output layouts of ipa_pallas.fused_ipa_attention_raw:
    out_s (b, h, ds, L), attn (b, h, L, L), out_p (b, L, h, P, 3)."""
    return _raw(ipa_attention_core, q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma,
                mask, scale_scalar, scale_point, scale_total)


def fused_ipa_attention_raw_reference(q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma,
                                      mask, scale_scalar, scale_point, scale_total):
    """The plain version with the entry's signature."""
    return _raw(ipa_attention_core_reference, q_s, k_s, v_s, q_p, k_p, v_p, bias,
                gamma, mask, scale_scalar, scale_point, scale_total)


def fused_ipa_attention(q_s, k_s, v_s, q_p, k_p, v_p, pair, bias, gamma, mask,
                        scale_scalar, scale_point, scale_total):
    """Signature of ipa_pallas.fused_ipa_attention: out_s (b, L, h, ds),
    out_pair (b, L, h, dp) from the attended pair rows, out_p
    (b, L, h, P, 3)."""
    from diffab_pytorch_tpu_torch.models.ipa import attended_pair_rows

    b, L, h, _ = q_s.shape
    out_s, attn, out_p = fused_ipa_attention_raw(
        q_s, k_s, v_s, q_p, k_p, v_p, bias, gamma, mask,
        scale_scalar, scale_point, scale_total)
    out_pair = attended_pair_rows(attn, pair.to(q_s.dtype), b // bias.shape[0])
    return out_s.permute(0, 3, 1, 2), out_pair.reshape(b, L, h, -1), out_p
