#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (diffab_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from csrc/ (nvcc, sm_90a) and print the build time,
     registers, shared memory and each kernel's instruction count ([sass]);
  3. each kernel against its plain PyTorch version on the card, at tiny
     shapes in float32 and bfloat16, at an L that is not a multiple of 16,
     at the main paths' shapes in float32 and bfloat16, and (K1) at the
     widest shape its gate takes, with the tolerances stated below; then
     each kernel's autograd Function against autograd of its plain version
     (float32, b=4, L=128);
  4. end-to-end checks: one default_config()-width denoiser forward (6
     layers, 8 designs of one L=128 target) on the card against the CPU
     plain path, in bf16 and in float32; on small inputs, sample() on the
     card (kernels) against sample() on the CPU (plain versions) with the
     same injected draws, and one training loss with its gradients on the
     card against the CPU with the same draws, each for fuse_ipa_layer None
     (fused-layer kernel) and False (attention-core kernel);
  5. the sampling main path: CDR-H3 codesign sampling with default_config()
     in bfloat16, 128 designs of one synthetic 128-residue target, T=100,
     seeded random weights; launch counts, output checks, designs/s and a
     profiler breakdown of one call; then the same in float32, the default
     compute dtype ([main-f32]);
  6. the training main path, once per flag: production_config() (bf16,
     batch 32, L=128) from a seeded init on one synthetic batch, 3 warm-up
     and 20 timed steps through fit(); launch counts, loss trajectory,
     state checks, steps/s and samples/s, and a profile of one step;
  7. per-launch kernel times at L = 128 against the plain version and the
     bound, in bfloat16 and float32 (float32 bounds at the 3xTF32 rate),
     K1's two bf16 launches timed apart with the card's idle time between
     them (profiler);
  8. [long] patches longer than 128 residues: both kernels against their
     plain versions at L = 136, 200, 256 (b = bp = 32 and b = 128, bp = 1),
     129 and 384, in both dtypes, and their times at L = 256; [e2e-long]
     sample() and a training loss with its gradients, card against CPU,
     at L = 256 for both flags;
  9. [fast] short few-step chains (chord init, fine tail, noise_t_max,
     heun, ab2, ddim, posterior orientations, t-restart, trajectory),
     card against CPU for both flags;
  10. [main-256]: the sampling main path on one 256-residue target, and a
     few production fit() steps at L = 256, batch 8, per flag; [fast]:
     K1 against its plain version at b = 512 (the recipes' widest shape),
     then bench.py's three few-step recipes on the [main] target (chord-10
     and 22-eval at 512 designs, the 25-step chain at 128);
  11. [design]: the design loop through the entry points: the fixture
     complex tests/fixtures/ab1_chothia.pdb featurized into a 128-residue
     patch, a seeded default_config() checkpoint, `cli.sample --rank -n 128
     --cdrs H3` and `cli.evaluate --json` on the card (files, scores, ranks,
     the report, K1 launches per sample and score call, designs/s, designs
     scored/s, relax and PDB-write times, a profile of one score call and
     one relax call); then score_designs card vs CPU (8 designs, both
     flags, float32 and bf16, injected ScoreDraws) and relax_ca card vs CPU;
  12. [data]: the training data path through the entry points: the
     family corpus (8 families x 32 = 256 complexes) through `cli.preprocess
     -j <cores> -k 128` (the C++ parser and featurizer, built from
     native/*.cpp in this run), the C++ routes against Python on 16 PDBs,
     `cli.train --production --max-steps 14` through the prefetch loader
     and with --device-pool (K1 launches, losses, the checkpoint and its
     model_config.json, steps/s, samples/s, peak memory, the pool's bytes,
     the loader's host ms per batch, a profile of one step), three pool
     steps through fit() at fuse_ipa_layer=False (K2), `cli.sample -n 16`
     from the trained checkpoint; then pool_train_step against train_step
     on its rows on the card, two pool steps card vs CPU, and the loader's
     card batches against the host batches;
  13. [selfcond]: self-conditioning.  Every variant (early fusion,
     geometry-only, late fusion, split trunk) card vs CPU at tiny widths
     for both kernel flags in float32 and bf16: a forward with an estimate
     (and one with |x0| ~ 1e4), the two-pass loss with its gradients per
     sample and per residue under mode dropout, a heun chain with sc_t_max;
     production_config() training, plain then with early fusion and with
     the split trunk (3 + 20 fit() steps, K1 6 / 12 / 24 a step, steps/s
     beside the plain run's and [train]'s, a profile of one step, peak
     memory; then 1 + 4 split-trunk steps at fuse_ipa_layer=False, K2 24 a
     step); the [main] sampling path, plain then self-conditioned (K1 600 /
     600 / 1,200 a call, designs/s beside the plain run's and [main]'s);
     `cli.train --production --self-conditioning
     --sc-split-trunk --sc-onset 2 --sc-rate-warmup 4 --max-steps 8` on
     [data]'s patches and `cli.sample -n 16` from its checkpoint;
  14. a `kernels` JSON line, the card line, and the final JSON line.

The L = 128 kernel times (phase 7) run where they ran before the long-patch
and few-step phases existed, so that two versions of this script read them
after the same work.  To time another checkout's package with this script's
phase, load this file with importlib from inside that checkout and call
kernel_times(torch, card, 32).

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores; float32 exact to the
# checks' 1e-4 on the tensor cores as 3xTF32 (three TF32 products for each
# product, a third of the 494.7 TFLOP/s TF32 rate), the fastest
# float32-exact route on this card; HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
PEAK_BYTES = 3.35e12

N_DESIGNS, L_MAIN, N_GENERATE = 128, 128, 8

# the few-step recipes bench.py times after the headline (name, designs,
# sample() options; t_start = 6 T / 10 at T = 100)
FAST_RECIPES = (
    ("chord-10", 512, dict(n_steps=10, init="chord", t_start=60, noise_scale=0.0)),
    ("22-eval", 512, dict(n_steps=22, n_fine_tail=12, noise_t_max=12, init="chord",
                          t_start=60, noise_scale=1.0)),
    ("25-step", 128, dict(n_steps=25)),
)

# K1's bf16 kernels (csrc/ipa_fused_layer_bf16.cuh), by profiler name
K1_LAUNCHES = ("layer_heads_kernel", "out_proj_kernel")
K1_DESIGN = ("two launches on head-major weights, every product on the tensor cores "
             "(mma.sync, cp.async). 1: one block of 8 warps per (head, design): the head's Q/K/V "
             "projection kept on chip, frames and augmented operands in shared memory, each "
             "warp's 16 x L logits and float32 softmax in registers, P [v_s|v_p] from register "
             "fragments, inverse frames and norms, per-head features out. 2: the output "
             "projection as a cp.async double-buffered tensor-core GEMM. bf16: mma.sync "
             "m16n8k16 bf16->f32 (ldmatrix). float32: 3xTF32 on mma.sync m16n8k8 (operands "
             "split into big + small tf32 as loaded, three products), float32-exact to 1e-4")
K2_DESIGN = ("one launch, one block of 8 warps per (head, design) (all 128 query rows), "
             "operands copied feature-major into padded shared tiles by cp.async, each warp's "
             "16 x L logits and float32 softmax in registers, P [v_s|v_p] from register "
             "fragments, outputs transposed through the warp's own q-tile columns for 16-byte "
             "stores. bf16: mma.sync m16n8k16 "
             "(ldmatrix, attn staged for 16-byte stores). float32: 3xTF32 on mma.sync m16n8k8 "
             "(operands and weights split into big + small tf32, three products), "
             "float32-exact to 1e-4")


def bound_ms(flops, n_bytes, dtype_name):
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the HBM rate.  Returns (ms,
    what bounds it, operations ms, bytes ms)."""
    t_o, t_b = flops / PEAK_FLOPS[dtype_name] * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_o, t_b), "operations" if t_o >= t_b else "bytes", t_o, t_b


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sass_counts(build) -> dict:
    """Machine instructions per kernel in each built library (`cuobjdump
    -sass`), keyed "<source>: <demangled kernel>", to compare the code two
    trees generate.  `build` is the package's `ops._build` module."""
    cuda_bin = os.path.dirname(os.path.realpath(build._nvcc()))
    counts = {}
    for name in sorted(p.stem for p in build.CSRC.glob("*.cu")):
        sass = subprocess.run([os.path.join(cuda_bin, "cuobjdump"), "-sass",
                               str(build._library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = subprocess.run([os.path.join(cuda_bin, "cu++filt")],
                                        input=line.split("Function :")[1].strip(),
                                        capture_output=True, text=True).stdout.strip()
                kernel = f"{name}: {kernel}"
                counts[kernel] = 0
            elif kernel and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):  # one per instruction
                counts[kernel] += 1
    return counts


def cuda_time_ms(fn, iters: int, warmup: int = 2, queued: bool = True) -> float:
    """Device time per call of fn over `iters` back-to-back calls (CUDA
    events).  queued: the calls wait behind a ~10 ms sleep kernel, so the
    time is the card's and not the host's launch rate; otherwise each call
    starts when the host issues it (how the earlier K1 design was timed)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_timeline(torch, fn, iters, names):
    """fn's device kernels over `iters` calls queued behind a sleep kernel
    (torch.profiler, after one warm-up call), in ms: the time per launch of
    each kernel whose name contains one of `names` (None where the profiler
    saw none); per call, the number and summed time of all device events
    and the card's idle time between them, by the name of the kernel that
    ends each gap.  None where the profiler reported no device time.  The
    profiler may miss the first or last calls' kernels, so "per call" is
    per call it saw (the launches of names[0], reported as calls_seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = sorted(((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start),
                 key=lambda e: e[0])
    first = next((i for i, e in enumerate(evs) if names[0] in e[2]), None)
    if first is None:
        return None
    evs = evs[first:]  # from fn's first kernel on: the sleep kernel stays out
    calls = sum(names[0] in e[2] for e in evs)
    per = lambda us: us / 1e3 / calls
    out = {}
    for n in names:  # one launch of each per call: per launch of its own
        mine = [e[1] - e[0] for e in evs if n in e[2]]
        out[n] = sum(mine) / 1e3 / len(mine) if mine else None
    idle = {}
    for prev, cur in zip(evs, evs[1:]):
        key = next((n for n in names if n in cur[2]), cur[2][:40])
        idle[key] = idle.get(key, 0.0) + max(0.0, cur[0] - prev[1])
    out.update(calls_seen=calls, events_per_call=len(evs) / calls,
               kernels_ms=per(sum(e[1] - e[0] for e in evs)),
               idle_before_ms={k: per(v) for k, v in idle.items()})
    return out


def layer_inputs(torch, b, bp, L, d, h, ds, p, dtype, bias_dtype, seed, n_masked):
    """Random fused-layer inputs on the card: orthonormal frames,
    translations of magnitude ~5, the last n_masked keys padded."""
    from diffab_pytorch_tpu_torch.geometry import so3
    from diffab_pytorch_tpu_torch.ops.ipa_fused_layer import pack_layer_weights

    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)
    w = lambda n_in, n_out: (f(n_in, n_out) / n_in ** 0.5).cuda()
    mask = torch.ones(b, L)
    mask[:, L - n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    wts = pack_layer_weights(
        w(d, h * ds), w(d, h * ds), w(d, h * ds),
        w(d, h * p * 3), w(d, h * p * 3), w(d, h * p * 3),
        w(h * ds, d), w(h * p * 3, d), w(h * p, d),
        (f(h).abs() + 0.5).cuda(), scales[0], scales[1], dtype,
    )
    args = dict(
        x=f(b, L, d).to(dtype).cuda(),
        rot=so3.uniform((b, L), generator=g).to(dtype).cuda(),
        trans=(f(b, L, 3) * 5).to(dtype).cuda(),
        mask=mask.to(dtype).cuda(),
        wts=wts,
        bias=f(bp, h, L, L).to(bias_dtype).cuda(),
        scale_total=scales[2],
    )
    return args


def ipa_layer_flops_bytes(b, bp, L, d, h, ds, p, itemsize, bias_itemsize):
    """Operations and compulsory bytes of one fused-layer call (each input
    read once, each output written once)."""
    fq = h * (ds + 3 * p)
    flops = b * (
        2 * L * d * 3 * fq  # Q/K/V projections
        + 2 * h * L * L * (ds + 3 * p + 3)  # augmented logits
        + 2 * h * L * L * (ds + 3 * p)  # weighted sums
        + 2 * L * d * h * (ds + 4 * p)  # output projections
    )
    n_bytes = (
        b * L * d * itemsize * 2  # x in, acc out
        + b * h * L * L * itemsize  # attn out
        + bp * h * L * L * bias_itemsize  # bias
        + (d * 3 * fq + h * (ds + 4 * p) * d) * itemsize  # weights
        + b * L * 13 * itemsize + h * 4  # rot, trans, mask, g
    )
    return flops, n_bytes


def check_layer(torch, name, args, bf16: bool):
    """Kernel vs plain version on the same card inputs; returns the largest
    absolute error.

    float32: every element within 1e-4 (attention weights) and 1e-4 of the
    output scale (acc).  The two sum the same float32 products in another
    order; the augmented logits carry |q|^2 and |k|^2 terms of ~10^2 at
    these shapes, so a last-bit difference there moves a weight by ~1e-5.

    bfloat16: both round at the same points, but where a float32 sum lands
    within its last bit of a bf16 rounding boundary the two round apart.
    For |k|^2 (~10^2, bf16 step 0.5) one such flip shifts a whole logit
    column by 0.3, so a few weights per 10^5 differ by far more than one
    bf16 step.  The check: at most 1e-4 of the elements beyond one bf16
    step (2^-8 on weights, 2^-7 of the output scale on acc); a wrong
    kernel misses on most elements."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    acc_k, attn_k = op.fused_ipa_layer_packed(**args)
    acc_p, attn_p = op.fused_ipa_layer_packed_reference(**args)
    torch.cuda.synchronize()
    d_attn = (attn_k.float() - attn_p.float()).abs()
    d_acc = (acc_k.float() - acc_p.float()).abs()
    scale = max(1.0, acc_p.float().abs().max().item())
    tol_attn, tol_acc = (2 ** -8, 2 ** -7 * scale) if bf16 else (1e-4, 1e-4 * scale)
    share_attn = (d_attn > tol_attn).float().mean().item()
    share_acc = (d_acc > tol_acc).float().mean().item()
    allowed = 1e-4 if bf16 else 0.0
    masked_keys = args["mask"][0] == 0  # every design pads the same keys
    padded = (attn_k[..., masked_keys].float().abs().max().item()
              if masked_keys.any() else 0.0)
    print(f"[parity] {name}: max|d attn| {d_attn.max().item():.3e}, "
          f"max|d acc| {d_acc.max().item():.3e} = {d_acc.max().item() / scale:.3e} of "
          f"max|acc| {scale:.3e}; share beyond tol (attn {tol_attn:.1e}, acc "
          f"{tol_acc:.1e}): {share_attn:.2e} / {share_acc:.2e} (allowed {allowed:.0e}); "
          f"padded-key attn {padded:.1e}")
    if not (torch.isfinite(acc_k).all() and torch.isfinite(attn_k).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    if share_attn > allowed or share_acc > allowed or padded != 0.0:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max(d_attn.max().item(), d_acc.max().item())


def attention_inputs(torch, b, bp, L, h, ds, p, dtype, bias_dtype, seed, n_masked):
    """Random attention-core operands on the card, assembled from
    projections and global-frame points of magnitude ~5 by the wrapper's
    own `augmented_operands` in `dtype`; the last n_masked keys padded."""
    from diffab_pytorch_tpu_torch.ops.ipa_attention import augmented_operands

    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)
    mask = torch.ones(b, L)
    mask[:, L - n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    proj = [f(b, L, h, ds) for _ in range(3)] + [f(b, L, h, p, 3) * 5 for _ in range(3)]
    ops = augmented_operands(*(t.to(dtype) for t in proj), f(h).abs() + 0.5,
                             mask.to(dtype), *scales)
    return dict(q_aug=ops[0].cuda(), k_aug=ops[1].cuda(), v_s=ops[2].cuda(),
                v_p=ops[3].cuda(), bias=f(bp, h, L, L).to(bias_dtype).cuda(),
                scale_total=scales[2])


def attention_flops_bytes(b, bp, L, h, ds, p, itemsize, bias_itemsize):
    """Operations and compulsory bytes of one attention-core call."""
    fv = ds + 3 * p
    n_feat = -(-(fv + 3) // 16) * 16
    flops = b * 2 * h * L * L * (n_feat + fv)
    n_bytes = (b * h * L * (2 * n_feat + 2 * fv) * itemsize  # q_aug, k_aug, v in; outs
               + b * h * L * L * itemsize  # attn out
               + bp * h * L * L * bias_itemsize)  # bias
    return flops, n_bytes


def check_attention(torch, name, args, n_masked, bf16: bool):
    """Attention-core kernel vs its plain version on the same card inputs;
    returns the largest absolute error.  The tolerances are check_layer's:
    float32 within 1e-4 (weights) and 1e-4 of the output scale; bfloat16 at
    most 1e-4 of the elements beyond one bf16 step (2^-8 on weights, 2^-7
    of the output scale), for the |k|^2 rounding flips check_layer
    describes.  Padded keys must get exactly 0."""
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2

    out_k = k2.ipa_attention_core(**args)
    out_p = k2.ipa_attention_core_reference(**args)
    torch.cuda.synchronize()
    worst, shares = 0.0, []
    for label, k, r in zip(("out_s", "out_p", "attn"), out_k, out_p):
        if not torch.isfinite(k).all():
            raise RuntimeError(f"{name}: non-finite kernel {label}")
        d = (k.float() - r.float()).abs()
        scale = 1.0 if label == "attn" else max(1.0, r.float().abs().max().item())
        tol = (2 ** -8 if label == "attn" else 2 ** -7 * scale) if bf16 else 1e-4 * scale
        shares.append((d > tol).float().mean().item())
        worst = max(worst, d.max().item())
    allowed = 1e-4 if bf16 else 0.0
    padded = out_k[2][..., -n_masked:].float().abs().max().item() if n_masked else 0.0
    print(f"[parity] {name}: max|d| {worst:.3e}; share beyond tol (out_s / out_p / attn) "
          f"{shares[0]:.2e} / {shares[1]:.2e} / {shares[2]:.2e} (allowed {allowed:.0e}); "
          f"padded-key attn {padded:.1e}")
    if max(shares) > allowed or padded != 0.0:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return worst


LONG_L = (136, 200, 256)  # one key chunk partly padding, a ragged chunk, two whole chunks


def long_patch_phase(torch, card):
    """[long]: K1 and K2 at L > 128 (query and key chunks of 128) against
    their plain versions on the card, at the default widths (d=128, h=8,
    ds=32, P=8), L = 136, 200, 256 at b = bp = 32 and at b = 128, bp = 1,
    and L = 129 (element-wise loads and stores) and 384 at b = 4, bp = 2,
    in bf16 and float32, 9 padded keys (each
    must get weight exactly 0), the tolerances of check_layer and
    check_attention; then each kernel's time at L = 256 at both shapes
    beside its bound.  Returns (K1 error, K2 error, {(kernel, dtype,
    shape): times})."""
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    widths = dict(d=128, h=8, ds=32, p=8)
    cases = ([(L, b, bp) for L in LONG_L for b, bp in ((32, 32), (128, 1))]
             + [(129, 4, 2), (384, 4, 2)])
    err1 = err2 = 0.0
    with torch.no_grad():
        for i, (L, b, bp) in enumerate(cases):
            for dtype in (torch.bfloat16, torch.float32):
                bf = dtype == torch.bfloat16
                tag = f"[long] {'bf16' if bf else 'f32'} L={L} b={b} bp={bp}"
                err1 = max(err1, check_layer(
                    torch, f"{tag} K1", layer_inputs(torch, b, bp, L, **widths, dtype=dtype,
                                                     bias_dtype=dtype, seed=200 + i,
                                                     n_masked=9), bf16=bf))
                err2 = max(err2, check_attention(
                    torch, f"{tag} K2",
                    attention_inputs(torch, b, bp, L, widths["h"], widths["ds"], widths["p"],
                                     dtype, dtype, 300 + i, 9), 9, bf16=bf))
        times = {}
        L = 256
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            for label, b, bp in (("train", 32, 32), ("sample", N_DESIGNS, 1)):
                la = layer_inputs(torch, b, bp, L, **widths, dtype=dtype, bias_dtype=dtype,
                                  seed=400 + b, n_masked=0)
                aa = attention_inputs(torch, b, bp, L, widths["h"], widths["ds"], widths["p"],
                                      dtype, dtype, 500 + b, 0)
                for kname, kern, plain, (fl, nb) in (
                        ("ipa_fused_layer", lambda: op.fused_ipa_layer_packed(**la),
                         lambda: op.fused_ipa_layer_packed_reference(**la),
                         ipa_layer_flops_bytes(b, bp, L, **widths, itemsize=dtype.itemsize,
                                               bias_itemsize=dtype.itemsize)),
                        ("ipa_attention", lambda: k2.ipa_attention_core(**aa),
                         lambda: k2.ipa_attention_core_reference(**aa),
                         attention_flops_bytes(b, bp, L, widths["h"], widths["ds"],
                                               widths["p"], itemsize=dtype.itemsize,
                                               bias_itemsize=dtype.itemsize))):
                    km = cuda_time_ms(kern, 20)
                    pm = cuda_time_ms(plain, 3)
                    km2 = cuda_time_ms(kern, 20)
                    bnd, by, t_o, t_b = bound_ms(fl, nb, dname)
                    times[(kname, dname, label)] = dict(ms=min(km, km2), plain_ms=pm,
                                                        bound_ms=bnd, bound_by=by)
                    print(f"[time] [long] {kname} b={b} bp={bp} L={L} {dname} ({label} shape) "
                          f"on {card}: kernel {km:.4f} / {km2:.4f} ms, plain version "
                          f"{pm:.4f} ms, bound {bnd:.4f} ms ({fl / 1e9:.2f} GFLOP -> "
                          f"{t_o:.4f} ms, {nb / 1e6:.2f} MB -> {t_b:.4f} ms; bound by {by}), "
                          f"{bnd / min(km, km2):.3%} of bound")
    return err1, err2, times


def check_grads(torch, name, kernel_fn, plain_fn, leaves, consts):
    """Gradients of sum(out_i * c_i) over every output, through the
    kernel's autograd Function and through autograd of its plain version,
    on the same card inputs and cotangents.  The Function's backward
    recomputes the plain version, so the two agree to float32 summation
    order: each leaf within 1e-5 of its largest entry."""
    runs = []
    for fn in (kernel_fn, plain_fn):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        outs = fn(*xs, *consts)
        if not runs:
            g = torch.Generator(device="cuda").manual_seed(7)
            cots = [torch.randn(o.shape, generator=g, device="cuda", dtype=o.dtype)
                    for o in outs]
        sum((o.float() * c.float()).sum() for o, c in zip(outs, cots)).backward()
        runs.append([x.grad for x in xs])
    torch.cuda.synchronize()
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
              for a, b in zip(*runs))
    print(f"[grad] {name}: {len(leaves)} input gradients, max |d| / scale {rel:.2e} (tol 1e-5)")
    if not all(torch.isfinite(a).all() for a in runs[0]) or rel > 1e-5:
        raise RuntimeError(f"{name}: autograd Function disagrees with the plain version")


def check_e2e(torch, compute_dtype, n_designs=8, L=128, seed=0):
    """One default_config()-width denoiser forward in `compute_dtype` (6 IPA
    layers through K1, n_designs designs of one L-residue target, bp=1) on
    the card against the CPU plain path with the same weights and inputs.
    The CPU runs it in float32 and in bfloat16.

    bfloat16 tolerance: the card and the CPU round at the same points but
    sum in other orders (K1's tensor-core tiles, cuBLAS against the CPU's
    kernels), so wherever a float32 sum lands on the other side of a bf16
    rounding boundary the two round apart, and over six layers and the
    heads such flips spread to every output.  Each is a bf16 computation of
    the same function, about as far from the exact result as bf16 rounding
    puts it; taking the CPU float32 forward as exact, the triangle
    inequality bounds their distance by twice that: for each output, the
    largest and the mean |card - CPU bf16| must be at most 2x those of
    |CPU float32 - CPU bf16|.

    float32 tolerance, derived the same way: taking the CPU float32
    forward as exact, the card's float32 forward differs from it by the
    error of its own products, ~3 2^-22 relative for K1's 3xTF32 (cuBLAS
    runs full float32), against bf16's 2^-8 steps for the CPU bf16
    forward: 2^13 times finer.  So for each output, the largest and the
    mean |card - CPU float32| must be at most 1/64 (2^-6) of those of
    |CPU bf16 - CPU float32|, a factor 2^7 looser than that ratio for the
    six layers to amplify the two alike.  A kernel with plain TF32
    products (2^-11, only 2^3 finer than bf16) misses, and a wrong kernel
    misses by orders of magnitude.  K1 must launch once per layer."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.geometry import so3
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.models.ipa import precompute_pair_biases
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.weights import init_parameters

    bf16 = compute_dtype == "bfloat16"
    tag = "[e2e-bf16]" if bf16 else "[e2e-f32]"
    mcfg = C.ModelConfig(compute_dtype=compute_dtype)
    cpu_bf16 = init_parameters(DiffAbModel(C.ModelConfig(compute_dtype="bfloat16"), device="cpu"),
                               torch.Generator().manual_seed(seed))
    models = {"card": DiffAbModel(mcfg, device="cuda"),
              "cpu_f32": DiffAbModel(C.ModelConfig(), device="cpu"), "cpu_bf16": cpu_bf16}
    for m in models.values():
        m.load_state_dict(cpu_bf16.state_dict())
    target = synthetic_batch(seed, 1, L, mcfg.n_atoms, n_generate=8)
    g = torch.Generator().manual_seed(seed + 1)
    rep = lambda a: torch.repeat_interleave(a, n_designs, dim=0)
    state = (torch.randint(0, 21, (n_designs, L), generator=g),
             rep(target.translations) + torch.randn(n_designs, L, 3, generator=g) * 2,
             so3.uniform((n_designs, L), generator=g),
             torch.rand(n_designs, generator=g) * 0.5 + 0.01,
             rep(target.generation_mask), rep(target.residue_mask))
    outs, launched = {}, 0
    for name, model in models.items():
        dev = "cuda" if name == "card" else "cpu"
        before = op.fused_ipa_layer_packed.launches
        with torch.no_grad():
            res, pair = model.encode_context(target.to(dev))
            ipa = model.denoiser.ipa
            biases = [b.to(model.cfg.dtype) for b in precompute_pair_biases(ipa, pair)]
            seq, x, r, beta, gen, rmask = (t.to(dev) for t in state)
            out = model.denoise(seq, x, r, res, pair, beta, gen, rmask, pair_biases=biases,
                                kernel_weights=ipa.kernel_weights())
        outs[name] = {k: v.float().cpu() for k, v in out.items()}
        if name == "card":
            launched = op.fused_ipa_layer_packed.launches - before
    ok = launched == mcfg.n_ipa_layers
    ref, other, factor = ("cpu_bf16", "cpu_f32", 2.0) if bf16 else ("cpu_f32", "cpu_bf16", 1 / 64)
    for key in ("translations_eps", "orientations_t0", "seq_logits"):
        d_card = (outs["card"][key] - outs[ref][key]).abs()
        d_other = (outs[other][key] - outs[ref][key]).abs()
        finite = bool(torch.isfinite(outs["card"][key]).all())
        passed = (finite and d_card.max() <= factor * d_other.max()
                  and d_card.mean() <= factor * d_other.mean())
        ok = ok and passed
        print(f"{tag} denoiser forward, default_config() widths {compute_dtype}, {n_designs} "
              f"designs x L={L}: {key}: card vs CPU {ref[4:]} max|d| {d_card.max().item():.3e} "
              f"mean {d_card.mean().item():.3e}; CPU {other[4:]} vs CPU {ref[4:]} max|d| "
              f"{d_other.max().item():.3e} mean {d_other.mean().item():.3e} (tol: {factor:g}x "
              f"these); {'ok' if passed else 'FAILED'}")
    print(f"{tag} K1 launches in the card forward {launched} (expected {mcfg.n_ipa_layers})")
    if not ok:
        raise RuntimeError(f"the {compute_dtype} denoiser forward on the card disagrees with the "
                           f"CPU plain path")


class RecordingLogger:
    """fit()'s logger: prints each logged step and keeps its scalars."""

    def __init__(self, tag):
        self.tag, self.rows = tag, []

    def log(self, step, metrics):
        row = {k: float(v) for k, v in metrics.items()}
        self.rows.append((step, row))
        print(f"[train] {self.tag} step {step}: loss {row['train/loss']:.4f} "
              f"(seq {row['train/seq_loss']:.4f}, ce {row['train/seq_ce_loss']:.4f}, "
              f"trans {row['train/translations_loss']:.4f}, "
              f"orient {row['train/orientations_loss']:.4f})")


def profile_device(torch, fn, wall_s, label, top=12, sum_of=()):
    """Device time by kernel over one call of fn (torch.profiler), and the
    idle share of an unprofiled call of wall_s seconds (None: no idle
    share).  Only device-side events (kernels, copies) are traced and
    summed: recording the CPU ops as well gives the same device rows, and
    reading them back took longer than the profiled call.  sum_of: kernel
    names whose events and ms are also printed as one sum.  Returns the
    device busy ms (None when the profiler reported none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us > 0:
        idle = ""
        if wall_s is not None:
            idle = (f"; median unprofiled call {wall_s * 1e3:.1f} ms -> device idle share "
                    f"{max(0.0, 1 - busy_us / (wall_s * 1e6)):.3f}")
        print(f"[profile] {label}: device busy {busy_us / 1e3:.3f} ms in "
              f"{sum(r[2] for r in rows)} device events{idle} (profiled wall "
              f"{prof_wall_us / 1e3:.1f} ms)")
        for dev_us, key, count in rows[:top]:
            print(f"[profile]   {dev_us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        if sum_of:
            mine = [r for r in rows if any(name in r[1] for name in sum_of)]
            print(f"[profile]   {' + '.join(sum_of)}: {sum(r[0] for r in mine) / 1e3:.3f} ms in "
                  f"{sum(r[2] for r in mine)} launches")
        return busy_us / 1e3
    print(f"[profile] {label}: device time not measured (profiler reported none)")
    return None


def denoiser_calls(t_seq, opts):
    """Denoiser calls of one sample() chain over t_seq: one per step, and
    heun's corrector on each active step (t > coord_solver_t_min, s >= 1)."""
    s_seq = list(t_seq[1:]) + [0]
    extra = 0
    if opts.get("coord_solver") == "heun":
        t_min = opts.get("coord_solver_t_min", 0)
        extra = sum(1 for t, s in zip(t_seq, s_seq) if t > t_min and s >= 1)
    return len(t_seq) + extra


def e2e_sample_check(torch, tag, L, T, single_chain=False, **opts):
    """sample() on the card (kernels) against sample() on the CPU (plain
    versions): tiny_config() widths in float32, 2 designs of one synthetic
    L-residue target (6 generated residues; single_chain: one chain, so the
    span has both anchors), a T-step schedule and the options `opts`, the
    same injected initialization and step draws on both, once per
    fuse_ipa_layer flag (None: K1, False: K2).  Tolerance: sequences equal,
    1e-3 on coordinates and frames (float32 sums in another order through
    the chain, as the CPU parity tests); each kernel launches once per
    layer and denoiser call."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import (InitNoise, StepNoise, sample,
                                                          timestep_schedule)
    from diffab_pytorch_tpu_torch.weights import init_parameters

    tiny = C.tiny_config()
    cpu_model = init_parameters(DiffAbModel(tiny.model, device="cpu"),
                                torch.Generator().manual_seed(0))
    sched = cosine_variance_schedule(T, s=tiny.diffusion.s, beta_max=tiny.diffusion.beta_max)
    tables = make_orientation_tables(sched)
    target = synthetic_batch(0, 1, L, n_generate=6)
    if single_chain:
        target.chain_idx[:] = 1
    bn = 2
    g = torch.Generator().manual_seed(1)
    t_seq = timestep_schedule(opts.get("t_start", T), opts.get("n_steps"),
                              opts.get("step_schedule", "uniform"),
                              opts.get("step_schedule_p", 0.5), opts.get("n_fine_tail")).tolist()
    init = InitNoise(seq=torch.randint(0, 21, (bn, L), generator=g),
                     coord=torch.randn(bn, L, 3, generator=g),
                     coord_prior=torch.randn(bn, L, 3, generator=g),
                     rot=AxisAngleNoise.draw((bn, L), g), rot_prior=torch.randn(bn, L, 4, generator=g))
    if opts.get("t_start", T) < T and opts.get("init", "prior") == "prior":
        init = init._replace(seq=-torch.log(-torch.log(torch.rand(bn, L, 21, generator=g))))
    noise = {t: StepNoise(gumbel=-torch.log(-torch.log(torch.rand(bn, L, 21, generator=g))),
                          coord=torch.randn(bn, L, 3, generator=g),
                          orientation=AxisAngleNoise.draw((bn, L), g))
             for t in t_seq}
    to = lambda x, dev: (None if x is None else AxisAngleNoise(*(a.to(dev) for a in x))
                         if isinstance(x, AxisAngleNoise) else x.to(dev))
    on = lambda dev: (lambda t: StepNoise(*(to(x, dev) for x in noise[t])))
    per_call = tiny.model.n_ipa_layers * denoiser_calls(t_seq, opts)
    for fuse in (None, False):
        mcfg_small = dataclasses.replace(tiny.model, fuse_ipa_layer=fuse)
        outs, ran = {}, None
        for dev in ("cpu", "cuda"):
            m = DiffAbModel(mcfg_small, device=dev)
            m.load_state_dict(cpu_model.state_dict())
            before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
            outs[dev] = sample(m, sched, tables, target, device=dev, n_designs=bn,
                               init_noise=InitNoise(*(to(x, dev) for x in init)),
                               step_noise=on(dev), **opts)
            if dev == "cuda":
                torch.cuda.synchronize()
                ran = (op.fused_ipa_layer_packed.launches - before[0],
                       k2.ipa_attention_core.launches - before[1])
        want = (per_call, 0) if fuse is None else (0, per_call)
        out_cpu, out_card = outs["cpu"], outs["cuda"]
        seq_same = torch.equal(out_card.seq_idx.cpu(), out_cpu.seq_idx)
        d_x = (out_card.translations.cpu() - out_cpu.translations).abs().max().item()
        d_r = (out_card.orientations.cpu() - out_cpu.orientations).abs().max().item()
        finite = bool(torch.isfinite(out_card.translations).all())
        print(f"{tag} sample() card vs CPU, tiny_config f32 L={L} fuse_ipa_layer={fuse}, "
              f"T={T}, {len(t_seq)} steps {opts}: sequences equal {seq_same}, max|d x| "
              f"{d_x:.3e}, max|d R| {d_r:.3e} (tol 1e-3); launches K1 {ran[0]}, K2 {ran[1]} "
              f"(expected {want[0]}, {want[1]})")
        if not (seq_same and finite and d_x <= 1e-3 and d_r <= 1e-3 and ran == want):
            raise RuntimeError(f"{tag} sample() on the card disagrees with the CPU plain path")


def e2e_train_check(torch, tag, L):
    """One training loss and all its gradients on the card (the kernels'
    forward, the recomputing backward) against the plain versions on the
    CPU with the same draws: tiny_config() in float32 with mode dropout,
    a batch of 4 synthetic L-residue patches, once per kernel flag.
    Tolerance 1e-4 of the loss, 1e-3 of each gradient leaf's largest entry
    (the CPU parity tests' float32 tolerance against JAX)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tiny = C.tiny_config()
    tiny_train = dataclasses.replace(tiny, train=dataclasses.replace(tiny.train, mode_dropout=0.3))
    tb = synthetic_batch(3, 4, L, n_generate=8)
    for fuse in (None, False):
        tcfg = dataclasses.replace(tiny_train, model=dataclasses.replace(tiny.model,
                                                                         fuse_ipa_layer=fuse))
        h_cpu, h_card = DiffAb(tcfg, device="cpu"), DiffAb(tcfg, device="cuda")
        draws = h_cpu.draw(tb, torch.Generator().manual_seed(4))
        before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
        l_cpu, _, g_cpu = h_cpu.loss_and_grads(h_cpu.init(0).params, tb, draws)
        l_card, _, g_card = h_card.loss_and_grads(h_card.init(0).params, tb.to("cuda"),
                                                  draws.to("cuda"))
        torch.cuda.synchronize()
        ran = (op.fused_ipa_layer_packed.launches - before[0],
               k2.ipa_attention_core.launches - before[1])
        d_loss = abs(l_card.item() - l_cpu.item())
        rel = max(((g_card[k].cpu() - g).abs().max() / g.abs().max().clamp(min=1.0)).item()
                  for k, g in g_cpu.items())
        print(f"{tag} loss and {len(g_cpu)} gradients card vs CPU, tiny_config f32 L={L} "
              f"fuse_ipa_layer={fuse}: loss {l_card.item():.6f} vs {l_cpu.item():.6f}, "
              f"max gradient |d| / scale {rel:.2e} (tol 1e-3); launches K1 {ran[0]}, K2 {ran[1]}")
        want = (tiny.model.n_ipa_layers, 0) if fuse is None else (0, tiny.model.n_ipa_layers)
        if d_loss > 1e-4 * max(1.0, abs(l_cpu.item())) or rel > 1e-3 or ran != want:
            raise RuntimeError(f"{tag} a training step on the card disagrees with the CPU "
                               f"plain path")


def layer_calls(mcfg, passes=1):
    """IPA layer calls (K1 or K2 launches) of `passes` denoiser calls: each
    runs n_ipa_layers layers, twice that with the split trunk's geo_ipa."""
    return passes * mcfg.n_ipa_layers * (2 if mcfg.sc_split_trunk else 1)


def training_main_path(torch, card, tag, fuse, L, n_warm, n_timed, batch_size=None,
                       profile=True, model=None):
    """production_config() training through fit() on one synthetic batch of
    L-residue patches (batch_size, default the config's 32), from a seeded
    init, its model changed by `model` (ModelConfig fields): n_warm warm-up
    steps, then n_timed timed steps with the launch counts set to 0 just
    before and read just after (a self-conditioned step runs the denoiser
    twice); loss trajectory, peak memory and state checks; a profile of one
    more step.  Returns ((K1, K2) launches, steps/s)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.train.harness import DiffAb
    from diffab_pytorch_tpu_torch.train.trainer import fit

    pcfg = C.production_config()
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, log_every=4, batch_size=batch_size or pcfg.train.batch_size))
    pb = pcfg.train.batch_size
    pool = [synthetic_batch(100, pb, L, pcfg.model.n_atoms, device="cuda")]
    kname = "fused layer (K1)" if fuse is None else "attention core (K2)"
    hcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, fuse_ipa_layer=fuse,
                                                               **(model or {})))
    harness = DiffAb(hcfg)
    init_params = {k: v.detach().clone() for k, v in harness.init(hcfg.train.seed).params.items()}
    logger = RecordingLogger(f"{tag} {kname}")
    t0 = time.perf_counter()
    state = fit(harness, pool, max_steps=n_warm, logger=logger)
    torch.cuda.synchronize()
    print(f"{tag} {kname}: {n_warm} warm-up steps {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = fit(harness, pool, max_steps=n_warm + n_timed, logger=logger, state=state)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    steps_per_s = n_timed / wall_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} {kname}: {n_timed} steps of production_config() (bf16, batch {pb}, "
          f"L={L}) in {wall_s:.4f} s: {steps_per_s:.3f} steps/s, "
          f"{steps_per_s * pb:.1f} samples/s on {card}; peak memory {peak_gb:.2f} GB")
    per_step = layer_calls(hcfg.model, 2 if hcfg.model.self_conditioning else 1)
    want = (per_step * n_timed, 0) if fuse is None else (0, per_step * n_timed)
    print(f"{tag} {kname}: launches ipa_fused_layer {counts[0]}, ipa_attention "
          f"{counts[1]} (expected {want[0]}, {want[1]})")
    losses = [row["train/loss"] for _, row in logger.rows]
    moved = sum(not torch.equal(state.params[k].detach(), v) for k, v in init_params.items())
    tchecks = {
        "steps": state.step == n_warm + n_timed,
        "losses_finite": bool(losses) and all(map(math.isfinite, losses)),
        "params_finite": all(bool(torch.isfinite(v).all()) for v in state.params.values()),
        "params_moved": moved >= 0.9 * len(init_params),
        "ema_differs": any(not torch.equal(state.ema_params[k], state.params[k].detach())
                           for k in init_params),
        "launches": counts == want,
    }
    print(f"{tag} {kname}: loss trajectory {[round(v, 4) for v in losses]}; "
          f"{moved}/{len(init_params)} parameter tensors moved; checks {tchecks}")
    if not all(tchecks.values()):
        raise RuntimeError(f"{tag} training main path check failed: {tchecks}")
    if profile:
        gen = torch.Generator(device="cuda").manual_seed(99)
        step_state = state

        def one_step():
            nonlocal step_state
            step_state, _ = harness.train_step(step_state, pool[0], harness.draw(pool[0], gen))
        profile_device(torch, one_step, wall_s / n_timed, f"{tag} one training step, {kname}, "
                       f"L={L}", sum_of=K1_LAUNCHES if fuse is None else ())
    return counts, steps_per_s


def sampling_main_path(torch, card, compute_dtype, n_calls, tag, L=L_MAIN,
                       n_designs=N_DESIGNS, model=None, **opts):
    """The sampling main path: CDR-H3 codesign sample() with
    default_config() (its model in `compute_dtype`, changed by `model`;
    float32 is default_config() exactly as it stands), one synthetic
    L-residue target (default 128), n_designs designs sharing the context
    (default 128), T=100 and the sampler options `opts` (none: the full
    chain from the prior), seeded random weights.  One warm-up call, then n_calls timed
    calls with the launch counts set to 0 just before them and read just
    after; output checks on the last; a profile of one more call.  Returns
    ((K1, K2) launches over the timed calls, designs/s of the median
    call)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import sample, timestep_schedule
    from diffab_pytorch_tpu_torch.weights import init_parameters

    cfg = C.default_config()
    mcfg = dataclasses.replace(cfg.model, compute_dtype=compute_dtype, **(model or {}))
    dcfg = cfg.diffusion
    t0 = time.perf_counter()
    model = init_parameters(DiffAbModel(mcfg), torch.Generator().manual_seed(0))
    sched = cosine_variance_schedule(dcfg.T, s=dcfg.s, beta_max=dcfg.beta_max, device="cuda")
    tables = make_orientation_tables(sched)
    target = synthetic_batch(0, 1, L, mcfg.n_atoms, n_generate=N_GENERATE, device="cuda")
    print(f"{tag} default_config(), compute dtype {mcfg.compute_dtype}: set-up (model, IGSO(3) "
          f"tables, target) {time.perf_counter() - t0:.2f} s")

    def run(seed):
        return sample(model, sched, tables, target, n_designs=n_designs,
                      generator=torch.Generator(device="cuda").manual_seed(seed), **opts)

    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    print(f"{tag} warm-up sample() {time.perf_counter() - t0:.2f} s")
    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
    call_s = []
    for i in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(11 + i)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    launches = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    t_seq = timestep_schedule(opts.get("t_start", dcfg.T), opts.get("n_steps"),
                              opts.get("step_schedule", "uniform"),
                              opts.get("step_schedule_p", 0.5), opts.get("n_fine_tail"))
    per_call = layer_calls(mcfg, denoiser_calls(t_seq.tolist(), opts))
    expected = (n_calls * per_call, 0)
    wall = sorted(call_s)[n_calls // 2]  # median call
    print(f"{tag} {n_calls} x sample(n_designs={n_designs}, T={dcfg.T}, L={L}, "
          f"{len(t_seq)} steps {opts}) in {mcfg.compute_dtype}: "
          f"{', '.join(f'{c:.4f}' for c in call_s)} s; median {n_designs / wall:.2f} designs/s "
          f"on {card}; ipa_fused_layer launches {launches[0]} ({launches[0] / n_calls:g} per "
          f"call), ipa_attention launches {launches[1]} (expected {expected[0]}, {expected[1]})")
    if launches != expected:
        raise RuntimeError(f"main path launched (fused layer, attention core) {launches} times, "
                           f"expected {expected}")
    ctx = ~target.generation_mask[0]
    checks = {
        "finite": bool(torch.isfinite(out.translations).all()
                       and torch.isfinite(out.orientations).all()),
        "shapes": tuple(out.translations.shape) == (n_designs, L, 3)
        and tuple(out.orientations.shape) == (n_designs, L, 3, 3),
        "orthonormal": float((out.orientations.transpose(-1, -2) @ out.orientations
                              - torch.eye(3, device="cuda")).abs().max()) < 1e-3,
        "context_unchanged": bool(
            (out.seq_idx[:, ctx] == target.seq_idx[0, ctx]).all()
            and (out.translations[:, ctx] == target.translations[0, ctx]).all()
            and (out.orientations[:, ctx] == target.orientations[0, ctx]).all()),
        "sequence_in_vocab": bool(((out.seq_idx >= 0) & (out.seq_idx < 21)).all()),
        "designs_differ": bool((out.translations[0] != out.translations[1]).any()),
    }
    print(f"{tag} output checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"main path output check failed: {checks}")
    profile_device(torch, lambda: run(20), wall, f"{tag} one {mcfg.compute_dtype} sample() call",
                   sum_of=K1_LAUNCHES)
    return launches, n_designs / wall


DESIGN_FIXTURE = os.path.join("tests", "fixtures", "ab1_chothia.pdb")
N_DESIGN_CHECK = 8  # designs in the card-vs-CPU score and relax checks


class Probe:
    """Wraps a callable of the design loop: synchronizes the card around
    each call and records its wall time, its K1 and K2 launches and its
    arguments (for a profiled call after the run)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    def __call__(self, *args, **kwargs):
        from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
        from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

        self.torch.cuda.synchronize()
        before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.calls.append(dict(
            s=time.perf_counter() - t0, args=args, kwargs=kwargs,
            launches=(op.fused_ipa_layer_packed.launches - before[0],
                      k2.ipa_attention_core.launches - before[1])))
        return out

    def total_s(self):
        return sum(c["s"] for c in self.calls)


def design_loop(torch, card, tmp):
    """[design] 1-2: featurize the fixture complex (chains H and L, antigen
    A) into a 128-residue patch with the port's structure modules, write
    seeded default_config() weights in the port's checkpoint format, then
    `cli.sample --rank -n 128 --cdrs H3` and `cli.evaluate --json` on the
    card, through their main().  Returns ({path: (K1, K2) launches}, the
    score call's and the relax call's records (`Probe.calls` entries))."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import evaluate as evaluate_cli
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.scoring import default_t_grid
    from diffab_pytorch_tpu_torch.structure import antibody
    from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag, n = "[design]", N_DESIGNS
    t0 = time.perf_counter()
    complex_ = antibody.from_pdb(os.path.join(HERE, DESIGN_FIXTURE), "H", "L", ["A"],
                                 keep_fv_only=True)
    patch = featurize_patch(complex_, patch_size=L_MAIN)
    patch_path = os.path.join(tmp, "target.npz")
    save_patch(patch_path, patch)
    cfg = C.default_config()
    ck = os.path.join(tmp, "ckpt")
    ckpt.save_checkpoint(ck, DiffAb(cfg, device="cpu").init(0))
    ckpt.save_model_config(ck, cfg.model)
    print(f"{tag} {DESIGN_FIXTURE}: {complex_.n_residues} residues -> a {L_MAIN}-residue patch "
          f"({int(patch['residue_mask'].sum())} valid, {int((patch['cdr_idx'] == 3).sum())} in "
          f"H3); seeded default_config() checkpoint; set-up {time.perf_counter() - t0:.2f} s")

    probes = {"sample": Probe(torch, DiffAb.sample), "score": Probe(torch, DiffAb.score_designs),
              "relax": Probe(torch, sample_cli.relax_ca),
              "write_pdb": Probe(torch, sample_cli.write_pdb)}
    out_dir = os.path.join(tmp, "designs")
    argv = ["--patch", patch_path, "--checkpoint-dir", ck, "-n", str(n), "--cdrs", "H3",
            "--rank", "-o", out_dir, "-s", "0"]
    log = io.StringIO()
    try:
        DiffAb.sample = lambda self, *a, **k: probes["sample"](self, *a, **k)
        DiffAb.score_designs = lambda self, *a, **k: probes["score"](self, *a, **k)
        sample_cli.relax_ca, sample_cli.write_pdb = probes["relax"], probes["write_pdb"]
        op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = sample_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    finally:
        DiffAb.sample, DiffAb.score_designs = probes["sample"].fn, probes["score"].fn
        sample_cli.relax_ca, sample_cli.write_pdb = probes["relax"].fn, probes["write_pdb"].fn
    print("\n".join(f"{tag} cli.sample: {line}" for line in log.getvalue().splitlines()
                    if line.startswith("[sample]")))
    s_call, sc_call = probes["sample"].calls[0], probes["score"].calls[0]
    print(f"{tag} cli.sample {' '.join(argv[4:])}: wall {wall:.3f} s (card: {card})")
    print(f"{tag} sample() {s_call['s']:.3f} s: {n / s_call['s']:.3f} designs/s (card: {card})")
    print(f"{tag} score_designs() {sc_call['s']:.3f} s: {n / sc_call['s']:.3f} designs scored/s "
          f"(card: {card})")
    print(f"{tag} relax_ca {probes['relax'].total_s() * 1e3:.2f} ms (card: {card})")
    print(f"{tag} {len(probes['write_pdb'].calls)} PDB writes "
          f"{probes['write_pdb'].total_s() * 1e3:.2f} ms (card: {card})")
    grid_points = 2 * len(default_t_grid(cfg.diffusion.T))
    want = {"sample": (cfg.model.n_ipa_layers * cfg.diffusion.T, 0),
            "score": (cfg.model.n_ipa_layers * grid_points, 0)}
    got = {"sample": s_call["launches"], "score": sc_call["launches"]}
    print(f"{tag} launches K1, K2: sample call {got['sample']}, score call {got['score']}, whole "
          f"CLI {total} (expected {want['sample']}, {want['score']}, the sum)")

    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".pdb"))
    fasta = open(os.path.join(out_dir, "designs.fasta")).read().splitlines()
    scores = json.load(open(os.path.join(out_dir, "scores.json")))
    values = [v for e in scores.values() for k, v in e.items() if k != "rank"]
    report_path = os.path.join(tmp, "report.json")
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc_eval = evaluate_cli.main(["--native-patch", patch_path, "--designs", out_dir,
                                     "--cdrs", "H3", "--json", report_path])
    eval_s = time.perf_counter() - t0
    agg = json.load(open(report_path))["aggregate"]
    rows = json.load(open(report_path))["designs"]
    print(f"{tag} cli.evaluate --json: {eval_s:.3f} s; " + "; ".join(
        line for line in log.getvalue().splitlines()[-3:-1]))
    checks = {
        "rc": rc == 0 and rc_eval == 0,
        "pdbs": names == [f"design_{i:04d}.pdb" for i in range(n)],
        "fasta": len(fasta) == 2 * n and all(
            fasta[2 * i].startswith(f">design_{i:04d} cdrs=H3 score=") for i in range(n)),
        "scores_finite": len(scores) == n and all(math.isfinite(v) for v in values),
        "ranks_permutation": sorted(e["rank"] for e in scores.values()) == list(range(n)),
        "report": agg["n_designs"] == n and 0.0 <= agg["aar_mean"] <= 1.0
        and all(0.0 <= r["aar"] <= 1.0 for r in rows)
        and all(math.isfinite(r[k]) for r in rows for k in ("ca_rmsd", "ca_rmsd_aligned")),
        "launches": got == want and total == tuple(map(sum, zip(*want.values()))),
    }
    print(f"{tag} checks {checks}; aggregate " + json.dumps(
        {k: agg[k] for k in ("aar_mean", "ca_rmsd_mean", "diversity", "valid_rate",
                             "rank_spearman")}))
    if not all(checks.values()):
        raise RuntimeError(f"{tag} the design loop failed a check: {checks}")
    return ({"design_cli": got["sample"], "score": got["score"]}, sc_call,
            probes["relax"].calls[0])


def design_card_vs_cpu(torch, tmp):
    """[design] 3: score_designs on the card against the CPU plain path at
    default_config() width on the fixture patch, 8 designs (the native's H3
    with random residue types, CAs moved by ~0.5 A and random frames), the
    same seeded weights and the same injected ScoreDraws (the default grid,
    16 points), for fuse_ipa_layer None (K1) and False (K2), in float32 and
    bfloat16; then relax_ca card against CPU on 8 perturbed designs, two
    of them torn so that its chord pre-pass runs.

    float32: every score within 1e-4 of the largest |CPU score| of its
    component (the end-to-end checks' float32 rule), both flags against
    one CPU float32 run.  bfloat16: the card and the CPU (the same flag's
    plain version) are two bf16 computations of one function, each off the
    exact (taken as the CPU float32 scores) by about one bf16 error, so by
    the triangle inequality |card - CPU bf16| <= e_card + e_cpu; with
    e_cpu the largest |CPU float32 - CPU bf16| over the designs of a
    component and e_card allowed up to twice that, every |card - CPU bf16|
    must be at most 3 e_cpu.  Ranks: wherever two designs' CPU scores
    differ by more than the tolerance, the card orders them the same.
    relax_ca, after the pre-pass alone, after 10 iterations and after the
    full 200: within 1e-4 model units (1e-3 A, the written PDB's
    precision), context rows exactly equal; the pre-pass moves the torn
    designs and no other.  After 200 iterations a torn loop lies on the
    gate's thresholds, where a last-digit difference flips a correction
    and the two devices' chains part (as the CPU against JAX in
    tests/test_torch_evaluation.py): the torn designs within 1e-2 model
    units (0.1 A), and the card's pass the gate's CA-CA and clash checks."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.dataset import COORD_SCALE, assemble_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.evaluation.metrics import backbone_validity
    from diffab_pytorch_tpu_torch.geometry import so3
    from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
    from diffab_pytorch_tpu_torch.sampling.scoring import ScoreDraws, default_t_grid, score_designs
    from diffab_pytorch_tpu_torch.structure.patch import load_patch
    from diffab_pytorch_tpu_torch.structure.relax import relax_ca
    from diffab_pytorch_tpu_torch.weights import init_parameters

    tag, n = "[design]", N_DESIGN_CHECK
    patch = load_patch(os.path.join(tmp, "target.npz"))
    batch, _ = assemble_batch([patch], ["H3"], device="cpu")
    g = torch.Generator().manual_seed(7)
    rep = lambda a: torch.repeat_interleave(a, n, dim=0)
    gen = rep(batch.generation_mask & batch.residue_mask)
    designs = SampleResult(
        torch.where(gen, torch.randint(0, 20, gen.shape, generator=g), rep(batch.seq_idx)),
        torch.where(gen[..., None], rep(batch.translations)
                    + torch.randn(n, L_MAIN, 3, generator=g) * 0.05, rep(batch.translations)),
        torch.where(gen[..., None, None], so3.uniform((n, L_MAIN), generator=g),
                    rep(batch.orientations)))
    cfg = C.default_config()
    grid = default_t_grid(cfg.diffusion.T)
    pts = 2 * len(grid)
    draws = ScoreDraws(-torch.log(-torch.log(torch.rand(pts, n, L_MAIN, 21, generator=g))),
                       torch.randn(pts, n, L_MAIN, 3, generator=g),
                       AxisAngleNoise.draw((pts, n, L_MAIN), g))
    weights = init_parameters(DiffAbModel(cfg.model, device="cpu"),
                              torch.Generator().manual_seed(0)).state_dict()
    dcfg = cfg.diffusion
    sched = cosine_variance_schedule(dcfg.T, s=dcfg.s, beta_max=dcfg.beta_max)
    tables = make_orientation_tables(sched)
    fields = ("score", "seq_score", "translations_score", "orientations_score")

    def run(fuse, dtype, dev):
        model = DiffAbModel(dataclasses.replace(cfg.model, fuse_ipa_layer=fuse,
                                                compute_dtype=dtype), device=dev)
        model.load_state_dict(weights)
        before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
        out = score_designs(model, sched, tables, batch, designs, device=dev, draws=draws)
        if dev == "cuda":
            torch.cuda.synchronize()
        ran = (op.fused_ipa_layer_packed.launches - before[0],
               k2.ipa_attention_core.launches - before[1])
        return {k: getattr(out, k).double().cpu() for k in fields}, ran

    # on the CPU both flags run plain versions of one layer function: one
    # float32 reference serves both; in bf16 the two plain versions round
    # in different places, so each flag's bound comes from its own
    t0 = time.perf_counter()
    cpu32 = run(None, "float32", "cpu")[0]
    cpu_s = time.perf_counter() - t0
    worst = {}
    for fuse in (None, False):
        t0 = time.perf_counter()
        cpu = {"float32": cpu32, "bfloat16": run(fuse, "bfloat16", "cpu")[0]}
        cpu_s += time.perf_counter() - t0
        for dt in ("float32", "bfloat16"):
            card, ran = run(fuse, dt, "cuda")
            want = (6 * pts, 0) if fuse is None else (0, 6 * pts)
            ok = ran == want
            ratios = []
            for k in fields:
                d = (card[k] - cpu[dt][k]).abs()
                if dt == "float32":
                    tol = 1e-4 * max(1.0, float(cpu[dt][k].abs().max()))
                else:
                    tol = 3.0 * float((cpu["float32"][k] - cpu[dt][k]).abs().max())
                order = torch.argsort(cpu[dt][k], stable=True)
                c_sorted, k_sorted = cpu[dt][k][order], card[k][order]
                apart = (c_sorted[1:] - c_sorted[:-1]) > tol
                ranks_ok = bool((k_sorted[1:] > k_sorted[:-1])[apart].all())
                ok = (ok and float(d.max()) <= tol and ranks_ok
                      and bool(torch.isfinite(card[k]).all()))
                ratios.append(float(d.max()) / max(tol, 1e-30))
                print(f"{tag} score_designs card vs CPU, default_config {dt}, fuse_ipa_layer="
                      f"{fuse}, {n} designs, {pts} grid points: {k} max|d| {float(d.max()):.3e} "
                      f"(tol {tol:.3e}), ranks kept where apart {ranks_ok}")
            worst[(fuse, dt)] = max(ratios)
            print(f"{tag} launches K1, K2 {ran} (expected {want}); {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{tag} score_designs on the card ({dt}, fuse_ipa_layer="
                                   f"{fuse}) disagrees with the CPU plain path")
    print(f"{tag} the CPU references took {cpu_s:.2f} s (3 score_designs calls)")

    # relax_ca on 8 designs of the native: H3's CAs moved by ~0.3 A, two
    # loops squeezed toward their first residue, and two torn (one designed
    # CA 20 A out, an edge past twice the gate: the chord pre-pass)
    x = torch.where(gen[..., None], rep(batch.translations)
                    + torch.randn(n, L_MAIN, 3, generator=g) * 0.03, rep(batch.translations))
    rows = torch.nonzero(gen[0]).flatten()
    for i in (2, 5):
        x[i, rows[-6:]] = x[i, rows[-6:][:1]] + (x[i, rows[-6:]] - x[i, rows[-6:][:1]]) * 0.2
    torn = [n - 2, n - 1]
    x[torn, rows[len(rows) // 2]] += 2.0
    masks = [rep(t) for t in (batch.residue_mask, batch.chain_idx, batch.residue_idx,
                              batch.generation_mask)]

    def relax_both(iters):
        return [relax_ca(x.to(dev), *(m.to(dev) for m in masks), coord_scale=COORD_SCALE,
                         n_iters=iters).cpu() for dev in ("cpu", "cuda")]

    mild = [i for i in range(n) if i not in torn]
    ok = True
    for iters in (0, 10, 200):
        cpu_out, card_out = relax_both(iters)
        d = (card_out - cpu_out).abs().amax(dim=(1, 2))
        d_mild, d_torn = float(d[mild].max()), float(d[torn].max())
        tol_torn = 1e-2 if iters == 200 else 1e-4
        ctx_same = bool(torch.equal(card_out[~gen], x[~gen]))
        fired = (cpu_out != x).any(dim=(1, 2))
        ok_i = d_mild <= 1e-4 and d_torn <= tol_torn and ctx_same
        if iters == 0:
            # the pre-pass moves the torn designs, and only them
            ok_i = ok_i and fired.tolist() == [i in torn for i in range(n)]
        if iters == 200:
            val = backbone_validity(card_out, card_out, card_out, *masks, scale=COORD_SCALE)
            ok_i = (ok_i and int(val["ca_break"][torn].sum() + val["clash_count"][torn].sum()) == 0
                    and bool(fired[[2, 5]].all()))
        ok = ok and ok_i
        print(f"{tag} relax_ca card vs CPU, {n} designs ({len(torn)} torn), {iters} iterations: "
              f"max|d| {d_mild:.3e} (tol 1e-4), torn {d_torn:.3e} (tol {tol_torn:g}) model "
              f"units; moved {fired.tolist()}; context rows unchanged {ctx_same}; "
              f"{'ok' if ok_i else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{tag} relax_ca on the card disagrees with the CPU")
    return worst


def design_phase(torch, card):
    """[design]: the design loop through the port's entry points on the
    card, its device profile, and its card-vs-CPU checks (see
    design_loop and design_card_vs_cpu).  Returns {path: (K1, K2)
    launches}."""
    import tempfile

    from diffab_pytorch_tpu_torch.structure.relax import relax_ca

    laps = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        launches, score_call, relax_call = design_loop(torch, card, tmp)
        laps.append(time.perf_counter())
        profile_device(torch, lambda: score_call["args"][0].score_designs(
            *score_call["args"][1:], **score_call["kwargs"]), score_call["s"],
            "[design] one score_designs() call (128 designs, the default 16 grid points, "
            "float32)")
        laps.append(time.perf_counter())
        profile_device(torch, lambda: relax_ca(*relax_call["args"], **relax_call["kwargs"]),
                       relax_call["s"], "[design] one relax_ca() call (128 designs, 200 "
                       "iterations)")
        laps.append(time.perf_counter())
        design_card_vs_cpu(torch, tmp)
        laps.append(time.perf_counter())
    loop_s, prof_score_s, prof_relax_s, check_s = (b - a for a, b in zip(laps, laps[1:]))
    print(f"[design] phase {laps[-1] - laps[0]:.2f} s: the CLIs {loop_s:.2f} s, the profiles of "
          f"the score and relax calls {prof_score_s:.2f} and {prof_relax_s:.2f} s, card-vs-CPU "
          f"checks {check_s:.2f} s")
    return launches


DATA_FAMILIES, DATA_PER_FAMILY = 8, 32  # the [data] corpus: 256 complexes
DATA_STEPS = 14  # about two epochs: 231 training patches at batch 32 give 7 steps an epoch
DATA_WINDOW = 7  # steps timed after the first epoch's validation pass


class StepRecorder:
    """Wraps DiffAb.train_step inside a training run without waiting for the
    card: each call's host entry time, its K1 and K2 launches, its loss and
    a checksum of its batch (tensors, read after the run)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, harness, state, batch, draws):
        from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
        from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

        t0 = time.perf_counter()
        before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
        state, metrics = self.fn(harness, state, batch, draws)
        self.calls.append(dict(t=t0, loss=metrics["train/loss"], args=(harness, state, batch,
                                                                         draws),
                               rows=(batch.xyz.double().sum(), batch.seq_idx.sum()),
                               launches=(op.fused_ipa_layer_packed.launches - before[0],
                                         k2.ipa_attention_core.launches - before[1])))
        return state, metrics


def data_corpus(tmp):
    """[data] 1-3: the family corpus through cli.preprocess (a subprocess,
    one spawned worker per core, the C++ parser and featurizer), then the
    C++ routes against the Python ones on 16 of the PDBs.  Returns (the
    patch directory, complexes/s)."""
    from diffab_pytorch_tpu_torch.data.synthetic import write_family_corpus
    from diffab_pytorch_tpu_torch.structure import antibody, geometry, pdb

    tag, n = "[data]", DATA_FAMILIES * DATA_PER_FAMILY
    t0 = time.perf_counter()
    meta = write_family_corpus(os.path.join(tmp, "corpus"), n_families=DATA_FAMILIES,
                               n_per_family=DATA_PER_FAMILY, seed=0)
    print(f"{tag} family corpus: {n} complexes (H, L, antigen A) and meta.csv written in "
          f"{time.perf_counter() - t0:.2f} s")
    patches = os.path.join(tmp, "patches")
    jobs = os.cpu_count() or 1
    cmd = [sys.executable, "-m", "diffab_pytorch_tpu_torch.cli.preprocess", "--meta", meta,
           "--data-dir", os.path.join(tmp, "corpus", "pdb"), "--out-dir", patches, "-j",
           str(jobs), "-k", str(L_MAIN)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    written = sorted(f for f in os.listdir(patches) if f.endswith(".npz")) \
        if os.path.isdir(patches) else []
    summary = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"{tag} cli.preprocess -j {jobs} -k {L_MAIN}: {summary[0]}; {len(written)} .npz in "
          f"{wall:.2f} s: {n / wall:.2f} complexes/s (host: {jobs} spawned workers)")
    if proc.returncode != 0 or len(written) != n or f"skipped 0" not in summary[0]:
        raise RuntimeError(f"{tag} cli.preprocess failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")

    t0 = time.perf_counter()
    d_xyz = d_geom = 0.0
    same = True
    for i in range(16):
        path = os.path.join(tmp, "corpus", "pdb", f"fam{i % DATA_FAMILIES}_s{i}.pdb")
        text = open(path).read()
        nat, py = pdb.parse_pdb(text), pdb.parse_pdb(text, prefer_native=False)
        same = same and set(nat) == set(py) and all(
            len(nat[c]) == len(py[c]) and all(
                (a.resseq, a.icode, a.resname) == (b.resseq, b.icode, b.resname)
                and (a.atom_mask == b.atom_mask).all() for a, b in zip(nat[c], py[c]))
            for c in nat)
        for c in nat:
            for a, b in zip(nat[c], py[c]):
                d_xyz = max(d_xyz, float(abs(a.xyz - b.xyz).max()))
        cx = antibody.from_chains(nat, "H", "L", ["A"], keep_fv_only=True)
        g_n = geometry.backbone_geometry(cx.xyz, cx.atom_mask, cx.chain_idx)
        g_p = geometry.backbone_geometry(cx.xyz, cx.atom_mask, cx.chain_idx, prefer_native=False)
        same = same and bool((g_n[2] == g_p[2]).all())
        d_geom = max(d_geom, *(float(abs(a - b).max()) for a, b in zip(g_n[:2], g_p[:2])))
    ok = same and d_xyz <= 1e-4 and d_geom <= 1e-5
    print(f"{tag} C++ vs Python on 16 PDBs: parser max|d xyz| {d_xyz:.2e} (tol 1e-4), the "
          f"rest equal {same}; featurizer max|d| {d_geom:.2e} (tol 1e-5); "
          f"{time.perf_counter() - t0:.2f} s; {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{tag} the C++ parser or featurizer disagrees with Python")
    return patches, n / wall


def data_train(torch, card, patches, tmp, pool):
    """[data] 4: `cli.train --production --max-steps 14` on the card through
    its main(), through the loader (pool False) or with --device-pool.
    Returns ((K1, K2) launches of the training steps, steps/s, the
    checkpoint directory, the recorded calls)."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import train as train_cli
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    path = "device pool" if pool else "loader"
    tag = f"[data] train ({path})"
    ck = os.path.join(tmp, "ck_pool" if pool else "ck_loader")
    argv = ["--data-dir", patches, "--production", "--max-steps", str(DATA_STEPS),
            "--checkpoint-dir", ck] + (["--device-pool"] if pool else [])
    rec, pool_rec = StepRecorder(DiffAb.train_step), []
    real_pool_step = DiffAb.pool_train_step

    def pool_step(self, state, pool_batch, idx, draws):
        pool_rec.append((pool_batch, idx))
        return real_pool_step(self, state, pool_batch, idx, draws)
    log = io.StringIO()
    try:
        DiffAb.train_step = lambda self, *a: rec(self, *a)
        DiffAb.pool_train_step = pool_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    finally:
        DiffAb.train_step, DiffAb.pool_train_step = rec.fn, real_pool_step
    for line in log.getvalue().splitlines():
        if line.startswith(("[train]", "[trainer]")):
            print(f"{tag} {line}")
    calls = rec.calls
    # steps/s over the steps after the first epoch's validation pass (entry
    # times of steps 7..13), as [train] times steps after a warm-up
    w0 = DATA_STEPS - DATA_WINDOW
    steps_per_s = (DATA_WINDOW - 1) / (calls[-1]["t"] - calls[w0]["t"])
    steps = (sum(c["launches"][0] for c in calls), sum(c["launches"][1] for c in calls))
    pcfg = C.production_config()
    n_layers, pb = pcfg.model.n_ipa_layers, pcfg.train.batch_size
    n_val = int(DATA_FAMILIES * DATA_PER_FAMILY * pcfg.train.val_pct)
    steps_per_epoch = (DATA_FAMILIES * DATA_PER_FAMILY - n_val) // pb
    n_evals = DATA_STEPS // steps_per_epoch  # one validation batch of n_val each
    losses = [float(c["loss"]) for c in calls]
    pool_batch = pool_rec[0][0] if pool_rec else None
    pool_mb = (sum(v.nbytes for v in pool_batch.to_numpy().values() if v is not None) / 1e6
               if pool_rec else 0.0)
    saved = ckpt.load_model_config(ck)
    checks = {
        "rc": rc == 0,
        "steps": len(calls) == DATA_STEPS and ckpt.all_steps(ck) == [DATA_STEPS],
        "model_config": saved == pcfg.model,
        "losses_finite": all(map(math.isfinite, losses)),
        "launches": steps == (n_layers * DATA_STEPS, 0)
        and total == (n_layers * (DATA_STEPS + n_evals), 0),
        "pool_rows": not pool or pool_batch.batch_size == DATA_FAMILIES * DATA_PER_FAMILY - n_val,
    }
    print(f"{tag}: cli.train {' '.join(argv[2:])}: wall {wall:.2f} s; steps {DATA_STEPS}, "
          f"{steps_per_s:.3f} steps/s, {steps_per_s * pb:.1f} samples/s over steps "
          f"{w0}-{DATA_STEPS - 1} (host clock, card: {card}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
          + (f"; pool on the card {pool_mb:.2f} MB ({pool_batch.batch_size} rows, "
             f"{pool_mb * 1e3 / pool_batch.batch_size:.1f} KB a patch)" if pool_rec else ""))
    print(f"{tag}: launches K1, K2: training steps {steps}, whole CLI {total} (expected "
          f"{(n_layers * DATA_STEPS, 0)}, and {n_evals} validation passes: "
          f"{(n_layers * (DATA_STEPS + n_evals), 0)}); losses {[round(v, 6) for v in losses]}")
    print(f"{tag}: checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} failed a check: {checks}")
    return steps, steps_per_s, ck, calls, pool_rec[-1] if pool_rec else None


def data_fuse_false(torch, patches):
    """[data] 5: three device-pool steps through fit() at
    fuse_ipa_layer=False (cli.train has no such flag, as in JAX): K2 at 6
    launches a step, K1 none."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.train.harness import DiffAb
    from diffab_pytorch_tpu_torch.train.trainer import fit

    pcfg = C.production_config()
    cfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, fuse_ipa_layer=False))
    ds = PatchDataset.from_dir(patches, cache=True)
    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
    state = fit(DiffAb(cfg), ds, max_steps=3, device_pool=True, logger=RecordingLogger("x"))
    torch.cuda.synchronize()
    got = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    want = (0, 3 * cfg.model.n_ipa_layers)
    ok = got == want and state.step == 3 and all(
        bool(torch.isfinite(v).all()) for v in state.params.values())
    print(f"[data] fit(device_pool=True) at fuse_ipa_layer=False: 3 steps, launches K1, K2 "
          f"{got} (expected {want}); {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("[data] the attention-core training path failed")
    return got


def data_sample(torch, card, patches, ck, tmp):
    """[data] 6: `cli.sample -n 16` on the card from the trained checkpoint:
    the recorded production model restores and the designs are written."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    cfg = C.production_config()
    patch = os.path.join(patches, sorted(os.listdir(patches))[0])
    out = os.path.join(tmp, "designs")
    argv = ["--patch", patch, "--checkpoint-dir", ck, "-n", "16", "-o", out]
    log = io.StringIO()
    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = sample_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    lines = log.getvalue().splitlines()
    names = sorted(f for f in os.listdir(out) if f.endswith(".pdb"))
    checks = {"rc": rc == 0, "recorded_model": any("recorded model config" in s for s in lines),
              "restored": any(f"restored checkpoint at step {DATA_STEPS}" in s for s in lines),
              "designs": names == [f"design_{i:04d}.pdb" for i in range(16)],
              "launches": got == (cfg.model.n_ipa_layers * cfg.diffusion.T, 0)}
    print(f"[data] cli.sample --patch {os.path.basename(patch)} -n 16 from the trained "
          f"checkpoint: wall {wall:.2f} s (card: {card}); launches K1, K2 {got}; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"[data] sampling from the trained checkpoint failed: {checks}")
    return got


def data_card_vs_cpu(torch, patches):
    """[data] 7: (a) pool_train_step against train_step on the gathered rows
    on the card (production_config(), 32 rows): the gathered batch equals
    the host rows; the loss and metrics are equal (the forward, kernels
    included, is deterministic on the card); the gradients agree within
    1e-6 of each leaf's scale (max |g|, at least 1): on the card they vary
    run to run in their last bits (train_step against itself, printed), so
    they are held to a bound a thousand times tighter than the card-vs-CPU
    rule, not to equality;
    (b) two device-pool steps on the card against the CPU plain path, each
    step's loss and gradients with the same injected draws (tiny_config()
    float32 with mode dropout, 4 rows of the corpus), within
    e2e_train_check's tolerances: 1e-4 of the loss, 1e-3 of each gradient
    leaf's largest entry; (c) the loader's card batches equal the host
    batches, checked as they arrive and again after the last one."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.dataset import PatchDataset
    from diffab_pytorch_tpu_torch.data.loader import PrefetchLoader
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag = "[data]"
    ds = PatchDataset.from_dir(patches, cache=True)
    host_pool, _ = ds.device_pool()
    pool = host_pool.to("cuda")
    fields = [f.name for f in dataclasses.fields(host_pool) if getattr(host_pool, f.name)
              is not None]

    # (a) the pool step is the plain step on its rows
    harness = DiffAb(C.production_config())
    idx = torch.randperm(host_pool.batch_size, generator=torch.Generator().manual_seed(0))[:32]
    idx = idx.cuda()
    rows = pool.gather_rows(idx)
    rows_equal = all(torch.equal(getattr(rows, f).cpu(), getattr(host_pool, f)[idx.cpu()])
                     for f in fields)
    draws = harness.draw(rows, torch.Generator(device="cuda").manual_seed(3))

    def after(step):
        state, metrics = step(harness.init(0))
        return ({k: v.clone() for k, v in state.opt_state.mu.items()},
                {k: float(v) for k, v in metrics.items()})
    # the first step of the production warmup has lr 0, so the first moment
    # (1 - beta1) x gradient carries what the step computed
    rel = lambda a, b: max(float((a[0][k] - b[0][k]).abs().max()
                                 / b[0][k].abs().max().clamp(min=1.0)) for k in b[0])
    pooled = after(lambda s: harness.pool_train_step(s, pool, idx, draws))
    plains = [after(lambda s: harness.train_step(s, rows, draws)) for _ in range(3)]
    d_pool = rel(pooled, plains[0])
    d_rerun = max(rel(p, plains[0]) for p in plains[1:])
    ok_a = (rows_equal and pooled[1] == plains[0][1] and all(p[1] == plains[0][1] for p in plains)
            and d_pool <= 1e-6)
    print(f"{tag} pool_train_step vs train_step on its rows, card, production_config (b=32): "
          f"gathered rows equal the host rows {rows_equal}; loss and metrics equal "
          f"{pooled[1] == plains[0][1]} (loss {pooled[1]['train/loss']:.6f}); gradients "
          f"max|d| / scale {d_pool:.2e} (tol 1e-6); train_step against itself, 2 reruns: "
          f"metrics equal {all(p[1] == plains[0][1] for p in plains)}, gradients {d_rerun:.2e} "
          f"(the step's own run-to-run variation); {'ok' if ok_a else 'FAILED'}")

    # (b) two pool steps, card vs CPU
    tiny = C.tiny_config()
    tcfg = dataclasses.replace(tiny, train=dataclasses.replace(tiny.train, mode_dropout=0.3))
    h_cpu, h_card = DiffAb(tcfg, device="cpu"), DiffAb(tcfg, device="cuda")
    s_cpu, s_card = h_cpu.init(0), h_card.init(0)
    g = torch.Generator().manual_seed(4)
    ok_b = True
    for step in range(2):
        sel = torch.arange(4 * step, 4 * step + 4)
        d = h_cpu.draw(host_pool.gather_rows(sel), g)
        l_cpu, _, g_cpu = h_cpu.loss_and_grads(s_cpu.params, host_pool.gather_rows(sel), d)
        l_card, _, g_card = h_card.loss_and_grads(s_card.params, pool.gather_rows(sel.cuda()),
                                                  d.to("cuda"))
        rel = max(((g_card[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1.0)).item()
                  for k, v in g_cpu.items())
        d_loss = abs(l_card.item() - l_cpu.item())
        ok_s = d_loss <= 1e-4 * max(1.0, abs(l_cpu.item())) and rel <= 1e-3
        ok_b = ok_b and ok_s
        print(f"{tag} pool step {step + 1} card vs CPU, tiny_config f32, rows {sel.tolist()}: "
              f"loss {l_card.item():.6f} vs {l_cpu.item():.6f}, max gradient |d| / scale "
              f"{rel:.2e} (tol 1e-3); {'ok' if ok_s else 'FAILED'}")
        s_cpu, s_card = h_cpu.apply_gradients(s_cpu, g_cpu), h_card.apply_gradients(s_card,
                                                                                       g_card)

    # (c) the loader's card batches
    host = list(ds.batches(32, seed=1, epochs=1))
    loader = PrefetchLoader(ds.batches(32, seed=1, epochs=1), "cuda", prefetch=2)
    got = []
    for (b, _), (h, _) in zip(loader, host):
        torch.matmul(b.xyz.flatten(1), b.xyz.flatten(1).T)  # a step's work on the batch
        got.append(b)
    loader.close()
    same_now = len(got) == len(host) and all(
        torch.equal(getattr(b, f).cpu(), getattr(h, f)) for b, (h, _) in zip(got, host)
        for f in fields)
    torch.cuda.synchronize()
    same_later = all(torch.equal(getattr(b, f).cpu(), getattr(h, f))
                     for b, (h, _) in zip(got, host) for f in fields)
    ok_c = same_now and same_later
    print(f"{tag} PrefetchLoader card batches vs host batches: {len(got)} batches of 32, "
          f"equal {same_now}, still equal after the last {same_later}; "
          f"{'ok' if ok_c else 'FAILED'}")
    if not (ok_a and ok_b and ok_c):
        raise RuntimeError(f"{tag} a card-vs-CPU check failed")


def data_phase(torch, card, tmp=None):
    """[data]: the training data path on the card, from PDBs to designs (see
    data_corpus, data_train, data_fuse_false, data_sample and
    data_card_vs_cpu), in the directory `tmp` (default a temporary one;
    the patches stay in <tmp>/patches).  Returns ({path: (K1, K2)
    launches}, {pool: steps/s})."""
    import contextlib
    import tempfile

    from diffab_pytorch_tpu_torch.config import production_config
    from diffab_pytorch_tpu_torch.data.dataset import PatchDataset

    laps = [time.perf_counter()]
    launches = {}
    with (tempfile.TemporaryDirectory() if tmp is None else contextlib.nullcontext(tmp)) as tmp:
        patches, _ = data_corpus(tmp)
        laps.append(time.perf_counter())
        rates, calls, busy = {}, {}, {}
        for pool in (False, True):
            key = "data_pool" if pool else "data_loader"
            launches[key], rates[pool], ck, calls[pool], pool_call = data_train(
                torch, card, patches, tmp, pool)
            harness, state, batch, draws = calls[pool][-1]["args"]
            if pool:
                pool_batch, idx = pool_call
                step = lambda: harness.pool_train_step(state, pool_batch, idx, draws)
            else:
                ck_loader = ck
                step = lambda: harness.train_step(state, batch, draws)
            busy[pool] = profile_device(
                torch, step, 1.0 / rates[pool], f"[data] one production training step "
                f"({'pool_train_step' if pool else 'train_step on a loader batch'}; wall from "
                f"the loop's rate)")
        # the data path's own device work (CUDA events, calls queued
        # behind a sleep): a pinned batch's copy (loader), the row gather
        # (pool)
        host_batch, _ = next(PatchDataset.from_dir(patches).batches(
            production_config().train.batch_size, seed=0))
        pinned = host_batch.pin_memory()
        batch_mb = sum(v.nbytes for v in host_batch.to_numpy().values() if v is not None) / 1e6
        copy_ms = cuda_time_ms(lambda: pinned.to("cuda", non_blocking=True), 20)
        gather_ms = cuda_time_ms(lambda: pool_batch.gather_rows(idx), 20)
        print(f"[data] the data path's device time: one batch's pinned host-to-card copy "
              f"{copy_ms:.4f} ms ({batch_mb:.2f} MB), one step's row gather {gather_ms:.4f} ms"
              + ("" if None in busy.values() else
                 f"; against a step's {busy[False]:.1f} / {busy[True]:.1f} ms: "
                 f"{copy_ms / busy[False]:.2%} (the loader issues it on its own stream) / "
                 f"{gather_ms / busy[True]:.2%}"))
        # both paths run the same seeded shuffle over the same usable rows,
        # so step by step they must train on the same batch
        same_rows = all(all(bool(x == y) for x, y in zip(a["rows"], b["rows"]))
                        for a, b in zip(calls[False], calls[True]))
        d_loss = max(abs(float(a["loss"]) - float(b["loss"]))
                     for a, b in zip(calls[False], calls[True]))
        print(f"[data] loader and device-pool runs: the same rows at every step {same_rows} "
              f"(checksums of each step's batch on the card); losses max|d| {d_loss:.3e} (the "
              f"same draws; a difference is the step's own run-to-run variation)")
        if not same_rows:
            raise RuntimeError("[data] the loader and the device pool fed different rows")
        laps.append(time.perf_counter())
        launches["data_fuse_false"] = data_fuse_false(torch, patches)
        launches["data_sample"] = data_sample(torch, card, patches, ck_loader, tmp)
        laps.append(time.perf_counter())
        data_card_vs_cpu(torch, patches)
        laps.append(time.perf_counter())
    pb = production_config().train.batch_size
    print(f"[data] training steps/s: loader {rates[False]:.3f} ({rates[False] * pb:.1f} "
          f"samples/s), device pool {rates[True]:.3f} ({rates[True] * pb:.1f} samples/s) "
          f"(card: {card})")
    corpus_s, train_s, rest_s, check_s = (b - a for a, b in zip(laps, laps[1:]))
    print(f"[data] phase {laps[-1] - laps[0]:.2f} s: corpus and preprocessing {corpus_s:.2f} s, "
          f"the two cli.train runs and profiles {train_s:.2f} s, fuse False and cli.sample "
          f"{rest_s:.2f} s, card-vs-CPU checks {check_s:.2f} s")
    return launches, rates


SC_VARIANTS = {"early": {}, "geometry-only": dict(self_conditioning_sequence=False),
               "late": dict(sc_late_fusion=True), "split": dict(sc_split_trunk=True)}
SC_CLI_STEPS = 8  # cli.train steps of [selfcond] 4 (onset 2, warm-up 4: the ramp ends at 6)


def sc_model_fields(variant):
    """The ModelConfig fields of a self-conditioning variant."""
    return dict(self_conditioning=True, **SC_VARIANTS[variant])


def sc_agree(torch, card, ref, other, factor):
    """The e2e rule on lists of tensors: the largest and the mean of
    |card - ref| must be at most `factor` times those of |other - ref|,
    each tensor's deviations divided by its largest |ref| (at least 1).
    Returns (passed, max and mean of the card's, of the other's)."""
    def dev(xs):
        return torch.cat([((x.float().cpu() - r.float().cpu()).abs()
                           / r.float().abs().max().clamp(min=1.0)).flatten()
                          for x, r in zip(xs, ref)])
    d_card, d_other = dev(card), dev(other)
    ok = bool(torch.isfinite(d_card).all() and d_card.max() <= factor * d_other.max()
              and d_card.mean() <= factor * d_other.mean())
    return ok, (d_card.max().item(), d_card.mean().item(), d_other.max().item(),
                d_other.mean().item())


def selfcond_card_vs_cpu(torch, L=32, T=12):
    """[selfcond] 1: each self-conditioning variant (early, geometry-only,
    late, split) at tiny_config() widths, card against the CPU plain path
    of the same flag, for both kernel flags (None: K1, False: K2) in
    float32 and bf16, each card run's
    launches asserted first: a forward with an estimate and a mixed
    per-residue flag (b = 4, L = 32), the same with an estimate |x0| ~ 1e4
    (finite); the two-pass loss with all gradients under mode dropout,
    per sample and per residue, the same injected StepDraws; a 5-step
    heun chain (2 designs of one target, sc_t_max = 8 of T = 12) with the
    same injected draws.  Tolerances, as the e2e checks: float32 losses
    1e-4 of the loss and 1e-3 of each gradient's scale, float32 chains
    sequences equal and 1e-3 on coordinates and frames, float32 forwards
    within 1/64 of the CPU bf16-float32 distance; in bf16 every output
    within 2x that distance (largest and mean).  bf16 chains generate the
    structure only (fix-sequence): one categorical draw that flips on a
    last-bit difference parts two codesign chains."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import (InitNoise, StepNoise, sample,
                                                          timestep_schedule)
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag = "[selfcond]"
    t0 = time.perf_counter()
    tiny = C.tiny_config()
    b, bn = 4, 2
    batch = synthetic_batch(5, b, L, n_generate=8)
    target = synthetic_batch(6, 1, L, n_generate=8)
    g = torch.Generator().manual_seed(7)
    x_t = batch.translations + 0.3 * torch.randn(b, L, 3, generator=g)
    beta = torch.linspace(0.05, 0.9, b)
    est = dict(sc_translations_x0=batch.translations + torch.randn(b, L, 3, generator=g),
               sc_seq_probs=torch.softmax(torch.randn(b, L, 21, generator=g), dim=-1),
               sc_mask=(torch.rand(b, L, generator=g) < 0.6).float())
    huge = dict(est, sc_translations_x0=batch.translations + 1e4)
    # mode draws: fix-structure, fix-sequence, codesign, codesign (p = 0.3)
    mode_u = torch.tensor([0.1, 0.45, 0.8, 0.9])
    sc_u = {"per sample": torch.tensor([0.2, 0.7, 0.1, 0.6]),
            "per residue": torch.rand(b, L, generator=g)}
    opts = dict(n_steps=5, coord_solver="heun", coord_solver_t_min=2, sc_t_max=8)
    t_seq = timestep_schedule(T, opts["n_steps"]).tolist()
    init = InitNoise(seq=torch.randint(0, 21, (bn, L), generator=g),
                     coord=torch.randn(bn, L, 3, generator=g),
                     rot_prior=torch.randn(bn, L, 4, generator=g))
    noise = {t: StepNoise(gumbel=-torch.log(-torch.log(torch.rand(bn, L, 21, generator=g))),
                          coord=torch.randn(bn, L, 3, generator=g),
                          orientation=AxisAngleNoise.draw((bn, L), g)) for t in t_seq}

    def to(x, dev):
        if x is None or isinstance(x, (int, float)):
            return x
        if isinstance(x, tuple):
            return type(x)(*(to(a, dev) for a in x))
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        return x.to(dev)

    def run(h, chains):
        """Every output of harness h, and the (K1, K2) launches of each."""
        dev = h.device.type
        params = h.init(0).params
        m, bd = h.model, batch.to(dev)
        outs, counts = {}, {}

        def counted(name, fn):
            before = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
            outs[name] = [x.detach() for x in fn()]
            if dev == "cuda":
                torch.cuda.synchronize()
            counts[name] = (op.fused_ipa_layer_packed.launches - before[0],
                            k2.ipa_attention_core.launches - before[1])

        for name, sc in (("forward", est), ("huge", huge)):
            with torch.no_grad():
                counted(name, lambda: m(bd, bd.seq_idx, x_t.to(dev), bd.orientations,
                                        beta.to(dev), **to(sc, dev)).values())
        for how, u in sc_u.items():
            draws = h.draw(batch, torch.Generator().manual_seed(8))._replace(mode_u=mode_u,
                                                                              sc_u=u)

            def loss():
                l_, _, grads = h.loss_and_grads(params, bd, to(draws, dev))
                return [l_] + [grads[k] for k in sorted(grads)]
            counted(f"loss {how}", loss)
        for gen_seq in chains:
            counted(f"chain {'codesign' if gen_seq else 'fix-sequence'}", lambda: sample(
                m, h.sched, h.orientation_tables, target, device=dev, n_designs=bn,
                init_noise=to(init, dev), step_noise=lambda t: to(noise[t], dev),
                generate_sequence=gen_seq, **opts)[:3])
        return outs, counts

    n_checks = 0
    for variant in SC_VARIANTS:
        cfgs = {}
        for dt in ("float32", "bfloat16"):
            for fuse in (None, False):
                mcfg = dataclasses.replace(tiny.model, compute_dtype=dt, fuse_ipa_layer=fuse,
                                           **sc_model_fields(variant))
                cfgs[dt, fuse] = dataclasses.replace(
                    tiny, model=mcfg, diffusion=C.DiffusionConfig(T=T, igso3_n_bins=256,
                                                                  igso3_n_terms=128),
                    train=dataclasses.replace(tiny.train, mode_dropout=0.3))
        cpu = {key: run(DiffAb(cfg, device="cpu"),
                        (True, False) if key[0] == "float32" else (False,))[0]
               for key, cfg in cfgs.items()}
        for (dt, fuse), cfg in cfgs.items():
            mcfg = cfg.model
            want_n = {"forward": layer_calls(mcfg), "huge": layer_calls(mcfg),
                      "loss per sample": layer_calls(mcfg, 2),
                      "loss per residue": layer_calls(mcfg, 2),
                      "chain": layer_calls(mcfg, denoiser_calls(t_seq, opts))}
            bf16 = dt == "bfloat16"
            outs, counts = run(DiffAb(cfg, device="cuda"), (not bf16,))
            for name, got in counts.items():
                n = want_n[name.split(" ")[0] if name.startswith("chain") else name]
                want = (n, 0) if fuse is None else (0, n)
                if got != want:
                    raise RuntimeError(f"{tag} {variant} {dt} fuse_ipa_layer={fuse} {name}: "
                                       f"launches K1, K2 {got}, expected {want}")
            ref, other = ((cpu["bfloat16", fuse], cpu["float32", fuse]) if bf16
                          else (cpu["float32", fuse], cpu["bfloat16", fuse]))
            results = {}
            for name, card in outs.items():
                if bf16:
                    results[name] = sc_agree(torch, card, ref[name], other[name], 2.0)
                elif name.startswith("chain"):
                    seq, x, r = (a.cpu() for a in card)
                    d = max((x - ref[name][1]).abs().max().item(),
                            (r - ref[name][2]).abs().max().item())
                    results[name] = (torch.equal(seq, ref[name][0]) and d <= 1e-3, (d,))
                elif name.startswith("loss"):
                    l_c, l_r = card[0].item(), ref[name][0].item()
                    rel = max(((c.cpu() - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
                              for c, r in zip(card[1:], ref[name][1:]))
                    d = abs(l_c - l_r)
                    results[name] = (d <= 1e-4 * max(1.0, abs(l_r)) and rel <= 1e-3, (d, rel))
                else:
                    results[name] = sc_agree(torch, card, ref[name], other[name], 1 / 64)
                n_checks += 1
            ok = all(r[0] for r in results.values())
            print(f"{tag} {variant} {dt} fuse_ipa_layer={fuse}: launches K1, K2 "
                  + ", ".join(f"{k} {v}" for k, v in counts.items()) + "; "
                  + "; ".join(f"{k} {'ok' if r[0] else 'FAILED'} "
                              + "/".join(f"{v:.2e}" for v in r[1]) for k, r in results.items()))
            if not ok:
                raise RuntimeError(f"{tag} {variant} {dt} fuse_ipa_layer={fuse}: the card "
                                   f"disagrees with the CPU plain path")
    print(f"{tag} card vs CPU: {n_checks} checks of 4 variants x 2 flags x 2 dtypes passed in "
          f"{time.perf_counter() - t0:.2f} s (float32 numbers: max|d| or loss |d| / gradient "
          f"|d| / scale; bf16 and float32 forwards: card max/mean, CPU bf16-float32 max/mean, "
          f"relative to scale)")


def selfcond_cli(torch, card, patches, tmp):
    """[selfcond] 4: `cli.train --production --self-conditioning
    --sc-split-trunk --sc-onset 2 --sc-rate-warmup 4 --max-steps 8` on
    [data]'s patches through its main() (a StepRecorder counts K1 per
    step: 24, and 24 for the validation batch), then `cli.sample -n 16`
    from that checkpoint (K1 1,200).  Returns {path: (K1, K2)}."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli
    from diffab_pytorch_tpu_torch.cli import train as train_cli
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag = "[selfcond] cli"
    ck = os.path.join(tmp, "ck_selfcond")
    argv = ["--data-dir", patches, "--production", "--self-conditioning", "--sc-split-trunk",
            "--sc-onset", "2", "--sc-rate-warmup", "4", "--max-steps", str(SC_CLI_STEPS),
            "--checkpoint-dir", ck]
    rec = StepRecorder(DiffAb.train_step)
    log = io.StringIO()
    try:
        DiffAb.train_step = lambda self, *a: rec(self, *a)
        torch.cuda.synchronize()
        op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    finally:
        DiffAb.train_step = rec.fn
    for line in log.getvalue().splitlines():
        if line.startswith(("[train]", "[trainer]")):
            print(f"{tag} {line}")
    pcfg = C.production_config()
    want_model = dataclasses.replace(pcfg.model, **sc_model_fields("split"))
    per_step = layer_calls(want_model, 2)
    n_val = int(DATA_FAMILIES * DATA_PER_FAMILY * pcfg.train.val_pct)
    n_evals = SC_CLI_STEPS // ((DATA_FAMILIES * DATA_PER_FAMILY - n_val) // pcfg.train.batch_size)
    steps = tuple(sum(c["launches"][i] for c in rec.calls) for i in range(2))
    losses = [float(c["loss"]) for c in rec.calls]
    harness = rec.calls[0]["args"][0] if rec.calls else None
    rates = [harness.sc_rate_at(s) for s in range(SC_CLI_STEPS)] if harness else []
    saved = ckpt.load_model_config(ck)
    checks = {
        "rc": rc == 0,
        "steps": len(rec.calls) == SC_CLI_STEPS and ckpt.all_steps(ck) == [SC_CLI_STEPS],
        "model_config": saved == want_model,
        "losses_finite": all(map(math.isfinite, losses)),
        "launches": all(c["launches"] == (per_step, 0) for c in rec.calls)
        and total == (per_step * (SC_CLI_STEPS + n_evals), 0),
        "schedule": rates == [0.0, 0.0, 0.0, 0.125, 0.25, 0.375, 0.5, 0.5],
    }
    print(f"{tag} train {' '.join(argv[2:])}: wall {wall:.2f} s (card: {card}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches K1, K2: steps {steps} "
          f"({per_step} a step), whole CLI {total} (with {n_evals} validation batch); sc rate by "
          f"step {rates}; losses {[round(v, 4) for v in losses]}; model_config.json "
          f"self_conditioning={saved.self_conditioning} sc_split_trunk={saved.sc_split_trunk}; "
          f"checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} cli.train --self-conditioning failed a check: {checks}")

    patch = os.path.join(patches, sorted(os.listdir(patches))[0])
    out = os.path.join(tmp, "designs_selfcond")
    sargv = ["--patch", patch, "--checkpoint-dir", ck, "-n", "16", "-o", out]
    log = io.StringIO()
    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = sample_cli.main(sargv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches)
    lines = log.getvalue().splitlines()
    names = sorted(f for f in os.listdir(out) if f.endswith(".pdb"))
    checks = {"rc": rc == 0,
              "self_conditioning": any("recorded model config (self-conditioning)" in x
                                       for x in lines),
              "designs": names == [f"design_{i:04d}.pdb" for i in range(16)],
              "launches": got == (layer_calls(want_model, pcfg.diffusion.T), 0)}
    print(f"{tag} sample -n 16 from that checkpoint: wall {wall:.2f} s (card: {card}); "
          f"launches K1, K2 {got}; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} cli.sample from the self-conditioned checkpoint failed: "
                           f"{checks}")
    return {"selfcond_cli_train": steps, "selfcond_cli_sample": got}


def selfcond_phase(torch, card, patches, tmp, train_rate, designs_rate):
    """[selfcond]: self-conditioning on the card.  1: every variant card vs
    CPU at tiny widths (selfcond_card_vs_cpu); 2: production_config()
    training with early fusion and with the split trunk (3 + 20 fit()
    steps on [train]'s batch; K1 12 and 24 a step), and 1 + 4 split-trunk
    steps at fuse_ipa_layer=False (K2 24 a step); 3: the [main] sampling
    path with a self-conditioned default_config() in bf16, early and split
    (K1 600 and 1,200 a call); 4: cli.train and cli.sample (selfcond_cli).
    Steps/s and designs/s are printed against the plain path run just
    before them, and against this run's earlier [train] (K1) steps/s and
    [main] designs/s (train_rate, designs_rate).  Returns {path: (K1, K2)}."""
    laps = [time.perf_counter()]
    selfcond_card_vs_cpu(torch)
    laps.append(time.perf_counter())
    # each path beside its plain counterpart run just before it: the host's
    # speed drifts over a run, so [train] and [main] from minutes earlier
    # are no reference for a ratio
    launches, train_rates, sample_rates = {}, {}, {}
    launches["selfcond_plain_train"], train_rates["plain"] = training_main_path(
        torch, card, "[selfcond] train plain", None, L_MAIN, 3, 20, profile=False)
    for variant in ("early", "split"):
        launches[f"selfcond_train_{variant}"], train_rates[variant] = training_main_path(
            torch, card, f"[selfcond] train {variant}", None, L_MAIN, 3, 20,
            model=sc_model_fields(variant))
    # the attention-core kernel at the split trunk's call pattern (K2 24 a step)
    launches["selfcond_train_split_fuse_False"], _ = training_main_path(
        torch, card, "[selfcond] train split", False, L_MAIN, 1, 4, profile=False,
        model=sc_model_fields("split"))
    laps.append(time.perf_counter())
    launches["selfcond_plain_sample"], sample_rates["plain"] = sampling_main_path(
        torch, card, "bfloat16", 2, "[selfcond] sample plain")
    for variant in ("early", "split"):
        launches[f"selfcond_sample_{variant}"], sample_rates[variant] = sampling_main_path(
            torch, card, "bfloat16", 2, f"[selfcond] sample {variant}",
            model=sc_model_fields(variant))
    laps.append(time.perf_counter())
    launches.update(selfcond_cli(torch, card, patches, tmp))
    laps.append(time.perf_counter())
    def ratios(rates, earlier):
        return ", ".join(
            f"{v} {rates[v]:.3f} ({rates[v] / rates['plain']:.3f}x the plain run before it, "
            f"{rates[v] / earlier:.3f}x the earlier phase's)" for v in ("early", "split"))
    print(f"[selfcond] training steps/s (production_config(), batch 32, L=128): plain "
          f"{train_rates['plain']:.3f} ([train] earlier {train_rate:.3f}), "
          f"{ratios(train_rates, train_rate)}; designs/s (128 designs, T=100, bf16): plain "
          f"{sample_rates['plain']:.3f} ([main] earlier {designs_rate:.3f}), "
          f"{ratios(sample_rates, designs_rate)} (card: {card})")
    parts = ("card vs CPU", "training", "sampling", "the CLIs")
    print(f"[selfcond] phase {laps[-1] - laps[0]:.2f} s: " + ", ".join(
        f"{p} {b_ - a:.2f} s" for p, a, b_ in zip(parts, laps, laps[1:])))
    return launches


def kernel_times(torch, card, pb):
    """Per-launch times at L = 128, the main paths' shapes (b = 128, bp = 1
    and b = bp = pb): K1 in bf16 (also host-paced, and its two launches
    apart by the profiler) and float32, K2 in both dtypes, each beside its
    plain version and its bound; K1 is held to its plain version at
    b = 128 first.  Returns (K1 bf16 times, K1 float32 times, K2 times,
    K1 bf16 error, K1 float32 error)."""
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    main_shape = dict(L=L_MAIN, d=128, h=8, ds=32, p=8)
    att_shape = dict(L=L_MAIN, h=8, ds=32, p=8)
    k1_times = {}
    for label, b, bp, seed in (("sample", N_DESIGNS, 1, 4), ("train", pb, pb, 6)):
        with torch.no_grad():
            a = layer_inputs(torch, b, bp, **main_shape, dtype=torch.bfloat16,
                             bias_dtype=torch.bfloat16, seed=seed, n_masked=0)
            if label == "sample":
                err_bf16 = check_layer(torch, "main bf16 (b=128 bp=1 L=128)", a, bf16=True)
            kern = lambda a=a: op.fused_ipa_layer_packed(**a)
            km = cuda_time_ms(kern, 20)
            pm = cuda_time_ms(lambda a=a: op.fused_ipa_layer_packed_reference(**a), 5)
            km2 = cuda_time_ms(kern, 20)
            host_paced = cuda_time_ms(kern, 20, queued=False)
            tl = device_timeline(torch, kern, 20, K1_LAUNCHES)
        fl, nb = ipa_layer_flops_bytes(b, bp, **main_shape, itemsize=2, bias_itemsize=2)
        bnd, by, t_o, t_b = bound_ms(fl, nb, "bfloat16")
        k1_times[label] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd, bound_by=by,
                               host_paced_ms=host_paced,
                               launch_ms=tl and {n: tl[n] for n in K1_LAUNCHES})
        print(f"[time] ipa_fused_layer b={b} bp={bp} L=128 bf16 ({label} shape) on {card}: "
              f"kernel {km:.4f} / {km2:.4f} ms (CUDA events, 20 calls queued behind a sleep), "
              f"{host_paced:.4f} ms issued call by call from the host (the earlier design's "
              f"method), "
              f"plain version {pm:.4f} ms, bound {bnd:.4f} ms ({fl / 1e9:.2f} GFLOP -> "
              f"{t_o:.4f} ms, {nb / 1e6:.2f} MB -> {t_b:.4f} ms; bound by {by}), "
              f"{bnd / min(km, km2):.3%} of bound")
        if tl is None:
            print(f"[time] ipa_fused_layer {label} shape, its launches: not measured "
                  f"(the profiler reported no device time)")
            continue
        print(f"[time] ipa_fused_layer {label} shape, profiler over 20 queued calls "
              f"({tl['calls_seen']} seen): " + ", ".join(
            f"{n} {'not measured' if tl[n] is None else f'{tl[n]:.4f} ms'}"
            for n in K1_LAUNCHES)
            + f"; {tl['events_per_call']:.2f} device events per call, {tl['kernels_ms']:.4f} ms "
            f"in all; card idle between them per call: " + ", ".join(
                f"before {k} {v:.4f} ms" for k, v in tl["idle_before_ms"].items()))
    print("[earlier] ipa_fused_layer b=128 bp=1 L=128 bf16: 0.7938 ms per call with the earlier "
          "CUDA-core design (PERF.md, K1 row; CUDA events, calls issued by the host)")

    # K1's float32 route (3xTF32), timed as bf16 above
    k1_f32 = {}
    for label, b, bp, seed in (("sample", N_DESIGNS, 1, 4), ("train", pb, pb, 6)):
        with torch.no_grad():
            a = layer_inputs(torch, b, bp, **main_shape, dtype=torch.float32,
                             bias_dtype=torch.float32, seed=seed, n_masked=0)
            if label == "sample":
                err_f32 = check_layer(torch, "main f32 (b=128 bp=1 L=128)", a, bf16=False)
            kern = lambda a=a: op.fused_ipa_layer_packed(**a)
            km = cuda_time_ms(kern, 20)
            pm = cuda_time_ms(lambda a=a: op.fused_ipa_layer_packed_reference(**a), 5)
            km2 = cuda_time_ms(kern, 20)
        fl, nb = ipa_layer_flops_bytes(b, bp, **main_shape, itemsize=4, bias_itemsize=4)
        bnd, by, t_o, t_b = bound_ms(fl, nb, "float32")
        k1_f32[label] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd, bound_by=by)
        print(f"[time] ipa_fused_layer b={b} bp={bp} L=128 f32 ({label} shape) on {card}: "
              f"kernel {km:.4f} / {km2:.4f} ms, plain version {pm:.4f} ms, bound {bnd:.4f} ms "
              f"({fl / 1e9:.2f} GFLOP at the 3xTF32 rate -> {t_o:.4f} ms, {nb / 1e6:.2f} MB -> "
              f"{t_b:.4f} ms; bound by {by}), {bnd / min(km, km2):.3%} of bound")
    print("[earlier] ipa_fused_layer L=128 f32 with the earlier CUDA-core design (three "
          "launches): 0.9785-0.9824 ms at b=128 bp=1 and 0.3148-0.3155 ms at b=bp=32 (PERF.md, "
          "K1 row; CUDA events, queued; H100 80GB HBM3, 700 W)")

    # K2 in both dtypes
    k2_times = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for label, b, bp in (("train", pb, pb), ("sample", N_DESIGNS, 1)):
            with torch.no_grad():
                aargs = attention_inputs(torch, b, bp, **att_shape, dtype=dtype,
                                         bias_dtype=dtype, seed=30 + b, n_masked=0)
                km = cuda_time_ms(lambda: k2.ipa_attention_core(**aargs), 20)
                pm = cuda_time_ms(lambda: k2.ipa_attention_core_reference(**aargs), 5)
                km2 = cuda_time_ms(lambda: k2.ipa_attention_core(**aargs), 20)
            fl, nb = attention_flops_bytes(b, bp, **att_shape, itemsize=dtype.itemsize,
                                           bias_itemsize=dtype.itemsize)
            bnd, by, t_o, t_b = bound_ms(fl, nb, dname)
            k2_times[(dname, label)] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd,
                                            bound_by=by)
            print(f"[time] ipa_attention b={b} bp={bp} L=128 {dname} ({label} shape) on {card}: "
                  f"kernel {km:.4f} / {km2:.4f} ms, plain version {pm:.4f} ms, bound "
                  f"{bnd:.4f} ms ({fl / 1e9:.2f} GFLOP -> {t_o:.4f} ms, {nb / 1e6:.2f} MB -> "
                  f"{t_b:.4f} ms; bound by {by}), {bnd / min(km, km2):.3%} of bound")
    print("[earlier] ipa_attention with the earlier CUDA-core design: bf16 0.1064-0.1071 ms at "
          "b=bp=32 and 0.4235-0.4263 ms at b=128 bp=1; float32 0.1152-0.1159 / 0.4263-0.4293 ms "
          "(PERF.md, K2 row; CUDA events, queued; H100 80GB HBM3, 700 W)")

    return k1_times, k1_f32, k2_times, err_bf16, err_f32


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.ops import _build
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.structure import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    native_lib = native.build()
    native_s = time.perf_counter() - t0
    build_s = _build.build_all()
    print(f"[build] kernels built in {build_s:.2f} s; the C++ parser and featurizer "
          f"({os.path.relpath(native_lib, HERE)}, from native/*.cpp) in {native_s:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for kernel, n in sass_counts(_build).items():
        print(f"[sass] {kernel}: {n} instructions")

    # ---- 3. kernel vs plain version ----------------------------------------
    main_shape = dict(L=L_MAIN, d=128, h=8, ds=32, p=8)
    att_shape = dict(L=L_MAIN, h=8, ds=32, p=8)
    with torch.no_grad():
        check_layer(torch, "tiny f32 (b=2 bp=1 L=24 d=32 h=4 ds=8 p=4)",
                    layer_inputs(torch, 2, 1, 24, 32, 4, 8, 4, torch.float32,
                                 torch.float32, 0, 5), bf16=False)
        err_f32 = check_layer(torch, "main f32 (b=8 bp=1 L=128)",
                              layer_inputs(torch, 8, 1, **main_shape, dtype=torch.float32,
                                           bias_dtype=torch.float32, seed=1, n_masked=16),
                              bf16=False)
        err_bf16 = check_layer(torch, "main bf16 (b=8 bp=1 L=128)",
                               layer_inputs(torch, 8, 1, **main_shape, dtype=torch.bfloat16,
                                            bias_dtype=torch.bfloat16, seed=2, n_masked=16),
                               bf16=True)
        check_layer(torch, "main bf16 with f32 bias (b=8 bp=2 L=128)",
                    layer_inputs(torch, 8, 2, **main_shape, dtype=torch.bfloat16,
                                 bias_dtype=torch.float32, seed=3, n_masked=0),
                    bf16=True)
        err_bf16 = max(err_bf16, check_layer(
            torch, "train bf16 (b=32 bp=32 L=128)",
            layer_inputs(torch, 32, 32, **main_shape, dtype=torch.bfloat16,
                         bias_dtype=torch.bfloat16, seed=5, n_masked=8), bf16=True))
        err_bf16 = max(err_bf16, check_layer(
            torch, "tiny bf16 (b=2 bp=1 L=24 d=32 h=4 ds=8 p=4)",
            layer_inputs(torch, 2, 1, 24, 32, 4, 8, 4, torch.bfloat16, torch.bfloat16, 7, 5),
            bf16=True))
        err_bf16 = max(err_bf16, check_layer(
            torch, "bf16 L=77 with f32 bias (b=8 bp=2)",
            layer_inputs(torch, 8, 2, 77, 128, 8, 32, 8, torch.bfloat16, torch.float32, 8, 9),
            bf16=True))
        # float32 at the tile edges: L % 8 != 0 with d % 4 != 0 (x read
        # element by element), the training shape, and the widest shape the
        # gate takes (ds + 3P = 64, P = 21) at narrow d and h
        err_f32 = max(err_f32, check_layer(
            torch, "f32 L=77 d=30 (b=8 bp=2 h=8 ds=32 p=8)",
            layer_inputs(torch, 8, 2, 77, 30, 8, 32, 8, torch.float32, torch.float32, 9, 9),
            bf16=False))
        err_f32 = max(err_f32, check_layer(
            torch, "train f32 (b=32 bp=32 L=128)",
            layer_inputs(torch, 32, 32, **main_shape, dtype=torch.float32,
                         bias_dtype=torch.float32, seed=18, n_masked=8), bf16=False))
        err_f32 = max(err_f32, check_layer(
            torch, "widest f32 (b=4 bp=1 L=128 d=20 h=2 ds=1 p=21)",
            layer_inputs(torch, 4, 1, 128, 20, 2, 1, 21, torch.float32, torch.float32, 19, 11),
            bf16=False))

        check_attention(torch, "K2 tiny f32 (b=2 bp=1 L=24 h=4 ds=8 p=4)",
                        attention_inputs(torch, 2, 1, 24, 4, 8, 4, torch.float32,
                                         torch.float32, 10, 5), 5, bf16=False)
        k2_err_f32 = check_attention(
            torch, "K2 main f32 (b=8 bp=2 L=128)",
            attention_inputs(torch, 8, 2, **att_shape, dtype=torch.float32,
                             bias_dtype=torch.float32, seed=11, n_masked=16), 16, bf16=False)
        k2_err_bf16 = check_attention(
            torch, "K2 train bf16 (b=32 bp=32 L=128)",
            attention_inputs(torch, 32, 32, **att_shape, dtype=torch.bfloat16,
                             bias_dtype=torch.bfloat16, seed=12, n_masked=8), 8, bf16=True)
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 sample bf16 (b=128 bp=1 L=128)",
            attention_inputs(torch, 128, 1, **att_shape, dtype=torch.bfloat16,
                             bias_dtype=torch.bfloat16, seed=13, n_masked=16), 16, bf16=True))
        check_attention(torch, "K2 bf16 with f32 bias (b=8 bp=2 L=128)",
                        attention_inputs(torch, 8, 2, **att_shape, dtype=torch.bfloat16,
                                         bias_dtype=torch.float32, seed=14, n_masked=0), 0,
                        bf16=True)
        # the tile edges: L below one 16-row tile of a warp, L % 8 != 0
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 tiny bf16 (b=2 bp=1 L=24 h=4 ds=8 p=4)",
            attention_inputs(torch, 2, 1, 24, 4, 8, 4, torch.bfloat16, torch.bfloat16, 15, 5),
            5, bf16=True))
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 bf16 L=77 with f32 bias (b=8 bp=2)",
            attention_inputs(torch, 8, 2, 77, 8, 32, 8, torch.bfloat16, torch.float32, 16, 9),
            9, bf16=True))
        k2_err_f32 = max(k2_err_f32, check_attention(
            torch, "K2 f32 L=77 (b=8 bp=2)",
            attention_inputs(torch, 8, 2, 77, 8, 32, 8, torch.float32, torch.float32, 17, 9),
            9, bf16=False))

    # autograd Functions (kernel forward, recomputed plain backward)
    la = layer_inputs(torch, 4, 4, **main_shape, dtype=torch.float32,
                      bias_dtype=torch.float32, seed=20, n_masked=8)
    shape = (la["wts"].n_head, la["wts"].d_scalar, la["wts"].n_point)
    layer_fn = lambda impl: (lambda x, wq, wo, g, bias, rot, trans, mask, st: impl(
        x, rot, trans, mask, op.LayerKernelWeights(wq, wo, g, *shape), bias, st))
    check_grads(torch, "K1 fused layer f32 (b=4 L=128)", layer_fn(op.fused_ipa_layer_packed),
                layer_fn(op.fused_ipa_layer_packed_reference),
                [la["x"], la["wts"].w_qkv, la["wts"].w_out, la["wts"].g, la["bias"]],
                (la["rot"], la["trans"], la["mask"], la["scale_total"]))
    aa = attention_inputs(torch, 4, 4, **att_shape, dtype=torch.float32,
                          bias_dtype=torch.float32, seed=21, n_masked=8)
    check_grads(torch, "K2 attention core f32 (b=4 L=128)", k2.ipa_attention_core,
                k2.ipa_attention_core_reference,
                [aa["q_aug"], aa["k_aug"], aa["v_s"], aa["v_p"], aa["bias"]],
                (aa["scale_total"],))

    # ---- 4. end to end on small inputs: card vs CPU ------------------------------
    check_e2e(torch, "bfloat16")
    check_e2e(torch, "float32")
    e2e_sample_check(torch, "[e2e-small]", 24, 8)
    e2e_train_check(torch, "[e2e-train]", 32)

    # ---- 5. sampling main path, bf16 then float32 --------------------------------------
    launches = {}
    launches["sample"], designs_per_s = sampling_main_path(torch, card, "bfloat16", 3, "[main]")
    launches["sample_f32"], designs_per_s_f32 = sampling_main_path(torch, card, "float32", 2,
                                                                   "[main-f32]")

    # ---- 6. training main path: production_config(), both flags -------------------
    n_warm, n_timed = 3, 20
    pb = C.production_config().train.batch_size
    train_rates = {}
    for fuse in (None, False):
        launches[f"train_fuse_{fuse}"], train_rates[fuse] = training_main_path(
            torch, card, "[train]", fuse, L_MAIN, n_warm, n_timed)

    # ---- 7. per-launch times at L = 128 ---------------------------------------------
    k1_times, k1_f32, k2_times, e_bf16, e_f32 = kernel_times(torch, card, pb)
    err_bf16, err_f32 = max(err_bf16, e_bf16), max(err_f32, e_f32)

    # ---- 8. patches longer than 128 residues ------------------------------------------
    err1_long, err2_long, long_times = long_patch_phase(torch, card)
    e2e_sample_check(torch, "[e2e-long]", 256, 4)
    e2e_train_check(torch, "[e2e-long]", 256)

    # ---- 9. the few-step recipes: card vs CPU on a short chain -------------------------
    for opts in (dict(init="chord", t_start=12, n_steps=6, n_fine_tail=2, noise_t_max=2,
                      orientation_reverse="posterior"),
                 dict(init="chord", chord_orientations=True, t_start=12, n_steps=5,
                      coord_solver="heun", coord_solver_t_min=3),
                 dict(t_start=10, n_steps=6, coord_solver="ab2", step_schedule="hight"),
                 dict(n_steps=6, coord_ddim_t_min=8, noise_scale=0.5,
                      return_trajectory=True)):
        e2e_sample_check(torch, "[fast]", 32, 20, single_chain=True, **opts)

    # ---- 10. L = 256 and the fast recipes at full width ---------------------------------
    launches["sample_L256"], designs_per_s_256 = sampling_main_path(
        torch, card, "bfloat16", 2, "[main-256]", L=256)
    for fuse in (None, False):
        launches[f"train_L256_fuse_{fuse}"], _ = training_main_path(
            torch, card, "[main-256] train", fuse, 256, 2, 4, batch_size=8, profile=False)
    # K1 at the widest shape the recipes give it (b = n_designs, bp = 1)
    b_fast = max(n for _, n, _ in FAST_RECIPES)
    with torch.no_grad():
        err_bf16 = max(err_bf16, check_layer(
            torch, f"[fast] bf16 (b={b_fast} bp=1 L=128)",
            layer_inputs(torch, b_fast, 1, **main_shape, dtype=torch.bfloat16,
                         bias_dtype=torch.bfloat16, seed=22, n_masked=8), bf16=True))
    fast_rates = {}
    for name, n_designs, opts in FAST_RECIPES:
        launches[f"sample_{name}"], fast_rates[name] = sampling_main_path(
            torch, card, "bfloat16", 2, f"[fast] {name}", n_designs=n_designs, **opts)

    # ---- 11. the design loop: cli.sample --rank and cli.evaluate --------------------------
    launches.update(design_phase(torch, card))

    # ---- 12. the training data path: PDBs -> patches -> cli.train -> cli.sample -------------
    with tempfile.TemporaryDirectory() as tmp:
        data_launches, data_rates = data_phase(torch, card, tmp)
        launches.update(data_launches)

        # ---- 13. self-conditioning ----------------------------------------------------------
        launches.update(selfcond_phase(torch, card, os.path.join(tmp, "patches"), tmp,
                                       train_rates[None], designs_per_s))

    # ---- 14. records ---------------------------------------------------------------
    by_path = lambda i: {path: c[i] for path, c in launches.items()}
    kernels = [{
        "name": "ipa_fused_layer",
        "route": "cuda",
        "source": "diffab_pytorch_tpu_torch/csrc/ipa_fused_layer.cu",
        "replaces": "diffab_pytorch_tpu/ops/ipa_pallas.py:519",
        "tpu_kernel": "ops/ipa_pallas.py:_layer_kernel_batched",
        "launches": sum(by_path(0).values()),
        "launches_by_path": by_path(0),
        "max_abs_err": max(err_f32, err_bf16),
        "max_err_f32": err_f32,
        "max_err_bf16": err_bf16,
        **k1_times["sample"],
        "library_ms": None,
        "design": K1_DESIGN,
        "train_shape": k1_times["train"],
        "f32": k1_f32,
        "max_err_L_over_128": err1_long,
        "L256": {f"{d}_{shape}": t for (k, d, shape), t in long_times.items()
                 if k == "ipa_fused_layer"},
    }, {
        "name": "ipa_attention",
        "route": "cuda",
        "source": "diffab_pytorch_tpu_torch/csrc/ipa_attention.cu",
        "replaces": "diffab_pytorch_tpu/ops/ipa_pallas.py:123",
        "tpu_kernel": "ops/ipa_pallas.py:_kernel (via _pallas_raw)",
        "launches": sum(by_path(1).values()),
        "launches_by_path": by_path(1),
        "max_abs_err": max(k2_err_f32, k2_err_bf16),
        "max_err_f32": k2_err_f32,
        "max_err_bf16": k2_err_bf16,
        **k2_times[("bfloat16", "train")],
        "library_ms": None,
        "design": K2_DESIGN,
        "sample_shape": k2_times[("bfloat16", "sample")],
        "f32": {label: k2_times[("float32", label)] for label in ("train", "sample")},
        "max_err_L_over_128": err2_long,
        "L256": {f"{d}_{shape}": t for (k, d, shape), t in long_times.items()
                 if k == "ipa_attention"},
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"[main] L=256: designs/s {designs_per_s_256:.3f} (bf16); few-step recipes: "
          + ", ".join(f"{name} {rate:.3f} designs/s" for name, rate in fast_rates.items())
          + f" (card: {card})")
    print(f"[main] designs/s {designs_per_s:.3f} (bf16) / {designs_per_s_f32:.3f} (float32); "
          f"training steps/s {train_rates[None]:.3f} (fused layer) / {train_rates[False]:.3f} "
          f"(attention core), from patches {data_rates[False]:.3f} (loader) / "
          f"{data_rates[True]:.3f} (device pool) (card: {card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
