#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (diffab_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # every phase below
    python3 chip_smoke.py --ga     # the build, then [ga] alone

The benchmark (benchmark/run.py) measures the port end to end; this script
holds the card's results to the plain versions, to the CPU and to
themselves, and times the two kernels per launch (PERF.md's kernel table).
Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. [build] every kernel from csrc/ (nvcc, sm_90a) and the C++ parser and
     featurizer, their build times, registers, shared memory and each
     kernel's instruction count ([sass]);
  3. each kernel against its plain PyTorch version on the card, at tiny
     shapes in float32 and bfloat16, at an L that is not a multiple of 16,
     at the main paths' shapes, with a bias a target and a bias for two,
     and (K1) at the widest shape its gate takes (L = 128 and 77) and with
     x read element by element at the default widths, with the tolerances
     stated below (K1 float32 against its plain version in float64); then
     each kernel's autograd Function against autograd of its plain version
     (float32, b=4, L=128);
  4. end-to-end checks: one default_config()-width denoiser forward (6
     layers, 8 designs of one L=128 target) on the card against the CPU
     plain path, in bf16 and in float32; on small inputs, sample() on the
     card (kernels) against sample() on the CPU (plain versions) with the
     same injected draws, and one training loss with its gradients on the
     card against the CPU with the same draws, each for fuse_ipa_layer None
     (fused-layer kernel) and False (attention-core kernel);
  5. [main] the sampling main path: CDR-H3 codesign sampling with
     default_config() in bfloat16, 128 designs of one synthetic
     128-residue target, T=100, seeded random weights (K1's persistent
     launch 1 against its plain version first); launch counts, K1's path
     counters and output checks of one call; then the same in float32,
     the default compute dtype ([main-f32], K1 at its shape against the
     float64 plain version first);
  6. [train] the training main path, once per flag: production_config()
     (bf16, batch 32, L=128) from a seeded init on one synthetic batch, 3
     + 20 steps through fit(); launch counts, loss trajectory and state
     checks;
  7. [time] per-launch kernel times at L = 128 against the plain version
     and the bound, in bfloat16 and float32 (float32 bounds at the 3xTF32
     rate), K1's two bf16 launches timed apart with the card's idle time
     between them (profiler);
  8. [long] patches longer than 128 residues: both kernels against their
     plain versions at L = 136, 200, 256 (b = bp = 32 and b = 128, bp = 1),
     129 and 384, in both dtypes, and their times at L = 256; [e2e-long]
     sample() and a training loss with its gradients, card against CPU,
     at L = 256 for both flags;
  9. [fast] short few-step chains (chord init, fine tail, noise_t_max,
     heun, ab2, ddim, posterior orientations, t-restart, trajectory),
     card against CPU for both flags;
  10. [main-256]: the sampling main path on one 256-residue target, and
     the captured production fit() steps at L = 256, batch 8, per flag;
     [fast]: K1 against its plain version at b = 512 (the recipes' widest
     shape), then bench.py's three few-step recipes on the [main] target
     (chord-10 and 22-eval at 512 designs, the 25-step chain at 128), each
     checked as [main] is;
  11. [design]: the design loop through the entry points: the fixture
     complex tests/fixtures/ab1_chothia.pdb featurized into a 128-residue
     patch, a seeded default_config() checkpoint, `cli.sample --rank -n 128
     --cdrs H3` and `cli.evaluate --json` on the card (files, scores, ranks,
     the report, K1 launches per sample and score call); then score_designs
     card vs CPU (8 designs, both flags, float32 and bf16, injected
     ScoreDraws) and relax_ca card vs CPU;
  12. [data]: the training data path through the entry points: the
     family corpus (8 families x 32 = 256 complexes) through `cli.preprocess
     -j <cores> -k 128` (the C++ parser and featurizer, built from
     native/*.cpp in this run), the C++ routes against Python on 16 PDBs,
     `cli.train --production --max-steps 14` through the prefetch loader
     and with --device-pool (K1 launches, losses, the checkpoint and its
     model_config.json, the same rows at every step on both paths), three
     pool steps through fit() at fuse_ipa_layer=False (K2), `cli.sample -n
     16` from the trained checkpoint; then pool_train_step against
     train_step on its rows on the card, two pool steps card vs CPU, and
     the loader's card batches against the host batches;
  13. [selfcond]: self-conditioning.  Every variant (early fusion,
     geometry-only, late fusion, split trunk) card vs CPU at tiny widths
     for both kernel flags in float32 and bf16: a forward with an estimate
     (and one with |x0| ~ 1e4), the two-pass loss with its gradients per
     sample and per residue under mode dropout, a heun chain with sc_t_max;
     production_config() training with early fusion and with the split
     trunk (3 + 20 fit() steps, K1 12 / 24 a step; then 1 + 4 split-trunk
     steps at fuse_ipa_layer=False, K2 24 a step); the [main] sampling
     path self-conditioned (K1 600 / 1,200 a call); `cli.train --production
     --self-conditioning --sc-split-trunk --sc-onset 2 --sc-rate-warmup 4
     --max-steps 8` on [data]'s patches and `cli.sample -n 16` from its
     checkpoint;
  14. [parallel]: data parallelism.  (a) NCCL at world size 1 in this
     process: make_dp_train_step at production_config(), batch 32, bitwise
     against train_step for 3 steps from the end of the warmup (both under
     deterministic algorithms); sample_fanout_sharded (128 designs, T=100)
     and score_fanout_sharded equal to sample() and score_designs(); (e)
     the IPA layer's plain branch (no pair bias; pq != pv) card vs CPU; (b)
     two ranks sharing the card over gloo (processes started with
     --parallel-worker; NCCL refuses two ranks on one card): 3 DP steps at
     2 x 16 rows and one at fuse_ipa_layer=False, from the end of the
     warmup and under deterministic algorithms, against a host loop, the
     ranks' states bit-identical after every step, a 2 x 64 fan-out
     against the host loop's rows; (c) `cli.train --production
     --data-parallel` under `torch.distributed.run --nproc-per-node 1`
     (--run-clis) against `cli.train` without the flag (checkpoints
     bitwise equal), then `cli.sample --data-parallel --rank -n 16`; (d)
     one rank per card over NCCL where there is more than one card;
  15. [tp]: tensor parallelism, each IPA layer split by head.  (a) NCCL at
     world size 1 in this process: make_sharded_train_step on make_mesh(1)
     bitwise against train_step (production_config(), 3 steps from the
     warmup's end under deterministic algorithms) at both flags; (b) two
     ranks sharing the card over gloo (--tp-worker processes) at tp = 2,
     4 heads a rank, production_config() in float32 and bf16 at both
     flags, 3 steps, each replayed in one process on the card from the tp
     run's state with the same draws (float32 gradients within 1e-5 of
     the gradient's largest entry of the host loop of the ranks' parts;
     bf16 within twice the bf16 step's own distance from float32; the
     update from the tp gradients within 1e-5 of each leaf's scale), the
     replicated leaves bit-identical after every step, then each rank's
     collectives a step; (d) the sharded checkpoint restored into the
     ranks and single-device, bitwise; (c) four ranks, dp = 2 x tp = 2,
     float32, each step replayed with host_dp_loss_and_grads; (e) K1 and
     K2 against their plain versions at h = 4, 2, 1 (L = 128 and 256, both
     shapes and dtypes), K1 at h = 8 against its two halves, and their
     times at those h beside h = 8's; (f) tp = 2 over NCCL, one rank per
     card, where there is more than one card;
  16. [rest]: the rest of the JAX package.  (a) sample_sharded of 8
     128-residue targets (default_config() bf16, T=100): NCCL at world
     size 1 in this process, bitwise sample() on the same batch, K1 600
     launches a call at b = bp = 8; then two gloo ranks sharing the card
     (--parallel-worker ... rest), 2 x 4 targets, bitwise the host loop of
     each rank's sample() from its rank generator; (b)
     pool_train_step(steps_per_call=4) at production_config(), batch 32,
     from a device pool of [train]'s batch under deterministic algorithms,
     bitwise four one-step calls (state and stacked metrics), K1 24 a
     call, one call at fuse_ipa_layer=False (K2 24); (c) checked_fn around
     one production training step (bitwise the unwrapped step; with a NaN
     parameter it raises naming an op), assert_all_finite, trace() with
     named_scope("denoiser") around one eager sample() of the 25-step
     recipe (the Chrome trace holds the scope and K1's kernel),
     block_and_time and StepTimer beside CUDA events; (d) the
     compositional corpus (write_combo_corpus, 4 instances of each of 40
     train combinations) through cli.preprocess -k 128, cli.train
     --production --max-steps 4 (K1 counted a step, the loader's copy
     stream kept off the graph capture stream), the checkpoint, and
     cli.sample -n 16 from it on a held-out combination's patch;
  17. [graph]: the compiled step bodies.  Every phase above runs on the
     card's default path, the step bodies replayed as captured CUDA graphs
     (utils/graphs.py); here each is held against its eager run
     (graphs=False) from the same seed under deterministic algorithms,
     bitwise: (a) sample() at [main]'s size in bf16 (K1 600 a call, the
     profiler's count the same, and a second call with other weights in
     the same tensors) and float32, the [fast] recipes, [main-256],
     self-conditioning (early fusion; the split trunk with Heun) at two
     IPA layers, and fuse_ipa_layer=False (the 25-step recipe); (b)
     make_train_step over 5 steps of [train]'s batch and make_eval_step at
     both flags and in both dtypes, make_pool_train_step(4) (one replay a
     call) against 8 train_steps at both flags in bf16, and the update
     with its scalars on the card against the same update with them as
     host floats; (c) the card's reserved memory across three fit() runs
     from new states (the capture pool must not grow a run);
  18. [ga]: the official DiffAb network (official_config()): K1 with
     direction rows against its plain version (b = 100, h = 12, L = 256 in
     both dtypes; L = 77 and b = 100, L = 128 in float32; b = 128, L = 128
     in bf16 off the persistent path; float32 at L = 129, 200, 256, 384,
     b = 100 and b = bp = 32, on
     the attention path each books) and through its autograd Function,
     sample() graphed bitwise eager with 600 GA blocks and 600 one-pass
     attention calls a call, the official call's K1 launches timed
     (`attend_time`), and sample(), score_designs, fit(),
     `cli.train --official` and `cli.sample --official` on the card;
  19. a `kernels` JSON line (launch counts by path, largest errors, the
     kernel times), the card line, and the final JSON line.

The L = 128 kernel times (phase 7) run where they ran before the long-patch
and few-step phases existed, so that two versions of this script read them
after the same work.  To time another checkout's kernels with this
script's functions (kernel_times, long_patch_phase, tp_kernels,
attend_time), load this file with importlib from inside that checkout and
call, for example, kernel_times(torch, card, 32).

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

from benchmark.lib import work  # the card's peaks, K1's operations and bytes

HERE = os.path.dirname(os.path.abspath(__file__))

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
K1_DESIGN = ("two launches on head-major weights, every product on the tensor cores. bf16 "
             "with at least two (head, design) items per SM (L <= 128, ds = 32, P = 8): launch 1 "
             "persistent, one block per SM walking head-major items, a producer warp loading "
             "x, frames and the resident W_h by cp.async and mbarriers, two consumer "
             "warpgroups each on its own item with wgmma products (projection, logits, "
             "P [v_s|v_p]) and operands, softmax and features in registers. Otherwise "
             "(mma.sync, cp.async) 1: one block of 8 warps per (head, design): the head's Q/K/V "
             "projection kept on chip, frames and augmented operands in shared memory, each "
             "warp's 16 x L logits and float32 softmax in registers, P [v_s|v_p] from register "
             "fragments, inverse frames and norms, per-head features out. 2: the output "
             "projection as a cp.async double-buffered tensor-core GEMM. bf16: mma.sync "
             "m16n8k16 bf16->f32 (ldmatrix). float32: 3xTF32 on mma.sync m16n8k8 (W_h split once "
             "a block into 16-byte tf32 pairs through a three-stage cp.async ring, the other "
             "operands split as loaded, three products a tile with their terms interleaved "
             "across tiles), float32-exact to 1e-4")
K2_DESIGN = ("one launch, one block of 8 warps per (head, design) (all 128 query rows), "
             "operands copied feature-major into padded shared tiles by cp.async, each warp's "
             "16 x L logits and float32 softmax in registers, P [v_s|v_p] from register "
             "fragments, outputs transposed through the warp's own q-tile columns for 16-byte "
             "stores. bf16: mma.sync m16n8k16 "
             "(ldmatrix, attn staged for 16-byte stores). float32: 3xTF32 on mma.sync m16n8k8 "
             "(operands and weights split into big + small tf32, three products), "
             "float32-exact to 1e-4")


def bound_parts(flops, n_bytes, dtype_name):
    """`work.bound_s` in ms, with what bounds it and its two terms: (ms,
    "operations" or "bytes", operations ms, bytes ms)."""
    t_o, t_b = flops / work.PEAK_FLOPS[dtype_name] * 1e3, n_bytes / work.PEAK_BYTES * 1e3
    return (work.bound_s(flops, n_bytes, dtype_name) * 1e3,
            "operations" if t_o >= t_b else "bytes", t_o, t_b)


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


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of fn over `iters` back-to-back calls (CUDA
    events), queued behind a ~10 ms sleep kernel, so that the time is the
    card's and not the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def layer_inputs(torch, b, bp, L, d, h, ds, p, dtype, seed, n_masked, directions=False):
    """Random fused-layer inputs on the card: orthonormal frames,
    translations of magnitude ~5, the last n_masked keys padded; with
    `directions`, direction rows packed too (drawn after the others)."""
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
        w_od=w(h * p * 3, d) if directions else None,
    )
    args = dict(
        x=f(b, L, d).to(dtype).cuda(),
        rot=so3.uniform((b, L), generator=g).to(dtype).cuda(),
        trans=(f(b, L, 3) * 5).to(dtype).cuda(),
        mask=mask.to(dtype).cuda(),
        wts=wts,
        bias=f(bp, h, L, L).to(dtype).cuda(),
        scale_total=scales[2],
    )
    return args


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
    kernel misses on most elements.

    float32 is held to the plain version computed in float64, so that the
    check measures the kernel and not the float32 plain version's own
    cancellation in |q|^2 + |k|^2 - 2 q.k; the 1e-4 rule stays."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    acc_k, attn_k = op.fused_ipa_layer_packed(**args)
    exact = not bf16
    if exact:
        wts = args["wts"]
        wts = wts._replace(w_qkv=wts.w_qkv.double(), w_out=wts.w_out.double(),
                           g=wts.g.double())
        args = {k: v.double() if torch.is_tensor(v) else v for k, v in args.items()}
        args["wts"] = wts
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
    print(f"[parity] {name}{' (plain version in float64)' if exact else ''}: max|d attn| "
          f"{d_attn.max().item():.3e}, "
          f"max|d acc| {d_acc.max().item():.3e} = {d_acc.max().item() / scale:.3e} of "
          f"max|acc| {scale:.3e}; share beyond tol (attn {tol_attn:.1e}, acc "
          f"{tol_acc:.1e}): {share_attn:.2e} / {share_acc:.2e} (allowed {allowed:.0e}); "
          f"padded-key attn {padded:.1e}")
    if not (torch.isfinite(acc_k).all() and torch.isfinite(attn_k).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    if share_attn > allowed or share_acc > allowed or padded != 0.0:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max(d_attn.max().item(), d_acc.max().item())


def layer_outputs(torch, args):
    """One K1 call through the library entry as the wrapper launches it,
    returning (acc, attn, feat): feat, the per-head features launch 1
    writes, is the wrapper's scratch.  Float32 without the persistent
    launch 1, on entry points older checkouts of the port share, so that
    two trees' launch 1 can be compared bit for bit (load this file from
    inside each checkout and call it on the same layer_inputs)."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    x, wts, bias = args["x"], args["wts"], args["bias"]
    b, L, d = x.shape
    h, ds, p = wts.n_head, wts.d_scalar, wts.n_point
    acc = torch.empty_like(x)
    attn = torch.empty((b, h, L, L), device=x.device)
    feat = torch.empty((b * L, h * op.feature_width(ds, p, wts.directions)), device=x.device)
    scratch = torch.empty(max(1, op.scratch_elems(torch.float32, b, L, h, ds, p)),
                          device=x.device)
    ptrs = [t.data_ptr() for t in (x, args["rot"], args["trans"], args["mask"], wts.w_qkv,
                                   wts.w_out, wts.g, bias, feat, acc, attn, scratch)]
    st = float(args["scale_total"])
    err = op._library().ipa_fused_layer_forward(
        0, *ptrs, b, bias.shape[0], L, d, h, ds, p, st, -op._NEG_INF / st, 0,
        int(wts.directions), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ipa_fused_layer_forward failed ({err})")
    return acc, attn, feat


def attention_inputs(torch, b, bp, L, h, ds, p, dtype, seed, n_masked):
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
                v_p=ops[3].cuda(), bias=f(bp, h, L, L).to(dtype).cuda(),
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
                                                     seed=200 + i, n_masked=9), bf16=bf))
                err2 = max(err2, check_attention(
                    torch, f"{tag} K2",
                    attention_inputs(torch, b, bp, L, widths["h"], widths["ds"], widths["p"],
                                     dtype, 300 + i, 9), 9, bf16=bf))
        times = {}
        L = 256
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            for label, b, bp in (("train", 32, 32), ("sample", N_DESIGNS, 1)):
                la = layer_inputs(torch, b, bp, L, **widths, dtype=dtype,
                                  seed=400 + b, n_masked=0)
                aa = attention_inputs(torch, b, bp, L, widths["h"], widths["ds"], widths["p"],
                                      dtype, 500 + b, 0)
                for kname, kern, plain, (fl, nb) in (
                        ("ipa_fused_layer", lambda: op.fused_ipa_layer_packed(**la),
                         lambda: op.fused_ipa_layer_packed_reference(**la),
                         work.ipa_layer_flops_bytes(b, bp, L, **widths, itemsize=dtype.itemsize,
                                               bias_itemsize=dtype.itemsize)),
                        ("ipa_attention", lambda: k2.ipa_attention_core(**aa),
                         lambda: k2.ipa_attention_core_reference(**aa),
                         attention_flops_bytes(b, bp, L, widths["h"], widths["ds"],
                                               widths["p"], itemsize=dtype.itemsize,
                                               bias_itemsize=dtype.itemsize))):
                    km = cuda_time_ms(kern, 20)
                    pm = cuda_time_ms(plain, 3)
                    km2 = cuda_time_ms(kern, 20)
                    bnd, by, t_o, t_b = bound_parts(fl, nb, dname)
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


def profiled_kernels(torch, fn, name):
    """The device events whose kernel name holds `name` in one call of fn
    under torch.profiler (device events only), or None where the profiler
    reported no device time at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda ev: getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0))
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0]
    return sum(ev.count for ev in evs if name in ev.key) if evs else None


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


def training_main_path(torch, tag, fuse, L, n_warm, n_steps, batch_size=None, model=None):
    """production_config() training through fit() on one synthetic batch of
    L-residue patches (batch_size, default the config's 32), from a seeded
    init, its model changed by `model` (ModelConfig fields): n_warm warm-up
    steps (the first captures the step), then n_steps steps with the launch
    counts set to 0 just before and read just after (a self-conditioned
    step runs the denoiser twice); loss trajectory and state checks.
    Returns (K1, K2) launches of the n_steps steps."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
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
    state = fit(harness, pool, max_steps=n_warm, logger=logger)
    torch.cuda.synchronize()
    zero_launches()
    state = fit(harness, pool, max_steps=n_warm + n_steps, logger=logger, state=state)
    torch.cuda.synchronize()
    counts = k_launches()
    per_step = layer_calls(hcfg.model, 2 if hcfg.model.self_conditioning else 1)
    want = (per_step * n_steps, 0) if fuse is None else (0, per_step * n_steps)
    print(f"{tag} {kname}: {n_steps} steps of production_config() (bf16, batch {pb}, L={L}) "
          f"after {n_warm}: launches ipa_fused_layer {counts[0]}, ipa_attention {counts[1]} "
          f"(expected {want[0]}, {want[1]})")
    losses = [row["train/loss"] for _, row in logger.rows]
    moved = sum(not torch.equal(state.params[k].detach(), v) for k, v in init_params.items())
    tchecks = {
        "steps": state.step == n_warm + n_steps,
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
    return counts


def sampling_main_path(torch, compute_dtype, tag, L=L_MAIN, n_designs=N_DESIGNS, model=None,
                       **opts):
    """The sampling main path: CDR-H3 codesign sample() with
    default_config() (its model in `compute_dtype`, changed by `model`;
    float32 is default_config() exactly as it stands), one synthetic
    L-residue target (default 128), n_designs designs sharing the context
    (default 128), T=100 and the sampler options `opts` (none: the full
    chain from the prior), seeded random weights.  One warm-up call (it
    captures the step graphs), then one call with the launch counts set to
    0 just before it and read just after, and output checks on it.
    Returns (K1, K2) launches of that call."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import sample, timestep_schedule
    from diffab_pytorch_tpu_torch.weights import init_parameters

    cfg = C.default_config()
    mcfg = dataclasses.replace(cfg.model, compute_dtype=compute_dtype, **(model or {}))
    dcfg = cfg.diffusion
    model = init_parameters(DiffAbModel(mcfg), torch.Generator().manual_seed(0))
    sched = cosine_variance_schedule(dcfg.T, s=dcfg.s, beta_max=dcfg.beta_max, device="cuda")
    tables = make_orientation_tables(sched)
    target = synthetic_batch(0, 1, L, mcfg.n_atoms, n_generate=N_GENERATE, device="cuda")

    def run(seed):
        return sample(model, sched, tables, target, n_designs=n_designs,
                      generator=torch.Generator(device="cuda").manual_seed(seed), **opts)

    if tag == "[main]" and compute_dtype == "bfloat16":
        check_persistent_path(torch, tag)
    if tag == "[main-f32]":
        with torch.no_grad():
            check_layer(torch, f"{tag} K1 f32 (b={n_designs} bp=1 L={L})",
                        layer_inputs(torch, n_designs, 1, L, mcfg.d_residue_emb, mcfg.n_head,
                                     mcfg.d_scalar_per_head, mcfg.n_query_point_per_head,
                                     torch.float32, 25, 8), bf16=False)
    run(10)
    torch.cuda.synchronize()
    zero_launches()
    paths0 = k1_paths()
    out = run(11)
    torch.cuda.synchronize()
    launches = k_launches()
    paths = k1_paths_since(paths0)
    t_seq = timestep_schedule(opts.get("t_start", dcfg.T), opts.get("n_steps"),
                              opts.get("step_schedule", "uniform"),
                              opts.get("step_schedule_p", 0.5), opts.get("n_fine_tail"))
    expected = (layer_calls(mcfg, denoiser_calls(t_seq.tolist(), opts)), 0)
    print(f"{tag} sample(n_designs={n_designs}, T={dcfg.T}, L={L}, {len(t_seq)} steps {opts}) "
          f"in {mcfg.compute_dtype}: ipa_fused_layer launches {launches[0]}, ipa_attention "
          f"launches {launches[1]} (expected {expected[0]}, {expected[1]}); K1 launch-1 paths "
          f"{paths}")
    if launches != expected:
        raise RuntimeError(f"main path launched (fused layer, attention core) {launches} times, "
                           f"expected {expected}")
    heads = mcfg.n_head
    if op.takes_persistent(torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32,
                           n_designs, L, mcfg.d_residue_emb, heads, mcfg.d_scalar_per_head,
                           mcfg.n_query_point_per_head, op._sm_count(torch.device("cuda"))):
        items = launches[0] * n_designs * heads
        if paths["items"] != items or paths["fallback_calls"]:
            raise RuntimeError(f"{tag}: K1's launches did not all take the persistent launch 1: "
                               f"{paths}, expected {items} items")
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
    return launches


DESIGN_FIXTURE = os.path.join("tests", "fixtures", "ab1_chothia.pdb")
N_DESIGN_CHECK = 8  # designs in the card-vs-CPU score and relax checks


class Probe:
    """Wraps a callable of the design loop and records the K1 and K2
    launches of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        before = k_launches()
        out = self.fn(*args, **kwargs)
        self.calls.append(tuple(b - a for a, b in zip(before, k_launches())))
        return out


def design_loop(torch, tmp):
    """[design] 1-2: featurize the fixture complex (chains H and L, antigen
    A) into a 128-residue patch with the port's structure modules, write
    seeded default_config() weights in the port's checkpoint format, then
    `cli.sample --rank -n 128 --cdrs H3` and `cli.evaluate --json` on the
    card, through their main().  Returns {path: (K1, K2) launches}."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import evaluate as evaluate_cli
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli
    from diffab_pytorch_tpu_torch.sampling.scoring import default_t_grid
    from diffab_pytorch_tpu_torch.structure import antibody
    from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag, n = "[design]", N_DESIGNS
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
          f"H3); seeded default_config() checkpoint")

    probes = {"sample": Probe(DiffAb.sample), "score": Probe(DiffAb.score_designs)}
    out_dir = os.path.join(tmp, "designs")
    argv = ["--patch", patch_path, "--checkpoint-dir", ck, "-n", str(n), "--cdrs", "H3",
            "--rank", "-o", out_dir, "-s", "0"]
    log = io.StringIO()
    try:
        DiffAb.sample = lambda self, *a, **k: probes["sample"](self, *a, **k)
        DiffAb.score_designs = lambda self, *a, **k: probes["score"](self, *a, **k)
        zero_launches()
        with contextlib.redirect_stdout(log):
            rc = sample_cli.main(argv)
        torch.cuda.synchronize()
        total = k_launches()
    finally:
        DiffAb.sample, DiffAb.score_designs = probes["sample"].fn, probes["score"].fn
    print("\n".join(f"{tag} cli.sample: {line}" for line in log.getvalue().splitlines()
                    if line.startswith("[sample]")))
    grid_points = 2 * len(default_t_grid(cfg.diffusion.T))
    want = {"sample": (cfg.model.n_ipa_layers * cfg.diffusion.T, 0),
            "score": (cfg.model.n_ipa_layers * grid_points, 0)}
    got = {"sample": probes["sample"].calls[0], "score": probes["score"].calls[0]}
    print(f"{tag} launches K1, K2: sample call {got['sample']}, score call {got['score']}, whole "
          f"CLI {total} (expected {want['sample']}, {want['score']}, the sum)")

    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".pdb"))
    fasta = open(os.path.join(out_dir, "designs.fasta")).read().splitlines()
    scores = json.load(open(os.path.join(out_dir, "scores.json")))
    values = [v for e in scores.values() for k, v in e.items() if k != "rank"]
    report_path = os.path.join(tmp, "report.json")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc_eval = evaluate_cli.main(["--native-patch", patch_path, "--designs", out_dir,
                                     "--cdrs", "H3", "--json", report_path])
    agg = json.load(open(report_path))["aggregate"]
    rows = json.load(open(report_path))["designs"]
    print(f"{tag} cli.evaluate --json: " + "; ".join(
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
    return {"design_cli": got["sample"], "score": got["score"]}


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
    cpu32 = run(None, "float32", "cpu")[0]
    worst = {}
    for fuse in (None, False):
        cpu = {"float32": cpu32, "bfloat16": run(fuse, "bfloat16", "cpu")[0]}
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


def design_phase(torch):
    """[design]: the design loop through the port's entry points on the
    card and its card-vs-CPU checks (see design_loop and
    design_card_vs_cpu).  Returns {path: (K1, K2) launches}."""
    with tempfile.TemporaryDirectory() as tmp:
        launches = design_loop(torch, tmp)
        design_card_vs_cpu(torch, tmp)
    return launches


DATA_FAMILIES, DATA_PER_FAMILY = 8, 32  # the [data] corpus: 256 complexes
DATA_STEPS = 14  # about two epochs: 231 training patches at batch 32 give 7 steps an epoch


class StepRecorder:
    """Wraps the step factory that fit() calls (DiffAb.make_train_step, or
    with pool=True make_pool_train_step) inside a training run, without
    waiting for the card: each call of the step it makes records its K1
    and K2 launches, its loss, its arguments and a checksum of its batch (a
    pool step's rows gathered for it; tensors, read after the run)."""

    def __init__(self, factory, pool=False):
        self.factory, self.pool, self.calls = factory, pool, []

    def __call__(self, harness, *args, **kwargs):
        step = self.factory(harness, *args, **kwargs)

        def recorded(state, *step_args):
            before = k_launches()
            out, metrics = step(state, *step_args)
            batch = step_args[0].gather_rows(step_args[1]) if self.pool else step_args[0]
            self.calls.append(dict(loss=metrics["train/loss"],
                                   args=(harness, state, *step_args),
                                   rows=(batch.xyz.double().sum(), batch.seq_idx.sum()),
                                   launches=tuple(b - a for a, b in zip(before, k_launches()))))
            return out, metrics
        return recorded


def data_corpus(tmp):
    """[data] 1-3: the family corpus through cli.preprocess (a subprocess,
    one spawned worker per core, the C++ parser and featurizer), then the
    C++ routes against the Python ones on 16 of the PDBs.  Returns the
    patch directory."""
    from diffab_pytorch_tpu_torch.data.synthetic import write_family_corpus
    from diffab_pytorch_tpu_torch.structure import antibody, geometry, pdb

    tag, n = "[data]", DATA_FAMILIES * DATA_PER_FAMILY
    meta = write_family_corpus(os.path.join(tmp, "corpus"), n_families=DATA_FAMILIES,
                               n_per_family=DATA_PER_FAMILY, seed=0)
    print(f"{tag} family corpus: {n} complexes (H, L, antigen A) and meta.csv written")
    patches = os.path.join(tmp, "patches")
    jobs = os.cpu_count() or 1
    cmd = [sys.executable, "-m", "diffab_pytorch_tpu_torch.cli.preprocess", "--meta", meta,
           "--data-dir", os.path.join(tmp, "corpus", "pdb"), "--out-dir", patches, "-j",
           str(jobs), "-k", str(L_MAIN)]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    written = sorted(f for f in os.listdir(patches) if f.endswith(".npz")) \
        if os.path.isdir(patches) else []
    summary = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"{tag} cli.preprocess -j {jobs} -k {L_MAIN}: {summary[0]}; {len(written)} .npz "
          f"({jobs} spawned workers)")
    if proc.returncode != 0 or len(written) != n or f"skipped 0" not in summary[0]:
        raise RuntimeError(f"{tag} cli.preprocess failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")

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
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{tag} the C++ parser or featurizer disagrees with Python")
    return patches


def data_train(torch, patches, tmp, pool):
    """[data] 4: `cli.train --production --max-steps 14` on the card through
    its main(), through the loader (pool False) or with --device-pool.
    Returns ((K1, K2) launches of the training steps, the checkpoint
    directory, the recorded calls)."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import train as train_cli
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    path = "device pool" if pool else "loader"
    tag = f"[data] train ({path})"
    ck = os.path.join(tmp, "ck_pool" if pool else "ck_loader")
    argv = ["--data-dir", patches, "--production", "--max-steps", str(DATA_STEPS),
            "--checkpoint-dir", ck] + (["--device-pool"] if pool else [])
    factory = "make_pool_train_step" if pool else "make_train_step"
    rec = StepRecorder(getattr(DiffAb, factory), pool)
    log = io.StringIO()
    try:
        setattr(DiffAb, factory, lambda self, *a, **k: rec(self, *a, **k))
        zero_launches()
        with contextlib.redirect_stdout(log):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
        total = k_launches()
    finally:
        setattr(DiffAb, factory, rec.factory)
    for line in log.getvalue().splitlines():
        if line.startswith(("[train]", "[trainer]")):
            print(f"{tag} {line}")
    calls = rec.calls
    steps = (sum(c["launches"][0] for c in calls), sum(c["launches"][1] for c in calls))
    pcfg = C.production_config()
    n_layers, pb = pcfg.model.n_ipa_layers, pcfg.train.batch_size
    n_val = int(DATA_FAMILIES * DATA_PER_FAMILY * pcfg.train.val_pct)
    steps_per_epoch = (DATA_FAMILIES * DATA_PER_FAMILY - n_val) // pb
    n_evals = DATA_STEPS // steps_per_epoch  # one validation batch of n_val each
    losses = [float(c["loss"]) for c in calls]
    pool_batch = calls[0]["args"][2] if pool else None
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
    print(f"{tag}: cli.train {' '.join(argv[2:])}: {len(calls)} steps"
          + (f"; pool on the card: {pool_batch.batch_size} rows" if pool else ""))
    print(f"{tag}: launches K1, K2: training steps {steps}, whole CLI {total} (expected "
          f"{(n_layers * DATA_STEPS, 0)}, and {n_evals} validation passes: "
          f"{(n_layers * (DATA_STEPS + n_evals), 0)}); losses {[round(v, 6) for v in losses]}")
    print(f"{tag}: checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} failed a check: {checks}")
    return steps, ck, calls


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


def data_sample(torch, patches, ck, tmp):
    """[data] 6: `cli.sample -n 16` on the card from the trained checkpoint:
    the recorded production model restores and the designs are written."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli

    cfg = C.production_config()
    patch = os.path.join(patches, sorted(os.listdir(patches))[0])
    out = os.path.join(tmp, "designs")
    argv = ["--patch", patch, "--checkpoint-dir", ck, "-n", "16", "-o", out]
    log = io.StringIO()
    zero_launches()
    with contextlib.redirect_stdout(log):
        rc = sample_cli.main(argv)
    torch.cuda.synchronize()
    got = k_launches()
    lines = log.getvalue().splitlines()
    names = sorted(f for f in os.listdir(out) if f.endswith(".pdb"))
    checks = {"rc": rc == 0, "recorded_model": any("recorded model config" in s for s in lines),
              "restored": any(f"restored checkpoint at step {DATA_STEPS}" in s for s in lines),
              "designs": names == [f"design_{i:04d}.pdb" for i in range(16)],
              "launches": got == (cfg.model.n_ipa_layers * cfg.diffusion.T, 0)}
    print(f"[data] cli.sample --patch {os.path.basename(patch)} -n 16 from the trained "
          f"checkpoint: launches K1, K2 {got}; checks {checks}")
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


def data_phase(torch, tmp=None):
    """[data]: the training data path on the card, from PDBs to designs (see
    data_corpus, data_train, data_fuse_false, data_sample and
    data_card_vs_cpu), in the directory `tmp` (default a temporary one;
    the patches stay in <tmp>/patches).  Returns {path: (K1, K2)
    launches}."""
    import contextlib

    launches = {}
    with (tempfile.TemporaryDirectory() if tmp is None else contextlib.nullcontext(tmp)) as tmp:
        patches = data_corpus(tmp)
        calls, cks = {}, {}
        for pool in (False, True):
            key = "data_pool" if pool else "data_loader"
            launches[key], cks[pool], calls[pool] = data_train(torch, patches, tmp, pool)
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
        launches["data_fuse_false"] = data_fuse_false(torch, patches)
        launches["data_sample"] = data_sample(torch, patches, cks[False], tmp)
        data_card_vs_cpu(torch, patches)
    return launches


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
    print(f"{tag} card vs CPU: {n_checks} checks of 4 variants x 2 flags x 2 dtypes passed "
          f"(float32 numbers: max|d| or loss |d| / gradient |d| / scale; bf16 and float32 "
          f"forwards: card max/mean, CPU bf16-float32 max/mean, relative to scale)")


def selfcond_cli(torch, patches, tmp):
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
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag = "[selfcond] cli"
    ck = os.path.join(tmp, "ck_selfcond")
    argv = ["--data-dir", patches, "--production", "--self-conditioning", "--sc-split-trunk",
            "--sc-onset", "2", "--sc-rate-warmup", "4", "--max-steps", str(SC_CLI_STEPS),
            "--checkpoint-dir", ck]
    rec = StepRecorder(DiffAb.make_train_step)
    log = io.StringIO()
    try:
        DiffAb.make_train_step = lambda self, *a, **k: rec(self, *a, **k)
        zero_launches()
        with contextlib.redirect_stdout(log):
            rc = train_cli.main(argv)
        torch.cuda.synchronize()
        total = k_launches()
    finally:
        DiffAb.make_train_step = rec.factory
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
    print(f"{tag} train {' '.join(argv[2:])}: launches K1, K2: steps {steps} "
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
    zero_launches()
    with contextlib.redirect_stdout(log):
        rc = sample_cli.main(sargv)
    torch.cuda.synchronize()
    got = k_launches()
    lines = log.getvalue().splitlines()
    names = sorted(f for f in os.listdir(out) if f.endswith(".pdb"))
    checks = {"rc": rc == 0,
              "self_conditioning": any("recorded model config (self-conditioning)" in x
                                       for x in lines),
              "designs": names == [f"design_{i:04d}.pdb" for i in range(16)],
              "launches": got == (layer_calls(want_model, pcfg.diffusion.T), 0)}
    print(f"{tag} sample -n 16 from that checkpoint: launches K1, K2 {got}; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} cli.sample from the self-conditioned checkpoint failed: "
                           f"{checks}")
    return {"selfcond_cli_train": steps, "selfcond_cli_sample": got}


def selfcond_phase(torch, patches, tmp):
    """[selfcond]: self-conditioning on the card.  1: every variant card vs
    CPU at tiny widths (selfcond_card_vs_cpu); 2: production_config()
    training with early fusion and with the split trunk (3 + 20 fit()
    steps on [train]'s batch; K1 12 and 24 a step), and 1 + 4 split-trunk
    steps at fuse_ipa_layer=False (K2 24 a step); 3: the [main] sampling
    path with a self-conditioned default_config() in bf16, early and split
    (K1 600 and 1,200 a call); 4: cli.train and cli.sample (selfcond_cli).
    Returns {path: (K1, K2)}."""
    selfcond_card_vs_cpu(torch)
    launches = {}
    for variant in ("early", "split"):
        launches[f"selfcond_train_{variant}"] = training_main_path(
            torch, f"[selfcond] train {variant}", None, L_MAIN, 3, 20,
            model=sc_model_fields(variant))
    # the attention-core kernel at the split trunk's call pattern (K2 24 a step)
    launches["selfcond_train_split_fuse_False"] = training_main_path(
        torch, "[selfcond] train split", False, L_MAIN, 1, 4, model=sc_model_fields("split"))
    for variant in ("early", "split"):
        launches[f"selfcond_sample_{variant}"] = sampling_main_path(
            torch, "bfloat16", f"[selfcond] sample {variant}", model=sc_model_fields(variant))
    launches.update(selfcond_cli(torch, patches, tmp))
    return launches


# ---- [parallel]: data parallelism ----------------------------------------------------

PAR_STEPS = 3  # DP training steps held against their reference in (a) and (b)
PAR_LOCAL = 64  # (b), (d): designs of the fan-out on each rank
PAR_CLI_STEPS = 4  # (c): cli.train steps (an epoch of [data]'s patches is 7)
PAR_CLI_DESIGNS = 16
PAR_BATCH = 32  # production_config()'s batch, split over the ranks


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms on: the scatter and index backward passes
    otherwise sum with atomics, so two runs of one training step part in
    their last bits (PERF.md §7) and no two runs can be held bitwise.
    Uninitialized memory is left unfilled, as outside this mode, and
    cuBLAS gets the workspace setting the mode asks for."""
    import torch.utils.deterministic as det

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def k_launches():
    """(K1, K2) launch counts so far."""
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    return op.fused_ipa_layer_packed.launches, k2.ipa_attention_core.launches


K1_PATHS = ("ipa_layer.items", "ipa_layer.items_overlapped", "ipa_layer.fallback_calls",
            "ipa_layer.attend_onepass_calls", "ipa_layer.attend_twopass_calls")


def k1_paths():
    """The port's counters of K1's paths so far: bf16 launch 1 (items and
    overlapped items of the persistent kernel, calls of the per-item one)
    and float32's attention beyond 128 residues (calls of the one-pass and
    of the two-pass core)."""
    from diffab_pytorch_tpu_torch.utils import profiling

    c = profiling.counters()
    return tuple(c.get(n, 0) for n in K1_PATHS)


def k1_paths_since(before):
    return dict(zip(("items", "overlapped", "fallback_calls", "attend_onepass",
                     "attend_twopass"), (a - b for a, b in zip(k1_paths(), before))))


# (b, bp, L, d, h, masked keys, seed) of check_persistent_path
PERSISTENT_CASES = (
    (N_DESIGNS, 1, L_MAIN, 128, 8, 0, 60),  # the main sampling call
    (N_DESIGNS, 1, 77, 128, 8, 9, 61),  # odd L: element-wise frames and stores
    (N_DESIGNS, N_DESIGNS, L_MAIN, 128, 8, 0, 62),  # a bias a design
    (N_DESIGNS, N_DESIGNS, 77, 128, 8, 9, 63),
    (N_DESIGNS, 1, L_MAIN, 128, 4, 0, 64),  # a tp rank's 4 heads: 512 items
    (N_DESIGNS, 1, L_MAIN, 64, 8, 0, 65),  # a narrower x row
)


def check_persistent_path(torch, tag):
    """K1's persistent launch 1 against the plain version on the card
    (PERSISTENT_CASES: the main sampling shape, b = 128, bp = 1, L = 128;
    L = 77, odd, with element-wise frame loads and attn stores and 9 padded
    keys; both again with a bias for each design, b = bp = 128; 4 heads;
    d = 64), with check_layer's bf16 tolerances; each
    call must have taken the persistent path (the counters: b h items, all
    but one per SM overlapped, no call of the per-item kernel).  Returns the
    largest error."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    worst = 0.0
    n_sm = op._sm_count(torch.device("cuda"))
    with torch.no_grad():
        for b, bp, L, d, h, n_masked, seed in PERSISTENT_CASES:
            a = layer_inputs(torch, b, bp, L, d, h, 32, 8, torch.bfloat16, seed, n_masked)
            before = k1_paths()
            worst = max(worst, check_layer(
                torch, f"{tag} persistent launch 1 (b={b} bp={bp} L={L} d={d} h={h})", a,
                bf16=True))
            got = k1_paths_since(before)
            items = b * h
            want = dict(items=items, overlapped=items - min(items, n_sm), fallback_calls=0,
                        attend_onepass=0, attend_twopass=0)
            print(f"{tag} K1 paths of that call: {got} (expected {want}, {n_sm} SMs)")
            if got != want:
                raise RuntimeError(f"{tag} K1 at b={b} bp={bp} L={L} d={d} h={h} did not take "
                                   f"the persistent launch 1: {got}")
    return worst


def zero_launches():
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    op.fused_ipa_layer_packed.launches = k2.ipa_attention_core.launches = 0


def par_train_setup(torch, device, fuse=None, compute_dtype="bfloat16"):
    """production_config() (fuse_ipa_layer `fuse`, its bf16 compute or
    `compute_dtype`) on `device` and [train]'s synthetic batch of 32 L=128
    patches."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    pcfg = C.production_config()
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, fuse_ipa_layer=fuse, compute_dtype=compute_dtype))
    batch = synthetic_batch(100, pcfg.train.batch_size, L_MAIN, pcfg.model.n_atoms,
                            device=device)
    return DiffAb(pcfg, device=device), batch


def par_draws(torch, harness, rows, step, rank):
    """Rank `rank`'s draws for its rows at `step`, from a generator on the
    rows' device seeded by (step, rank): the same numbers in any process."""
    gen = torch.Generator(device=rows.seq_idx.device).manual_seed(700 + 10 * step + rank)
    return harness.draw(rows, gen)


def par_state(harness):
    """harness.init(0) at the end of the learning-rate warmup (its step and
    update count), so that every compared step updates at the full rate:
    at production_config()'s step 0 the rate is 0, and a comparison of the
    parameters after it could not fail."""
    state = harness.init(0)
    warm = harness.config.train.lr_warmup_steps
    return dataclasses.replace(state, step=warm, opt_state=state.opt_state._replace(count=warm))


def par_fan_setup(torch, device):
    """default_config() in bf16 from a seeded init on `device`, and [main]'s
    synthetic 128-residue target."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    cfg = C.default_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             compute_dtype="bfloat16"))
    fan = DiffAb(cfg, device=device)
    fan.init(0)  # the model's own weights
    target = synthetic_batch(0, 1, L_MAIN, cfg.model.n_atoms, n_generate=N_GENERATE,
                             device=device)
    return fan, target


def leaf_rel(a: dict, b: dict) -> float:
    """max over leaves of max |a - b| over the leaf's scale (max |b|, at least 1)."""
    return max(float((a[k].detach().float() - v.detach().float()).abs().max()
                     / v.detach().float().abs().max().clamp(min=1.0)) for k, v in b.items())


def parallel_one_rank(torch):
    """[parallel] (a): NCCL, world size 1, in this process (a TCP store on
    a free port).  make_dp_train_step at production_config(), batch 32,
    L=128, against harness.train_step with the same draws for PAR_STEPS
    steps from the end of the warmup (`par_state`), bitwise (loss,
    metrics, parameters, EMA), both under deterministic().
    sample_fanout_sharded (128 designs, default_config() bf16, T=100)
    against sample() from the same generator: rows equal;
    score_fanout_sharded against score_designs: equal.  Returns {path:
    (K1, K2)}."""
    import torch.distributed as dist

    from diffab_pytorch_tpu_torch.parallel.dp import (
        make_dp_train_step, sample_fanout_sharded, score_fanout_sharded)
    from diffab_pytorch_tpu_torch.sampling.scoring import default_t_grid

    tag = "[parallel] (a)"
    launches = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                            world_size=1)
    try:
        harness, batch = par_train_setup(torch, "cuda")
        step = make_dp_train_step(harness)
        draws = lambda s: par_draws(torch, harness, batch, s, 0)
        with deterministic(torch):
            dp_state, state = par_state(harness), par_state(harness)
            equal, losses, lrs, dp_launches = [], [], [], (0, 0)
            for s in range(PAR_STEPS):
                d = draws(s)
                lrs.append(harness.learning_rate(state.opt_state.count))
                before = k_launches()
                dp_state, m_dp = step(dp_state, batch, d)
                losses.append(round(float(m_dp["train/loss"]), 4))
                torch.cuda.synchronize()
                dp_launches = tuple(a + c - b for a, b, c in zip(dp_launches, before,
                                                                  k_launches()))
                state, m = harness.train_step(state, batch, d)
                equal.append(all(torch.equal(m_dp[k], m[k]) for k in m)
                             and all(torch.equal(dp_state.params[k], state.params[k])
                                     and torch.equal(dp_state.ema_params[k], state.ema_params[k])
                                     for k in state.params))
        want = (PAR_STEPS * layer_calls(harness.config.model), 0)
        print(f"{tag} NCCL world size 1: make_dp_train_step vs train_step, production_config() "
              f"(bf16, batch 32, L={L_MAIN}), {PAR_STEPS} steps with the same draws under "
              f"deterministic algorithms: loss, metrics, parameters and EMA bitwise equal by "
              f"step {equal}; lr by step {lrs}; losses {losses}; DP launches "
              f"K1, K2 {dp_launches} (expected {want})")
        if not all(equal) or dp_launches != want or min(lrs) <= 0:
            raise RuntimeError(f"{tag} the one-rank DP step is not the single-device step")
        launches["parallel_dp_step_1rank"] = dp_launches

        fan, target = par_fan_setup(torch, "cuda")
        gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
        fan.sample(None, target, gen(6), n_designs=N_DESIGNS)  # captures the step graphs
        plain = fan.sample(None, target, gen(7), n_designs=N_DESIGNS)
        zero_launches()
        rows = sample_fanout_sharded(fan, None, target, gen(7), None, N_DESIGNS)
        torch.cuda.synchronize()
        launches["parallel_fanout_1rank"] = k_launches()
        zero_launches()
        scores = score_fanout_sharded(fan, None, target, rows, gen(8))
        torch.cuda.synchronize()
        launches["parallel_score_1rank"] = k_launches()
        plain_scores = fan.score_designs(None, target, plain, gen(8))
        same_rows = all(torch.equal(a, b) for a, b in zip(rows[:3], plain[:3]))
        same_scores = all(torch.equal(a, b) for a, b in zip(scores, plain_scores))
        mcfg = fan.config.model
        want_fan = (layer_calls(mcfg, fan.config.diffusion.T), 0)
        want_score = (layer_calls(mcfg, 2 * len(default_t_grid(fan.config.diffusion.T))), 0)
        print(f"{tag} sample_fanout_sharded({N_DESIGNS} designs, default_config() bf16, "
              f"T={fan.config.diffusion.T}, L={L_MAIN}) vs sample() from the same generator: "
              f"rows equal {same_rows}; launches K1, K2 {launches['parallel_fanout_1rank']} "
              f"(expected {want_fan}); score_fanout_sharded vs score_designs: equal "
              f"{same_scores}, launches {launches['parallel_score_1rank']} (expected "
              f"{want_score})")
        if not (same_rows and same_scores and launches["parallel_fanout_1rank"] == want_fan
                and launches["parallel_score_1rank"] == want_score):
            raise RuntimeError(f"{tag} the one-rank fan-out or scores differ from sample() / "
                               f"score_designs()")
    finally:
        dist.destroy_process_group()
    return launches


def plain_ipa_card_vs_cpu(torch):
    """[parallel] (e): the IPA layer's plain branch (no kernel: pair bias
    off, or pq != pv) on the card against the CPU, default_config() widths
    in float32, 8 designs of 2 targets at L=128 (16 padded residues).
    Tolerance 1e-4 of the output's scale; neither kernel may launch."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.models.ipa import InvariantPointAttentionLayer
    from diffab_pytorch_tpu_torch.weights import init_parameters

    base = C.default_config().model
    b = synthetic_batch(3, 8, L_MAIN, base.n_atoms)
    mask = b.residue_mask.clone()
    mask[:, -16:] = False
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((8, L_MAIN, base.d_residue_emb), generator=gen)
    pair = torch.randn((2, L_MAIN, L_MAIN, base.d_pair_emb), generator=gen)
    ok, pq = True, base.n_query_point_per_head
    for name, fields in (("no pair bias", dict(use_pair_bias=False)),
                         (f"pq={pq} != pv={pq // 2}", dict(n_value_point_per_head=pq // 2))):
        layer = init_parameters(InvariantPointAttentionLayer(dataclasses.replace(base, **fields)),
                                torch.Generator().manual_seed(1))
        args = (x, pair, b.orientations, b.translations, mask)
        with torch.no_grad():
            want = layer(*args)
            zero_launches()
            got = layer.to("cuda")(*(a.to("cuda") for a in args)).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        good = rel <= 1e-4 and k_launches() == (0, 0) and not layer.use_kernel
        ok = ok and good
        print(f"[parallel] (e) IPA layer's plain branch, {name}, card vs CPU (d=128, h=8, "
              f"b=8, bp=2, L={L_MAIN}, float32): max |d| / scale {rel:.2e} (tol 1e-4); "
              f"launches K1, K2 {k_launches()}; {'ok' if good else 'FAILED'}")
    if not ok:
        raise RuntimeError("[parallel] (e) the plain IPA branch on the card disagrees with the CPU")


def run_workers(torch, flag, world, args, out, tag, stem="rank"):
    """Run `world` processes of this script, `chip_smoke.py FLAG RANK WORLD
    PORT *args` (a free local port for their store), wait for all of them
    and return what each wrote to out/<stem><RANK>.pt; raises, with each
    rank's output, if one failed."""
    os.makedirs(out, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(world), str(port), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode != 0 for p in procs):
        for r, log in enumerate(logs):
            print(f"{tag} rank {r} exited {procs[r].returncode}:\n{log[-4000:]}")
        raise RuntimeError(f"{tag} a worker failed")
    return [torch.load(os.path.join(out, f"{stem}{r}.pt"), weights_only=False)
            for r in range(world)]


def parallel_worker(argv) -> int:
    """One rank of [parallel] (b) or (d), started by parallel_ranks:
    chip_smoke.py --parallel-worker RANK WORLD PORT BACKEND OUT_DIR.  The
    DP step PAR_STEPS times at the K1 flag on its rows from `par_state`
    under deterministic algorithms (the state checked replicated after
    each step), one step at fuse_ipa_layer=False (K2),
    the fan-out of PAR_LOCAL designs a rank; writes what it holds and its
    launch counts to OUT_DIR/rank<RANK>.pt.  With a sixth argument `rest`,
    one rank of [rest] (a) instead (`rest_worker`)."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from diffab_pytorch_tpu_torch.parallel.dp import make_dp_train_step, sample_fanout_sharded
    from diffab_pytorch_tpu_torch.parallel.mesh import batch_sharding, check_replicated, put_global

    rank, world, port, backend, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        if argv[5:6] == ["rest"]:
            rest_worker(rank, world, device, out)
            return 0
        res = {}
        for fuse, n_steps in ((None, PAR_STEPS), (False, 1)):
            harness, batch = par_train_setup(torch, device, fuse)
            rows = put_global(batch, batch_sharding())
            step, state = make_dp_train_step(harness), par_state(harness)
            per_step, before = [], k_launches()
            with deterministic(torch):
                for s in range(n_steps):
                    state, m = step(state, rows, par_draws(torch, harness, rows, s, rank))
                    check_replicated((state.params, state.ema_params))  # raises if ranks differ
                    per_step.append(({k: float(v) for k, v in m.items()},
                                     {k: v.detach().to("cpu", copy=True)
                                      for k, v in state.params.items()}))
            torch.cuda.synchronize()
            res[f"train_{fuse}"] = (per_step, tuple(
                b - a for a, b in zip(before, k_launches())))
        fan, target = par_fan_setup(torch, device)
        before = k_launches()
        rows = sample_fanout_sharded(fan, None, target,
                                     torch.Generator(device=device).manual_seed(9), None,
                                     PAR_LOCAL * world)
        torch.cuda.synchronize()
        res["fanout"] = ([x.cpu() for x in rows[:3]],
                         tuple(b - a for a, b in zip(before, k_launches())))
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def parallel_ranks(torch, world, backend, tmp, tag):
    """[parallel] (b) / (d): `world` worker processes (parallel_worker) on
    `backend`, against the host loop in this process on the card:
    host_dp_train_step over the same shards and draws, PAR_STEPS steps at
    the K1 flag and 1 at fuse_ipa_layer=False, from the end of the warmup
    (`par_state`: every step at a learning rate above 0, printed), both
    sides under deterministic algorithms, held to 1e-6 of each parameter
    leaf's scale and 1e-6 of the metrics; the ranks' states were checked
    bit-identical after every step in the workers; the fan-out's rows equal
    the host loop's (each rank's sample() of PAR_LOCAL designs from its
    rank generator, in rank order).  Returns {path: (K1, K2)} of rank 0,
    with every rank's counts checked equal."""
    from diffab_pytorch_tpu_torch.parallel.dp import host_dp_train_step, rank_generator
    from diffab_pytorch_tpu_torch.parallel.mesh import BatchSharding, put_global

    out = os.path.join(tmp, f"ranks_{backend}_{world}")
    ranks = run_workers(torch, "--parallel-worker", world, [backend, out], out, tag)

    checks, launches = {}, {}
    for fuse, n_steps in ((None, PAR_STEPS), (False, 1)):
        harness, batch = par_train_setup(torch, "cuda", fuse)
        state = par_state(harness)
        shards = [put_global(batch, BatchSharding(r, world)) for r in range(world)]
        d_params, d_metrics, lrs = [], [], []
        for s in range(n_steps):
            lrs.append(harness.learning_rate(state.opt_state.count))
            with deterministic(torch):
                state, m = host_dp_train_step(
                    harness, state, shards, [par_draws(torch, harness, x, s, r)
                                             for r, x in enumerate(shards)])
            got_m, got_p = ranks[0][f"train_{fuse}"][0][s]
            d_params.append(leaf_rel(got_p, {k: v.cpu() for k, v in state.params.items()}))
            d_metrics.append(max(abs(got_m[k] - float(v)) / max(abs(float(v)), 1.0)
                                 for k, v in m.items()))
        counts = [r[f"train_{fuse}"][1] for r in ranks]
        per_step = layer_calls(harness.config.model) * n_steps
        want = (per_step, 0) if fuse is None else (0, per_step)
        name = f"train_fuse_{fuse}"
        checks[name] = max(d_params) <= 1e-6 and max(d_metrics) <= 1e-6 and all(
            c == want for c in counts) and min(lrs) > 0
        launches[f"parallel_{backend}{world}_{name}"] = counts[0]
        print(f"{tag} {world} ranks, {backend}, DP step fuse_ipa_layer={fuse}, {world} x "
              f"{batch.batch_size // world} rows, {n_steps} steps at lr {lrs} vs the host loop, both "
              f"under deterministic algorithms: parameters "
              f"max |d| / scale by step {[f'{v:.2e}' for v in d_params]}, metrics "
              f"{[f'{v:.2e}' for v in d_metrics]} (tol 1e-6); ranks bit-identical after every "
              f"step (checked in the workers); launches K1, K2 per rank {counts} (expected "
              f"{want}); {'ok' if checks[name] else 'FAILED'}")
    fan, target = par_fan_setup(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    parts = [fan.sample(None, target, rank_generator(gen, r), n_designs=PAR_LOCAL)
             for r in range(world)]
    host = [torch.cat([getattr(p, f) for p in parts]).cpu()
            for f in ("seq_idx", "translations", "orientations")]
    same = [all(torch.equal(a, b) for a, b in zip(r["fanout"][0], host)) for r in ranks]
    counts = [r["fanout"][1] for r in ranks]
    want = (layer_calls(fan.config.model, fan.config.diffusion.T), 0)
    checks["fanout"] = all(same) and all(c == want for c in counts)
    launches[f"parallel_{backend}{world}_fanout"] = counts[0]
    print(f"{tag} {world} ranks, {backend}: sample_fanout_sharded {world} x {PAR_LOCAL} designs "
          f"(default_config() bf16, T={fan.config.diffusion.T}) vs the host loop's rows in "
          f"rank order: equal on each rank {same}; launches K1, K2 per rank {counts} (expected "
          f"{want})")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} failed: {checks}")
    return launches


def run_clis(argv) -> int:
    """[parallel] (c)'s process under torchrun: chip_smoke.py --run-clis
    MODULE ARGS... [--then MODULE ARGS...]: each module's main() in turn
    under deterministic(), each followed by a line with its K1 and K2
    launches."""
    import runpy

    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs, cur = [], []
    for a in argv:
        if a == "--then":
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    with deterministic(torch):
        for module, *args in runs:
            before = k_launches()
            sys.argv = [module, *args]
            try:
                runpy.run_module(module, run_name="__main__", alter_sys=True)
            except SystemExit as e:
                if e.code not in (0, None):
                    raise
            got = tuple(b - a for a, b in zip(before, k_launches()))
            print(f"[run-clis] {module} launches K1 {got[0]} K2 {got[1]}", flush=True)
    return 0


def parallel_clis(torch, patches, tmp):
    """[parallel] (c): `cli.train --production --max-steps PAR_CLI_STEPS`
    in this process, then `cli.train ... --data-parallel` and `cli.sample
    --data-parallel --rank -n PAR_CLI_DESIGNS` from its checkpoint under
    `python -m torch.distributed.run --standalone --nproc-per-node 1`
    (run_clis), both trainings under deterministic(): the two checkpoints
    are bitwise equal (parameters, moments, EMA); the designs and scores
    are written once.  Returns {path: (K1, K2)}."""
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import train as train_cli
    from diffab_pytorch_tpu_torch.sampling.scoring import default_t_grid
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt

    tag = "[parallel] (c)"
    argv = ["--data-dir", patches, "--production", "--max-steps", str(PAR_CLI_STEPS),
            "--no-resume"]
    ck_plain, ck_dp = os.path.join(tmp, "ck_par_plain"), os.path.join(tmp, "ck_par_dp")
    log = io.StringIO()
    zero_launches()
    with deterministic(torch), contextlib.redirect_stdout(log):
        rc = train_cli.main(argv + ["--checkpoint-dir", ck_plain])
    torch.cuda.synchronize()
    plain_launches = k_launches()

    patch = os.path.join(patches, sorted(os.listdir(patches))[0])
    out = os.path.join(tmp, "designs_par")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", os.path.abspath(__file__), "--run-clis", "diffab_pytorch_tpu_torch.cli.train",
           *argv, "--checkpoint-dir", ck_dp, "--data-parallel", "--then",
           "diffab_pytorch_tpu_torch.cli.sample", "--patch", patch, "--checkpoint-dir", ck_dp,
           "-n", str(PAR_CLI_DESIGNS), "--rank", "-o", out, "--data-parallel"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=HERE))
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
        raise RuntimeError(f"{tag} the torchrun CLIs exited {proc.returncode}")
    counts = [tuple(int(v) for v in re.findall(r"launches K1 (\d+) K2 (\d+)", line)[0])
              for line in proc.stdout.splitlines() if line.startswith("[run-clis]")]
    a, b = (ckpt.restore_checkpoint(d, "cpu") for d in (ck_plain, ck_dp))
    pairs = ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu), (a.ema_params, b.ema_params))
    equal = a.step == b.step == PAR_CLI_STEPS and all(
        set(x) == set(y) and all(torch.equal(x[k].detach(), y[k].detach()) for k in x)
        for x, y in pairs)
    pcfg = C.production_config()
    # rank 0 validates at each epoch end, one K1 call a layer per validation batch
    n_patches, bsz = len(os.listdir(patches)), pcfg.train.batch_size
    n_val = int(n_patches * pcfg.train.val_pct)
    n_evals = PAR_CLI_STEPS // ((n_patches - n_val) // bsz)
    want_train = (layer_calls(pcfg.model, PAR_CLI_STEPS + n_evals * math.ceil(n_val / bsz)), 0)
    T = pcfg.diffusion.T
    want_sample = (layer_calls(C.default_config().model, T + 2 * len(default_t_grid(T))), 0)
    names = sorted(os.listdir(out)) if os.path.isdir(out) else []
    checks = {
        "rc": rc == 0,
        "checkpoints_equal": equal,
        "data_parallel": "data-parallel over 1 ranks" in proc.stdout,
        "launches": plain_launches == want_train and counts == [want_train, want_sample],
        "designs": names == [f"design_{i:04d}.pdb" for i in range(PAR_CLI_DESIGNS)]
        + ["designs.fasta", "scores.json"],
    }
    print(f"{tag} cli.train {' '.join(argv[2:])} in process, launches K1, K2 "
          f"{plain_launches}; under torchrun --nproc-per-node 1 with --data-parallel, then "
          f"cli.sample --data-parallel --rank -n {PAR_CLI_DESIGNS}: launches {counts} (expected "
          f"{[want_train, want_sample]}); checkpoints at step {b.step} bitwise equal {equal}; "
          f"{len(names)} files; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} failed: {checks}")
    return {"parallel_cli_train": counts[0], "parallel_cli_sample": counts[1]}


def parallel_phase(torch, patches, tmp):
    """[parallel]: (a) NCCL, world size 1, in process (parallel_one_rank);
    (e) the IPA layer's plain branch card vs CPU; (b) two ranks on the one
    card over gloo (NCCL refuses two ranks on one card); (c) the CLIs under
    torchrun; (d) one rank per card over NCCL when there is more than one
    card.  Returns {path: (K1, K2)}."""
    launches = parallel_one_rank(torch)
    plain_ipa_card_vs_cpu(torch)
    launches.update(parallel_ranks(torch, 2, "gloo", tmp, "[parallel] (b)"))
    launches.update(parallel_clis(torch, patches, tmp))
    n_cards = torch.cuda.device_count()
    if n_cards > 1 and PAR_BATCH % n_cards == 0:
        launches.update(parallel_ranks(torch, n_cards, "nccl", tmp, "[parallel] (d)"))
    else:
        print(f"[parallel] (d) {n_cards} card(s) on this machine: one rank per card over NCCL "
              f"needs more than one card (and a batch of {PAR_BATCH} divisible by their count); "
              f"not run")
    return launches


TP_STEPS = 3  # (a)-(c): tp steps held against their reference
TP_RUNS = (("float32", None), ("float32", False), ("bfloat16", None), ("bfloat16", False))
TP_HEADS = (4, 2, 1)  # (e): one rank's heads at tp = 2, 4, 8 of the default h = 8
# (b) bf16: two bf16 runs that round apart each sit about the bf16-float32 gap from
# float32, and about sqrt(2) times that gap from each other; a scalar loss one bf16
# step (2^-8 of its value) apart
TP_BF16_FACTOR = 2.0


def tp_one_rank(torch):
    """[tp] (a): NCCL, world size 1, in this process: make_mesh(1) and
    make_sharded_train_step at production_config() (bf16, batch 32, L=128)
    from the end of the warmup, against train_step with the same draws for
    TP_STEPS steps under deterministic algorithms, bitwise (metrics,
    parameters, EMA), at fuse_ipa_layer None (K1 6 a step) and False (K2 6
    a step).  Returns {path: (K1, K2)}."""
    import torch.distributed as dist

    from diffab_pytorch_tpu_torch.parallel.mesh import make_mesh
    from diffab_pytorch_tpu_torch.parallel.tp import make_sharded_train_step, shard_state

    tag, launches = "[tp] (a)", {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        for fuse in (None, False):
            harness, batch = par_train_setup(torch, "cuda", fuse)
            step = make_sharded_train_step(harness, mesh)
            equal, counts = [], (0, 0)
            with deterministic(torch):
                tp_state, state = shard_state(par_state(harness), mesh), par_state(harness)
                for s in range(TP_STEPS):
                    d = par_draws(torch, harness, batch, s, 0)
                    before = k_launches()
                    tp_state, m_tp = step(tp_state, batch, d)
                    torch.cuda.synchronize()
                    counts = tuple(a + c - b for a, b, c in zip(counts, before, k_launches()))
                    state, m = harness.train_step(state, batch, d)
                    equal.append(all(torch.equal(m_tp[k], m[k]) for k in m) and all(
                        torch.equal(tp_state.params[k], state.params[k])
                        and torch.equal(tp_state.ema_params[k], state.ema_params[k])
                        for k in state.params))
            n = TP_STEPS * layer_calls(harness.config.model)
            want = (n, 0) if fuse is None else (0, n)
            launches[f"tp_nccl1_fuse_{fuse}"] = counts
            ok = all(equal) and counts == want
            print(f"{tag} NCCL world size 1, mesh {mesh.shape}: make_sharded_train_step vs "
                  f"train_step, production_config() (bf16, batch 32, L={L_MAIN}), "
                  f"fuse_ipa_layer={fuse}, {TP_STEPS} steps from the warmup's end under "
                  f"deterministic algorithms: metrics, parameters and EMA bitwise equal by step "
                  f"{equal}; launches K1, K2 {counts} (expected {want}); "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{tag} the tp = 1 step is not the single-device step")
    finally:
        dist.destroy_process_group()
    return launches


def tp_replay(torch, device, dtype, fuse, batch, dp, tp, steps):
    """[tp] (b) / (c)'s references, on rank 0 of the workers: each checked
    tp step replayed in this one process on the card from the tp run's
    gathered pre-step state with the same draws, under deterministic
    algorithms.  The gradients of `train_step` (`loss_and_grads`; at dp > 1
    `host_dp_loss_and_grads` over the dp shards) and, in float32, of the
    host loop of the tp ranks' parts (`host_tp_harness`: the same kernel
    calls at h / tp heads, summed in this process), against the tp step's
    (gathered over tp, averaged over dp); the update, `apply_gradients` on
    the pre-step state with the tp step's own gradients, against the tp
    step's parameters; for bf16 the whole step (the replay's own gradients
    and update) against the tp step's, with the same distances between the
    replay in bf16 and in float32 (the bf16 step's own rounding gap).
    Returns by step: metrics (the largest relative difference against
    train_step), update (max |d| over each leaf's scale, at least 1);
    float32: host and single (max |d| over the whole gradient's largest
    entry, against the host loop and against train_step) and far (the
    leaf of train_step's largest |d|, it, and the leaf's largest entry);
    bf16: grads, grads_gap (relative L2 distances), step and step_gap (the
    parameters' distance as a share of the step's update)."""
    from diffab_pytorch_tpu_torch.parallel.dp import host_dp_loss_and_grads
    from diffab_pytorch_tpu_torch.parallel.mesh import BatchSharding, put_global
    from diffab_pytorch_tpu_torch.parallel.tp import host_tp_harness
    from diffab_pytorch_tpu_torch.train.harness import OptState, TrainState

    dtypes = (dtype,) if dtype == "float32" else (dtype, "float32")
    harnesses = {dt: par_train_setup(torch, device, fuse, dt)[0] for dt in dtypes}
    shards = [put_global(batch, BatchSharding(r, dp)) for r in range(dp)]
    on = lambda d, grad=False: {k: v.to(device, copy=True).requires_grad_(grad)
                                for k, v in d.items()}
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}

    def loss_and_grads(harness, params, draws, step):
        if dp == 1:
            _, metrics, grads = harness.loss_and_grads(params, batch, draws[0], step)
        else:
            grads, metrics = host_dp_loss_and_grads(harness, params, shards, draws, step)
        return {f"train/{k}": float(v) for k, v in metrics.items()}, host(grads)

    out = []
    with deterministic(torch):
        for s, rec in enumerate(steps):
            pre = rec["pre"]
            fresh = lambda: TrainState(pre["step"], on(pre["params"], True),
                                       OptState(pre["count"], on(pre["mu"]), on(pre["nu"])),
                                       on(pre["ema"]))
            got = {}
            for dt, harness in harnesses.items():
                state = fresh()
                draws = [par_draws(torch, harness, x, s, r) for r, x in enumerate(shards)]
                metrics, grads = loss_and_grads(harness, state.params, draws, state.step)
                own = harness.apply_gradients(state, on(grads))
                got[dt] = (grads, metrics, host(own.params))
            grads, metrics, own = got[dtype]
            replayed = harnesses[dtype].apply_gradients(fresh(), on(rec["grads"]))
            row = dict(metrics=max(abs(rec["metrics"][k] - v) / max(abs(v), 1e-30)
                                   for k, v in metrics.items()),
                       update=leaf_rel(rec["post"], host(replayed.params)))
            if dtype == "float32":
                top = max(float(v.abs().max()) for v in grads.values())
                state = fresh()
                _, host_grads = loss_and_grads(host_tp_harness(harnesses[dtype], tp),
                                               state.params, draws, state.step)
                diff = {k: float((rec["grads"][k] - v).abs().max()) for k, v in grads.items()}
                far = max(diff, key=diff.get)
                row.update(host=max(float((rec["grads"][k] - v).abs().max())
                                    for k, v in host_grads.items()) / top,
                           single=diff[far] / top,
                           far=(far, diff[far], float(grads[far].abs().max())))
            else:
                g32, _, own32 = got["float32"]
                row.update(grads=grad_l2(rec["grads"], grads), grads_gap=grad_l2(grads, g32),
                           step=update_l2(rec["post"], own, pre["params"]),
                           step_gap=update_l2(own, own32, pre["params"]))
            out.append(row)
    return out


def tp_worker(argv) -> int:
    """One rank of [tp] (b), (c) or (f), started by run_workers: chip_smoke.py
    --tp-worker RANK WORLD PORT TP BACKEND OUT_DIR.  Gloo on the one card
    (or NCCL, one card a rank), the (dp, tp) mesh over WORLD ranks; for
    each of TP_RUNS (tp = WORLD) or float32 at the K1 flag (dp x tp): the
    state from `par_state`, sharded; TP_STEPS steps under deterministic
    algorithms, each after the gradients of the pre-step state (gathered
    over tp), with the replicated leaves checked bit-identical over the
    mesh after each step; then (tp = WORLD, the first run) the sharded
    checkpoint saved and restored into the mesh; then the collectives of
    one step (count and bytes); last, on rank 0, the checked steps
    replayed single-device (`tp_replay`).  Writes what it holds to
    OUT_DIR/rank<RANK>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from diffab_pytorch_tpu_torch.parallel.mesh import (
        batch_sharding, check_replicated, make_mesh, param_sharding, put_global)
    from diffab_pytorch_tpu_torch.parallel.tp import (
        gather_params, gather_state, head_shard, make_sharded_train_step, shard_state,
        tp_harness)
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt

    rank, world, port, tp = (int(a) for a in argv[:4])
    backend, out = argv[4], argv[5]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    cpu = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}

    def host_state(state):
        full = gather_state(state, mesh)  # a collective: every rank calls it
        return dict(step=full.step, count=full.opt_state.count, params=cpu(full.params),
                    mu=cpu(full.opt_state.mu), nu=cpu(full.opt_state.nu),
                    ema=cpu(full.ema_params))
    try:
        mesh = make_mesh(tp)
        res = {}
        for i, (dtype, fuse) in enumerate(TP_RUNS if tp == world else TP_RUNS[:1]):
            harness, batch = par_train_setup(torch, device, fuse, dtype)
            local = tp_harness(harness, head_shard(harness.config.model, mesh))
            rows = put_global(batch, batch_sharding(mesh.dp_group))
            state = shard_state(par_state(harness), mesh)
            splits = param_sharding(state.params, mesh)
            step = make_sharded_train_step(harness, mesh)
            draws = lambda s: par_draws(torch, harness, rows, s, mesh.dp_rank)
            per_step, counts, lrs = [], (0, 0), []
            with deterministic(torch):
                for s in range(TP_STEPS):
                    pre = host_state(state)
                    lrs.append(harness.learning_rate(state.opt_state.count))
                    _, _, grads = local.loss_and_grads(state.params, rows, draws(s), state.step)
                    grads = gather_params([grads], mesh)[0]
                    if mesh.shape["dp"] > 1:  # the average the step applies
                        flat = torch.cat([g.reshape(-1) for g in grads.values()])
                        dist.all_reduce(flat, group=mesh.dp_group)
                        flat /= mesh.shape["dp"]
                        grads = dict(zip(grads, (f.view_as(g) for f, g in zip(
                            flat.split([g.numel() for g in grads.values()]), grads.values()))))
                    torch.cuda.synchronize()
                    before = k_launches()
                    state, m = step(state, rows, draws(s))
                    torch.cuda.synchronize()
                    counts = tuple(a + c - b for a, b, c in zip(counts, before, k_launches()))
                    check_replicated([v for k, v in state.params.items() if splits[k] is None]
                                     + [v for k, v in state.ema_params.items()
                                        if splits[k] is None], mesh.group)
                    per_step.append(dict(pre=pre, grads=cpu(grads), post=host_state(state)[
                        "params"], metrics={k: float(v) for k, v in m.items()}))
            run = dict(launches=counts, lrs=lrs, heads=local.model.denoiser.ipa.layers[0].n_head)
            if tp == world and i == 0:
                ck_dir = os.path.join(out, "ck_tp")
                ckpt.save_checkpoint(ck_dir, state, mesh=mesh)
                back = ckpt.restore_checkpoint(ck_dir, device, mesh=mesh)
                run["restored_equal"] = all(
                    torch.equal(back.params[k].detach(), v.detach()) and torch.equal(
                        back.ema_params[k], state.ema_params[k]) and torch.equal(
                        back.opt_state.mu[k], state.opt_state.mu[k]) and torch.equal(
                        back.opt_state.nu[k], state.opt_state.nu[k])
                    for k, v in state.params.items())
                saved = host_state(state)
                if rank == 0:
                    run["saved"] = saved
            real, seen = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}, []

            def counted(name):
                def call(t, *a, **k):
                    x = a[0] if name == "all_gather" else t
                    seen.append((name, x.numel() * x.element_size()))
                    return real[name](t, *a, **k)
                return call
            for n in real:
                setattr(dist, n, counted(n))
            try:
                state, _ = step(state, rows, draws(100))
                torch.cuda.synchronize()
            finally:
                for n, f in real.items():
                    setattr(dist, n, f)
            run["collectives"] = seen
            del state, local
            if rank == 0:
                run["check"] = tp_replay(torch, device, dtype, fuse, batch,
                                         mesh.shape["dp"], tp, per_step)
            res[f"{dtype}_{fuse}"] = run
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def grad_l2(a: dict, b: dict) -> float:
    """|a - b| / |b| over all leaves together."""
    num = sum(float((a[k].float() - v.float()).square().sum()) for k, v in b.items())
    return (num / max(sum(float(v.float().square().sum()) for v in b.values()), 1e-30)) ** 0.5


def update_l2(a: dict, b: dict, before: dict) -> float:
    """|a - b| over |b - before|: two steps' parameters against one step's
    update, all leaves together."""
    num = sum(float((a[k] - v).square().sum()) for k, v in b.items())
    return (num / max(sum(float((v - before[k]).square().sum()) for k, v in b.items()),
                      1e-30)) ** 0.5


def tp_rule(dtype, fuse, check) -> tuple[bool, str]:
    """[tp]'s rule on a run's replayed steps (`tp_replay`).  Both dtypes:
    the update the tp step makes from its own gradients within 1e-5 of
    each leaf's scale (at least 1) of the single-device update from those
    gradients.  float32: the gradients within 1e-5 of the whole gradient's
    largest entry of the host loop of the tp ranks' parts on the card, and
    at fuse_ipa_layer=False of train_step's too; the metrics within 1e-5
    relative of train_step's.  At the K1 flag train_step's gradient
    distance is a reading, not a gate: K1's float32 route (3xTF32) rounds
    a layer's output ~3e-6 of its scale apart at 4 and 8 heads (its
    per-head weights are bitwise equal; PERF.md §6), and a ReLU of a
    head whose input lies that close to 0 changes side.  bf16 (stated
    before the first run): the gradients' relative L2 distance and the
    whole step's parameters' distance as a share of its update each at
    most TP_BF16_FACTOR times the replay's own bf16-float32 gap, the
    metrics within 2^-8 relative.  Returns (passed, what it read)."""
    col = lambda key, fmt=".2e": [f"{row[key]:{fmt}}" for row in check]
    if dtype == "float32":
        ok = all(max(row["host"], row["update"], row["metrics"]) <= 1e-5
                 and (fuse is not False or row["single"] <= 1e-5) for row in check)
        far = [(row["far"][0], f"{row['far'][1]:.2e}", f"{row['far'][2]:.2e}") for row in check]
        return ok, (f"gradients max |d| / the gradient's largest entry by step, against the "
                    f"host loop of the tp ranks' parts on the card {col('host')} and against "
                    f"the single-device step {col('single')}"
                    + (" (a reading at the K1 flag: the largest |d| (leaf, |d|, its largest "
                       f"entry) {far})" if fuse is not False else "")
                    + f"; update from the tp gradients / leaf scale {col('update')}; metrics "
                    f"{col('metrics')} (tol 1e-5)")
    ok = all(row["metrics"] <= 2 ** -8 and row["update"] <= 1e-5
             and row["grads"] <= TP_BF16_FACTOR * row["grads_gap"]
             and row["step"] <= TP_BF16_FACTOR * row["step_gap"] for row in check)
    return ok, (f"gradient L2 by step {col('grads', '.3e')} vs the bf16-float32 gap "
                f"{col('grads_gap', '.3e')}; the step's parameters / update {col('step', '.3e')} "
                f"vs {col('step_gap', '.3e')} (rule: at most {TP_BF16_FACTOR} x the gap); update "
                f"from the tp gradients / leaf scale {col('update')} (tol 1e-5); metrics "
                f"{col('metrics')} (tol 2^-8)")


def tp_collectives_line(tag, backend, name, got):
    """The collectives a step of a run's first rank: count and bytes."""
    coll = got[0]["collectives"]
    by_kind = {k: (sum(1 for c in coll if c[0] == k), sum(c[1] for c in coll if c[0] == k))
               for k in ("all_reduce", "all_gather")}
    print(f"{tag} {name}: collectives a step per rank {by_kind} (count, bytes; {backend})")


def tp_two_ranks(torch, tmp, backend="gloo", tag="[tp] (b)"):
    """[tp] (b) and (d) (or (f): NCCL, one card a rank): two tp_worker ranks
    at tp = 2 (4 heads a rank) for TP_RUNS, each checked step held to
    train_step's gradients and update on the card from the same state with
    the same draws (`tp_replay`, `tp_rule`); the replicated leaves bit-identical over the
    ranks after every step (checked in the workers); K1 or K2 6 a step on 4
    heads; every step at a learning rate above 0.  (d): the sharded
    checkpoint restored into the ranks equals their parts, and restored
    single-device the gathered state, bitwise.  Returns {path: (K1, K2)}."""
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt

    out = os.path.join(tmp, f"tp_{backend}_2_2")
    ranks = run_workers(torch, "--tp-worker", 2, ["2", backend, out], out, tag)
    launches, checks = {}, {}
    for dtype, fuse in TP_RUNS:
        name = f"{dtype}_{fuse}"
        got = [r[name] for r in ranks]
        n = TP_STEPS * 6
        want = (n, 0) if fuse is None else (0, n)
        counts = [g["launches"] for g in got]
        ok, rule = tp_rule(dtype, fuse, got[0]["check"])
        lrs = got[0]["lrs"]
        ok = ok and all(c == want for c in counts) and min(lrs) > 0 and all(
            g["heads"] == 4 for g in got)
        checks[name] = ok
        launches[f"tp_{backend}2_{name}"] = counts[0]
        print(f"{tag} 2 ranks, {backend}, tp = 2 ({got[0]['heads']} heads a rank), "
              f"production_config() {dtype}, fuse_ipa_layer={fuse}, {TP_STEPS} steps at lr "
              f"{[f'{v:.2e}' for v in lrs]}, each replayed on the card from the same "
              f"state: {rule}; launches K1, K2 per rank {counts} (expected {want}); "
              f"{'ok' if ok else 'FAILED'}")
        tp_collectives_line(tag, backend, name, got)
    name = "_".join(map(str, TP_RUNS[0]))
    restored = [r[name]["restored_equal"] for r in ranks]
    back = ckpt.restore_checkpoint(os.path.join(out, "ck_tp"), "cpu")
    saved = ranks[0][name]["saved"]
    single = all(torch.equal(a[k].detach(), b[k]) for a, b in (
        (back.params, saved["params"]), (back.opt_state.mu, saved["mu"]),
        (back.opt_state.nu, saved["nu"]), (back.ema_params, saved["ema"])) for k in b)
    single = single and (back.step, back.opt_state.count) == (saved["step"], saved["count"])
    checks["checkpoint"] = all(restored) and single
    print(f"{tag} (d) the sharded state after the {name} steps saved (gathered over tp, "
          f"rank 0 writes): restored into the 2 ranks equal to their parts bitwise "
          f"{restored}; restored single-device equal to the gathered state bitwise {single} "
          f"(step {back.step})")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} failed: {checks}")
    return launches


def tp_dp_by_tp(torch, tmp):
    """[tp] (c): four tp_worker ranks over gloo on the card, dp = 2 x
    tp = 2, float32 at the K1 flag, each of TP_STEPS steps held to the
    host DP step (`host_dp_loss_and_grads` over the two dp shards with
    their draws, then the update) on the card from the same state
    (`tp_replay`, `tp_rule`).  Returns {path: (K1, K2)}."""
    tag = "[tp] (c)"
    out = os.path.join(tmp, "tp_gloo_4_2")
    ranks = run_workers(torch, "--tp-worker", 4, ["2", "gloo", out], out, tag)
    got = [r["float32_None"] for r in ranks]
    counts = [g["launches"] for g in got]
    want = (TP_STEPS * 6, 0)
    ok, rule = tp_rule("float32", None, got[0]["check"])
    ok = ok and all(c == want for c in counts) and min(got[0]["lrs"]) > 0
    print(f"{tag} 4 ranks, gloo on the card, dp = 2 x tp = 2, production_config() float32, "
          f"2 x 16 rows, {TP_STEPS} steps, each replayed with the host DP step on the card "
          f"from the same state: {rule}; launches K1, K2 per rank {counts} (expected {want}); "
          f"{'ok' if ok else 'FAILED'}")
    tp_collectives_line(tag, "gloo", "float32_None", got)
    if not ok:
        raise RuntimeError(f"{tag} the dp x tp step disagrees with the host DP step")
    return {"tp_gloo4_dp2_tp2": counts[0]}


def tp_kernels(torch, card, pb):
    """[tp] (e): K1 and K2 at one tp rank's head counts (h = 4, 2, 1 of 8),
    d = 128, ds = 32, P = 8, b = bp = 32 and b = 128 / bp = 1, L = 128 and
    256, in both dtypes, against their plain versions (check_layer /
    check_attention's rules, 8 padded keys); K1 at h = 8 against its two
    halves (`tp_head_halves`); then kernel_times at each h.  Returns (K1
    error, K2 error, {h: kernel_times(...)})."""
    err1 = err2 = 0.0
    with torch.no_grad():
        for i, (h, L, (b, bp), dtype) in enumerate(
                (h, L, shape, dtype) for h in TP_HEADS for L in (L_MAIN, 256)
                for shape in ((32, 32), (N_DESIGNS, 1))
                for dtype in (torch.bfloat16, torch.float32)):
            bf = dtype == torch.bfloat16
            name = f"[tp] (e) {'bf16' if bf else 'f32'} h={h} L={L} b={b} bp={bp}"
            err1 = max(err1, check_layer(
                torch, f"{name} K1", layer_inputs(torch, b, bp, L, 128, h, 32, 8, dtype,
                                                  600 + i, 8), bf16=bf))
            err2 = max(err2, check_attention(
                torch, f"{name} K2", attention_inputs(torch, b, bp, L, h, 32, 8, dtype,
                                                      700 + i, 8), 8, bf16=bf))
        tp_head_halves(torch)
    times = {h: kernel_times(torch, card, pb, h=h) for h in TP_HEADS}
    for h, t in times.items():
        err1 = max(err1, t[3], t[4])
    return err1, err2, times


def tp_head_halves(torch):
    """[tp] (e): one K1 call at h = 8 against two at h = 4 on each half of
    its heads' packed weights and biases (L = 128, both shapes and
    dtypes): each block computes one (head, design), so the attention
    weights must be bitwise equal; the output, the sum of the halves',
    is printed as a share of the output's scale (the head-count rounding
    the tp step's float32 rule meets, PERF.md §6)."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    for b, bp in ((32, 32), (N_DESIGNS, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            a = layer_inputs(torch, b, bp, L_MAIN, 128, 8, 32, 8, dtype, 800 + b, 8)
            w = a["wts"]
            fh = w.w_out.shape[0] // w.n_head
            acc8, attn8 = op.fused_ipa_layer_packed(**a)
            halves = []
            for r in range(2):
                sl = slice(4 * r, 4 * r + 4)
                wr = op.LayerKernelWeights(w.w_qkv[sl].contiguous(),
                                           w.w_out[sl.start * fh:sl.stop * fh].contiguous(),
                                           w.g[sl].contiguous(), 4, w.d_scalar, w.n_point)
                halves.append(op.fused_ipa_layer_packed(**dict(
                    a, wts=wr, bias=a["bias"][:, sl].contiguous())))
            same = torch.equal(torch.cat([h[1] for h in halves], 1), attn8)
            summed = halves[0][0].float() + halves[1][0].float()
            apart = float((summed - acc8.float()).abs().max()
                          / acc8.float().abs().max().clamp(min=1.0))
            print(f"[tp] (e) K1 at h = 8 vs two calls at h = 4 on its halves ({dtype}, b={b} "
                  f"bp={bp} L={L_MAIN}): attention weights bitwise equal {same}; outputs' sum "
                  f"{apart:.2e} of the output's scale apart")
            if not same:
                raise RuntimeError("[tp] (e) K1's attention weights depend on the head count")


def tp_phase(torch, card, tmp, k1_times, k2_times):
    """[tp]: (a) one NCCL rank; (b) two ranks on the card over gloo, with
    (d) the checkpoints; (c) four ranks, dp x tp; (e) the kernels at the
    path's head counts, with their times beside h = 8's (`k1_times`,
    `k2_times` from phase 7); (f) one rank per card over NCCL where there
    are several cards.  Returns ({path: (K1, K2)}, K1 error, K2 error,
    {h: times})."""
    launches = tp_one_rank(torch)
    launches.update(tp_two_ranks(torch, tmp))
    launches.update(tp_dp_by_tp(torch, tmp))
    err1, err2, times = tp_kernels(torch, card, PAR_BATCH)
    for label in ("sample", "train"):
        t4 = times[4]
        print(f"[tp] (e) per launch at L={L_MAIN}, {label} shape, h = 4 beside h = 8 (card: "
              f"{card}): K1 bf16 {t4[0][label]['ms']:.4f} vs {k1_times[label]['ms']:.4f} ms "
              f"(x{t4[0][label]['ms'] / k1_times[label]['ms']:.3f}; bound "
              f"{t4[0][label]['bound_ms']:.5f} vs {k1_times[label]['bound_ms']:.5f}); K2 bf16 "
              f"{t4[2][('bfloat16', label)]['ms']:.4f} vs "
              f"{k2_times[('bfloat16', label)]['ms']:.4f} ms (bound "
              f"{t4[2][('bfloat16', label)]['bound_ms']:.5f} vs "
              f"{k2_times[('bfloat16', label)]['bound_ms']:.5f})")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        launches.update(tp_two_ranks(torch, tmp, "nccl", "[tp] (f)"))
    else:
        print(f"[tp] (f) {n_cards} card on this machine: tp = 2 over NCCL, one rank per card, "
              f"needs two cards or more; not run")
    return launches, err1, err2, times


REST_TARGETS = 8  # (a): targets of sample_sharded, each its own seed
REST_K = 4  # (b): steps_per_call
REST_RECIPE = dict(n_steps=25)  # (c): the 25-step recipe of bench.py, traced and timed
REST_COMBOS_PER = 4  # (d): instances of each train combination in the corpus
REST_CLI_STEPS = 4  # (d): cli.train steps on the corpus


def rest_targets(torch, device, n=REST_TARGETS, seed0=300):
    """n synthetic L_MAIN-residue targets, each drawn from its own seed, as
    one batch of n rows."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import ProteinBatch, synthetic_batch

    parts = [synthetic_batch(seed0 + i, 1, L_MAIN, C.default_config().model.n_atoms,
                             n_generate=N_GENERATE, device=device) for i in range(n)]
    return ProteinBatch(**{f.name: None if getattr(parts[0], f.name) is None else
                           torch.cat([getattr(p, f.name) for p in parts])
                           for f in dataclasses.fields(ProteinBatch)})


def rest_worker(rank, world, device, out) -> None:
    """[rest] (a) on one of two gloo ranks sharing the card (parallel_worker
    with the mode `rest`): sample_sharded of REST_TARGETS targets, its
    rows and launch counts to OUT_DIR/rest<RANK>.pt."""
    import torch

    from diffab_pytorch_tpu_torch.parallel.dp import sample_sharded

    fan, _ = par_fan_setup(torch, device)
    targets = rest_targets(torch, device)
    before = k_launches()
    rows = sample_sharded(fan, None, targets, torch.Generator(device=device).manual_seed(31),
                          None)
    torch.cuda.synchronize()
    torch.save(([x.cpu() for x in rows[:3]], tuple(b - a for a, b in zip(before, k_launches()))),
               os.path.join(out, f"rest{rank}.pt"))


def rest_sample_sharded(torch, tmp):
    """[rest] (a): sample_sharded of REST_TARGETS 128-residue targets
    (default_config() bf16, T=100, one design each).  NCCL at world size 1
    in this process: bitwise sample() on the same batch from the same
    generator, K1 at b = bp = REST_TARGETS.  Then two gloo ranks sharing
    the card (--parallel-worker ... rest processes), REST_TARGETS / 2 targets each, against the host loop
    of each rank's sample() from its rank generator: bitwise, as [parallel]
    (b) holds the fan-out (sampling has no backward pass, so no atomics).
    Returns {path: (K1, K2)}."""
    import torch.distributed as dist

    from diffab_pytorch_tpu_torch.parallel.dp import rank_generator, sample_sharded
    from diffab_pytorch_tpu_torch.parallel.mesh import BatchSharding, put_global

    tag = "[rest] (a)"
    fan, _ = par_fan_setup(torch, "cuda")
    targets = rest_targets(torch, "cuda")
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    mcfg, T = fan.config.model, fan.config.diffusion.T
    want = (layer_calls(mcfg, T), 0)
    launches = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                            world_size=1)
    try:
        sample_sharded(fan, None, targets, gen(30), None)  # captures the step graphs
        plain = fan.sample(None, targets, gen(31))
        zero_launches()
        rows = sample_sharded(fan, None, targets, gen(31), None)
        torch.cuda.synchronize()
        launches["rest/sample_sharded"] = k_launches()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(rows[:3], plain[:3]))
    finite = bool(torch.isfinite(rows.translations).all() and torch.isfinite(rows.orientations).all())
    print(f"{tag} NCCL world size 1: sample_sharded({REST_TARGETS} targets of L={L_MAIN}, "
          f"default_config() bf16, T={T}) vs sample() on the same batch from the same generator: "
          f"rows bitwise equal {same}, finite {finite}; launches K1, K2 "
          f"{launches['rest/sample_sharded']} (expected {want}: b = bp = {REST_TARGETS})")
    if not (same and finite and launches["rest/sample_sharded"] == want):
        raise RuntimeError(f"{tag} the one-rank sample_sharded is not sample()")

    out = os.path.join(tmp, "rest_ranks")
    ranks = run_workers(torch, "--parallel-worker", 2, ["gloo", out, "rest"], out, tag, "rest")
    parts = [fan.sample(None, put_global(targets, BatchSharding(r, 2)),
                        rank_generator(gen(31), r)) for r in range(2)]
    host = [torch.cat([getattr(p, f) for p in parts]).cpu()
            for f in ("seq_idx", "translations", "orientations")]
    same = [all(torch.equal(a, b) for a, b in zip(r[0], host)) for r in ranks]
    counts = [r[1] for r in ranks]
    want2 = (layer_calls(mcfg, T), 0)
    launches["rest/sample_sharded_gloo2"] = counts[0]
    print(f"{tag} 2 ranks, gloo, sharing the card: sample_sharded 2 x {REST_TARGETS // 2} "
          f"targets vs the host loop of each rank's sample() from its rank generator: bitwise "
          f"equal on each rank {same} (no tolerance: the same kernels on the same rows); "
          f"launches K1, K2 per rank {counts} (expected {want2}: b = bp = {REST_TARGETS // 2})")
    if not (all(same) and all(c == want2 for c in counts)):
        raise RuntimeError(f"{tag} the two-rank sample_sharded differs from the host loop")
    return launches


def rest_steps_per_call(torch):
    """[rest] (b): pool_train_step(steps_per_call=REST_K) at
    production_config(), batch 32, rows drawn from a device pool of
    [train]'s batch, from the warmup's end (`par_state`) under
    deterministic algorithms: bitwise the chain of REST_K one-step calls
    (state, Adam moments, EMA and the stacked metrics); K1 6 a step; one
    call at fuse_ipa_layer=False (K2).  Returns {path: (K1, K2)}."""
    tag = "[rest] (b)"
    launches = {}
    for fuse in (None, False):
        harness, pool = par_train_setup(torch, "cuda", fuse)
        pb = pool.batch_size
        g = torch.Generator(device="cuda").manual_seed(41)
        idx = torch.stack([torch.randperm(pb, generator=g, device="cuda")
                           for _ in range(REST_K)])
        draws = [harness.draw(pool.gather_rows(i), torch.Generator(device="cuda").manual_seed(
            900 + s)) for s, i in enumerate(idx)]
        with deterministic(torch):
            chain, metrics = par_state(harness), []
            for i, d in zip(idx, draws):
                chain, m = harness.pool_train_step(chain, pool, i, d)
                metrics.append(m)
            torch.cuda.synchronize()
            zero_launches()
            multi, stacked = harness.pool_train_step(par_state(harness), pool, idx, draws,
                                                     steps_per_call=REST_K)
            torch.cuda.synchronize()
            counts = k_launches()
        per_call = layer_calls(harness.config.model, REST_K)
        want = (per_call, 0) if fuse is None else (0, per_call)
        checks = {
            "state": multi.step == chain.step and multi.opt_state.count == chain.opt_state.count
            and all(torch.equal(multi.params[k], chain.params[k])
                    and torch.equal(multi.ema_params[k], chain.ema_params[k])
                    and torch.equal(multi.opt_state.mu[k], chain.opt_state.mu[k])
                    and torch.equal(multi.opt_state.nu[k], chain.opt_state.nu[k])
                    for k in chain.params),
            "metrics": all(v.shape == (REST_K,) and torch.equal(
                v, torch.stack([m[k] for m in metrics])) for k, v in stacked.items()),
            "finite": all(bool(torch.isfinite(v).all()) for v in stacked.values()),
            "launches": counts == want,
        }
        name = "rest/steps_per_call" + ("" if fuse is None else "_fuse_False")
        launches[name] = counts
        print(f"{tag} fuse_ipa_layer={fuse}: pool_train_step(steps_per_call={REST_K}) vs "
              f"{REST_K} one-step calls, production_config() (bf16, batch {pb}, L={L_MAIN}) "
              f"under deterministic algorithms: state, moments, EMA and stacked metrics bitwise "
              f"{checks['state'] and checks['metrics']}; losses "
              f"{[round(float(v), 4) for v in stacked['train/loss']]}; launches K1, K2 {counts} "
              f"(expected {want}); checks {checks}")
        if not all(checks.values()):
            raise RuntimeError(f"{tag} steps_per_call={REST_K} is not the one-step chain")
    return launches


def rest_tools(torch, card, tmp):
    """[rest] (c): the debug and profiling tools on the card.  checked_fn
    around one production training step (batch 32, deterministic
    algorithms): its state and metrics bitwise the unwrapped step's; with
    one parameter set to NaN it
    raises FloatingPointError naming an op; assert_all_finite on the state.
    trace() around one eager sample() (graphs=False: a replay runs no
    Python, so no host scope) of the 25-step recipe (128 designs of
    [main]'s target) with named_scope("denoiser") on the model's denoise:
    the Chrome trace holds the scope and K1's kernel; block_and_time and
    StepTimer on the graphed call beside CUDA events.  Returns {path: (K1, K2)}."""
    from diffab_pytorch_tpu_torch.sampling.sampler import timestep_schedule
    from diffab_pytorch_tpu_torch.utils.debug import assert_all_finite, checked_fn
    from diffab_pytorch_tpu_torch.utils.profiling import (
        StepTimer, block_and_time, named_scope, trace)

    tag = "[rest] (c)"
    launches = {}
    harness, batch = par_train_setup(torch, "cuda")
    draws = par_draws(torch, harness, batch, 0, 0)
    step = checked_fn(harness.train_step)
    with deterministic(torch):
        plain, m_plain = harness.train_step(par_state(harness), batch, draws)
        zero_launches()
        checked, m_checked = step(par_state(harness), batch, draws)
        torch.cuda.synchronize()
        launches["rest/checked"] = k_launches()
    same = (all(torch.equal(m_plain[k], m_checked[k]) for k in m_plain)
            and all(torch.equal(plain.params[k], checked.params[k])
                    and torch.equal(plain.ema_params[k], checked.ema_params[k])
                    for k in plain.params))
    assert_all_finite(checked, "the checked step's state")
    bad = par_state(harness)
    name = "denoiser.ipa.layer_0.to_q_scalar.weight"
    with torch.no_grad():
        bad.params[name][0, 0] = float("nan")
    try:
        step(bad, batch, draws)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    try:
        assert_all_finite(bad, "the state")
        flagged = None
    except FloatingPointError as e:
        flagged = str(e)
    want = (layer_calls(harness.config.model), 0)
    print(f"{tag} checked_fn(train_step), production_config() (bf16, batch 32, L={L_MAIN}) "
          f"under deterministic algorithms: state and metrics bitwise the unwrapped step's "
          f"{same}; launches K1, K2 {launches['rest/checked']} (expected {want}); "
          f"assert_all_finite passed on its state; with {name}[0, 0] = NaN it raised: {raised!r}; "
          f"assert_all_finite: {flagged!r}")
    if not (same and raised and raised.startswith("nan produced by ") and flagged
            and name in flagged and launches["rest/checked"] == want):
        raise RuntimeError(f"{tag} the debug mode failed")

    fan, target = par_fan_setup(torch, "cuda")
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    run = lambda graphs=None: fan.sample(None, target, gen(51), n_designs=N_DESIGNS,
                                         graphs=graphs, **REST_RECIPE)
    run(), run(False)  # warm-up
    torch.cuda.synchronize()
    fan.model.denoise = named_scope("denoiser")(fan.model.denoise)
    log_dir = os.path.join(tmp, "rest_trace")
    try:
        zero_launches()
        # eager: a replayed graph runs no Python between its kernels, so its
        # trace holds the kernels but none of the host's scopes
        with trace(log_dir):
            out = run(False)
        launches["rest/trace"] = k_launches()
    finally:
        del fan.model.denoise
    path = os.path.join(log_dir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    # each scope is a host span and its projection on the card's timeline
    n_scope = sum(e.get("name") == "denoiser" and e.get("cat") == "user_annotation"
                  for e in events)
    n_scope_gpu = sum(e.get("name") == "denoiser" and e.get("cat") == "gpu_user_annotation"
                      for e in events)
    n_k1 = sum(K1_LAUNCHES[0] in e.get("name", "") for e in events)
    t_seq = timestep_schedule(fan.config.diffusion.T, REST_RECIPE["n_steps"])
    want = (layer_calls(fan.config.model, denoiser_calls(t_seq.tolist(), REST_RECIPE)), 0)
    per_call = block_and_time(run, iters=3)
    timer = StepTimer()
    timer.tick()
    for _ in range(3):
        run()
    timer_s = 1.0 / timer.tick(3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(3):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    event_s = ev[0].elapsed_time(ev[1]) / 3e3
    checks = {"trace_file": os.path.getsize(path) > 0, "scope": n_scope == len(t_seq),
              "k1_in_trace": n_k1 > 0, "launches": launches["rest/trace"] == want,
              "finite": bool(torch.isfinite(out.translations).all())}
    print(f"{tag} trace() around an eager sample({N_DESIGNS} designs, {REST_RECIPE}, bf16): "
          f"{os.path.getsize(path)} bytes of Chrome trace, {len(events)} events, "
          f"'denoiser' scopes {n_scope} on the host (expected {len(t_seq)}) and {n_scope_gpu} "
          f"on the card, {K1_LAUNCHES[0]} events {n_k1}; "
          f"launches K1, K2 {launches['rest/trace']} (expected "
          f"{want}); seconds a call: block_and_time {per_call:.4f}, StepTimer {timer_s:.4f}, "
          f"CUDA events {event_s:.4f} on {card}; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} the profiling tools failed: {checks}")
    return launches


def rest_corpus(torch, tmp):
    """[rest] (d): the compositional corpus (write_combo_corpus,
    REST_COMBOS_PER instances of each train combination) through
    `cli.preprocess -k 128` (a subprocess, one worker per core), `cli.train
    --production --max-steps REST_CLI_STEPS` (K1 counted per step by a
    StepRecorder), the checkpoint checked, then `cli.sample -n 16` from it
    on a held-out combination's patch.  Returns {path: (K1, K2)}."""
    import contextlib
    import io

    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import sample as sample_cli
    from diffab_pytorch_tpu_torch.cli import train as train_cli
    from diffab_pytorch_tpu_torch.data import loader as loader_mod
    from diffab_pytorch_tpu_torch.data.synthetic import write_combo_corpus
    from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    tag = "[rest] (d)"
    root = os.path.join(tmp, "combo")
    man = write_combo_corpus(root, n_per_combo=REST_COMBOS_PER)
    n = len(man["train_combos"]) * REST_COMBOS_PER + len(man["heldout_combos"]) * man[
        "n_val_instances"]
    patches = os.path.join(tmp, "combo_patches")
    jobs = os.cpu_count() or 1
    proc = subprocess.run([sys.executable, "-m", "diffab_pytorch_tpu_torch.cli.preprocess",
                           "--meta", os.path.join(root, "meta.csv"), "--data-dir",
                           os.path.join(root, "pdb"), "--out-dir", patches, "-j", str(jobs),
                           "-k", str(L_MAIN)], cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    written = sorted(f for f in os.listdir(patches) if f.endswith(".npz")) \
        if os.path.isdir(patches) else []
    if proc.returncode != 0 or len(written) != n:
        raise RuntimeError(f"{tag} cli.preprocess failed (rc {proc.returncode}, {len(written)} "
                           f"of {n}):\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    ck = os.path.join(tmp, "combo_ck")
    rec = StepRecorder(DiffAb.make_train_step)
    log = io.StringIO()
    # the worst case for the loader's copy stream: the next default-priority
    # stream of PyTorch's pool is the one graph captures run on
    capture, taken = align_stream_pool(torch)
    loaders = []
    init = loader_mod.PrefetchLoader.__init__

    def recorded(self, *a, **k):
        init(self, *a, **k)
        loaders.append(self._stream)

    try:
        DiffAb.make_train_step = lambda self, *a, **k: rec(self, *a, **k)
        loader_mod.PrefetchLoader.__init__ = recorded
        zero_launches()
        with contextlib.redirect_stdout(log):
            rc = train_cli.main(["--data-dir", patches, "--production", "--max-steps",
                                 str(REST_CLI_STEPS), "--checkpoint-dir", ck])
        torch.cuda.synchronize()
    finally:
        DiffAb.make_train_step = rec.factory
        loader_mod.PrefetchLoader.__init__ = init
    print(f"{tag} stream pool advanced by {taken} so that its next default-priority stream is "
          f"the graph capture stream; cli.train's loaders' copy streams: priorities "
          f"{[s.priority for s in loaders]}, the capture stream among them "
          f"{any(s == capture for s in loaders)}")
    steps = tuple(sum(c["launches"][i] for c in rec.calls) for i in range(2))
    launches = {"rest/corpus": steps}
    pcfg = C.production_config()
    losses = [float(c["loss"]) for c in rec.calls]
    patch = os.path.join(patches, "h0_s0_H_L_A.npz")
    out = os.path.join(tmp, "combo_designs")
    slog = io.StringIO()
    zero_launches()
    with contextlib.redirect_stdout(slog):
        src = sample_cli.main(["--patch", patch, "--checkpoint-dir", ck, "-n", "16", "-o", out])
    torch.cuda.synchronize()
    launches["rest/corpus_sample"] = k_launches()
    designs = sorted(f for f in os.listdir(out) if f.endswith(".pdb"))
    checks = {
        "train_rc": rc == 0, "steps": len(rec.calls) == REST_CLI_STEPS
        and ckpt.all_steps(ck) == [REST_CLI_STEPS],
        "model_config": ckpt.load_model_config(ck) == pcfg.model,
        "losses_finite": all(map(math.isfinite, losses)),
        "train_launches": steps == (layer_calls(pcfg.model, REST_CLI_STEPS), 0),
        "loader_stream": bool(loaders) and not any(s == capture for s in loaders),
        "sample_rc": src == 0, "designs": designs == [f"design_{i:04d}.pdb" for i in range(16)],
        "sample_launches": launches["rest/corpus_sample"] == (
            layer_calls(pcfg.model, pcfg.diffusion.T), 0),
    }
    print(f"{tag} write_combo_corpus(n_per_combo={REST_COMBOS_PER}): {n} complexes; "
          f"cli.preprocess -j {jobs} -k {L_MAIN}: {len(written)} .npz; cli.train --production "
          f"--max-steps {REST_CLI_STEPS}: losses {[round(v, 4) for v in losses]}, launches K1, "
          f"K2 of the steps {steps}; cli.sample -n 16 on {os.path.basename(patch)} (a held-out "
          f"combination): launches {launches['rest/corpus_sample']}; checks {checks}")
    if not all(checks.values()):
        for line in (log.getvalue() + slog.getvalue()).splitlines()[-20:]:
            print(f"{tag} {line}")
        raise RuntimeError(f"{tag} the compositional corpus path failed: {checks}")
    return launches


def align_stream_pool(torch):
    """Take streams from PyTorch's pool of default-priority streams (32,
    handed out round-robin; `torch.cuda.Stream()` takes the next) until the
    next one is `torch.cuda.graph`'s capture stream, made here if no capture
    has made it yet.  Returns (the capture stream, streams taken)."""
    capture = torch.cuda.graph.default_capture_stream
    if capture is None:
        capture = torch.cuda.graph.default_capture_stream = torch.cuda.Stream()
    for taken in range(1, 33):
        if torch.cuda.Stream() == capture:
            break
    else:
        raise RuntimeError("the graph capture stream is not in the default-priority pool")
    for _ in range(31):
        torch.cuda.Stream()
    return capture, taken + 31


def rest_phase(torch, card, tmp):
    """[rest]: (a) sample_sharded, (b) steps_per_call, (c) the debug and
    profiling tools, (d) the compositional corpus through the CLIs.
    Returns {path: (K1, K2)}."""
    launches = rest_sample_sharded(torch, tmp)
    launches.update(rest_steps_per_call(torch))
    launches.update(rest_tools(torch, card, tmp))
    launches.update(rest_corpus(torch, tmp))
    return launches


GRAPH_TRAIN_STEPS = 5  # [graph] (b): training steps held bitwise against train_step
GRAPH_UPDATE_STEPS = 3  # [graph] (b): updates held bitwise against the host-float update
GRAPH_FIT_STEPS = 3  # [graph] (c): steps of each fit() run whose memory is read


def last_entry(cache):
    """The most recently used StepGraphs of a utils.graphs.GraphCache."""
    return next(reversed(cache.entries.values()))


def graph_sample(torch, tag, sched, tables, compute_dtype, n_designs, L, model=None,
                 k1_per_call=None, other_weights=False, profiler_count=False, **opts):
    """[graph] (a) for one sample() configuration (default_config(), its
    model in `compute_dtype` and changed by `model`, one synthetic
    L-residue target, default_config()'s schedule and tables), under
    deterministic algorithms (the sampler's kernels are the default
    mode's): an eager call (graphs=False), a graphed call (warm-up and
    capture), two replays and a second eager call, all bitwise the first,
    the launch counts equal (K1 `k1_per_call`; with `profiler_count` the
    profiler's count of K1's kernels in a graphed call too); with
    `other_weights` a graphed call after new weights are written into the
    same tensors, bitwise its eager call.  Returns {"k1_paths": K1's path
    counters of a replay}."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.sampling import sampler
    from diffab_pytorch_tpu_torch.weights import init_parameters

    mcfg = dataclasses.replace(C.default_config().model, compute_dtype=compute_dtype,
                               **(model or {}))
    net = init_parameters(DiffAbModel(mcfg), torch.Generator().manual_seed(0))
    target = synthetic_batch(0, 1, L, mcfg.n_atoms, n_generate=N_GENERATE, device="cuda")

    paths = {}  # K1's launch-1 path counters of the last call, eager (False) / graphed (None)

    def run(graphs, seed=7):
        torch.cuda.synchronize()
        zero_launches()
        before = k1_paths()
        out = sampler.sample(net, sched, tables, target, n_designs=n_designs, graphs=graphs,
                             generator=torch.Generator(device="cuda").manual_seed(seed), **opts)
        torch.cuda.synchronize()
        paths[graphs] = k1_paths_since(before)
        return out, k_launches()

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)

    with deterministic(torch):
        e1, k_eager = run(False)
        g1, k_first = run(None)
        (g2, k_replay), (g3, _) = run(None), run(None)
        paths_replay = paths[None]
        e2, _ = run(False)
        checks = {"eager_twice": equal(e1, e2), "graphed_first": equal(g1, e1),
                  "graphed_replays": equal(g2, e1) and equal(g3, e1),
                  "launches": k_first == k_replay == k_eager
                  and (k1_per_call is None or k_replay[0] == k1_per_call),
                  "k1_paths": paths_replay == paths[False]}
        if other_weights:
            init_parameters(net, torch.Generator().manual_seed(1))  # new values, same tensors
            checks["other_weights"] = equal(run(None, 8)[0], run(False, 8)[0])
    print(f"{tag}: {n_designs} designs, L={L}, {opts or 'the full chain'}, {compute_dtype}; under "
          f"deterministic algorithms: bitwise {checks} (the second eager call, the graphed call "
          f"that captured, two replays against the first eager call"
          + (", a graphed call with other weights in the same tensors against its eager call"
             if other_weights else "")
          + f"); launches K1, K2 graphed {k_first} / {k_replay}, eager {k_eager}; K1 launch-1 "
          f"paths a replay {paths_replay}, an eager call {paths[False]}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} graphed sample() against eager failed: {checks}")
    if profiler_count:
        # the profiler can drop a replay's events (never add one): its K1
        # count must reach the counter's in one of three profiled calls; a
        # run whose profiler counted nothing fails
        seen = []
        for _ in range(3):
            seen.append(profiled_kernels(torch, lambda: run(None), K1_LAUNCHES[0]))
            if seen[-1] == k1_per_call:
                break
        print(f"{tag}: the profiler's K1 count by profiled call {seen}, the counter "
              f"{k1_per_call} a call")
        if k1_per_call not in seen:
            raise RuntimeError(f"{tag} the profiler saw {seen} K1 launches in "
                               f"{len(seen)} calls, the counter {k1_per_call} a call")
    return {"k1_paths": paths_replay}


def graph_train(torch, tag, compute_dtype, fuse, pool_check):
    """[graph] (b) for production_config() training ([train]'s
    batch: 32 synthetic L=128 patches) in `compute_dtype` at
    fuse_ipa_layer `fuse`: under deterministic algorithms, from one seeded
    init, GRAPH_TRAIN_STEPS steps of make_train_step() bitwise the eager
    train_step's (parameters, moments, EMA, metrics); two calls of
    make_pool_train_step(steps_per_call=4), each one replay of four bodies
    after the first call's capture, bitwise eight eager steps; the eval
    step (the pool steps with `pool_check`)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    pcfg = C.production_config()
    hcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, compute_dtype=compute_dtype, fuse_ipa_layer=fuse))
    harness = DiffAb(hcfg)
    pb = pcfg.train.batch_size
    batch = synthetic_batch(100, pb, L_MAIN, pcfg.model.n_atoms, device="cuda")
    pool = synthetic_batch(101, 2 * pb, L_MAIN, pcfg.model.n_atoms, device="cuda")
    gen = torch.Generator(device="cuda")
    draws = [harness.draw(batch, gen.manual_seed(500 + i)) for i in range(8)]
    idx = torch.randint(0, 2 * pb, (8, pb), device="cuda", generator=gen.manual_seed(9))

    def same(a, b):
        trees = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.ema_params, b.ema_params)]
        return (a.step == b.step and a.opt_state.count == b.opt_state.count
                and all(torch.equal(x[k], y[k]) for x, y in trees for k in x))

    per_step = layer_calls(hcfg.model)
    want = (per_step, 0) if fuse is None else (0, per_step)
    with deterministic(torch):
        eager, ems = harness.init(0), []
        for d in draws[:GRAPH_TRAIN_STEPS]:
            eager, m = harness.train_step(eager, batch, d)
            ems.append(m)
        step, state, gms, counts = harness.make_train_step(), harness.init(0), [], []
        for d in draws[:GRAPH_TRAIN_STEPS]:
            zero_launches()
            state, m = step(state, batch, d)
            counts.append(k_launches())
            gms.append(m)
        metrics_equal = lambda a, b: all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
        pool_step = harness.make_pool_train_step(steps_per_call=4)
        if pool_check:
            eager_pool, graph_pool = harness.init(0), harness.init(0)
            eager_metrics = []
            for j in range(8):
                eager_pool, m = harness.train_step(eager_pool, pool.gather_rows(idx[j]), draws[j])
                eager_metrics.append(m)
            pool_counts, pool_metrics = [], []
            for c in range(2):
                zero_launches()
                graph_pool, m = pool_step(graph_pool, pool, idx[4 * c:4 * c + 4],
                                          draws[4 * c:4 * c + 4])
                pool_counts.append(k_launches())
                pool_metrics.append(m)
            pool_entry = last_entry(harness._step_graphs)
        ev_step = harness.make_eval_step()
        v_e = harness.eval_step(state.params, batch, draws[0])
        v_g = [ev_step(state.params, batch, d) for d in draws[:2]]
        v_e2 = harness.eval_step(state.params, batch, draws[1])
    torch.cuda.synchronize()
    checks = {
        "train_step": same(state, eager) and metrics_equal(gms, ems),
        "launches": all(c == want for c in counts),
        "eval": metrics_equal([v_e, v_e2], v_g),
    }
    pool_line = ""
    if pool_check:
        stacked = {k: torch.stack([m[k] for m in eager_metrics]) for k in eager_metrics[0]}
        checks["pool_k4"] = same(graph_pool, eager_pool) and all(
            torch.equal(torch.cat([m[k] for m in pool_metrics]), stacked[k]) for k in stacked)
        checks["pool_one_replay"] = (pool_entry.replays == 1 and len(pool_entry.graphs) == 1
                                     and all(c == tuple(4 * n for n in want)
                                             for c in pool_counts))
        pool_line = (f"make_pool_train_step(4) twice bitwise 8 train_steps {checks['pool_k4']} "
                     f"(one replay a call after the capture {checks['pool_one_replay']}, "
                     f"launches a call {pool_counts}); ")
    print(f"{tag}: production_config() {compute_dtype}, fuse_ipa_layer={fuse}, batch {pb}, "
          f"L={L_MAIN}; under deterministic algorithms: {GRAPH_TRAIN_STEPS} steps of "
          f"make_train_step bitwise train_step {checks['train_step']} (launches K1, K2 a step "
          f"{counts}); {pool_line}make_eval_step bitwise eval_step {checks['eval']}")
    if not all(checks.values()):
        raise RuntimeError(f"{tag} graphed training against eager failed: {checks}")


def host_float_update(torch, harness, state, grads):
    """The optimizer update of `DiffAb.apply_gradients` with its learning
    rate and bias corrections as host floats (optax's arithmetic in
    `_foreach_*` form, as the update ran before its scalars moved to the
    card): [graph] (b)'s reference for the update the DP and TP steps run
    eagerly.  In place on the state's tensors."""
    t = harness.config.train
    names = list(state.params)
    params = [state.params[k] for k in names]
    mu = [state.opt_state.mu[k] for k in names]
    nu = [state.opt_state.nu[k] for k in names]
    g = [grads[k] for k in names]
    with torch.no_grad():
        if t.grad_clip_norm > 0:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            scale = torch.where(g_norm < t.grad_clip_norm, torch.ones_like(g_norm),
                                t.grad_clip_norm / g_norm)
            g = torch._foreach_mul(g, scale)
        b1, b2 = t.betas
        count = state.opt_state.count + 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        den = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, t.adam_eps)
        u = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(u, den)
        if t.update_clip_rms > 0:
            rms = torch._foreach_mul(torch._foreach_norm(u),
                                     [1.0 / math.sqrt(x.numel()) for x in u])
            torch._foreach_div_(u, torch._foreach_clamp_min(
                torch._foreach_div(rms, t.update_clip_rms), 1.0))
        if t.weight_decay > 0:
            torch._foreach_add_(u, params, alpha=t.weight_decay)
        torch._foreach_add_(params, u, alpha=-harness.learning_rate(state.opt_state.count))
        if state.ema_params is not None:
            ema = [state.ema_params[k] for k in names]
            torch._foreach_mul_(ema, t.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - t.ema_decay)


def graph_update_check(torch, card):
    """[graph] (b): `apply_gradients` (the learning rate and the bias
    corrections read on the card from `step_scalars`, as the train, pool,
    DP and TP steps run it) bitwise `host_float_update` over
    GRAPH_UPDATE_STEPS updates of a production_config() float32 state from
    update count 3 (warm-up learning rate, bias corrections away from 1),
    with the gradients of one real step.  Returns whether it held."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.train.harness import OptState, TrainState, DiffAb

    pcfg = C.production_config()
    harness = DiffAb(dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, compute_dtype="float32")))
    batch = synthetic_batch(100, pcfg.train.batch_size, L_MAIN, pcfg.model.n_atoms,
                            device="cuda")
    base = harness.init(0)
    _, _, grads = harness.loss_and_grads(base.params, batch,
                                         harness.draw(batch, torch.Generator(
                                             device="cuda").manual_seed(500)), 0)
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}
    fresh = lambda: TrainState(3, copy(base.params), OptState(3, copy(base.opt_state.mu),
                                                              copy(base.opt_state.nu)),
                               copy(base.ema_params))
    card_state, host_state = fresh(), fresh()
    lrs = []
    for _ in range(GRAPH_UPDATE_STEPS):
        lrs.append(harness.learning_rate(card_state.opt_state.count))
        card_state = harness.apply_gradients(card_state, grads)
        host_float_update(torch, harness, host_state, grads)
        host_state = TrainState(host_state.step + 1, host_state.params,
                                OptState(host_state.opt_state.count + 1, host_state.opt_state.mu,
                                         host_state.opt_state.nu), host_state.ema_params)
    torch.cuda.synchronize()
    trees = ("params", "mu", "nu", "ema")
    get = lambda st: (st.params, st.opt_state.mu, st.opt_state.nu, st.ema_params)
    same = {n: all(torch.equal(a[k], b[k]) for k in a)
            for n, a, b in zip(trees, get(card_state), get(host_state))}
    moved = max(float((card_state.params[k] - base.params[k]).abs().max()) for k in grads)
    print(f"[graph] (b) apply_gradients with its scalars on the card against the host-float "
          f"update: {GRAPH_UPDATE_STEPS} updates from count 3 at lr "
          f"{[f'{v:.2e}' for v in lrs]} (parameters moved up to {moved:.2e}), bitwise {same} "
          f"(card: {card})")
    return all(same.values()) and moved > 0


def graph_fit_memory(torch, card):
    """[graph] (c): three fit() runs of GRAPH_FIT_STEPS production bf16
    steps, each from a new init that replaces the last run's state (a new
    state is a new cache entry, its capture in the harness's one pool):
    the card's reserved memory after each run and the pool's growth in
    each.  Fails if the later runs grew the pool by a quarter of the first
    run's growth, or the card's reserved memory from the second run to
    the third by a tenth of it (a new pool a run would add all of it)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.train.harness import DiffAb
    from diffab_pytorch_tpu_torch.train.trainer import fit

    pcfg = C.production_config()
    harness = DiffAb(dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, log_every=GRAPH_FIT_STEPS)))
    data = [synthetic_batch(100, pcfg.train.batch_size, L_MAIN, pcfg.model.n_atoms,
                            device="cuda")]
    logger = RecordingLogger("[graph] (c) fit memory")
    reserved, grown, state = [], [], None
    for run in range(3):
        before = harness._step_graphs.pool_bytes
        state = fit(harness, data, max_steps=GRAPH_FIT_STEPS, logger=logger,
                    state=harness.init(run))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        grown.append(harness._step_graphs.pool_bytes - before)
    ok = grown[1] + grown[2] < 0.25 * grown[0] and reserved[2] - reserved[1] < 0.1 * grown[0]
    print(f"[graph] (c) three fit() runs of {GRAPH_FIT_STEPS} steps, each from a new state: "
          f"reserved after each {[round(r / 1e9, 3) for r in reserved]} GB, the pool grew "
          f"{[round(g / 1e9, 3) for g in grown]} GB, {len(harness._step_graphs.entries)} cached "
          f"steps (card: {card}); {'ok' if ok else 'FAILED'}")
    return ok


def graph_phase(torch, card):
    """[graph] (phase 17): the compiled step bodies.  (a) the graphed
    sample() bitwise the eager one (graphs=False) from the same generator
    seed under deterministic algorithms: [main] in bf16 (K1 600 a call, the
    profiler's count agreeing) and float32, the [fast] recipes, [main-256],
    self-conditioning (early fusion; the split trunk with Heun) at two IPA
    layers, and fuse_ipa_layer=False on the 25-step recipe; (b)
    make_train_step and make_eval_step bitwise their eager chains at both
    flags and dtypes, make_pool_train_step(4) at both flags in bf16, and
    apply_gradients bitwise the host-float update; (c) the card's reserved
    memory across fit() runs (graph_fit_memory)."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule

    d = C.default_config().diffusion
    sched = cosine_variance_schedule(d.T, s=d.s, beta_max=d.beta_max, device="cuda")
    tables = make_orientation_tables(sched)
    run = lambda label, *args, **kw: graph_sample(torch, f"[graph] (a) {label}", sched, tables,
                                                  *args, **kw)
    check_persistent_path(torch, "[graph]")
    run("[main] bfloat16", "bfloat16", N_DESIGNS, L_MAIN, k1_per_call=600, other_weights=True,
        profiler_count=True)
    run("[main] float32", "float32", N_DESIGNS, L_MAIN, k1_per_call=600)
    for name, n_designs, opts in FAST_RECIPES:
        run(f"[fast] {name}", "bfloat16", n_designs, L_MAIN, **opts)
    run("[main-256]", "bfloat16", N_DESIGNS, 256, k1_per_call=600)
    small = dict(n_ipa_layers=2)
    run("sc early", "bfloat16", 32, L_MAIN, model=dict(small, **sc_model_fields("early")),
        n_steps=25, sc_t_max=60)
    run("sc split", "bfloat16", 32, L_MAIN, model=dict(small, **sc_model_fields("split")),
        n_steps=20, sc_t_max=60, coord_solver="heun", coord_solver_t_min=10)
    run("[fast] 25-step fuse_ipa_layer=False", "bfloat16", N_DESIGNS, L_MAIN,
        model=dict(fuse_ipa_layer=False), n_steps=25)
    for dtype in ("bfloat16", "float32"):
        for fuse in (None, False):
            graph_train(torch, f"[graph] (b) train {dtype} fuse={fuse}", dtype, fuse,
                        pool_check=dtype == "bfloat16")
    if not graph_update_check(torch, card):
        raise RuntimeError("[graph] (b) apply_gradients is not the host-float update bitwise")
    if not graph_fit_memory(torch, card):
        raise RuntimeError("[graph] (c) the card's memory grew across fit() runs")


def kernel_times(torch, card, pb, h=8):
    """Per-launch times at L = 128, the main paths' shapes (b = 128, bp = 1
    and b = bp = pb): K1 in bf16 (its two launches also apart by the
    profiler) and float32, K2 in both dtypes, each beside its
    plain version and its bound; K1 is held to its plain version at
    b = 128 first.  `h`: the heads of a call (8, the default width's; 4, 2,
    1 for one tp rank's at tp = 2, 4, 8).  Returns (K1 bf16 times, K1
    float32 times, K2 times, K1 bf16 error, K1 float32 error)."""
    from diffab_pytorch_tpu_torch.ops import ipa_attention as k2
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    main_shape = dict(L=L_MAIN, d=128, h=h, ds=32, p=8)
    att_shape = dict(L=L_MAIN, h=h, ds=32, p=8)
    heads = "" if h == 8 else f" h={h}"
    k1_times = {}
    for label, b, bp, seed in (("sample", N_DESIGNS, 1, 4), ("train", pb, pb, 6)):
        with torch.no_grad():
            a = layer_inputs(torch, b, bp, **main_shape, dtype=torch.bfloat16, seed=seed,
                             n_masked=0)
            if label == "sample":
                err_bf16 = check_layer(torch, f"main bf16 (b=128 bp=1 L=128{heads})", a,
                                       bf16=True)
            kern = lambda a=a: op.fused_ipa_layer_packed(**a)
            km = cuda_time_ms(kern, 20)
            pm = cuda_time_ms(lambda a=a: op.fused_ipa_layer_packed_reference(**a), 5)
            km2 = cuda_time_ms(kern, 20)
            tl = device_timeline(torch, kern, 20, K1_LAUNCHES)
        fl, nb = work.ipa_layer_flops_bytes(b, bp, **main_shape, itemsize=2, bias_itemsize=2)
        bnd, by, t_o, t_b = bound_parts(fl, nb, "bfloat16")
        k1_times[label] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd, bound_by=by,
                               launch_ms=tl and {n: tl[n] for n in K1_LAUNCHES})
        print(f"[time] ipa_fused_layer b={b} bp={bp} L=128{heads} bf16 ({label} shape) on "
              f"{card}: "
              f"kernel {km:.4f} / {km2:.4f} ms (CUDA events, 20 calls queued behind a sleep), "
              f"plain version {pm:.4f} ms, bound {bnd:.4f} ms ({fl / 1e9:.2f} GFLOP -> "
              f"{t_o:.4f} ms, {nb / 1e6:.2f} MB -> {t_b:.4f} ms; bound by {by}), "
              f"{bnd / min(km, km2):.3%} of bound")
        if tl is None:
            print(f"[time] ipa_fused_layer{heads} {label} shape, its launches: not measured "
                  f"(the profiler reported no device time)")
            continue
        path = ("persistent" if op.takes_persistent(torch.bfloat16, b, L_MAIN, 128, h, 32, 8,
                                                     op._sm_count(torch.device("cuda")))
                else "one block per (head, design)")
        print(f"[time] ipa_fused_layer{heads} {label} shape, launch 1 {path}, profiler over 20 "
              f"queued calls ({tl['calls_seen']} seen): " + ", ".join(
            f"{n} {'not measured' if tl[n] is None else f'{tl[n]:.4f} ms'}"
            for n in K1_LAUNCHES)
            + f"; {tl['events_per_call']:.2f} device events per call, {tl['kernels_ms']:.4f} ms "
            f"in all; card idle between them per call: " + ", ".join(
                f"before {k} {v:.4f} ms" for k, v in tl["idle_before_ms"].items()))

    # K1's float32 route (3xTF32), timed as bf16 above
    k1_f32 = {}
    for label, b, bp, seed in (("sample", N_DESIGNS, 1, 4), ("train", pb, pb, 6)):
        with torch.no_grad():
            a = layer_inputs(torch, b, bp, **main_shape, dtype=torch.float32, seed=seed,
                             n_masked=0)
            if label == "sample":
                err_f32 = check_layer(torch, f"main f32 (b=128 bp=1 L=128{heads})", a,
                                      bf16=False)
            kern = lambda a=a: op.fused_ipa_layer_packed(**a)
            km = cuda_time_ms(kern, 20)
            pm = cuda_time_ms(lambda a=a: op.fused_ipa_layer_packed_reference(**a), 5)
            km2 = cuda_time_ms(kern, 20)
        fl, nb = work.ipa_layer_flops_bytes(b, bp, **main_shape, itemsize=4, bias_itemsize=4)
        bnd, by, t_o, t_b = bound_parts(fl, nb, "float32")
        k1_f32[label] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd, bound_by=by)
        print(f"[time] ipa_fused_layer b={b} bp={bp} L=128{heads} f32 ({label} shape) on "
              f"{card}: "
              f"kernel {km:.4f} / {km2:.4f} ms, plain version {pm:.4f} ms, bound {bnd:.4f} ms "
              f"({fl / 1e9:.2f} GFLOP at the 3xTF32 rate -> {t_o:.4f} ms, {nb / 1e6:.2f} MB -> "
              f"{t_b:.4f} ms; bound by {by}), {bnd / min(km, km2):.3%} of bound")

    # K2 in both dtypes
    k2_times = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for label, b, bp in (("train", pb, pb), ("sample", N_DESIGNS, 1)):
            with torch.no_grad():
                aargs = attention_inputs(torch, b, bp, **att_shape, dtype=dtype, seed=30 + b,
                                         n_masked=0)
                km = cuda_time_ms(lambda: k2.ipa_attention_core(**aargs), 20)
                pm = cuda_time_ms(lambda: k2.ipa_attention_core_reference(**aargs), 5)
                km2 = cuda_time_ms(lambda: k2.ipa_attention_core(**aargs), 20)
            fl, nb = attention_flops_bytes(b, bp, **att_shape, itemsize=dtype.itemsize,
                                           bias_itemsize=dtype.itemsize)
            bnd, by, t_o, t_b = bound_parts(fl, nb, dname)
            k2_times[(dname, label)] = dict(ms=min(km, km2), plain_ms=pm, bound_ms=bnd,
                                            bound_by=by)
            print(f"[time] ipa_attention b={b} bp={bp} L=128{heads} {dname} ({label} shape) on "
                  f"{card}: "
                  f"kernel {km:.4f} / {km2:.4f} ms, plain version {pm:.4f} ms, bound "
                  f"{bnd:.4f} ms ({fl / 1e9:.2f} GFLOP -> {t_o:.4f} ms, {nb / 1e6:.2f} MB -> "
                  f"{t_b:.4f} ms; bound by {by}), {bnd / min(km, km2):.3%} of bound")

    return k1_times, k1_f32, k2_times, err_bf16, err_f32


GA_MODEL = dict(n_head=12, ipa_block="ga")


def ga_patches(tmp, n, L=256):
    """n synthetic complexes (the family corpus's) as L-residue patch files
    in tmp; returns their paths."""
    from diffab_pytorch_tpu_torch.data.synthetic import make_family_pdb
    from diffab_pytorch_tpu_torch.structure.antibody import from_chains
    from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch
    from diffab_pytorch_tpu_torch.structure.pdb import parse_pdb

    paths = []
    for i in range(n):
        patch = featurize_patch(from_chains(parse_pdb(make_family_pdb(i % 8, 100 + i)), "H",
                                            "L", ["A"]), L)
        paths.append(os.path.join(tmp, f"ga{i:03d}.npz"))
        save_patch(paths[-1], patch)
    return paths


# (L, b, bp, d, h, ds, P, seed) of ga_long_checks at the official heads: a
# chunk that is mostly padding, a ragged chunk, two whole chunks and three
# chunks, each at the sampler's fan-out (b = 100 designs of one target) and
# at a bias a design (b = bp = 32)
GA_LONG_CASES = tuple((L, b, bp, 128, 12, 32, 8, 95 + 2 * i + (bp > 1))
                      for i, L in enumerate((129, 200, 256, 384))
                      for b, bp in ((100, 1), (32, 32)))
# the same at other head widths, where the one-pass kernel takes its slices
# at run time: narrow heads, and the widest (ds + 3P = 64) at its longest
# one-pass L
ONEPASS_WIDTH_CASES = ((200, 8, 2, 30, 3, 8, 4, 105), (256, 8, 2, 20, 2, 1, 21, 106))


def ga_long_checks(torch):
    """[ga] (a) K1 float32 with direction rows at the official heads (h =
    12, d = 128, ds 32, P 8) beyond 128 residues against its plain version
    (in float64, check_layer), 9 padded keys, GA_LONG_CASES, and at other
    head widths (ONEPASS_WIDTH_CASES); each call must book the attention
    path `attend_path` names (one pass up to L = 272 at the default widths,
    two beyond).  Returns the largest error."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    worst = 0.0
    with torch.no_grad():
        for L, b, bp, d, h, ds, p, seed in GA_LONG_CASES + ONEPASS_WIDTH_CASES:
            before = k1_paths()
            worst = max(worst, check_layer(
                torch, f"[ga] (a) K1 directions f32 (b={b} bp={bp} L={L} d={d} h={h} ds={ds} "
                f"P={p})",
                layer_inputs(torch, b, bp, L, d, h, ds, p, torch.float32,
                             seed, 9, directions=True), bf16=False))
            got = k1_paths_since(before)
            onepass = op.attend_path(torch.float32, L, ds, p) == op.ATTEND_ONEPASS
            want = dict(items=0, overlapped=0, fallback_calls=0, attend_onepass=int(onepass),
                        attend_twopass=int(not onepass))
            print(f"[ga] (a) K1 paths of that call: {got} (expected {want})")
            if got != want:
                raise RuntimeError(f"[ga] (a) K1 f32 at L={L} booked {got}, expected {want}")
    return worst


def attend_time(torch, card, iters=20):
    """[time] K1 float32 with direction rows at the official cell's call (b =
    100, bp = 1, h = 12, L = 256, d = 128, ds 32, P 8): the whole call by CUDA
    events (queued behind a sleep) and its three launches apart by the
    profiler, the attention launch (`attend_kernel` in its name) beside the
    bound of its products and of its compulsory bytes.  Uses nothing that an
    older checkout of the port lacks, so that two trees' kernels can be
    timed by this one function in one call.  Returns the readings."""
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op

    b, bp, L, h, ds, p = 100, 1, 256, 12, 32, 8
    names = ("layer_heads_kernel", "attend_kernel", "out_proj_kernel")
    with torch.no_grad():
        a = layer_inputs(torch, b, bp, L, 128, h, ds, p, torch.float32, 98, 0,
                         directions=True)
        kern = lambda: op.fused_ipa_layer_packed(**a)
        km = cuda_time_ms(kern, iters)
        tl = device_timeline(torch, kern, iters, names)
        km2 = cuda_time_ms(kern, iters)
    # the core's products (logits over the ds + 3P + 3 augmented features,
    # weighted sums over ds + 3P) and its compulsory bytes: attn written,
    # the operand scratch (FP = 64, FVP = 56 rows) read once, the features
    # written (FH = 88)
    fv = ds + 3 * p
    fp, fvp, fh = -(-(fv + 3) // 8) * 8, -(-fv // 8) * 8, -(-(ds + 7 * p) // 8) * 8
    flops = 2 * b * h * L * L * (2 * fv + 3)
    n_bytes = 4 * (b * h * L * L + b * h * (2 * fp + fvp) * L + b * L * h * fh)
    bnd, by, t_o, t_b = bound_parts(flops, n_bytes, "float32")
    att = tl and tl["attend_kernel"]
    out = dict(call_ms=min(km, km2), launch_ms=tl and {n: tl[n] for n in names},
               attend_bound_ms=bnd)
    print(f"[time] K1 f32 directions b={b} bp={bp} L={L} h={h} on {card}: the call "
          f"{km:.4f} / {km2:.4f} ms (CUDA events, {iters} calls queued behind a sleep); "
          + ("its launches: not measured (the profiler reported no device time)" if tl is None
             else "its launches (profiler, " + str(tl["calls_seen"]) + " calls seen): "
             + ", ".join(f"{n} {'not measured' if tl[n] is None else f'{tl[n]:.4f} ms'}"
                         for n in names))
          + f"; the attention launch's bound {bnd:.4f} ms ({flops / 1e9:.2f} GFLOP at the "
          f"3xTF32 rate -> {t_o:.4f} ms, {n_bytes / 1e6:.1f} MB -> {t_b:.4f} ms; bound by {by})"
          + ("" if not att else f", {bnd / att:.2%} of it"))
    return out


def ga_phase(torch, card):
    """[ga] the official DiffAb network (official_config(): GA blocks of 12
    heads with point directions, the quaternion rotation head, six CDRs, L =
    256, float32) on the card.  (a) K1 with direction rows against its plain
    version: b = 100, h = 12, L = 256 in float32 and bf16 (the chunked path),
    L = 77 in float32 at d = 30, b = 100, L = 128 in float32, and b = 128,
    L = 128 in bf16, where the
    persistent launch 1 would take the call without direction rows: it must
    take the per-item kernel (the counters); float32 at h = 12 and L = 129,
    200, 256, 384 (ga_long_checks, each booking its attention path); then
    the autograd Function with direction rows against autograd of its plain
    version.  (b) sample() graphed bitwise eager under deterministic
    algorithms (8 designs, L = 256, T = 100; K1 600 a call, each on the
    one-pass attention: the counters) and the `ga.blocks` counter, 600 a
    call on both; then attend_time, the official call's K1 [time] line.
    (c) `DiffAb(official_config())` through its entry points: sample()
    (graphed) of 100 designs of a six-CDR 256-residue patch, score_designs,
    and fit() for 3 steps at batch 4; then `cli.train --official` 2 steps
    and `cli.sample --official` from its checkpoint.  Returns the largest
    K1 error."""
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.cli import sample as cli_sample
    from diffab_pytorch_tpu_torch.cli import train as cli_train
    from diffab_pytorch_tpu_torch.data.dataset import PatchDataset, assemble_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.structure.patch import load_patch
    from diffab_pytorch_tpu_torch.train.harness import DiffAb
    from diffab_pytorch_tpu_torch.train.trainer import fit
    from diffab_pytorch_tpu_torch.utils import profiling

    worst = 0.0
    with torch.no_grad():
        for dtype, seed in ((torch.float32, 90), (torch.bfloat16, 91)):
            worst = max(worst, check_layer(
                torch, f"[ga] (a) K1 directions {dtype} (b=100 bp=1 L=256 h=12)",
                layer_inputs(torch, 100, 1, 256, 128, 12, 32, 8, dtype, seed, 9,
                             directions=True), bf16=dtype == torch.bfloat16))
        worst = max(worst, check_layer(
            torch, "[ga] (a) K1 directions f32 L=77 d=30 (b=8 bp=2 h=12)",
            layer_inputs(torch, 8, 2, 77, 30, 12, 32, 8, torch.float32, 92, 9,
                         directions=True), bf16=False))
        worst = max(worst, check_layer(
            torch, "[ga] (a) K1 directions f32 (b=100 bp=1 L=128 h=12)",
            layer_inputs(torch, 100, 1, L_MAIN, 128, 12, 32, 8, torch.float32, 96, 9,
                         directions=True), bf16=False))
        before = k1_paths()
        worst = max(worst, check_layer(
            torch, "[ga] (a) K1 directions bf16 (b=128 bp=1 L=128 h=8)",
            layer_inputs(torch, N_DESIGNS, 1, L_MAIN, 128, 8, 32, 8, torch.bfloat16, 93, 0,
                         directions=True), bf16=True))
        got = k1_paths_since(before)
        print(f"[ga] (a) K1 paths of that call: {got} (the per-item kernel: no items, one call)")
        if got != dict(items=0, overlapped=0, fallback_calls=1, attend_onepass=0,
                       attend_twopass=0):
            raise RuntimeError(f"[ga] (a) K1 with direction rows took the persistent path: {got}")
    worst = max(worst, ga_long_checks(torch))
    la = layer_inputs(torch, 4, 4, L_MAIN, 128, 12, 32, 8, torch.float32, 94, 8,
                      directions=True)
    shape = (12, 32, 8, True)
    layer_fn = lambda impl: (lambda x, wq, wo, g, bias, rot, trans, mask, st: impl(
        x, rot, trans, mask, op.LayerKernelWeights(wq, wo, g, *shape), bias, st))
    check_grads(torch, "[ga] (a) K1 directions f32 (b=4 L=128 h=12)",
                layer_fn(op.fused_ipa_layer_packed), layer_fn(op.fused_ipa_layer_packed_reference),
                [la["x"], la["wts"].w_qkv, la["wts"].w_out, la["wts"].g, la["bias"]],
                (la["rot"], la["trans"], la["mask"], la["scale_total"]))

    d = C.default_config().diffusion
    sched = cosine_variance_schedule(d.T, s=d.s, beta_max=d.beta_max, device="cuda")
    tables = make_orientation_tables(sched)
    blocks0 = profiling.counters().get("ga.blocks", 0)
    gs = graph_sample(torch, "[ga] (b)", sched, tables, "float32", 8, 256, model=GA_MODEL,
                      k1_per_call=600)
    blocks = profiling.counters().get("ga.blocks", 0) - blocks0
    print(f"[ga] (b) ga.blocks over those 5 calls (eager, graphed, 2 replays, eager): {blocks}")
    if blocks != 5 * 600:
        raise RuntimeError(f"[ga] (b) ga.blocks {blocks}, expected {5 * 600}")
    attend = {k: gs["k1_paths"][k] for k in ("attend_onepass", "attend_twopass")}
    print(f"[ga] (b) K1 attention paths a replay: {attend} (expected 600 one-pass calls)")
    if attend != dict(attend_onepass=600, attend_twopass=0):
        raise RuntimeError(f"[ga] (b) the L=256 float32 calls took {attend}")
    attend_time(torch, card)

    cfg = C.official_config()
    cdrs = cfg.data.cdrs_to_generate
    with tempfile.TemporaryDirectory() as tmp:
        paths = ga_patches(tmp, 8)
        h = DiffAb(cfg)
        state = h.init(0)
        batch = assemble_batch([load_patch(paths[0])], cdrs, device="cuda")[0]
        gen = torch.Generator(device="cuda")
        res = h.sample(state.params, batch, generator=gen.manual_seed(0), n_designs=100)
        scores = h.score_designs(state.params, batch, res, generator=gen.manual_seed(9)).score
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(t).all()) for t in (res.translations, res.orientations,
                                                         scores))
        ds = PatchDataset(paths, cdrs_to_generate=cdrs)
        rows = [b for b, _ in ds.batches(4, shuffle=False, epochs=1)]
        state = fit(h, rows, max_steps=3, state=state, seed=1)
        print(f"[ga] (c) official_config(): sample() 100 designs of a six-CDR L=256 patch and "
              f"score_designs finite {ok}, fit() to step {state.step}")
        if not ok or state.step != 3:
            raise RuntimeError("[ga] (c) the official network's entry points failed")
        ck = os.path.join(tmp, "ck")
        rc = cli_train.main(["--data-dir", tmp, "--official", "--max-steps", "2", "-b", "4",
                             "--val-pct", "0", "--checkpoint-dir", ck])
        rc = rc or cli_sample.main(["--patch", paths[1], "--checkpoint-dir", ck, "-n", "4",
                                    "--official", "-o", os.path.join(tmp, "designs")])
        print(f"[ga] (c) cli.train --official and cli.sample --official: exit {rc}")
        if rc:
            raise RuntimeError("[ga] (c) the --official CLIs failed")
    print(f"[ga] K1 with direction rows: largest error {worst:.3e}")
    return worst


def ga_main() -> int:
    """`python3 chip_smoke.py --ga`: the build, then the [ga] phase alone."""
    import torch

    sys.path.insert(0, HERE)
    from diffab_pytorch_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[build] kernels built in {_build.build_all():.2f} s")
    ga_phase(torch, card_line())
    return 0


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
    f32, b16 = torch.float32, torch.bfloat16
    with torch.no_grad():
        check_layer(torch, "tiny f32 (b=2 bp=1 L=24 d=32 h=4 ds=8 p=4)",
                    layer_inputs(torch, 2, 1, 24, 32, 4, 8, 4, f32, 0, 5), bf16=False)
        err_f32 = check_layer(torch, "main f32 (b=8 bp=1 L=128)",
                              layer_inputs(torch, 8, 1, **main_shape, dtype=f32, seed=1,
                                           n_masked=16), bf16=False)
        err_bf16 = check_layer(torch, "main bf16 (b=8 bp=1 L=128)",
                               layer_inputs(torch, 8, 1, **main_shape, dtype=b16, seed=2,
                                            n_masked=16), bf16=True)
        err_bf16 = max(err_bf16, check_layer(
            torch, "main bf16 (b=8 bp=2 L=128)",
            layer_inputs(torch, 8, 2, **main_shape, dtype=b16, seed=3, n_masked=0), bf16=True))
        err_bf16 = max(err_bf16, check_layer(
            torch, "train bf16 (b=32 bp=32 L=128)",
            layer_inputs(torch, 32, 32, **main_shape, dtype=b16, seed=5, n_masked=8), bf16=True))
        err_bf16 = max(err_bf16, check_layer(
            torch, "tiny bf16 (b=2 bp=1 L=24 d=32 h=4 ds=8 p=4)",
            layer_inputs(torch, 2, 1, 24, 32, 4, 8, 4, b16, 7, 5), bf16=True))
        err_bf16 = max(err_bf16, check_layer(
            torch, "bf16 L=77 (b=8 bp=2)",
            layer_inputs(torch, 8, 2, 77, 128, 8, 32, 8, b16, 8, 9), bf16=True))
        # float32 at the tile edges: L % 8 != 0 with d % 4 != 0 (x read
        # element by element), the training shape, and the widest shape the
        # gate takes (ds + 3P = 64, P = 21) at narrow d and h
        err_f32 = max(err_f32, check_layer(
            torch, "f32 L=77 d=30 (b=8 bp=2 h=8 ds=32 p=8)",
            layer_inputs(torch, 8, 2, 77, 30, 8, 32, 8, f32, 9, 9), bf16=False))
        err_f32 = max(err_f32, check_layer(
            torch, "train f32 (b=32 bp=32 L=128)",
            layer_inputs(torch, 32, 32, **main_shape, dtype=f32, seed=18, n_masked=8),
            bf16=False))
        err_f32 = max(err_f32, check_layer(
            torch, "widest f32 (b=4 bp=1 L=128 d=20 h=2 ds=1 p=21)",
            layer_inputs(torch, 4, 1, 128, 20, 2, 1, 21, f32, 19, 11), bf16=False))
        err_f32 = max(err_f32, check_layer(
            torch, "widest f32 L=77 (b=4 bp=2 d=20 h=2 ds=1 p=21)",
            layer_inputs(torch, 4, 2, 77, 20, 2, 1, 21, f32, 23, 9), bf16=False))
        # the default widths' fixed slices with x read element by element
        err_f32 = max(err_f32, check_layer(
            torch, "f32 L=128 d=30 (b=8 bp=2 h=8 ds=32 p=8)",
            layer_inputs(torch, 8, 2, 128, 30, 8, 32, 8, f32, 24, 9), bf16=False))

        check_attention(torch, "K2 tiny f32 (b=2 bp=1 L=24 h=4 ds=8 p=4)",
                        attention_inputs(torch, 2, 1, 24, 4, 8, 4, f32, 10, 5), 5, bf16=False)
        k2_err_f32 = check_attention(
            torch, "K2 main f32 (b=8 bp=2 L=128)",
            attention_inputs(torch, 8, 2, **att_shape, dtype=f32, seed=11, n_masked=16), 16,
            bf16=False)
        k2_err_bf16 = check_attention(
            torch, "K2 train bf16 (b=32 bp=32 L=128)",
            attention_inputs(torch, 32, 32, **att_shape, dtype=b16, seed=12, n_masked=8), 8,
            bf16=True)
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 sample bf16 (b=128 bp=1 L=128)",
            attention_inputs(torch, 128, 1, **att_shape, dtype=b16, seed=13, n_masked=16), 16,
            bf16=True))
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 bf16 (b=8 bp=2 L=128)",
            attention_inputs(torch, 8, 2, **att_shape, dtype=b16, seed=14, n_masked=0), 0,
            bf16=True))
        # the tile edges: L below one 16-row tile of a warp, L % 8 != 0
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 tiny bf16 (b=2 bp=1 L=24 h=4 ds=8 p=4)",
            attention_inputs(torch, 2, 1, 24, 4, 8, 4, b16, 15, 5), 5, bf16=True))
        k2_err_bf16 = max(k2_err_bf16, check_attention(
            torch, "K2 bf16 L=77 (b=8 bp=2)",
            attention_inputs(torch, 8, 2, 77, 8, 32, 8, b16, 16, 9), 9, bf16=True))
        k2_err_f32 = max(k2_err_f32, check_attention(
            torch, "K2 f32 L=77 (b=8 bp=2)",
            attention_inputs(torch, 8, 2, 77, 8, 32, 8, f32, 17, 9), 9, bf16=False))

    # autograd Functions (kernel forward, recomputed plain backward)
    la = layer_inputs(torch, 4, 4, **main_shape, dtype=f32, seed=20, n_masked=8)
    shape = (la["wts"].n_head, la["wts"].d_scalar, la["wts"].n_point)
    layer_fn = lambda impl: (lambda x, wq, wo, g, bias, rot, trans, mask, st: impl(
        x, rot, trans, mask, op.LayerKernelWeights(wq, wo, g, *shape), bias, st))
    check_grads(torch, "K1 fused layer f32 (b=4 L=128)", layer_fn(op.fused_ipa_layer_packed),
                layer_fn(op.fused_ipa_layer_packed_reference),
                [la["x"], la["wts"].w_qkv, la["wts"].w_out, la["wts"].g, la["bias"]],
                (la["rot"], la["trans"], la["mask"], la["scale_total"]))
    aa = attention_inputs(torch, 4, 4, **att_shape, dtype=f32, seed=21, n_masked=8)
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
    launches = {"sample": sampling_main_path(torch, "bfloat16", "[main]"),
                "sample_f32": sampling_main_path(torch, "float32", "[main-f32]")}

    # ---- 6. training main path: production_config(), both flags -------------------
    for fuse in (None, False):
        launches[f"train_fuse_{fuse}"] = training_main_path(torch, "[train]", fuse, L_MAIN, 3, 20)

    # ---- 7. per-launch times at L = 128 ---------------------------------------------
    pb = C.production_config().train.batch_size
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
    launches["sample_L256"] = sampling_main_path(torch, "bfloat16", "[main-256]", L=256)
    # the captured bf16 training steps at L = 256, K1 and K2 (the K2 capture
    # was once invalidated in one run of three, PERF.md §7)
    for fuse in (None, False):
        launches[f"train_L256_fuse_{fuse}"] = training_main_path(
            torch, "[main-256] train", fuse, 256, 2, 4, batch_size=8)
    # K1 at the widest shape the recipes give it (b = n_designs, bp = 1)
    b_fast = max(n for _, n, _ in FAST_RECIPES)
    with torch.no_grad():
        err_bf16 = max(err_bf16, check_layer(
            torch, f"[fast] bf16 (b={b_fast} bp=1 L=128)",
            layer_inputs(torch, b_fast, 1, **main_shape, dtype=b16, seed=22, n_masked=8),
            bf16=True))
    for name, n_designs, opts in FAST_RECIPES:
        launches[f"sample_{name}"] = sampling_main_path(
            torch, "bfloat16", f"[fast] {name}", n_designs=n_designs, **opts)

    # ---- 11. the design loop: cli.sample --rank and cli.evaluate --------------------------
    launches.update(design_phase(torch))

    # ---- 12. the training data path: PDBs -> patches -> cli.train -> cli.sample -------------
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(data_phase(torch, tmp))
        patches = os.path.join(tmp, "patches")

        # ---- 13. self-conditioning ----------------------------------------------------------
        launches.update(selfcond_phase(torch, patches, tmp))

        # ---- 14. data parallelism -------------------------------------------------------------
        launches.update(parallel_phase(torch, patches, tmp))

        # ---- 15. tensor parallelism -----------------------------------------------------------
        tp_launches, err1_tp, err2_tp, tp_times = tp_phase(torch, card, tmp, k1_times,
                                                           k2_times)
        launches.update(tp_launches)

        # ---- 16. the rest of the JAX package: sample_sharded, steps_per_call, tools, corpus ---
        launches.update(rest_phase(torch, card, tmp))

    # ---- 17. the compiled step bodies: graphed against eager --------------------------
    graph_phase(torch, card)

    # ---- 18. the official DiffAb network --------------------------------------------------
    ga_phase(torch, card)

    # ---- 19. records ---------------------------------------------------------------
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
        "max_err_tp_heads": err1_tp,
        "tp_heads": {h: {"bf16": t[0], "f32": t[1]} for h, t in tp_times.items()},
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
        "max_err_tp_heads": err2_tp,
        "tp_heads": {h: {f"{d}_{shape}": v for (d, shape), v in t[2].items()}
                     for h, t in tp_times.items()},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--run-clis"]:
        sys.exit(run_clis(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--ga"]:
        sys.exit(ga_main())
    sys.exit(main())
