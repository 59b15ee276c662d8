#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (diffab_pytorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from csrc/ (nvcc, sm_90a) and print the build time;
  3. each kernel against its plain PyTorch version on the card, at tiny
     shapes in float32 and at the main path's shapes in float32 and
     bfloat16, with the tolerances stated below;
  4. end-to-end check on a small input: sample() on the card (kernels)
     against sample() on the CPU (plain versions) from one initial state
     with the same injected noise;
  5. the main path: CDR-H3 codesign sampling with default_config() in
     bfloat16, 128 designs of one synthetic 128-residue target, T=100,
     seeded random weights; launch counts, output checks, designs/s and a
     profiler breakdown of one call;
  6. per-launch kernel times against the plain version and the bound;
  7. a `kernels` JSON line, the card line, and the final JSON line.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

N_DESIGNS, L_MAIN, N_GENERATE = 128, 128, 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_inputs(torch, b, bp, L, d, h, ds, p, dtype, bias_dtype, seed, n_masked):
    """Random fused-layer inputs on the card: orthonormal frames,
    translations of magnitude ~5, the last n_masked keys padded."""
    from diffab_pytorch_tpu_torch.geometry import so3
    from diffab_pytorch_tpu_torch.ops.ipa_fused_layer import pack_layer_weights

    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)
    w = lambda n_in, n_out: f(n_in, n_out) / n_in ** 0.5
    mask = torch.ones(b, L)
    mask[:, L - n_masked:] = 0.0
    scales = (ds ** -0.5, (4.5 * p) ** -0.5, 3 ** -0.5)
    wts = pack_layer_weights(
        w(d, h * ds), w(d, h * ds), w(d, h * ds),
        w(d, h * p * 3), w(d, h * p * 3), w(d, h * p * 3),
        w(h * ds, d), w(h * p * 3, d), w(h * p, d),
        f(h).abs() + 0.5, scales[0], scales[1], dtype,
    )
    wts = wts._replace(w_qkv=wts.w_qkv.cuda(), w_out=wts.w_out.cuda(), g=wts.g.cuda())
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
    masked = args["mask"][:, -1] == 0
    padded = attn_k[masked][..., -1].float().abs().max().item() if masked.any() else 0.0
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from diffab_pytorch_tpu_torch import config as C
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
    from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
    from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
    from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
    from diffab_pytorch_tpu_torch.ops import _build
    from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as op
    from diffab_pytorch_tpu_torch.sampling.sampler import StepNoise, sample
    from diffab_pytorch_tpu_torch.weights import init_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    print(f"[build] kernels built in {build_s:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel vs plain version ----------------------------------------
    main_shape = dict(L=L_MAIN, d=128, h=8, ds=32, p=8)
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

    # ---- 4. end to end on a small input: card vs CPU -------------------------
    tiny = C.tiny_config()
    gen_cpu = torch.Generator().manual_seed(0)
    cpu_model = init_parameters(DiffAbModel(tiny.model, device="cpu"), gen_cpu)
    card_model = DiffAbModel(tiny.model, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    s8 = cosine_variance_schedule(8, s=tiny.diffusion.s, beta_max=tiny.diffusion.beta_max)
    t8 = make_orientation_tables(s8)
    small = synthetic_batch(0, 1, 24, n_generate=6)
    n_small, bn = 2, 2
    g = torch.Generator().manual_seed(1)
    init = (torch.randint(0, 21, (bn, 24), generator=g), torch.randn(bn, 24, 3, generator=g),
            torch.linalg.qr(torch.randn(bn, 24, 3, 3, generator=g))[0])
    init = (init[0], init[1], init[2] * torch.det(init[2])[..., None, None].sign())
    noise = {t: StepNoise(gumbel=-torch.log(-torch.log(torch.rand(bn, 24, 21, generator=g))),
                          coord=torch.randn(bn, 24, 3, generator=g),
                          orientation=AxisAngleNoise.draw((bn, 24), g))
             for t in range(1, 9)}
    on = lambda dev: (lambda t: StepNoise(noise[t].gumbel.to(dev), noise[t].coord.to(dev),
                                          AxisAngleNoise(*(a.to(dev) for a in noise[t].orientation))))
    out_cpu = sample(cpu_model, s8, t8, small, device="cpu", n_designs=n_small,
                     initial_state=init, step_noise=on("cpu"))
    out_card = sample(card_model, s8, t8, small, device="cuda", n_designs=n_small,
                      initial_state=init, step_noise=on("cuda"))
    torch.cuda.synchronize()
    seq_same = torch.equal(out_card.seq_idx.cpu(), out_cpu.seq_idx)
    d_x = (out_card.translations.cpu() - out_cpu.translations).abs().max().item()
    d_r = (out_card.orientations.cpu() - out_cpu.orientations).abs().max().item()
    print(f"[e2e-small] card vs CPU, tiny_config f32, T=8, 2 designs: sequences equal "
          f"{seq_same}, max|d x| {d_x:.3e}, max|d R| {d_r:.3e} (tol 1e-3)")
    if not seq_same or d_x > 1e-3 or d_r > 1e-3:
        raise RuntimeError("sample() on the card disagrees with the CPU plain path")

    # ---- 5. main path -----------------------------------------------------------
    cfg = C.default_config()
    mcfg = C.ModelConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = init_parameters(DiffAbModel(mcfg), torch.Generator().manual_seed(0))
    sched = cosine_variance_schedule(cfg.diffusion.T, s=cfg.diffusion.s,
                                     beta_max=cfg.diffusion.beta_max, device="cuda")
    tables = make_orientation_tables(sched)
    target = synthetic_batch(0, 1, L_MAIN, mcfg.n_atoms, n_generate=N_GENERATE, device="cuda")
    print(f"[main] set-up (model, IGSO(3) tables, target) {time.perf_counter() - t0:.2f} s")

    def run(seed):
        return sample(model, sched, tables, target, n_designs=N_DESIGNS,
                      generator=torch.Generator(device="cuda").manual_seed(seed))

    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    print(f"[main] warm-up sample() {time.perf_counter() - t0:.2f} s")

    n_calls = 3
    op.fused_ipa_layer_packed.launches = 0
    call_s = []
    for i in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(11 + i)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    launches = op.fused_ipa_layer_packed.launches
    expected = n_calls * mcfg.n_ipa_layers * cfg.diffusion.T
    wall = sorted(call_s)[n_calls // 2]  # median call
    designs_per_s = N_DESIGNS / wall
    print(f"[main] {n_calls} x sample(n_designs={N_DESIGNS}, T={cfg.diffusion.T}): "
          f"{', '.join(f'{c:.4f}' for c in call_s)} s; median {designs_per_s:.2f} "
          f"designs/s on {card}; ipa_fused_layer launches {launches} "
          f"(expected {expected})")
    if launches != expected:
        raise RuntimeError(f"main path launched the fused layer {launches} times, "
                           f"expected {expected}")
    bn = N_DESIGNS
    ctx = ~target.generation_mask[0]
    checks = {
        "finite": bool(torch.isfinite(out.translations).all() and torch.isfinite(out.orientations).all()),
        "shapes": tuple(out.translations.shape) == (bn, L_MAIN, 3)
        and tuple(out.orientations.shape) == (bn, L_MAIN, 3, 3),
        "orthonormal": float((out.orientations.transpose(-1, -2) @ out.orientations
                              - torch.eye(3, device="cuda")).abs().max()) < 1e-3,
        "context_unchanged": bool(
            (out.seq_idx[:, ctx] == target.seq_idx[0, ctx]).all()
            and (out.translations[:, ctx] == target.translations[0, ctx]).all()
            and (out.orientations[:, ctx] == target.orientations[0, ctx]).all()),
        "sequence_in_vocab": bool(((out.seq_idx >= 0) & (out.seq_idx < 21)).all()),
        "designs_differ": bool((out.translations[0] != out.translations[1]).any()),
    }
    print(f"[main] output checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"main path output check failed: {checks}")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(20)
        torch.cuda.synchronize()
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us > 0:
        call_us = wall * 1e6
        print(f"[profile] one sample() call: device busy {busy_us / 1e3:.1f} ms; "
              f"median unprofiled call {call_us / 1e3:.1f} ms -> device idle share "
              f"{max(0.0, 1 - busy_us / call_us):.3f} (profiled wall "
              f"{prof_wall_us / 1e3:.1f} ms)")
        for dev_us, key, count in rows[:12]:
            print(f"[profile]   {dev_us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    else:
        print("[profile] device time: not measured (profiler reported none)")

    # ---- 6. per-launch time at the main shapes (b=128 designs, bp=1) -----------
    with torch.no_grad():
        args = layer_inputs(torch, N_DESIGNS, 1, **main_shape, dtype=torch.bfloat16,
                            bias_dtype=torch.bfloat16, seed=4, n_masked=0)
        err_bf16 = max(err_bf16, check_layer(torch, "main bf16 (b=128 bp=1 L=128)", args, bf16=True))
        kernel_ms = cuda_time_ms(lambda: op.fused_ipa_layer_packed(**args), 20)
        plain_ms = cuda_time_ms(lambda: op.fused_ipa_layer_packed_reference(**args), 5)
        kernel_ms_2 = cuda_time_ms(lambda: op.fused_ipa_layer_packed(**args), 20)
    flops, n_bytes = ipa_layer_flops_bytes(N_DESIGNS, 1, **main_shape, itemsize=2,
                                           bias_itemsize=2)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, n_bytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[time] ipa_fused_layer b=128 L=128 bf16 on {card}: kernel {kernel_ms:.4f} / "
          f"{kernel_ms_2:.4f} ms, plain version {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms, {n_bytes / 1e6:.2f} MB -> "
          f"{t_bytes:.4f} ms; bound by {bound_by}), {bound_ms / kernel_ms:.3%} of bound")

    # ---- 7. records ---------------------------------------------------------------
    kernels = [{
        "name": "ipa_fused_layer",
        "route": "cuda",
        "source": "diffab_pytorch_tpu_torch/csrc/ipa_fused_layer.cu",
        "replaces": "diffab_pytorch_tpu/ops/ipa_pallas.py:519",
        "tpu_kernel": "ops/ipa_pallas.py:_layer_kernel_batched",
        "launches": launches,
        "max_abs_err": max(err_f32, err_bf16),
        "max_err_f32": err_f32,
        "max_err_bf16": err_bf16,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"[main] designs/s {designs_per_s:.3f} (card: {card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
