"""The official DiffAb network in the port (`ModelConfig(ipa_block="ga")`,
`official_config()`)
against its plain reference `benchmark/reference/ga.py`, at a tiny size on
the CPU (d 32, 4 heads, 4 points, 2 blocks, L 24 or a 64-residue patch,
residues masked) on the benchmark's seeded random weights.

The tolerances, each with its reason (float32 on both sides; the port and
the reference sum the same products in other orders):

  BLOCK 2e-5 of the output scale: a GA block's output passes a LayerNorm,
      which divides by the features' spread (~1 here): the attention's
      float32 rounding (~1e-7 relative, sums of ~100 terms) stays under
      1e-6 through it;
  EPS_NET 2e-5: two blocks and three MLP heads on top, the same argument;
  LOSS 2e-6 relative: a mean of float32 terms;
  GRADS 2e-4 of a leaf's gradient norm (or the median leaf's, where that
      is larger): backward through softmax, LayerNorm and the quaternion
      head amplifies the forward's rounding by ~10x at these sizes.

The float32 port reads 5.6e-7, 1.9e-6, 1e-7 and 1.9e-5 on these cases; a
bfloat16 port reads 1e-2, 3e-2, 8e-4 and 0.47, and the test below holds it
to more than 5x each tolerance (`test_each_tolerance_fails_a_bfloat16_port`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import program  # noqa: E402
from benchmark.lib.weights_ga import make_params  # noqa: E402
from benchmark.reference import data as ref_data  # noqa: E402
from benchmark.reference import ga as ref_ga  # noqa: E402
from benchmark.reference import geometry as ref_geo  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference.precision import Precision  # noqa: E402
from diffab_pytorch_tpu_torch import config as C  # noqa: E402
from diffab_pytorch_tpu_torch.data.dataset import assemble_batch  # noqa: E402
from diffab_pytorch_tpu_torch.data.synthetic import make_family_pdb  # noqa: E402
from diffab_pytorch_tpu_torch.geometry import so3  # noqa: E402
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel  # noqa: E402
from diffab_pytorch_tpu_torch.ops import _build  # noqa: E402
from diffab_pytorch_tpu_torch.ops import ipa_fused_layer as k1  # noqa: E402
from diffab_pytorch_tpu_torch.sampling import sampler as tsampler  # noqa: E402
from diffab_pytorch_tpu_torch.structure.antibody import from_chains  # noqa: E402
from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, save_patch  # noqa: E402
from diffab_pytorch_tpu_torch.structure.pdb import parse_pdb  # noqa: E402
from diffab_pytorch_tpu_torch.train.harness import DiffAb  # noqa: E402
from diffab_pytorch_tpu_torch.utils import graphs, profiling  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(d_residue_emb=32, d_pair_emb=16, n_ipa_layers=2, d_scalar_per_head=8,
            n_query_point_per_head=4, n_value_point_per_head=4, n_head=4)
GA = dict(ipa_block="ga")
CDRS = ("H1", "H2", "H3", "L1", "L2", "L3")
TOL = dict(block=2e-5, eps_net=2e-5, loss=2e-6, grads=2e-4)
F32 = Precision("f32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_config(fuse=None, dtype="float32") -> C.ModelConfig:
    return C.ModelConfig(**TINY, **GA, fuse_ipa_layer=fuse, compute_dtype=dtype)


def full_config(fuse=None, dtype="float32") -> C.DiffAbConfig:
    return C.DiffAbConfig(model=model_config(fuse, dtype),
                          diffusion=C.DiffusionConfig(T=10, igso3_n_bins=512, igso3_n_terms=256),
                          data=C.DataConfig(patch_size=64, cdrs_to_generate=CDRS),
                          train=C.TrainConfig(mode_dropout=0.15))


def seeded_model(cfg: C.ModelConfig, seed=3):
    model = DiffAbModel(cfg, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = make_params(shapes, seed, torch.device("cpu"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    return model, params


def frames_inputs(b=3, L=24, d=32, dp=16, seed=0, n_masked=5):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(b, L, dtype=torch.bool)
    mask[:, L - n_masked:] = False
    mask[1, 3] = False
    return dict(x=torch.randn(b, L, d, generator=g),
                pair=torch.randn(1, L, L, dp, generator=g),
                rot=so3.uniform((b, L), generator=g),
                trans=2.0 * torch.randn(b, L, 3, generator=g), mask=mask)


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.abs().max()))


# ---- the gaps the tolerances bound ------------------------------------------------


def block_gap(fuse, dtype) -> float:
    """Each GA block's output on the port's input to it, port against the
    reference; the worst block."""
    cfg = model_config(fuse, dtype)
    model, P = seeded_model(cfg)
    a = frames_inputs()
    c = dataclasses.asdict(cfg)
    x, worst = a["x"], 0.0
    with torch.no_grad():
        for i, layer in enumerate(model.denoiser.ipa.layers):
            out = layer(x, a["pair"], a["rot"], a["trans"], a["mask"])
            ref = ref_ga.ga_block(P, f"denoiser.ipa.layer_{i}", c, x.float(), a["pair"],
                                  a["rot"], a["trans"], a["mask"], F32)
            worst = max(worst, rel(out, ref))
            x = out
    return worst


def eps_net_gap(fuse, dtype) -> float:
    """One EpsilonNet call, each output, port against the reference."""
    cfg = model_config(fuse, dtype)
    model, P = seeded_model(cfg, seed=4)
    a = frames_inputs(seed=1)
    g = torch.Generator().manual_seed(5)
    b, L = a["mask"].shape
    seq = torch.randint(0, cfg.aa_vocab_size, (b, L), generator=g)
    res_ctx = torch.randn(1, L, cfg.d_residue_emb, generator=g)
    beta = torch.rand(b, generator=g)
    with torch.no_grad():
        out = model.denoiser(seq, a["trans"], a["rot"], res_ctx, a["pair"], beta, a["mask"])
        ref = ref_ga.denoise(P, dataclasses.asdict(cfg), seq, a["trans"], a["rot"], res_ctx,
                             a["pair"], beta, a["mask"], F32)
    return max(rel(out[k], ref[k]) for k in ("translations_eps", "orientations_t0",
                                             "seq_logits"))


@pytest.fixture(scope="module")
def patch_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ga_patches")
    paths = []
    for i in range(2):
        patch = featurize_patch(from_chains(parse_pdb(make_family_pdb(i, 11 + i)), "H", "L",
                                            ["A"]), 64)
        paths.append(str(tmp / f"p{i}.npz"))
        save_patch(paths[-1], patch)
    return paths


def loss_gaps(paths, fuse, dtype):
    """(loss gap, worst leaf's gradient gap) of one training loss on two
    six-CDR patches under the same draws."""
    cfg = full_config(fuse, dtype)
    h = DiffAb(cfg, device="cpu")
    _, P = seeded_model(cfg.model, seed=6)
    from diffab_pytorch_tpu_torch.structure.patch import load_patch

    batch, _ = assemble_batch([load_patch(p) for p in paths], CDRS, device="cpu")
    seed, T = 21, cfg.diffusion.T
    draws = h.draw(batch, torch.Generator().manual_seed(ref_train.step_seed(seed, 0)))
    params = {n: v.clone().requires_grad_(True) for n, v in P.items()}
    loss, _, grads = h.loss_and_grads(params, batch, draws, 0)

    c, tc = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    sched, table = ref_geo.diffusion_tables(dataclasses.asdict(cfg.diffusion), "cpu")
    rb = ref_data.to_batch([ref_ga.normalize(ref_data.load(p), CDRS) for p in paths], "cpu")
    d = ref_train.step_draws(seed, 0, *batch.seq_idx.shape, c["aa_vocab_size"], T, "cpu")
    leaves = {n: v.clone().requires_grad_(True) for n, v in P.items()}
    ref_loss, _ = ref_ga.loss(leaves, c, tc, sched, table, rb, d, F32)
    names = list(leaves)
    ref_grads = dict(zip(names, torch.autograd.grad(ref_loss, [leaves[n] for n in names],
                                                    allow_unused=True, materialize_grads=True)))
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    grad_gap = max(float((grads[n].float() - ref_grads[n]).norm()) / max(norms[n], med)
                   for n in names)
    ref_loss = float(ref_loss.detach())
    return abs(float(loss.detach()) - ref_loss) / abs(ref_loss), grad_gap


# ---- the port against the reference ----------------------------------------------------


@pytest.mark.parametrize("fuse", [None, False], ids=["k1", "attention_core"])
def test_each_ga_block_matches_the_reference(fuse):
    assert block_gap(fuse, "float32") <= TOL["block"]


@pytest.mark.parametrize("fuse", [None, False], ids=["k1", "attention_core"])
def test_the_epsilon_net_matches_the_reference(fuse):
    assert eps_net_gap(fuse, "float32") <= TOL["eps_net"]


@pytest.mark.parametrize("fuse", [None, False], ids=["k1", "attention_core"])
def test_the_loss_and_every_gradient_match_the_reference(patch_paths, fuse):
    loss_gap, grad_gap = loss_gaps(patch_paths, fuse, "float32")
    assert loss_gap <= TOL["loss"]
    assert grad_gap <= TOL["grads"]


@pytest.mark.parametrize("case", ["block", "eps_net", "loss", "grads"])
def test_each_tolerance_fails_a_bfloat16_port(patch_paths, case):
    if case == "block":
        gap = block_gap(None, "bfloat16")
    elif case == "eps_net":
        gap = eps_net_gap(None, "bfloat16")
    else:
        gap = dict(zip(("loss", "grads"), loss_gaps(patch_paths, None, "bfloat16")))[case]
    assert gap > 5 * TOL[case], gap


def test_the_plain_branch_takes_the_directions():
    """Without the kernels' preconditions (pq != pv) the layer's plain
    branch computes the same GA block features in the official order."""
    cfg = dataclasses.replace(model_config(), n_query_point_per_head=2)
    model, P = seeded_model(cfg)
    layer = model.denoiser.ipa.layers[0]
    assert not layer.use_kernel
    a = frames_inputs()
    with torch.no_grad():
        out = layer(a["x"], a["pair"], a["rot"], a["trans"], a["mask"])
        ref = ref_ga.ga_block(P, "denoiser.ipa.layer_0", dataclasses.asdict(cfg), a["x"],
                              a["pair"], a["rot"], a["trans"], a["mask"], F32)
    assert rel(out, ref) <= TOL["block"]


# ---- the compiled step -----------------------------------------------------------------


def test_a_reverse_step_under_capture_rules_is_the_eager_step(patch_paths, monkeypatch):
    """The GA model's reverse body holds no op a CUDA graph capture cannot
    take (`graphs.capture_safe`: no host read, no data-shaped op), and the
    body run so gives the eager (graphs=False) result bit for bit."""
    from diffab_pytorch_tpu_torch.structure.patch import load_patch

    cfg = full_config()
    h = DiffAb(cfg, device="cpu")
    _, P = seeded_model(cfg.model, seed=7)
    batch, _ = assemble_batch([load_patch(patch_paths[0])], CDRS, device="cpu")
    run = lambda **kw: h.sample(P, batch, torch.Generator().manual_seed(2), n_designs=2,
                                n_steps=2, **kw)
    eager = run(graphs=False)
    real, ran = tsampler._reverse_body, []

    def checked(model, opts):
        body = real(model, opts)

        def step(c, *variant):
            ran.append(variant)
            return graphs.capture_safe(body, c, *variant)
        return step
    monkeypatch.setattr(tsampler, "_reverse_body", checked)
    safe = run()
    assert len(ran) == 2
    for a, b in zip(eager, safe):
        if a is not None:
            assert torch.equal(a, b)


def test_ga_blocks_count_on_every_replay_and_the_transition_is_a_span():
    """`ga.blocks` goes into a capture's tally (one a block) and each replay
    books it; the residual, LayerNorms and MLP run in the span
    `ga.transition` while a profiler records."""
    cfg = model_config()
    model, _ = seeded_model(cfg)
    a = frames_inputs()
    with torch.no_grad(), _build.capturing() as tally:
        model.denoiser.ipa(a["x"], a["pair"], a["rot"], a["trans"], a["mask"])
    assert tally == {"ga.blocks": cfg.n_ipa_layers}
    before = profiling.counters().get("ga.blocks", 0)
    for _ in range(3):
        _build.replayed(tally)
    assert profiling.counters()["ga.blocks"] == before + 3 * cfg.n_ipa_layers
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model.denoiser.ipa(a["x"], a["pair"], a["rot"], a["trans"], a["mask"])
    spans = [r for r in profiling.records() if r.name == "ga.transition"]
    assert len(spans) >= cfg.n_ipa_layers


# ---- the packing, the configuration, the entry points --------------------------------


def _native(seed, d=32, h=4, ds=8, p=4):
    g = torch.Generator().manual_seed(seed)
    w = lambda n_in, n_out: torch.randn(n_in, n_out, generator=g) / n_in ** 0.5
    return [w(d, h * ds), w(d, h * ds), w(d, h * ds), w(d, h * p * 3), w(d, h * p * 3),
            w(d, h * p * 3), w(h * ds, d), w(h * p * 3, d), w(h * p, d),
            torch.rand(h, generator=g) + 0.5]


def test_pack_without_direction_rows_packs_as_before_and_with_them_after_w_n():
    d, h, ds, p = 30, 4, 8, 4
    *w, gamma = _native(8, d, h, ds, p)
    scales = (ds ** -0.5, (4.5 * p) ** -0.5)
    plain = k1.pack_layer_weights(*w, gamma, *scales, torch.float32)
    # the head-major output rows as they were packed before direction rows
    fh, dpad = -(-(ds + 4 * p) // 8) * 8, -(-d // 8) * 8
    rows = torch.cat([w[6].reshape(h, ds, d),
                      w[7].reshape(h, p, 3, d).transpose(1, 2).reshape(h, 3 * p, d),
                      w[8].reshape(h, p, d)], 1)
    want = torch.nn.functional.pad(rows, (0, dpad - d, 0, fh - ds - 4 * p)).reshape(h * fh, dpad)
    assert not plain.directions and torch.equal(plain.w_out, want)
    w_od = torch.randn(h * p * 3, d)
    wd = k1.pack_layer_weights(*w, gamma, *scales, torch.float32, w_od=w_od)
    fh7 = k1.feature_width(ds, p, True)
    assert wd.directions and fh7 == 40 and wd.w_out.shape == (h * fh7, dpad)
    assert torch.equal(wd.w_qkv, plain.w_qkv) and torch.equal(wd.g, plain.g)
    heads = wd.w_out.reshape(h, fh7, dpad)
    assert torch.equal(heads[:, :ds + 4 * p], want.reshape(h, fh, dpad)[:, :ds + 4 * p])
    dirs = w_od.reshape(h, p, 3, d).transpose(1, 2).reshape(h, 3 * p, d)
    assert torch.equal(heads[:, ds + 4 * p:ds + 7 * p, :d], dirs)
    assert not k1.takes_persistent(torch.bfloat16, 128, 128, 128, 8, 32, 8, 132,
                                   directions=True)
    assert k1.takes_persistent(torch.bfloat16, 128, 128, 128, 8, 32, 8, 132)


def test_the_official_config_and_its_checks():
    cfg = C.official_config()
    m = cfg.model
    assert (m.d_residue_emb, m.d_pair_emb, m.n_ipa_layers, m.n_head, m.d_scalar_per_head,
            m.n_query_point_per_head, m.n_value_point_per_head) == (128, 64, 6, 12, 32, 8, 8)
    assert (m.ipa_block, m.compute_dtype) == ("ga", "float32")
    assert cfg.data.patch_size == 256 and cfg.data.cdrs_to_generate == CDRS
    assert cfg.diffusion.T == 100 and cfg.train.grad_clip_norm == 100.0
    # the benchmark's configuration file is this preset
    conf = json.loads((ROOT / "benchmark/configs/diffab-official-multicdr.json").read_text())
    assert program.diffab_config(conf) == cfg
    # the block kind defaults to the bare network
    assert C.ModelConfig().ipa_block == "ipa"
    with pytest.raises(ValueError, match="ipa_block"):
        C.ModelConfig(ipa_block="gab")
    # the bare network's parameters are unchanged
    names = {n for n, _ in DiffAbModel(C.ModelConfig(**TINY), device="cpu").named_parameters()}
    assert not any("layer_norm" in n or "transition" in n for n in names)


def test_the_quaternion_head_is_the_official_one():
    v = torch.randn(50, 3, dtype=torch.float64)
    r = so3.quaternion_1ijk_to_rotation_matrix(v)
    assert torch.allclose(r, ref_ga.quaternion_1ijk(v), atol=1e-12)
    assert torch.allclose(r @ r.transpose(-1, -2), torch.eye(3, dtype=torch.float64)[None],
                          atol=1e-12)
    assert torch.allclose(so3.quaternion_1ijk_to_rotation_matrix(torch.zeros(3)), torch.eye(3))


def test_the_cli_flag_selects_the_official_config():
    from diffab_pytorch_tpu_torch.cli import train as ttrain

    got = ttrain.build_config(ttrain.parse_args(["--data-dir", "x", "--official"]))
    assert got.model == C.official_config().model
    with pytest.raises(SystemExit):
        ttrain.build_config(ttrain.parse_args(["--data-dir", "x", "--official",
                                               "--production"]))


def test_tensor_parallelism_refuses_the_ga_block():
    from diffab_pytorch_tpu_torch.parallel import tp

    class Mesh:
        shape = {"tp": 2}
        tp_rank, tp_group = 0, None

    with pytest.raises(ValueError, match="GA block"):
        tp.head_shard(model_config(), Mesh())


@pytest.mark.parametrize("b, bp, L", [(1, 1, 24), (4, 4, 64), (100, 1, 256)])
def test_the_ga_work_counts_the_weights_the_block_adds(b, bp, L):
    """`benchmark/lib/work_ga.py` against the model's own shapes: a GA
    stack's work exceeds the bare stack's of the same widths by two
    operations a row for each weight it adds (the directions' columns of
    `to_out`, the transition's three layers), and K1's bytes by the
    directions' columns read once."""
    from benchmark.lib import work, work_ga

    def matrices(block):
        model = DiffAbModel(C.ModelConfig(**TINY, ipa_block=block), device="cpu")
        return {n: p.numel() for n, p in model.named_parameters() if p.dim() == 2}

    bare, ga = matrices("ipa"), matrices("ga")
    added = sum(n - bare.get(name, 0) for name, n in ga.items())
    c = dataclasses.asdict(C.ModelConfig(**TINY))
    assert work_ga.denoiser_flops(c, b, bp, L) - work.denoiser_flops(c, b, bp, L) == \
        2 * b * L * added
    layer = ga["denoiser.ipa.layer_0.to_out.weight"] - bare["denoiser.ipa.layer_0.to_out.weight"]
    widths = (b, bp, L, c["d_residue_emb"], c["n_head"], c["d_scalar_per_head"],
              c["n_value_point_per_head"], 4, 4)
    (f0, b0), (f1, b1) = work.ipa_layer_flops_bytes(*widths), work_ga.ga_layer_flops_bytes(*widths)
    assert (f1 - f0, b1 - b0) == (2 * b * L * layer, 4 * layer)

# ---- the benchmark's cells on the CPU ---------------------------------------------------


# a cell's run in a process of its own (this one has JAX loaded, which the
# benchmark refuses), at CPU size: the widths above, T = 10, short patches
_CELL = """
import copy, json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
over = json.loads({over!r})
def edit(conf, mix, limits):
    conf, mix = copy.deepcopy(conf), dict(mix)
    for group, values in over["conf"].items():
        conf[group].update(values)
    mix.update(over["mix"])
    return conf, mix, limits
from benchmark import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", {seed!r}, "--seconds", "0.5",
                   "--trace", "0"], device=torch.device("cpu"), edit=edit))
"""


def _run_cell(cell, seed, model=(), mix=()):
    over = dict(conf=dict(model=dict(TINY, **dict(model)),
                          diffusion=dict(T=10, igso3_n_bins=512, igso3_n_terms=256),
                          data=dict(patch_size=64)), mix=dict(mix))
    code = _CELL.format(root=str(ROOT), over=json.dumps(over), cell=cell, seed=str(seed))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT), env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_design_cell_follows_the_port(dtype):
    """The official cell at CPU size: a float32 port reads at float32
    rounding, far under the limits; a bfloat16 port reads incorrect."""
    result = _run_cell("official-multicdr-t100-fan100-L256", 2 ** 31 + 11,
                       model=dict(compute_dtype=dtype),
                       mix=dict(n_designs=4, n_targets=2, warmup_jobs=1, reference_block=3))
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["designs_off"] == 0 and checks["jobs_unfollowed"] == 0
    if dtype == "float32":
        assert result["correct"] and result["failed"] == 0
        assert checks["seq_gap"] == 0.0 and checks["x_gap"] < 1e-4 and checks["r_gap"] < 1e-3
    else:
        assert not result["correct"]
