"""The port's design loop through its entry points, on the CPU: the sample
CLI (`--device cpu --rank`) on the curated fixture's patch with a tiny
checkpoint in the port's format (weights transplanted from a JAX init),
its post-processing against the JAX pieces in the JAX CLI's order, and
the evaluate CLI against the JAX evaluate CLI on one design directory.

Tolerances: the PDB bytes exactly equal; the two evaluate reports equal
in every string and count and within 1e-5 in every number (the same
float32 metrics).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.cli import evaluate as jevaluate
from diffab_pytorch_tpu.data import dataset as jdataset
from diffab_pytorch_tpu.models.diffab import DiffAbModel as JaxModel
from diffab_pytorch_tpu.structure import pdb as jpdb
from diffab_pytorch_tpu.structure import reconstruct as jreconstruct
from diffab_pytorch_tpu.structure.relax import relax_ca as jrelax

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.cli import evaluate as tevaluate
from diffab_pytorch_tpu_torch.cli import sample as tsample
from diffab_pytorch_tpu_torch.cli import train as ttrain
from diffab_pytorch_tpu_torch.constants import AA_THREE, THREE_TO_ONE
from diffab_pytorch_tpu_torch.data.dataset import assemble_batch
from diffab_pytorch_tpu_torch.geometry import so3
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
from diffab_pytorch_tpu_torch.structure import antibody
from diffab_pytorch_tpu_torch.structure.patch import featurize_patch, load_patch, save_patch
from diffab_pytorch_tpu_torch.structure.pdb import parse_pdb_file
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train.harness import DiffAb
from diffab_pytorch_tpu_torch.weights import params_from_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ab1_chothia.pdb")
N = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one worker process per core: torch's own thread pool
    in each would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The fixture's patch, a tiny checkpoint of transplanted JAX weights,
    and one `cli.sample --rank` run on it."""
    root = tmp_path_factory.mktemp("torch_cli")
    c = antibody.from_pdb(FIXTURE, "H", "L", ["A"], keep_fv_only=True)
    patch = str(root / "target.npz")
    save_patch(patch, featurize_patch(c, patch_size=128))

    jb, _ = jdataset.assemble_batch([load_patch(patch)], ["H3"])
    jcfg = jconfig.tiny_config().model
    params = jax.device_get(jax.jit(JaxModel(jcfg).init)(
        jax.random.key(0), jb, jb.seq_idx, jb.translations, jb.orientations, jnp.zeros((1,))))
    cfg = tconfig.tiny_config()
    state = DiffAb(cfg, device="cpu").init(0)
    with torch.no_grad():
        for k, v in params_from_jax(params).items():
            state.params[k].copy_(v)
    ck = str(root / "ckpt")
    ckpt.save_checkpoint(ck, state)
    ckpt.save_model_config(ck, cfg.model)

    out = root / "designs"
    rc = tsample.main(["--patch", patch, "--checkpoint-dir", ck, "-n", str(N), "--cdrs", "H3",
                       "-o", str(out), "-s", "3", "--rank", "--device", "cpu"])
    assert rc == 0
    return dict(root=root, patch=patch, ckpt=ck, out=out)


def test_sample_cli_writes_its_three_kinds_of_files(work):
    out = work["out"]
    native = load_patch(work["patch"])
    n_rows = int(native["residue_mask"].sum())
    for i in range(N):
        chains = parse_pdb_file(str(out / f"design_{i:04d}.pdb"))
        assert sum(len(r) for r in chains.values()) == n_rows
        assert {"H", "L"} <= set(chains) <= {"H", "L", "A"}
    fasta = (out / "designs.fasta").read_text().splitlines()
    scores = json.loads((out / "scores.json").read_text())
    assert sorted(scores) == [f"design_{i:04d}" for i in range(N)]
    ranks = sorted(v["rank"] for v in scores.values())
    assert ranks == list(range(N))
    n_gen = int((native["cdr_idx"] == 3).sum())
    for i in range(N):
        entry = scores[f"design_{i:04d}"]
        assert list(entry) == ["score", "seq_score", "translations_score",
                               "orientations_score", "rank"]
        assert all(np.isfinite(v) for v in entry.values())
        assert fasta[2 * i] == (f">design_{i:04d} cdrs=H3 score={entry['score']:.4f} "
                                f"rank={entry['rank']}")
        assert len(fasta[2 * i + 1]) == n_gen
    by_rank = sorted(scores.values(), key=lambda e: e["rank"])
    assert [e["score"] for e in by_rank] == sorted(e["score"] for e in by_rank)


def test_sample_cli_from_a_pdb(work, tmp_path):
    """--pdb featurizes inline; without --rank no scores.json."""
    rc = tsample.main(["--pdb", FIXTURE, "--heavy-chain-id", "H", "--light-chain-id", "L",
                       "-a", "A", "--checkpoint-dir", work["ckpt"], "-n", "1", "--n-steps", "5",
                       "-o", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "design_0000.pdb").exists()
    assert not (tmp_path / "scores.json").exists()
    assert (tmp_path / "designs.fasta").read_text().startswith(">design_0000 cdrs=H3\n")


def test_post_processing_writes_the_jax_bytes(work, tmp_path):
    """One fixed set of result arrays (3 designs: designed CAs moved by
    ~0.3 A, random frames and residue types) through `write_designs`,
    against the JAX pieces in cli/sample.py's order."""
    sample_dict = load_patch(work["patch"])
    batch, norm = assemble_batch([sample_dict], ["H3"], device="cpu")
    rng = np.random.default_rng(5)
    gen = batch.generation_mask[0].numpy()
    rep = lambda a: np.repeat(a.numpy(), N, axis=0)
    seq = np.where(gen, rng.integers(0, 21, (N, gen.size)), rep(batch.seq_idx))
    x = rep(batch.translations)
    x = np.where(gen[:, None], x + rng.normal(size=x.shape) * 0.03, x).astype(np.float32)
    rot = so3.uniform((N, gen.size), generator=torch.Generator().manual_seed(5)).numpy()
    rot = np.where(gen[:, None, None], rot, rep(batch.orientations)).astype(np.float32)

    port_dir = tmp_path / "port"
    port_dir.mkdir()
    tsample.write_designs(str(port_dir), SampleResult(*(torch.from_numpy(v) for v in
                                                        (seq, x, rot))),
                          batch, norm, sample_dict, ["H3"])

    jb, jnorm = jdataset.assemble_batch([sample_dict], ["H3"])
    jrep = lambda v: jnp.repeat(v, N, axis=0)
    relaxed = np.asarray(jrelax(jnp.asarray(x), jrep(jb.residue_mask), jrep(jb.chain_idx),
                                jrep(jb.residue_idx), jrep(jb.generation_mask),
                                coord_scale=jdataset.COORD_SCALE))
    assert not np.array_equal(relaxed, x)  # the relaxation did move designs
    xyz_ca = jdataset.NormalizationInfo(np.repeat(jnorm.center, N, 0), jnorm.scale,
                                        np.repeat(jnorm.rot, N, 0)).denormalize(relaxed)
    ori = jdataset.NormalizationInfo(np.repeat(jnorm.center, N, 0), jnorm.scale,
                                     np.repeat(jnorm.rot, N, 0)).denormalize_orientations(rot)
    mask = sample_dict["residue_mask"].astype(bool)
    letters = ["?", "H", "L"] + [chr(ord("A") + i) for i in range(7)]
    for i in range(N):
        xyz, am = jreconstruct.reconstruct_backbone(ori[i], xyz_ca[i])
        xyz = np.where(gen[:, None, None], xyz, sample_dict["xyz"].astype(np.float32))
        am = np.where(gen[:, None], am, sample_dict["atom_mask"].astype(bool))
        xyz = jreconstruct.idealize_peptide_bonds(xyz, am, sample_dict["chain_idx"],
                                                  sample_dict["residue_idx"], edge_mask=gen)
        jpdb.write_pdb(str(tmp_path / "jax.pdb"), xyz[mask], am[mask], seq[i][mask],
                       [letters[c] for c in sample_dict["chain_idx"][mask]],
                       sample_dict["residue_number"][mask],
                       icodes=sample_dict["icode"][mask])
        assert (port_dir / f"design_{i:04d}.pdb").read_bytes() == \
            (tmp_path / "jax.pdb").read_bytes(), i
    fasta = (port_dir / "designs.fasta").read_text().splitlines()
    assert fasta[0] == ">design_0000 cdrs=H3"
    assert fasta[1] == "".join(THREE_TO_ONE[AA_THREE[s]] if s < 20 else "X"
                               for s in seq[0][gen])


def _close_reports(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _close_reports(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close_reports(x, y)
    elif isinstance(a, (bool, str)) or a is None:
        assert a == b
    else:
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_evaluate_cli_matches_jax(work, capsys):
    root = work["root"]
    args = ["--native-patch", work["patch"], "--designs", str(work["out"]), "--cdrs", "H3"]
    capsys.readouterr()
    assert tevaluate.main(args + ["--json", str(root / "report.json"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jevaluate.main(args + ["--json", str(root / "report.json")]) == 0
    jax_out = capsys.readouterr().out
    jax_report = json.loads((root / "report.json").read_text())
    assert tevaluate.main(args + ["--json", str(root / "report.json"), "--device", "cpu"]) == 0
    port_report = json.loads((root / "report.json").read_text())
    assert port_out == jax_out
    assert list(port_report) == ["designs", "aggregate"]
    assert port_report["aggregate"]["n_designs"] == N
    assert "rank_spearman" in port_report["aggregate"]
    assert all("model_score" in d for d in port_report["designs"])
    _close_reports(port_report, jax_report)


def test_evaluate_cli_rejects_a_mismatched_design(work, tmp_path):
    bad = tmp_path / "design_0000.pdb"
    bad.write_text("\n".join((work["out"] / "design_0000.pdb").read_text().splitlines()[40:]))
    with pytest.raises(ValueError, match="residues"):
        tevaluate.main(["--native-patch", work["patch"], "--designs", str(tmp_path),
                        "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--data-parallel", "--multihost"])
def test_unported_flags_raise(work, flag):
    with pytest.raises(NotImplementedError, match="A14"):
        tsample.main(["--patch", work["patch"], "--checkpoint-dir", work["ckpt"], flag,
                      "--device", "cpu"])


def test_sample_cli_reads_a_self_conditioned_checkpoint(work, tmp_path, monkeypatch, capsys):
    """`cli.train --self-conditioning --sc-split-trunk` writes a checkpoint
    (two steps on copies of the fixture's patch); `cli.sample --device cpu`
    rebuilds the recorded split-trunk model from it and its designs are
    the harness's with the same weights, options and seed."""
    data, ck = tmp_path / "patches", str(tmp_path / "sc")
    data.mkdir()
    for i in range(2):
        shutil.copy(work["patch"], data / f"p{i}.npz")
    assert ttrain.main(["--data-dir", str(data), "--tiny", "--device", "cpu", "--max-steps",
                        "2", "-b", "2", "--val-pct", "0", "--checkpoint-dir", ck,
                        "--self-conditioning", "--sc-split-trunk"]) == 0
    saved = ckpt.load_model_config(ck)
    assert saved.self_conditioning and saved.sc_split_trunk
    written = []
    real = tsample.write_designs
    monkeypatch.setattr(tsample, "write_designs",
                        lambda out, result, *a, **kw: (written.append(result),
                                                       real(out, result, *a, **kw)))
    capsys.readouterr()
    assert tsample.main(["--patch", work["patch"], "--checkpoint-dir", ck, "-n", "2", "-o",
                         str(tmp_path / "d"), "-s", "3", "--device", "cpu"]) == 0
    assert "recorded model config (self-conditioning)" in capsys.readouterr().out

    cfg = dataclasses.replace(tconfig.tiny_config(), model=saved)
    harness = DiffAb(cfg, device="cpu")
    batch, _ = assemble_batch([load_patch(work["patch"])], cdrs_to_generate=["H3"],
                              device="cpu")
    params, step = ckpt.restore_params(ck)
    assert step == 2
    want = harness.sample(params, batch, generator=torch.Generator().manual_seed(3),
                          n_designs=2, noise_t_max=cfg.diffusion.T // 2)
    (got,) = written
    assert torch.equal(got.seq_idx, want.seq_idx)
    assert torch.equal(got.translations, want.translations)
    assert torch.equal(got.orientations, want.orientations)


def test_clis_need_the_card_unless_told(work, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsample.main(["--patch", work["patch"], "--checkpoint-dir", work["ckpt"],
                      "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(["--native-patch", work["patch"], "--designs", str(work["out"])])
