"""The port's training CLI against the JAX package's, on the CPU: the
configuration its flags resolve to (field by field, the self-conditioning
flags too), the flags that are not ported yet, the card by default, and
the whole path a user runs: `cli.preprocess` -> `cli.train --device cpu`
-> `cli.sample --device cpu` from that checkpoint.
"""

import dataclasses
import os

import pytest
import torch

from diffab_pytorch_tpu.cli import train as jtrain
from diffab_pytorch_tpu.structure.testing import make_synthetic_antibody_pdb

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.cli import preprocess as tpreprocess
from diffab_pytorch_tpu_torch.cli import sample as tsample
from diffab_pytorch_tpu_torch.cli import train as ttrain
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one worker process per core: torch's own thread pool
    in each would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg):
    """The port's DiffAbConfig with every field it shares with `jcfg`."""
    def sub(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return tconfig.DiffAbConfig(model=sub(tconfig.ModelConfig, jcfg.model),
                                diffusion=sub(tconfig.DiffusionConfig, jcfg.diffusion),
                                data=sub(tconfig.DataConfig, jcfg.data),
                                train=sub(tconfig.TrainConfig, jcfg.train))


FLAG_SETS = [
    [],
    ["--production"],
    ["--production", "-b", "8", "-l", "3e-4", "--grad-clip", "0.5", "--mode-dropout", "0.1"],
    ["--production", "--dist-atoms", "0", "--d-pair", "32", "--lr-warmup-steps", "5",
     "--lr-decay-steps", "50", "--ema", "0"],
    ["--tiny", "--bf16", "--dist-atoms", "4", "--seq-ce-weight", "0.5", "--adam-eps", "1e-5",
     "--update-clip-rms", "0", "-e", "3", "-s", "7", "--val-pct", "0.2"],
    ["--tiny", "--production", "--checkpoint-dir", "elsewhere"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or "defaults")
@pytest.mark.parametrize("horizon", [0, 120])
def test_build_config_matches_jax(flags, horizon):
    argv = ["--data-dir", "x", *flags]
    want = port_config(jtrain.build_config(jtrain.parse_args(argv), horizon=horizon))
    got = ttrain.build_config(ttrain.parse_args(argv), horizon=horizon)
    for part in ("model", "diffusion", "data", "train"):
        assert getattr(got, part) == getattr(want, part), part


SC_FLAGS = [["--self-conditioning"], ["--sc-geometry-only"], ["--sc-late-fusion"],
            ["--sc-split-trunk"], ["--sc-rate", "0.3"], ["--sc-onset", "10"],
            ["--sc-rate-warmup", "5"], ["--sc-seq-loss-weight", "0.5"], ["--sc-per-residue"]]


@pytest.mark.parametrize("flag", SC_FLAGS, ids=lambda f: " ".join(f))
def test_sc_flags_build_the_jax_config(flag):
    """Each self-conditioning flag alone (the model flags then change
    nothing, as in JAX), with --self-conditioning, and under --production."""
    for extra in ([], ["--self-conditioning"], ["--production", "--self-conditioning"]):
        argv = ["--data-dir", "x", *extra, *flag]
        want = port_config(jtrain.build_config(jtrain.parse_args(argv), horizon=50))
        got = ttrain.build_config(ttrain.parse_args(argv), horizon=50)
        assert got == want, argv


@pytest.mark.parametrize("flag", [["--data-parallel"], ["--multihost"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="A14"):
        ttrain.main(["--data-dir", str(tmp_path), "--device", "cpu", *flag])


def test_train_needs_the_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--data-dir", str(tmp_path)])


@pytest.mark.parametrize("device_pool", [False, True])
def test_preprocess_train_sample(tmp_path, device_pool, capsys):
    """PDBs -> patches (bulk, 2 workers) -> 3 training steps of the tiny
    model -> designs from the checkpoint, all on the CPU."""
    pdb_dir = tmp_path / "pdb"
    pdb_dir.mkdir()
    rows = ["pdb_id,Hchain,Lchain,antigen_chain"]
    for i in range(5):
        (pdb_dir / f"c{i}.pdb").write_text(make_synthetic_antibody_pdb(seed=20 + i))
        rows.append(f"c{i},H,L,A")
    (tmp_path / "meta.csv").write_text("\n".join(rows) + "\n")
    patches, ck = tmp_path / "patches", tmp_path / "ck"
    assert tpreprocess.main(["--meta", str(tmp_path / "meta.csv"), "--data-dir", str(pdb_dir),
                             "--out-dir", str(patches), "-j", "2", "-k", "48"]) == 0
    assert len(os.listdir(patches)) == 5
    argv = ["--data-dir", str(patches), "--tiny", "--device", "cpu", "--max-steps", "3", "-b",
            "2", "--val-pct", "0.2", "--checkpoint-dir", str(ck), "--csv",
            str(tmp_path / "m.csv")]
    assert ttrain.main(argv + (["--device-pool"] if device_pool else [])) == 0
    out = capsys.readouterr().out
    assert "4 training and 1 validation patches" in out
    assert ckpt.all_steps(str(ck)) == [3]
    assert ckpt.load_model_config(str(ck)) == tconfig.tiny_config().model
    state = ckpt.restore_checkpoint(str(ck), device="cpu")
    assert state.step == 3 and all(torch.isfinite(v).all() for v in state.params.values())
    assert (tmp_path / "m.csv").exists()  # val/ rows at the epoch end (step 2)

    designs = tmp_path / "designs"
    patch = str(patches / sorted(os.listdir(patches))[0])
    assert tsample.main(["--patch", patch, "--checkpoint-dir", str(ck), "-n", "2", "-o",
                         str(designs), "--device", "cpu"]) == 0
    assert "restored checkpoint at step 3" in capsys.readouterr().out
    assert sorted(os.listdir(designs)) == ["design_0000.pdb", "design_0001.pdb",
                                           "designs.fasta"]
