"""scripts/jax_checkpoint_to_torch.py: a run trained by the JAX package's
`cli.train` (an orbax checkpoint with EMA weights) converted into the
port's format, on the CPU.

The converted step, parameters, Adam count and moments and EMA are the
JAX restore passed through `params_from_jax` bit for bit; the port's
`restore_params` picks the EMA weights exactly when JAX's does (a run
with EMA, and one saved without); the port's `cli.sample --device cpu`
samples from the converted directory; a flag that disagrees with the
recorded architecture, a recorded field the port does not have set to
other than its default, and flags that build another optimizer chain are
refused with the field named.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil

import jax
import pytest
import torch

from diffab_pytorch_tpu.cli import train as jtrain
from diffab_pytorch_tpu.data.batch import synthetic_batch as jsynthetic_batch
from diffab_pytorch_tpu.structure import antibody, featurize_patch, parse_pdb, save_patch
from diffab_pytorch_tpu.structure.testing import make_synthetic_antibody_pdb
from diffab_pytorch_tpu.train import checkpoint as jckpt
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb

from diffab_pytorch_tpu_torch.cli import sample as tsample
from diffab_pytorch_tpu_torch.train import checkpoint as tckpt
from diffab_pytorch_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch", os.path.join(REPO, "scripts", "jax_checkpoint_to_torch.py"))
convert = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert)

# the run's cli.train flags: an optimizer chain with a clip, a schedule and EMA
FLAGS = ["--tiny", "-b", "2", "-l", "1e-2", "--grad-clip", "1.0", "--lr-warmup-steps", "1",
         "--lr-decay-steps", "6", "--ema", "0.9", "--val-pct", "0"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Three steps of JAX cli.train on four 48-residue patches."""
    root = tmp_path_factory.mktemp("jax_run")
    patches = root / "patches"
    patches.mkdir()
    for i in range(4):
        c = antibody.from_chains(parse_pdb(make_synthetic_antibody_pdb(seed=i)), "H", "L",
                                 ["A"], keep_fv_only=True)
        save_patch(str(patches / f"s{i}.npz"), featurize_patch(c, patch_size=48))
    ck = str(root / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jtrain.main(["--data-dir", str(patches), "--max-steps", "3", "--checkpoint-dir",
                            ck, *FLAGS]) == 0
    out = str(root / "port")
    assert convert.main(["--jax-dir", ck, "--out", out, *FLAGS]) == 0
    return dict(root=root, patches=patches, ck=ck, out=out)


def jax_template(flags):
    cfg = jtrain.build_config(jtrain.parse_args(["--data-dir", "-", *flags]))
    return JaxDiffAb(cfg).init(jax.random.key(1), jsynthetic_batch(jax.random.key(1), 1, 16))


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32 and torch.equal(got[k], v), k


def test_converted_state_is_the_jax_restore(run):
    want = jax.device_get(jckpt.restore_checkpoint(run["ck"], jax_template(FLAGS)))
    got = tckpt.restore_checkpoint(run["out"], "cpu")
    assert got.step == int(want.step) == 3
    assert_bitwise({k: v.detach() for k, v in got.params.items()}, params_from_jax(want.params))
    adam = [s for s in want.opt_state if hasattr(s, "mu")][0]
    assert got.opt_state.count == int(adam.count) == 3
    assert_bitwise(got.opt_state.mu, params_from_jax(adam.mu))
    assert_bitwise(got.opt_state.nu, params_from_jax(adam.nu))
    assert_bitwise(got.ema_params, params_from_jax(want.ema_params))
    # the EMA is not the raw parameters: restore_params must choose
    assert not all(torch.equal(got.ema_params[k], got.params[k]) for k in got.params)
    assert tckpt.load_model_config(run["out"]) == tckpt.ModelConfig(**{
        k: v for k, v in json.load(open(os.path.join(run["ck"], "model_config.json"))).items()
        if k in {f for f in tckpt.ModelConfig.__dataclass_fields__}})


def test_restore_params_picks_the_ema_when_jax_does(run, tmp_path):
    template = jax_template(FLAGS).params
    want, step = jckpt.restore_params(run["ck"], template)
    got, got_step = tckpt.restore_params(run["out"])
    assert got_step == step == 3
    assert jckpt._checkpoint_has_ema(run["ck"], 3)
    assert_bitwise(got, params_from_jax(jax.device_get(want)))
    # a run saved without EMA: both restore the raw parameters
    flags = [f if f != "0.9" else "0" for f in FLAGS]
    state = jax_template(flags)
    assert state.ema_params is None
    ck, out = str(tmp_path / "ck"), str(tmp_path / "port")
    jckpt.save_checkpoint(ck, state)
    jckpt.save_model_config(ck, jtrain.build_config(jtrain.parse_args(
        ["--data-dir", "-", *flags])).model)
    assert convert.main(["--jax-dir", ck, "--out", out, *flags]) == 0
    assert not jckpt._checkpoint_has_ema(ck, 0)
    assert tckpt.restore_checkpoint(out, "cpu").ema_params is None
    want, _ = jckpt.restore_params(ck, state.params)
    got, _ = tckpt.restore_params(out)
    assert_bitwise(got, params_from_jax(jax.device_get(want)))


def test_port_cli_sample_reads_the_converted_run(run):
    designs = run["root"] / "designs"
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = tsample.main(["--patch", str(run["patches"] / "s0.npz"), "--checkpoint-dir",
                           run["out"], "-n", "2", "-o", str(designs), "--device", "cpu"])
    assert rc == 0
    assert "restored checkpoint at step 3" in log.getvalue()
    assert sorted(os.listdir(designs)) == ["design_0000.pdb", "design_0001.pdb", "designs.fasta"]


def test_refusals_name_the_field(run, tmp_path, capsys):
    out = str(tmp_path / "x")
    assert convert.main(["--jax-dir", run["ck"], "--out", out, *FLAGS, "--d-pair", "24"]) == 1
    assert "d_pair_emb: flags give 24, the run recorded 16" in capsys.readouterr().err
    # a recorded field the port's ModelConfig does not have, set
    ck = str(tmp_path / "ck")
    shutil.copytree(run["ck"], ck)
    path = os.path.join(ck, "model_config.json")
    cfg = json.load(open(path))
    cfg["remat_ipa"] = True
    json.dump(cfg, open(path, "w"))
    assert convert.main(["--jax-dir", ck, "--out", out, *FLAGS]) == 1
    assert "ModelConfig.remat_ipa = True (default False)" in capsys.readouterr().err
    # flags that build another optimizer chain (no global-norm clip)
    flags = FLAGS[:4] + FLAGS[6:]
    assert convert.main(["--jax-dir", run["ck"], "--out", out, *flags]) == 1
    assert "does not fit the TrainState the flags build" in capsys.readouterr().err
    assert not os.path.exists(out)
