"""The port's training data path against the JAX package, on the CPU: the
synthetic PDB text, the C++ parser and featurizer (built by the port from
`native/*.cpp`), `cli.preprocess` in both modes, `PatchDataset` (batches,
the normalized-sample cache, the device pool and its index stream), the
pool train step, `PrefetchLoader`, and the rows `fit` consumes on both of
its paths.

Tolerances: PDB text, patches, batches and pools exactly equal (the same
numpy operations, and the same C++ sources built with the same flags);
the C++ routes against the port's Python ones as `tests/test_native.py`
holds the JAX package's: parser coordinates 1e-4, the rest equal;
featurizer 1e-5.
"""

import csv
import dataclasses
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu import config as jconfig
from diffab_pytorch_tpu.cli import preprocess as jpreprocess
from diffab_pytorch_tpu.data import dataset as jdataset
from diffab_pytorch_tpu.data import synthetic as jsynthetic
from diffab_pytorch_tpu.structure import geometry as jgeometry
from diffab_pytorch_tpu.structure import pdb as jpdb
from diffab_pytorch_tpu.structure import testing as jtesting
from diffab_pytorch_tpu.train import trainer as jtrainer
from diffab_pytorch_tpu.train.harness import DiffAb as JaxDiffAb
from diffab_pytorch_tpu.train.harness import TrainState as JaxTrainState

from diffab_pytorch_tpu_torch import config as tconfig
from diffab_pytorch_tpu_torch.cli import preprocess as tpreprocess
from diffab_pytorch_tpu_torch.data import dataset as tdataset
from diffab_pytorch_tpu_torch.data import synthetic as tsynthetic
from diffab_pytorch_tpu_torch.data.loader import PrefetchLoader
from diffab_pytorch_tpu_torch.structure import antibody as tantibody
from diffab_pytorch_tpu_torch.structure import geometry as tgeometry
from diffab_pytorch_tpu_torch.structure import native as tnative
from diffab_pytorch_tpu_torch.structure import pdb as tpdb
from diffab_pytorch_tpu_torch.structure import testing as ttesting
from diffab_pytorch_tpu_torch.structure.patch import load_patch
from diffab_pytorch_tpu_torch.train import checkpoint as ckpt
from diffab_pytorch_tpu_torch.train.harness import DiffAb
from diffab_pytorch_tpu_torch.train.trainer import fit

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HOSTILE = os.path.join(FIXTURES, "ab2_hostile.pdb")
K = 64  # patch size
# small IGSO(3) tables keep the harness set-up fast
DIFFUSION = dict(T=8, igso3_n_bins=256, igso3_n_terms=128)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one worker process per core: torch's own thread pool
    in each would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_chains(a, b, atol=0.0):
    assert set(a) == set(b)
    for ch in a:
        assert len(a[ch]) == len(b[ch]), ch
        for ra, rb in zip(a[ch], b[ch]):
            assert (ra.resseq, ra.icode, ra.resname) == (rb.resseq, rb.icode, rb.resname)
            np.testing.assert_array_equal(ra.atom_mask, rb.atom_mask)
            np.testing.assert_allclose(ra.xyz, rb.xyz, atol=atol, rtol=0)


def assert_same_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def pdb_texts():
    return {"synthetic_0": jtesting.make_synthetic_antibody_pdb(0),
            "synthetic_3_no_antigen": jtesting.make_synthetic_antibody_pdb(3, with_antigen=False),
            "hostile": open(HOSTILE).read()}


def random_structure(seed, L=60):
    """Random coordinates with some peptide bonds (a few just past the
    2.5 A cut-off) and missing atoms, three chains (tests/test_native.py)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(L, 15, 3)).astype(np.float32) * 5
    mask = rng.random((L, 15)) > 0.1
    chain = np.repeat(np.array([1, 2, 3], np.int32), [L // 3, L // 3, L - 2 * (L // 3)])
    for i in range(L - 1):
        r = rng.random()
        if r > 0.5:
            xyz[i + 1, 0] = xyz[i, 2] + rng.normal(scale=0.3, size=3)
        elif r > 0.4:
            d = rng.normal(size=3)
            xyz[i + 1, 0] = xyz[i, 2] + 2.6 * d / np.linalg.norm(d)
    return xyz, mask, chain


# ---------------------------------------------------------------------------
# PDB text


@pytest.mark.parametrize("kwargs", [dict(seed=0), dict(seed=5, with_antigen=False),
                                    dict(seed=2, heavy_len=90, light_len=60, antigen_len=20)])
def test_synthetic_pdb_text_matches_jax(kwargs):
    assert ttesting.make_synthetic_antibody_pdb(**kwargs) == \
        jtesting.make_synthetic_antibody_pdb(**kwargs)


@pytest.mark.parametrize("family,seed,kwargs", [(0, 0, {}), (3, 7, {}),
                                                (5, 1, dict(n_families=6, jitter=0.3))])
def test_family_pdb_text_matches_jax(family, seed, kwargs):
    assert tsynthetic.make_family_pdb(family, seed, **kwargs) == \
        jsynthetic.make_family_pdb(family, seed, **kwargs)
    assert tsynthetic.family_h3_motif(family) == jsynthetic.family_h3_motif(family)


def test_family_corpus_files_match_jax(tmp_path):
    tmeta = tsynthetic.write_family_corpus(str(tmp_path / "t"), n_families=2, n_per_family=2,
                                           seed=1)
    jmeta = jsynthetic.write_family_corpus(str(tmp_path / "j"), n_families=2, n_per_family=2,
                                           seed=1)
    assert open(tmeta).read() == open(jmeta).read()
    names = sorted(os.listdir(tmp_path / "j" / "pdb"))
    assert names == sorted(os.listdir(tmp_path / "t" / "pdb")) and len(names) == 4
    for n in names:
        assert (tmp_path / "t" / "pdb" / n).read_text() == (tmp_path / "j" / "pdb" / n).read_text()


# ---------------------------------------------------------------------------
# the C++ parser and featurizer


@pytest.mark.parametrize("name", ["synthetic_0", "synthetic_3_no_antigen", "hostile"])
def test_native_parser_matches_python_and_jax(name):
    text = pdb_texts()[name]
    native = tpdb.parse_pdb(text)  # the default route: C++
    assert_same_chains(native, tpdb.parse_pdb(text, prefer_native=False), atol=1e-4)
    assert_same_chains(native, jpdb.parse_pdb(text))


def test_native_parser_edge_cases():
    """Altloc B skipped, MSE -> MET with SE -> SD, unknown residue -> UNK
    backbone, ENDMDL stops, junk lines ignored, a residue without CA
    dropped (the lines of tests/test_native.py)."""
    text = "\n".join([
        "REMARK junk",
        "ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N",
        "ATOM      2  CA  ALA A   1      12.000   6.000  -6.000  1.00  0.00           C",
        "ATOM      3  CA BALA A   1      99.000  99.000  99.000  1.00  0.00           C",
        "ATOM      4  C   ALA A   1      13.000   6.500  -5.500  1.00  0.00           C",
        "HETATM    5  N   MSE A   2      14.000   7.000  -5.000  1.00  0.00           N",
        "HETATM    6  CA  MSE A   2      15.000   7.500  -4.500  1.00  0.00           C",
        "HETATM    7 SE   MSE A   2      16.000   8.000  -4.000  1.00  0.00          SE",
        "ATOM      8  N   XYZ A   3      17.000   8.500  -3.500  1.00  0.00           N",
        "ATOM      9  CA  XYZ A   3      18.000   9.000  -3.000  1.00  0.00           C",
        "ATOM     10  N   GLY A   4      19.000   9.500  -2.500  1.00  0.00           N",
        "ENDMDL",
        "ATOM     11  CA  TRP B   9      20.000  10.000  -2.000  1.00  0.00           C",
        "END",
    ]) + "\n"
    native = tnative.parse_pdb_native(text)
    assert_same_chains(native, tpdb.parse_pdb(text, prefer_native=False), atol=1e-4)
    assert [r.resname for r in native["A"]] == ["ALA", "MET", "UNK"] and "B" not in native
    assert native["A"][0].xyz[1, 0] == pytest.approx(12.0) and native["A"][1].atom_mask[6]


def _complex_geometry(name):
    if name == "hostile":
        c = tantibody.from_pdb(HOSTILE, "H", "L", ["a", "B"], keep_fv_only=False)
        return c.xyz, c.atom_mask, c.chain_idx
    if name == "synthetic":
        c = tantibody.from_chains(tpdb.parse_pdb(jtesting.make_synthetic_antibody_pdb(1)),
                                  "H", "L", ["A"])
        return c.xyz, c.atom_mask, c.chain_idx
    return random_structure(int(name[-1]))


@pytest.mark.parametrize("name", ["hostile", "synthetic", "random_0", "random_1"])
def test_native_featurizer_matches_numpy_and_jax(name):
    xyz, mask, chain = _complex_geometry(name)
    native = tgeometry.backbone_geometry(xyz, mask, chain)  # the default route: C++
    numpy_ = tgeometry.backbone_geometry(xyz, mask, chain, prefer_native=False)
    for a, b, what in zip(native, numpy_, ("orientations", "dihedrals", "mask")):
        assert a.dtype == b.dtype, what
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=what)
    np.testing.assert_array_equal(native[2], numpy_[2])
    for a, b in zip(native, jgeometry.backbone_geometry(xyz, mask, chain)):
        np.testing.assert_array_equal(a, b)


def test_native_library_is_built_from_the_sources(tmp_path, monkeypatch):
    """The library is built under build/native/ from native/*.cpp, keyed by
    their hash; a build that fails raises with the compiler's output."""
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path.name.startswith("libdiffab_native_") and path == tnative.library_path()
    assert tnative.load().diffab_native_abi_version() == tnative.ABI_VERSION
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCES", (bad,))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*broken.cpp"):
        tnative.build()


# ---------------------------------------------------------------------------
# cli.preprocess


def test_preprocess_workers_import_no_torch():
    """The preprocessing CLI, which each spawned worker imports, stays on
    the numpy structure layer: the package's names load on first use."""
    code = ("import sys, diffab_pytorch_tpu_torch.cli.preprocess; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, timeout=120,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0


def test_preprocess_single_matches_jax(tmp_path):
    pdb_path = tmp_path / "syn.pdb"
    pdb_path.write_text(jtesting.make_synthetic_antibody_pdb(4))
    args = ["-i", str(pdb_path), "--heavy-chain-id", "H", "--light-chain-id", "L", "-a", "A",
            "-k", str(K)]
    assert tpreprocess.main(args + ["-o", str(tmp_path / "t.npz")]) == 0
    assert jpreprocess.main(args + ["-o", str(tmp_path / "j.npz")]) == 0
    assert_same_dicts(load_patch(str(tmp_path / "t.npz")), load_patch(str(tmp_path / "j.npz")))


def test_preprocess_bulk_matches_jax(tmp_path):
    """Bulk mode over a meta.csv written with the csv module: a good row, a
    two-chain antigen written 'a | B', a 'nan' light chain, a file that is
    not a PDB and a missing file; the last two are skipped."""
    pdb_dir, out_dir = tmp_path / "pdb", tmp_path / "out"
    pdb_dir.mkdir()
    (pdb_dir / "good.pdb").write_text(jtesting.make_synthetic_antibody_pdb(7))
    (pdb_dir / "heavy.pdb").write_text(jtesting.make_synthetic_antibody_pdb(8))
    (pdb_dir / "hostile.pdb").write_text(open(HOSTILE).read())
    (pdb_dir / "bad.pdb").write_text("not a pdb at all\n")
    meta = tmp_path / "meta.csv"
    with open(meta, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["pdb_id", "Hchain", "Lchain", "antigen_chain"])
        w.writerows([["good", "H", "L", "A"], ["hostile", "H", "L", "a | B"],
                     ["heavy", "H", "nan", "A"], ["bad", "H", "L", ""],
                     ["missing", "H", "L", "A"]])
    rc = tpreprocess.main(["--meta", str(meta), "--data-dir", str(pdb_dir),
                           "--out-dir", str(out_dir), "-j", "2", "-k", str(K)])
    assert rc == 0
    want = {"good_H_L_A.npz": ("good", "H", "L", "A"),
            "hostile_H_L_aB.npz": ("hostile", "H", "L", "aB"),
            "heavy_H_na_A.npz": ("heavy", "H", None, "A")}
    assert sorted(os.listdir(out_dir)) == sorted(want)
    for name, (pdb_id, h, l, ag) in want.items():
        ref = str(tmp_path / f"jax_{name}")
        jpreprocess.process_one(str(pdb_dir / f"{pdb_id}.pdb"), ref, h, l, ag, K)
        assert_same_dicts(load_patch(str(out_dir / name)), load_patch(ref))


# ---------------------------------------------------------------------------
# PatchDataset


@pytest.fixture(scope="module")
def patch_dir(tmp_path_factory):
    """Six 64-residue patches of synthetic complexes; the last one's heavy
    chain stops before H3, so its H3 generation mask is empty."""
    root = tmp_path_factory.mktemp("torch_data")
    for i in range(6):
        kw = dict(heavy_len=90) if i == 5 else {}
        p = root / f"syn{i}.pdb"
        p.write_text(jtesting.make_synthetic_antibody_pdb(seed=10 + i, **kw))
        tpreprocess.process_one(str(p), str(root / f"syn{i}.npz"), "H", "L", "A", K)
    return str(root)


def assert_same_batch(tb, jb):
    for f in dataclasses.fields(tb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = a.numpy(), np.asarray(b)
        if b.dtype.kind == "f":
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f.name)


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_batches_match_jax(patch_dir, cache, normalize):
    """The same order (np.random.default_rng(seed) shuffles), the same
    skipped sample, the same drop_last, equal arrays; twice over with the
    cache (the second pass reads it)."""
    tds = tdataset.PatchDataset.from_dir(patch_dir, cache=cache)
    jds = jdataset.PatchDataset.from_dir(patch_dir, cache=cache)
    assert tds.paths == jds.paths and len(tds) == 6
    drop_last = cache  # both behaviours of the ragged last batch
    kw = dict(shuffle=True, seed=3, epochs=2, drop_last=drop_last, normalize=normalize)
    for _ in range(2 if cache else 1):
        tb = list(tds.batches(2, **kw))
        jb = list(jds.batches(2, **kw))
        assert len(tb) == len(jb) == (4 if drop_last else 6)
        for (t, tinfo), (j, jinfo) in zip(tb, jb):
            assert t.xyz.device.type == "cpu"
            assert_same_batch(t, j)
            np.testing.assert_array_equal(tinfo.center, jinfo.center)
            assert tinfo.scale == jinfo.scale
            want_rot = jinfo.rot if normalize else np.broadcast_to(np.eye(3), tinfo.rot.shape)
            np.testing.assert_array_equal(tinfo.rot, want_rot)
    assert len(tds._norm_cache) == (6 if cache and normalize else 0)


@pytest.mark.parametrize("normalize", [True, False])
def test_device_pool_and_epoch_indices_match_jax(patch_dir, normalize):
    tds = tdataset.PatchDataset.from_dir(patch_dir)
    jds = jdataset.PatchDataset.from_dir(patch_dir)
    (tp, tinfo), (jp, jinfo) = tds.device_pool(normalize), jds.device_pool(normalize)
    assert tp.batch_size == jp.batch_size == 5  # the sample without H3 is dropped
    assert_same_batch(tp, jp)
    np.testing.assert_array_equal(tinfo.center, jinfo.center)
    for kw in (dict(shuffle=True, seed=4), dict(shuffle=True, seed=4, drop_last=False),
               dict(shuffle=False)):
        ti, ji = tds.epoch_indices(2, n_rows=5, **kw), jds.epoch_indices(2, n_rows=5, **kw)
        for _ in range(7):
            a, b = next(ti), next(ji)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def _harness(**train):
    cfg = tconfig.tiny_config()
    return DiffAb(dataclasses.replace(
        cfg, diffusion=tconfig.DiffusionConfig(**DIFFUSION),
        train=dataclasses.replace(cfg.train, **train)), device="cpu")


def test_pool_train_step_is_the_train_step_on_its_rows(patch_dir):
    """Bit for bit on the CPU: the gathered rows are the batch, and the
    same draws give the same update."""
    harness = _harness(lr=1e-3, ema_decay=0.9, mode_dropout=0.15)
    pool, _ = tdataset.PatchDataset.from_dir(patch_dir).device_pool()
    idx = torch.tensor([3, 0, 4])
    rows = pool.gather_rows(idx)
    for f in dataclasses.fields(rows):
        v = getattr(rows, f.name)
        if v is not None:
            assert torch.equal(v, getattr(pool, f.name)[idx]), f.name
    draws = harness.draw(rows, torch.Generator().manual_seed(5))
    a, ma = harness.pool_train_step(harness.init(0), pool, idx, draws)
    b, mb = harness.train_step(harness.init(0), rows, draws)
    assert a.step == b.step == 1 and all(torch.equal(ma[k], mb[k]) for k in ma)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]) and torch.equal(a.ema_params[k],
                                                                      b.ema_params[k])


# ---------------------------------------------------------------------------
# PrefetchLoader


def test_prefetch_loader_yields_the_host_batches(patch_dir):
    ds = tdataset.PatchDataset.from_dir(patch_dir)
    plain = list(ds.batches(2, seed=1, epochs=2))
    loader = PrefetchLoader(ds.batches(2, seed=1, epochs=2), "cpu", prefetch=2)
    got = list(loader)
    assert len(got) == len(plain) == 4 and len(loader.batch_seconds) == 4
    for (a, ai), (b, bi) in zip(got, plain):
        assert_same_batch(a, b)
        np.testing.assert_array_equal(ai.center, bi.center)
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()
    with pytest.raises(NotImplementedError, match="A14"):
        PrefetchLoader(iter(()), "cpu", sharding=object())


def test_prefetch_loader_raises_the_worker_error_and_closes():
    def failing():
        yield "first"
        raise ValueError("bad patch")

    class Item:
        def __init__(self, v):
            self.v = v

        def to(self, device):
            return self

    loader = PrefetchLoader((Item(v) for v in failing()), "cpu")
    assert next(loader)[0].v == "first"
    with pytest.raises(ValueError, match="bad patch"):
        next(loader)
    loader.close()
    # close() drains a full queue and stops a worker blocked on it
    endless = PrefetchLoader((Item(i) for i in iter(int, 1)), "cpu", prefetch=1)
    next(endless)
    endless.close(timeout=10)
    assert not endless._thread.is_alive()
    assert threading.active_count() < 50


def test_prefetch_loader_keeps_order_under_a_short_switch_interval():
    """Many small items through a one-slot queue with the interpreter
    switching threads as often as it can: every item arrives once, in
    order, and a loader closed mid-stream stops its worker."""
    class Item:
        def __init__(self, v):
            self.v = v

        def to(self, device):
            return self

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [b.v for b, _ in PrefetchLoader((Item(i) for i in range(500)), "cpu", prefetch=1)]
        assert got == list(range(500))
        loader = PrefetchLoader((Item(i) for i in range(10**6)), "cpu", prefetch=1)
        assert [next(loader)[0].v for _ in range(5)] == list(range(5))
        loader.close(timeout=10)
        assert not loader._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)


# ---------------------------------------------------------------------------
# fit over a PatchDataset: the rows it consumes, against the JAX fit


def jax_rows(patch_dir, monkeypatch, device_pool, epochs=2):
    """The rows the JAX fit consumes, step by step, with a recording step
    (no model runs): normalized xyz per step for the loader path, the
    (b,) row indices for the pool path."""
    jcfg = dataclasses.replace(jconfig.tiny_config(),
                               diffusion=jconfig.DiffusionConfig(**DIFFUSION))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, batch_size=2))
    harness = JaxDiffAb(jcfg)
    rows = []

    def step(state, *args):
        rows.append(np.asarray(args[-2] if device_pool else args[0].xyz))
        return state.replace(step=state.step + 1), {"train/loss": jnp.float32(0.0)}

    monkeypatch.setattr(harness, "init", lambda key, batch: JaxTrainState(
        step=jnp.int32(0), params={}, opt_state=()))
    if device_pool:
        monkeypatch.setattr(harness, "make_pool_train_step", lambda: step)
    jtrainer.fit(harness, jdataset.PatchDataset.from_dir(patch_dir, cache=True), epochs=epochs,
                 seed=42, train_step=None if device_pool else step, device_pool=device_pool)
    return rows


@pytest.mark.parametrize("device_pool", [False, True])
def test_fit_consumes_the_jax_rows_checkpoints_and_resumes(patch_dir, tmp_path, monkeypatch,
                                                           device_pool, capsys):
    want = jax_rows(patch_dir, monkeypatch, device_pool)
    assert len(want) == 4  # 2 epochs of 5 usable samples at batch 2
    harness = _harness(batch_size=2, lr=1e-3, ema_decay=0.9, log_every=1, checkpoint_every=2)
    rows = []
    if device_pool:
        real = harness.pool_train_step

        def recording(state, pool, idx, draws):
            rows.append(idx.numpy().copy())
            return real(state, pool, idx, draws)
        monkeypatch.setattr(harness, "pool_train_step", recording)
        step = None
    else:
        def step(state, batch, draws):
            rows.append(batch.xyz.numpy().copy())
            return harness.train_step(state, batch, draws)
    ds = tdataset.PatchDataset.from_dir(patch_dir, cache=True)
    d = str(tmp_path / "run")
    state = fit(harness, ds, ds, epochs=2, seed=42, checkpoint_dir=d, train_step=step,
                device_pool=device_pool)
    out = capsys.readouterr().out
    assert state.step == 4 and ckpt.all_steps(d) == [2, 4]
    assert "val/loss=" in out  # every len(ds) // 2 = 3 steps, as in the JAX fit
    assert len(rows) == 4
    for a, b in zip(rows, want):
        np.testing.assert_array_equal(a, b)
    assert all(torch.isfinite(v).all() for v in state.params.values())
    # resuming: the checkpoint's state, and the row stream from its start
    # (as the JAX fit restarts it); draws by (seed, step)
    rows.clear()
    resumed = fit(harness, ds, epochs=3, max_steps=5, seed=42, checkpoint_dir=d,
                  train_step=step, device_pool=device_pool)
    assert "resumed from step 4" in capsys.readouterr().out and resumed.step == 5
    np.testing.assert_array_equal(rows[0], want[0])
    assert ckpt.latest_step(d) == 5


def test_fit_refuses_what_the_jax_fit_refuses(patch_dir):
    harness = _harness(batch_size=2)
    ds = tdataset.PatchDataset.from_dir(patch_dir)
    with pytest.raises(ValueError, match="injected train_step"):
        fit(harness, ds, device_pool=True, train_step=harness.train_step, max_steps=1)
    with pytest.raises(ValueError, match="smaller than batch_size=8"):
        fit(_harness(batch_size=8), ds, device_pool=True, max_steps=1)
