"""The port's compositional and meta-shaped corpora against the JAX
package's, on the CPU: every file they write (each PDB, meta.csv, the
JSON manifests) byte for byte, and the returned manifests equal.

The meta-shaped corpus reads its meta.csv with the `csv` module where JAX
uses pandas; the meta.csv files the tests write hold what pandas reads in
its own ways: a multi-Fv file (duplicated pdb_id rows), a multi-chain
antigen ('a | b'), 'nan' and empty heavy and light fields, chain ids that
look numeric (in a column of letters, and in an all-numeric column with a
missing value, which pandas reads as floats), a quoted field, a blank
line and columns the corpus does not read.  The reference SAbDab meta.csv
is used too where it is present, as tests/test_meta_corpus.py does.
"""

import os

import numpy as np
import pytest

from diffab_pytorch_tpu.data import synthetic as jsynthetic
from diffab_pytorch_tpu_torch.data import synthetic as tsynthetic
from test_meta_corpus import META as REFERENCE_META  # the reference SAbDab meta.csv

META_MIXED = """pdb_id,Hchain,Lchain,model,antigen_chain,antigen_type,resolution
7abc,H,L,0,A | B,protein | protein,2.1
7abc,I,M,0,A,protein,2.1
7abc,J,N,0,C | D | E,protein,2.1
1xyz,H,,0,,,3.0
2nan,nan,L,0,C,protein,2.5
3num,1,2,0,9,protein,1.9
4one,H,L,0,A,protein,2.0

5two,B,C,0,"D | E",protein,2.2
6six,H,nan,0,G,peptide,2.8
8eit,H,L,0,A,protein,NA
9nin,K,L,0,A | B,protein,2.4
"""

# every Hchain / Lchain numeric or missing: pandas reads those columns as float64
META_NUMERIC = """pdb_id,Hchain,Lchain,antigen_chain
5aaa,1,2,3
5aab,1,,4
5aac,,2,4
5aad,7,8,
"""


def tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def assert_same_files(a, b):
    fa, fb = tree_bytes(a), tree_bytes(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    return fa


@pytest.mark.parametrize("options", [
    dict(),
    dict(seq_degeneracy=3),
    dict(cdr_loops=("H1", "H2", "H3"), seq_degeneracy=2),
    dict(decouple_shape=True, seed=3),
    dict(cdr_loops=("H1", "H3"), decouple_shape=True, jitter=0.2, bump_step=0.9),
], ids=["plain", "degenerate", "multi-cdr", "decoupled", "h1h3-kwargs"])
def test_combo_corpus_is_jax_s(tmp_path, options):
    sizes = dict(n_values=3, n_train_combos=12, n_heldout_combos=3, n_per_combo=2,
                 n_val_instances=1)
    mj = jsynthetic.write_combo_corpus(str(tmp_path / "jax"), **sizes, **options)
    mt = tsynthetic.write_combo_corpus(str(tmp_path / "port"), **sizes, **options)
    assert mt == mj
    files = assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert len([f for f in files if f.endswith(".pdb")]) == 12 * 2 + 3 * 1


def test_combo_helpers_are_jax_s():
    combo = (2, 0, 3, 1)
    assert tsynthetic.all_combos(3) == jsynthetic.all_combos(3)
    for loop in ("H1", "H2", "H3"):
        assert (tsynthetic.loop_motif_index_options(combo, loop, 4)
                == jsynthetic.loop_motif_index_options(combo, loop, 4))
        assert (tsynthetic.combo_loop_motif(combo, loop, [1] * 8)
                == jsynthetic.combo_loop_motif(combo, loop, [1] * 8))
    assert tsynthetic.combo_h3_motif(combo) == jsynthetic.combo_h3_motif(combo)
    assert tsynthetic.split_combos(3, 12, 3, seed=4) == jsynthetic.split_combos(3, 12, 3, seed=4)
    assert tsynthetic.make_combo_pdb(combo, 7) == jsynthetic.make_combo_pdb(combo, 7)
    with pytest.raises(ValueError, match="seq_degeneracy"):
        tsynthetic.make_combo_pdb(combo, 0, seq_degeneracy=5)
    with pytest.raises(RuntimeError, match="could not cover"):
        tsynthetic.split_combos(4, 2, 1)


@pytest.mark.parametrize("meta_text, limit", [(META_MIXED, None), (META_MIXED, 6),
                                              (META_NUMERIC, None)],
                         ids=["mixed", "mixed-limit", "numeric"])
def test_meta_shaped_corpus_is_jax_s(tmp_path, meta_text, limit):
    meta = str(tmp_path / "meta.csv")
    with open(meta, "w") as fh:
        fh.write(meta_text)
    kw = dict(n_values=3, n_train_combos=12, n_heldout_combos=3, n_heldout_targets=2,
              limit=limit)
    mj = jsynthetic.write_meta_shaped_corpus(str(tmp_path / "jax"), meta, **kw)
    mt = tsynthetic.write_meta_shaped_corpus(str(tmp_path / "port"), meta, **kw)
    assert mt == mj
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    if meta_text is META_NUMERIC:  # read as floats, as pandas reads them
        assert "5aaa_1.0_2.0_3.0" in mt["rows"]
    else:
        assert mt["n_pdb_files"] < mt["n_rows"]  # the multi-Fv file
        assert {r["split"] for r in mt["rows"].values()} >= {"train", "no_heavy", "heldout"}


def test_meta_values_are_pandas_s(tmp_path):
    """The csv reader's values against pandas.read_csv's, cell by cell."""
    pd = pytest.importorskip("pandas")
    for i, text in enumerate((META_MIXED, META_NUMERIC)):
        meta = str(tmp_path / f"meta{i}.csv")
        with open(meta, "w") as fh:
            fh.write(text)
        want = pd.read_csv(meta)[["pdb_id", "Hchain", "Lchain", "antigen_chain"]]
        got = tsynthetic._read_meta(meta, None)
        assert len(got) == len(want)
        for row, rec in zip(got, want.itertuples(index=False)):
            for a, b in zip(row, rec):
                if a is None:
                    assert pd.isna(b)
                else:
                    assert type(a)(b) == a and str(a) == str(b), (row, tuple(rec))


@pytest.mark.skipif(not os.path.exists(REFERENCE_META), reason="reference meta.csv not present")
def test_meta_shaped_corpus_on_the_reference_meta_is_jax_s(tmp_path):
    kw = dict(n_heldout_targets=2, limit=60)
    mj = jsynthetic.write_meta_shaped_corpus(str(tmp_path / "jax"), REFERENCE_META, **kw)
    mt = tsynthetic.write_meta_shaped_corpus(str(tmp_path / "port"), REFERENCE_META, **kw)
    assert mt == mj
    assert_same_files(tmp_path / "jax", tmp_path / "port")


def test_corpus_patches_preprocess(tmp_path):
    """The port's compositional corpus goes through the port's bulk
    preprocessing: every row becomes a patch with the combination's H3."""
    from diffab_pytorch_tpu_torch.cli import preprocess
    from diffab_pytorch_tpu_torch.constants import AA_INDEX

    man = tsynthetic.write_combo_corpus(str(tmp_path / "c"), n_values=3, n_train_combos=12,
                                        n_heldout_combos=2, n_per_combo=1, n_val_instances=1)
    out = tmp_path / "p"
    assert preprocess.main(["--meta", str(tmp_path / "c" / "meta.csv"), "--data-dir",
                            str(tmp_path / "c" / "pdb"), "--out-dir", str(out), "-j", "1",
                            "-k", "64"]) == 0
    names = sorted(os.listdir(out))
    assert len(names) == 12 + 2
    patch = np.load(out / "c0_s0_H_L_A.npz")
    h3 = patch["cdr_idx"] == 3  # CDR.H3
    want = [AA_INDEX[a] for a in tsynthetic.combo_h3_motif(tuple(man["train_combos"][0]))]
    assert patch["seq_idx"][h3].tolist() == want
