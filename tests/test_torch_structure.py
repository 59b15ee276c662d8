"""The port's structure layer and batch assembly against the JAX package,
on the CPU: the PDB parser, complex assembly, patch featurization,
patches on disk, PDB writing, backbone reconstruction, and
`assemble_batch` with its pose normalization.

Both sides run their numpy geometry, the JAX side also its Python parser
(the C++ library is told apart: `tests/test_native.py` holds the two JAX
paths equal, `tests/test_torch_data.py` the port's).  Tolerances: parsing, assembly, featurization and the written
bytes exactly equal; backbone reconstruction and idealization 1e-6 A;
float fields of the batch 1e-6 (the same float32 numpy operations); the
inverse pose transform 1e-5 A plus 1e-6 of the coordinate (the patch's
antigen reaches ~170 A from the origin, where one float32 step is 1.5e-5
A, and the normalized coordinates are stored in float32).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from diffab_pytorch_tpu.data import dataset as jdataset
from diffab_pytorch_tpu.structure import antibody as jantibody
from diffab_pytorch_tpu.structure import geometry as jgeometry
from diffab_pytorch_tpu.structure import native as jnative
from diffab_pytorch_tpu.structure import patch as jpatch
from diffab_pytorch_tpu.structure import pdb as jpdb
from diffab_pytorch_tpu.structure import reconstruct as jreconstruct

from diffab_pytorch_tpu_torch.data import dataset as tdataset
from diffab_pytorch_tpu_torch.structure import antibody as tantibody
from diffab_pytorch_tpu_torch.structure import geometry as tgeometry
from diffab_pytorch_tpu_torch.structure import patch as tpatch
from diffab_pytorch_tpu_torch.structure import pdb as tpdb
from diffab_pytorch_tpu_torch.structure import reconstruct as treconstruct

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# fixture -> (heavy, light, antigens)
CHAINS = {"ab1_chothia.pdb": ("H", "L", ["A"]), "ab2_hostile.pdb": ("H", "L", ["a", "B"])}


@pytest.fixture(autouse=True)
def numpy_geometry_on_both_sides(monkeypatch):
    """Both featurizers on their numpy geometry, not the C++ library (held
    to it in tests/test_torch_data.py)."""
    monkeypatch.setattr(jnative, "backbone_geometry_native", lambda *a, **k: None)
    monkeypatch.setattr(tgeometry, "backbone_geometry",
                        functools.partial(tgeometry.backbone_geometry, prefer_native=False))


def path_of(name):
    return os.path.join(FIXTURES, name)


def complexes(name, keep_fv_only=True):
    h, l, ag = CHAINS[name]
    j = jantibody.from_chains(jpdb.parse_pdb_file(path_of(name), prefer_native=False),
                              h, l, ag, keep_fv_only)
    t = tantibody.from_pdb(path_of(name), h, l, ag, keep_fv_only)
    return j, t


def assert_same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_parser_matches_jax(name):
    j = jpdb.parse_pdb_file(path_of(name), prefer_native=False)
    t = tpdb.parse_pdb_file(path_of(name))
    assert list(j) == list(t)
    for ch in j:
        assert len(j[ch]) == len(t[ch])
        for rj, rt in zip(j[ch], t[ch]):
            assert (rj.resseq, rj.icode, rj.resname, rj.aa_index) == (
                rt.resseq, rt.icode, rt.resname, rt.aa_index)
            np.testing.assert_array_equal(rj.xyz, rt.xyz)
            np.testing.assert_array_equal(rj.atom_mask, rt.atom_mask)


@pytest.mark.parametrize("keep_fv_only", [True, False])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_complex_assembly_matches_jax(name, keep_fv_only):
    j, t = complexes(name, keep_fv_only)
    assert_same_arrays(dataclasses.asdict(j), dataclasses.asdict(t))
    np.testing.assert_array_equal(j.get_cdr_mask(["H3", "L1"]), t.get_cdr_mask(["H3", "L1"]))
    for a, b in zip(jgeometry.backbone_geometry(j.xyz, j.atom_mask, j.chain_idx,
                                                prefer_native=False),
                    tgeometry.backbone_geometry(t.xyz, t.atom_mask, t.chain_idx)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown CDRs"):
        t.get_cdr_mask(["H4"])


@pytest.mark.parametrize("with_numbers", [True, False])
def test_from_arrays_matches_jax(with_numbers):
    """Without author numbers the residues are numbered 1.. per chain."""
    j, _ = complexes("ab1_chothia.pdb")
    n = 40
    args = (j.xyz[:n], j.atom_mask[:n], j.seq_idx[:n], j.chain_idx[:n], j.residue_number[:n])
    if not with_numbers:
        args = args[:4]
    assert_same_arrays(dataclasses.asdict(jantibody.from_arrays(*args)),
                       dataclasses.asdict(tantibody.from_arrays(*args)))


@pytest.mark.parametrize("patch_size", [128, 256])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_featurize_patch_matches_jax(name, patch_size):
    """128 cuts the union of the nearest-residue sets (CDRs kept), 256
    pads it."""
    j, t = complexes(name)
    pj = jpatch.featurize_patch(j, patch_size=patch_size)
    pt = tpatch.featurize_patch(t, patch_size=patch_size)
    assert tuple(pt) == tpatch.PATCH_KEYS == jpatch.PATCH_KEYS
    assert_same_arrays(pj, pt)
    np.testing.assert_array_equal(jpatch.extract_patch_mask(j, 64),
                                  tpatch.extract_patch_mask(t, 64))


def test_patch_round_trips_through_npz(tmp_path):
    _, t = complexes("ab1_chothia.pdb")
    p = tpatch.featurize_patch(t, patch_size=128)
    tpatch.save_patch(str(tmp_path / "p.npz"), p)
    assert_same_arrays(p, tpatch.load_patch(str(tmp_path / "p.npz")))
    assert_same_arrays(p, jpatch.load_patch(str(tmp_path / "p.npz")))


def test_patch_without_anchors_is_rejected():
    _, t = complexes("ab1_chothia.pdb")
    t.anchor_mask[:] = False
    with pytest.raises(ValueError, match="no CDR anchor"):
        tpatch.extract_patch_mask(t)


@pytest.mark.parametrize("with_icodes", [True, False])
def test_write_pdb_is_byte_identical_to_jax(tmp_path, with_icodes):
    """The fixture's residues (Chothia insertion codes in H3) plus one
    residue far out, whose coordinates overflow the 3-decimal field."""
    _, t = complexes("ab1_chothia.pdb")
    xyz = t.xyz.copy()
    xyz[5, 1] = (12345.6789, -9999.12345, 123456789.0)
    chain_ids = t.chain_ids
    icodes = t.icode if with_icodes else None
    assert (t.icode != ord(" ")).any()
    seq = t.seq_idx.copy()
    seq[3] = 20  # UNK: backbone atoms only
    args = (xyz, t.atom_mask, seq, chain_ids, t.residue_number)
    jpdb.write_pdb(str(tmp_path / "j.pdb"), *args, icodes=icodes)
    tpdb.write_pdb(str(tmp_path / "t.pdb"), *args, icodes=icodes)
    assert (tmp_path / "j.pdb").read_bytes() == (tmp_path / "t.pdb").read_bytes()


def test_reconstruct_and_idealize_match_jax():
    rng = np.random.default_rng(0)
    j, _ = complexes("ab1_chothia.pdb")
    rot, _ = tgeometry.backbone_orientations(j.xyz, j.atom_mask)
    trans = j.xyz[:, 1] + rng.normal(size=(j.n_residues, 3)).astype(np.float32) * 0.3
    out_j = jreconstruct.reconstruct_backbone(rot, trans)
    out_t = treconstruct.reconstruct_backbone(rot, trans)
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-6)
    np.testing.assert_array_equal(out_t[1], out_j[1])
    edge = np.zeros(j.n_residues, bool)
    edge[90:110] = True
    for mask in (None, edge):
        ij = jreconstruct.idealize_peptide_bonds(out_j[0], out_j[1], j.chain_idx,
                                                 j.residue_idx, edge_mask=mask)
        it = treconstruct.idealize_peptide_bonds(out_t[0], out_t[1], j.chain_idx,
                                                 j.residue_idx, edge_mask=mask)
        np.testing.assert_allclose(it, ij, atol=1e-6)
    # the context outside the masked edges is untouched
    np.testing.assert_array_equal(it[:80], out_t[0][:80])


@pytest.fixture(scope="module")
def fixture_patch():
    _, t = complexes("ab1_chothia.pdb")
    return tpatch.featurize_patch(t, patch_size=128)


@pytest.mark.parametrize("cdrs", [["H3"], ["H1", "H2", "H3"], ["L3"]])
def test_assemble_batch_matches_jax(fixture_patch, cdrs):
    shifted = dict(fixture_patch, xyz=fixture_patch["xyz"] + np.float32(3.0))
    samples = [fixture_patch, shifted]
    jb, jinfo = jdataset.assemble_batch(samples, cdrs)
    tb, tinfo = tdataset.assemble_batch(samples, cdrs, device="cpu")
    assert int(tb.generation_mask.sum()) > 0
    for f in dataclasses.fields(tb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if b is None:
            assert a is None, f.name
            continue
        b = np.asarray(b)
        a = a.numpy()
        if b.dtype.kind == "f":
            assert a.dtype == b.dtype, f.name
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f.name)
    np.testing.assert_allclose(tinfo.center, jinfo.center, atol=1e-6)
    assert tinfo.scale == jinfo.scale
    np.testing.assert_allclose(tinfo.rot, jinfo.rot, atol=1e-6)


def test_normalization_inverts_the_pose(fixture_patch):
    """denormalize(normalized CA) gives the patch's CA back and
    denormalize_orientations its frames, in angstroms, for a patch in two
    poses; the canonical pose is the same for both."""
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    posed = dict(fixture_patch, xyz=(fixture_patch["xyz"] @ q.astype(np.float32)) + 5.0,
                 orientations=fixture_patch["orientations"] @ q.astype(np.float32))
    tb, info = tdataset.assemble_batch([fixture_patch, posed], ["H3"], device="cpu")
    ca = np.stack([fixture_patch["xyz"][:, 1], posed["xyz"][:, 1]])
    m = fixture_patch["atom_mask"][:, 1]
    back = info.denormalize(tb.translations.numpy())
    np.testing.assert_allclose(back[:, m], ca[:, m], atol=1e-5, rtol=1e-6)
    ori = np.stack([fixture_patch["orientations"], posed["orientations"]])
    np.testing.assert_allclose(info.denormalize_orientations(tb.orientations.numpy()), ori,
                               atol=1e-5)
    np.testing.assert_allclose(tb.translations[0].numpy(), tb.translations[1].numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown CDRs"):
        tdataset.generation_mask_from_cdr(fixture_patch["cdr_idx"], ["H9"])


def test_assemble_batch_defaults_to_the_card(fixture_patch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdataset.assemble_batch([fixture_patch])
