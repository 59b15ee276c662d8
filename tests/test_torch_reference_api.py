"""The port's reference API against the JAX package, on the CPU: the
`AntibodyComplex` getters, its geometry methods and `residue_masked_select`,
`geometry.pairwise_dihedrals` / `pairwise_distance_matrix`, the three
diffuser classes, and `fetch_pdb` / `from_pdb_id` with the network stubbed
(no test downloads anything).

Tolerances: the getters and the numpy geometry run the same float32 /
float64 numpy code on both sides and are held equal; the diffusers'
float32 torch math against jnp within 1e-5 (tests/test_torch_geometry_
diffusion.py), sampled sequences equal, orientations 3e-5 as there.
"""

import io
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu.diffusion import coordinate as jcoord
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion import sequence as jseq
from diffab_pytorch_tpu.structure import antibody as jantibody
from diffab_pytorch_tpu.structure import geometry as jgeometry
from diffab_pytorch_tpu.structure import pdb as jpdb

from diffab_pytorch_tpu_torch import diffusion as tdiffusion
from diffab_pytorch_tpu_torch import structure as tstructure
from diffab_pytorch_tpu_torch.diffusion import coordinate as tcoord
from diffab_pytorch_tpu_torch.diffusion import orientation as torient
from diffab_pytorch_tpu_torch.structure import antibody as tantibody
from diffab_pytorch_tpu_torch.structure import geometry as tgeometry
from test_torch_geometry_diffusion import B, L, T, _state, close, igso3_draw, t_

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ab1_chothia.pdb")


@pytest.fixture(scope="module")
def complexes():
    """The fixture complex from both packages, each through its Python parser."""
    j = jantibody.from_chains(jpdb.parse_pdb_file(FIXTURE, prefer_native=False),
                              "H", "L", ["A"], keep_fv_only=True)
    t = tantibody.from_chains(tstructure.parse_pdb_file(FIXTURE, prefer_native=False),
                              "H", "L", ["A"], keep_fv_only=True)
    return j, t


def assert_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)
        return
    assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("getter", ["get_xyz", "get_seq_idx", "get_chain_idx", "get_atom_mask",
                                    "backbone_orientations", "backbone_dihedrals",
                                    "pairwise_dihedrals"])
def test_complex_getters_match_jax(complexes, getter):
    j, t = complexes
    assert_equal(getattr(t, getter)(), getattr(j, getter)())


def test_sizes_and_masked_select_match_jax(complexes):
    j, t = complexes
    assert t.get_max_n_residues() == j.get_max_n_residues() == j.n_residues
    assert t.get_max_n_atoms_per_residue() == j.get_max_n_atoms_per_residue()
    mask = t.get_cdr_mask(["H3"]) | t.get_antigen_mask()
    js, ts = j.residue_masked_select(mask), t.residue_masked_select(mask)
    assert ts.n_residues == int(mask.sum())
    for field in ("xyz", "atom_mask", "seq_idx", "chain_idx", "residue_idx", "residue_number",
                  "icode", "cdr_idx", "anchor_mask"):
        assert_equal(getattr(ts, field), getattr(js, field))
    assert ts.chain_ids == js.chain_ids
    # the all-atom distances on the selection (L^2 A^2 entries)
    assert_equal(ts.pairwise_distance_matrix(), js.pairwise_distance_matrix())


def test_pairwise_geometry_matches_jax():
    """On random coordinates with missing backbone atoms: the masked pairs
    get 0 and the mask drops them, as in JAX."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(12, 15, 3)).astype(np.float32) * 3.0
    mask = rng.random((12, 15)) > 0.2
    mask[3, :3] = False
    d_t = tgeometry.pairwise_dihedrals(xyz, mask)
    assert_equal(d_t, jgeometry.pairwise_dihedrals(xyz, mask))
    assert (d_t[3] == 0).all() and (d_t[:, 3] == 0).all()
    assert_equal(tgeometry.pairwise_distance_matrix(xyz, mask),
                 jgeometry.pairwise_distance_matrix(xyz, mask))


def test_structure_exports_are_jax_s():
    import diffab_pytorch_tpu.structure as jstructure

    jax_names = {n for n in dir(jstructure) if not n.startswith("_")}
    for name in jax_names:
        assert getattr(tstructure, name) is not None, name
    assert tstructure.fetch_pdb is tantibody.fetch_pdb


# ---- fetch_pdb / from_pdb_id with urlopen stubbed -------------------------------


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_fetch_pdb_and_from_pdb_id_read_what_rcsb_serves(monkeypatch, complexes):
    text = open(FIXTURE).read()
    urls = []

    def urlopen(url, timeout):
        urls.append((url, timeout))
        return _Response(text.encode())
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    assert tantibody.fetch_pdb("1ABC") == jantibody.fetch_pdb("1ABC") == text
    assert urls[0] == ("https://files.rcsb.org/download/1abc.pdb", 30.0) == urls[1]
    j, _ = complexes
    t = tantibody.from_pdb_id("1abc", "H", "L", ["A"], keep_fv_only=True)
    assert_equal(t.xyz, j.xyz)
    assert_equal(t.seq_idx, j.seq_idx)
    assert t.chain_ids == j.chain_ids


def test_fetch_pdb_without_network_raises_jax_s_message(monkeypatch):
    def urlopen(url, timeout):
        raise urllib.error.URLError("no route to host")
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    with pytest.raises(ConnectionError) as t_err:
        tantibody.from_pdb_id("7xyz", "H", "L")
    with pytest.raises(ConnectionError) as j_err:
        jantibody.from_pdb_id("7xyz", "H", "L")
    assert str(t_err.value) == str(j_err.value)
    assert "download the file manually and use from_pdb()" in str(t_err.value)


# ---- the diffuser classes ----------------------------------------------------------


@pytest.fixture(scope="module")
def diffusers():
    return dict(
        seq=(jseq.SequenceDiffuser(T), tdiffusion.SequenceDiffuser(T, device="cpu")),
        coord=(jcoord.CoordinateDiffuser(T), tcoord.CoordinateDiffuser(T, device="cpu")),
        orient=(jorient.OrientationDiffuser(T), torient.OrientationDiffuser(T, device="cpu")))


def test_sequence_diffuser_matches_jax(diffusers):
    jd, td = diffusers["seq"]
    np.testing.assert_array_equal(td.sched.alpha_bar.numpy(), np.asarray(jd.sched.alpha_bar))
    s = _state(11)
    seq, t, gen = s["seq"], s["t"], s["gen"]
    jargs = (jnp.asarray(seq, jnp.int32), jnp.asarray(t, jnp.int32), jnp.asarray(gen))
    targs = (t_(seq), t_(t), t_(gen))
    close(td.forward_prob_single_step(*targs), jd.forward_prob_single_step(*jargs), atol=1e-6)
    close(td.forward_prob_from_t0(*targs), jd.forward_prob_from_t0(*jargs), atol=1e-6)
    key = jax.random.key(3)
    gumbel = t_(jax.random.gumbel(key, (B, L, 21)))
    np.testing.assert_array_equal(td.diffuse_single_step(*targs, gumbel=gumbel).numpy(),
                                  np.asarray(jd.diffuse_single_step(key, *jargs)))
    seq_t, post_t = td.diffuse_from_t0(*targs, gumbel=gumbel)
    seq_j, post_j = jd.diffuse_from_t0(key, *jargs)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    close(post_t, post_j, atol=1e-6)
    only = td.diffuse_from_t0(*targs, return_posterior=False, gumbel=gumbel)
    assert torch.equal(only, seq_t)
    s0 = t_(s["seq"][::-1].copy())
    close(td.posterior_single_step(seq_t, s0, targs[1], targs[2]),
          jd.posterior_single_step(seq_j, jnp.asarray(s0.numpy(), jnp.int32), *jargs[1:]),
          atol=1e-6)
    probs = s["probs"]
    out_t = td.reverse_step(targs[0], t_(probs), targs[1], targs[2], gumbel=gumbel)
    out_j = jd.reverse_step(key, jargs[0], jnp.asarray(probs), *jargs[1:])
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_coordinate_diffuser_matches_jax(diffusers):
    jd, td = diffusers["coord"]
    s = _state(12)
    key = jax.random.key(4)
    z = t_(jax.random.normal(key, (B, L, 3)))
    x_t, eps = td.diffuse_from_t0(t_(s["x"]), t_(s["t"]), t_(s["gen"]), noise=z)
    x_j, eps_j = jd.diffuse_from_t0(key, jnp.asarray(s["x"]), jnp.asarray(s["t"], jnp.int32),
                                    jnp.asarray(s["gen"]))
    close(x_t, x_j)
    close(eps, eps_j)
    assert torch.equal(td.diffuse_from_t0(t_(s["x"]), t_(s["t"]), t_(s["gen"]),
                                          return_eps=False, noise=z), x_t)
    out_t = td.reverse_step(t_(s["x"]), t_(s["eps"]), t_(s["t"]), t_(s["gen"]), noise=z)
    out_j = jd.reverse_step(key, jnp.asarray(s["x"]), jnp.asarray(s["eps"]),
                            jnp.asarray(s["t"], jnp.int32), jnp.asarray(s["gen"]))
    close(out_t, out_j)


def test_orientation_diffuser_matches_jax(diffusers):
    jd, td = diffusers["orient"]
    s = _state(13)
    key = jax.random.key(5)
    noise = igso3_draw(key, (B, L))
    # the reference's argument order: (orientations, generation_mask, t)
    r_t = td.diffuse_from_t0(t_(s["r"]), t_(s["gen"]), t_(s["t"]), noise=noise)
    r_j = jd.diffuse_from_t0(key, jnp.asarray(s["r"]), jnp.asarray(s["gen"]),
                             jnp.asarray(s["t"], jnp.int32))
    close(r_t, r_j, atol=3e-5)
    out_t = td.reverse_step(t_(s["r"]), t_(s["r0"]), t_(s["t"]), t_(s["gen"]), noise=noise)
    out_j = jd.reverse_step(key, jnp.asarray(s["r"]), jnp.asarray(s["r0"]),
                            jnp.asarray(s["t"], jnp.int32), jnp.asarray(s["gen"]))
    close(out_t, out_j, atol=3e-5)
    # a generator instead of injected noise: a valid draw that keeps the context
    out = td.reverse_step(t_(s["r"]), t_(s["r0"]), t_(s["t"]), t_(s["gen"]),
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(out[~t_(s["gen"])], t_(s["r"])[~t_(s["gen"])])


def test_diffusers_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tdiffusion.SequenceDiffuser, tcoord.CoordinateDiffuser,
                torient.OrientationDiffuser):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(T)


def test_harness_model_calls_and_native_probe():
    """`DiffAb.encode_context` / `denoise` run the model on the parameters
    given (JAX's `model.apply(params, method=...)`); `native.available`
    reports whether the C++ library builds here."""
    from diffab_pytorch_tpu_torch import config as tconfig
    from diffab_pytorch_tpu_torch.data.batch import synthetic_batch
    from diffab_pytorch_tpu_torch.structure import native
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    harness = DiffAb(tconfig.tiny_config(), device="cpu")
    params = {k: v.detach() for k, v in harness.init(0).params.items()}
    batch = synthetic_batch(0, 2, 16, harness.config.model.n_atoms, n_generate=4)
    harness.init(1)  # other weights in the model: the calls must load `params`
    res, pair = harness.encode_context(params, batch)
    harness.model.load_state_dict(params)
    want_res, want_pair = harness.model.encode_context(batch)
    assert torch.equal(res, want_res) and torch.equal(pair, want_pair)
    beta = torch.full((2,), 0.1)
    args = (batch.seq_idx, batch.translations, batch.orientations, res, pair, beta,
            batch.generation_mask, batch.residue_mask)
    harness.init(1)
    got = harness.denoise(params, *args)
    harness.model.load_state_dict(params)
    want = harness.model.denoise(*args)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert native.available() is True
