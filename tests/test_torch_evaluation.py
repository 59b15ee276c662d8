"""The port's evaluation metrics and designed-loop relaxation against the
JAX package, on the CPU in float32, on seeded inputs and on designs made
from the curated fixture's H1 and H3 loops.

Tolerance: 1e-5 (the same float32 operations summed in another order;
for relax_ca over 200 iterations, in model units, but for a torn loop,
whose bound `test_relax_of_a_torn_loop_matches_jax` explains); counts,
masks and ranks exactly equal; context rows of relax_ca byte-identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu.data.batch import ProteinBatch as JaxBatch
from diffab_pytorch_tpu.evaluation import metrics as jm
from diffab_pytorch_tpu.sampling.sampler import SampleResult as JaxResult
from diffab_pytorch_tpu.structure.relax import relax_ca as jrelax

from diffab_pytorch_tpu_torch.constants import ATOM
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.data.dataset import COORD_SCALE, assemble_batch
from diffab_pytorch_tpu_torch.evaluation import metrics as tm
from diffab_pytorch_tpu_torch.sampling.sampler import SampleResult
from diffab_pytorch_tpu_torch.structure import antibody
from diffab_pytorch_tpu_torch.structure.patch import featurize_patch
from diffab_pytorch_tpu_torch.structure.relax import relax_ca as trelax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ab1_chothia.pdb")
N_DESIGNS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs one worker process per core: torch's own thread pool
    in each would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a):
    return torch.from_numpy(np.array(a))


def j_(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.int32) if a.dtype.kind in "iu" else a)


def close(actual, expected, atol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64), np.asarray(expected, np.float64),
                               atol=atol, rtol=1e-5)


@pytest.fixture(scope="module")
def native():
    """The fixture patch as a batch of N_DESIGNS identical rows (H1 and H3
    generated) and its CDR labels, in numpy."""
    c = antibody.from_pdb(FIXTURE, "H", "L", ["A"], keep_fv_only=True)
    p = featurize_patch(c, patch_size=128)
    batch, _ = assemble_batch([p] * N_DESIGNS, ["H1", "H3"], device="cpu")
    return batch.to_numpy(), np.repeat(p["cdr_idx"][None], N_DESIGNS, 0).astype(np.int64)


def designs(native_arrays, kind, seed=0):
    """Designs of the native: generated rows perturbed.  'noise': every
    designed CA moved by ~0.3 A and random residue types; 'torn': one loop
    residue 20 A out (an extreme edge, the relaxation's chord pass);
    'squeezed': the H3 loop collapsed toward its first residue (clashes)."""
    a = native_arrays
    rng = np.random.default_rng(seed)
    gen = a["generation_mask"] & a["residue_mask"]
    x = a["xyz"][:, :, ATOM.CA].copy()
    seq = a["seq_idx"].copy()
    if kind == "noise":
        x = np.where(gen[..., None], x + rng.normal(size=x.shape).astype(np.float32) * 0.03, x)
        seq = np.where(gen, rng.integers(0, 20, seq.shape), seq)
    elif kind == "torn":
        rows = np.nonzero(gen[0])[0]
        x[:, rows[len(rows) // 2]] += np.float32(2.0)
    elif kind == "squeezed":
        rows = np.nonzero(gen[0])[0][-6:]
        x[:, rows] = x[:, rows[:1]] + (x[:, rows] - x[:, rows[:1]]) * np.float32(0.2)
    rot = a["orientations"].copy()
    return x.astype(np.float32), seq, rot


def jax_batch(a):
    return JaxBatch(**{k: (None if v is None else j_(v)) for k, v in a.items()})


def test_recovery_rmsd_and_diversity_match_jax():
    rng = np.random.default_rng(0)
    b, L = 3, 24
    pred, nat = rng.integers(0, 20, (b, L)), rng.integers(0, 20, (b, L))
    mask = rng.random((b, L)) < 0.4
    mask[2] = False  # an empty mask gives 0, not a division by zero
    x1 = rng.normal(size=(b, L, 3)).astype(np.float32)
    x2 = rng.normal(size=(b, L, 3)).astype(np.float32)
    close(tm.amino_acid_recovery(t_(pred), t_(nat), t_(mask)),
          jm.amino_acid_recovery(j_(pred), j_(nat), j_(mask)))
    close(tm.ca_rmsd(t_(x1), t_(x2), t_(mask), scale=10.0),
          jm.ca_rmsd(j_(x1), j_(x2), j_(mask), scale=10.0))
    for m in (mask[0], mask):
        close(tm.sequence_diversity(t_(pred), t_(m)), jm.sequence_diversity(j_(pred), j_(m)))


def _rigid(rng, x, reflect=False):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    if reflect:
        q = q @ np.diag([1.0, 1.0, -1.0])
    return (x @ q + rng.normal(size=3)).astype(np.float32)


@pytest.mark.parametrize("case", ["rigid", "reflected", "collinear"])
def test_kabsch_and_aligned_rmsd_match_jax(case):
    """A rigid motion with noise; a mirror image (the fit must stay a
    proper rotation); a collinear cloud (its SVD is degenerate: any roll
    about the line is optimal, so the RMSD must agree whatever rotation the
    solver returns)."""
    rng = np.random.default_rng(1)
    b, L = 2, 30
    if case == "collinear":
        target = (np.linspace(-5, 5, L)[None, :, None] * rng.normal(size=(b, 1, 3))).astype(
            np.float32)
    else:
        target = rng.normal(size=(b, L, 3)).astype(np.float32) * 4
    mobile = np.stack([_rigid(rng, t, reflect=case == "reflected") for t in target])
    if case == "rigid":
        mobile += rng.normal(size=mobile.shape).astype(np.float32) * 0.05
    fit = np.ones((b, L), bool)
    fit[:, :5] = False
    score = ~fit
    rot_t, trans_t = tm.kabsch(t_(mobile), t_(target), t_(fit))
    rot_j, trans_j = jm.kabsch(j_(mobile), j_(target), j_(fit))
    close(torch.linalg.det(rot_t), np.ones(b))
    close(rot_t.transpose(1, 2) @ rot_t, np.broadcast_to(np.eye(3), (b, 3, 3)))
    if case != "collinear":
        close(rot_t, rot_j)
        close(trans_t, trans_j)
    close(tm.aligned_ca_rmsd(t_(mobile), t_(target), t_(score), t_(fit), scale=10.0),
          jm.aligned_ca_rmsd(j_(mobile), j_(target), j_(score), j_(fit), scale=10.0))


def test_spearman_with_ties_matches_jax():
    rng = np.random.default_rng(2)
    for a, b in [(rng.normal(size=16), rng.normal(size=16)),
                 (np.array([1.0, 1.0, 2.0, 0.5, 1.0, 3.0, 3.0, 0.5]),
                  np.array([0.2, 0.1, 0.4, 0.4, 0.9, 0.9, 0.0, 0.3])),
                 (np.arange(10.0), np.arange(10.0)[::-1].copy())]:
        a, b = a.astype(np.float32), b.astype(np.float32)
        close(tm.spearman_corr(t_(a), t_(b)), jm.spearman_corr(j_(a), j_(b)))


def _validity_args(a, x_ca):
    xyz = a["xyz"]
    has_bb = a["atom_mask"][..., ATOM.N] & a["atom_mask"][..., ATOM.CA] & a["atom_mask"][
        ..., ATOM.C]
    return (xyz[..., ATOM.N, :], x_ca, xyz[..., ATOM.C, :], a["residue_mask"] & has_bb,
            a["chain_idx"], a["residue_idx"], a["generation_mask"])


@pytest.mark.parametrize("kind", ["native", "torn", "squeezed"])
def test_backbone_validity_matches_jax(native, kind):
    a, _ = native
    x = a["xyz"][:, :, ATOM.CA] if kind == "native" else designs(a, kind)[0]
    args = _validity_args(a, x)
    out_t = tm.backbone_validity(*(t_(v) for v in args), scale=COORD_SCALE)
    out_j = jm.backbone_validity(*(j_(v) for v in args), scale=COORD_SCALE)
    assert set(out_t) == set(out_j)
    for k in out_j:
        close(out_t[k], out_j[k])
    assert bool(out_t["valid"].all()) == (kind == "native")


@pytest.mark.parametrize("idealize,relax", [(False, False), (True, False), (True, True)])
def test_validity_from_result_matches_jax(native, idealize, relax):
    a, _ = native
    x, seq, rot = designs(a, "torn")
    out_t = tm.validity_from_result(SampleResult(t_(seq), t_(x), t_(rot)),
                                    ProteinBatch.from_numpy(a), coord_scale=COORD_SCALE,
                                    idealize=idealize, relax=relax)
    out_j = jm.validity_from_result(JaxResult(j_(seq), j_(x), j_(rot)), jax_batch(a),
                                    coord_scale=COORD_SCALE, idealize=idealize, relax=relax)
    for k in out_j:
        close(out_t[k], out_j[k])


@pytest.mark.parametrize("align,cdrs", [(False, None), (True, None), (False, ("H3",))])
def test_evaluate_designs_matches_jax(native, align, cdrs):
    a, cdr_idx = native
    x, seq, rot = designs(a, "noise")
    out_t = tm.evaluate_designs(SampleResult(t_(seq), t_(x), t_(rot)),
                                ProteinBatch.from_numpy(a),
                                coord_scale=COORD_SCALE, cdr_idx=t_(cdr_idx), align=align,
                                cdrs=cdrs)
    out_j = jm.evaluate_designs(JaxResult(j_(seq), j_(x), j_(rot)), jax_batch(a),
                                coord_scale=COORD_SCALE, cdr_idx=j_(cdr_idx), align=align,
                                cdrs=cdrs)
    assert set(out_t) == set(out_j)
    assert {"aar_H3", "ca_rmsd_H3"} <= set(out_t)
    assert ("aar_H1" in out_t) == (cdrs is None)
    for k in out_j:
        close(out_t[k], out_j[k])


def _relax_both(a, x, **kw):
    masks = (a["residue_mask"], a["chain_idx"], a["residue_idx"], a["generation_mask"])
    out_t = trelax(t_(x), *(t_(m) for m in masks), coord_scale=COORD_SCALE, **kw).numpy()
    out_j = np.asarray(jrelax(j_(x), *(j_(m) for m in masks), coord_scale=COORD_SCALE, **kw))
    return out_t, out_j


@pytest.mark.parametrize("kind", ["noise", "squeezed"])
def test_relax_matches_jax(native, kind):
    a, _ = native
    x = designs(a, kind, seed=3)[0]
    out_t, out_j = _relax_both(a, x)
    close(out_t, out_j)
    ctx = ~a["generation_mask"]
    assert out_t[ctx].tobytes() == x[ctx].tobytes()
    assert not np.array_equal(out_t, x)


def test_relax_of_a_torn_loop_matches_jax(native):
    """The torn loop goes through the chord pass and lands near full
    stretch, with edges on the gate's thresholds.  The projection fires a
    correction only outside the gate, so a last-digit rounding difference
    (the clash sum reduced in another order) flips a correction on an edge
    that sits on a threshold, and from there the two chains of corrections
    part: 4e-8 after 5 iterations, 8e-7 after 10, 4e-3 model units (0.04
    A) after 200, with no step computed differently.  So: the first 10
    iterations within 1e-5; after 200, both results pass the gate's CA
    checks with the context byte-identical, and lie within 1e-2 model
    units (0.1 A) of each other."""
    a, _ = native
    x = designs(a, "torn", seed=3)[0]
    close(*_relax_both(a, x, n_iters=10))
    out_t, out_j = _relax_both(a, x)
    np.testing.assert_allclose(out_t, out_j, atol=1e-2, rtol=0)
    ctx = ~a["generation_mask"]
    assert out_t[ctx].tobytes() == x[ctx].tobytes()
    for out in (out_t, out_j):
        val = tm.backbone_validity(*(t_(v) for v in _validity_args(a, out)), scale=COORD_SCALE)
        assert int(val["ca_break"].sum()) == 0 and int(val["clash_count"].sum()) == 0


def test_relax_leaves_valid_geometry_unchanged(native):
    a, _ = native
    x = a["xyz"][:, :, ATOM.CA]
    masks = (a["residue_mask"], a["chain_idx"], a["residue_idx"], a["generation_mask"])
    out = trelax(t_(x), *(t_(m) for m in masks), coord_scale=COORD_SCALE).numpy()
    assert out.tobytes() == x.tobytes()
    # and the torn loop comes back valid under the shipped gate
    xt, seq, rot = designs(a, "torn")
    val = tm.validity_from_result(SampleResult(t_(seq), t_(xt), t_(rot)),
                                  ProteinBatch.from_numpy(a),
                                  coord_scale=COORD_SCALE, idealize=True, relax=True)
    assert bool(val["valid"].all())
