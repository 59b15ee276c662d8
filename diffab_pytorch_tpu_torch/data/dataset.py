"""Patches to batches (`diffab_pytorch_tpu/data/dataset.py`): the
normalization into diffusion space, stacking into the port's
`ProteinBatch`, and `PatchDataset`, the index over a directory of
preprocessed .npz patches with its batch iterator and device pool.

  * generation_mask comes from the stored per-CDR labels, for any subset
    of CDRs to generate;
  * coordinates are centred on the CONTEXT (non-generated) CA centroid,
    rotated into the context's canonical principal-axes pose and divided
    by COORD_SCALE, so that the coordinate prior N(0, I) matches the data
    and the frames live in a pose the model can reproduce at sampling
    time; `NormalizationInfo` inverts the transform after sampling;
  * the pairwise dihedrals are left to the model (PairEmbedding).

The normalization is host-side numpy in float32, as in the JAX package,
and a `PatchDataset` batch is assembled on the host (CPU tensors); moving
it to the card is the loader's job (`data/loader.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from diffab_pytorch_tpu_torch.config import resolve_device
from diffab_pytorch_tpu_torch.constants import CDR, CDR_NAMES
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.structure.patch import load_patch

# angstrom -> diffusion units: CA coordinates of a centred 128-residue
# patch have a std of ~10 A
COORD_SCALE = 10.0


@dataclasses.dataclass
class NormalizationInfo:
    """Per-sample invertible pose transform:
    x_norm = ((x - center) @ rot) / scale, frames O_norm = O @ rot."""

    center: np.ndarray  # (b, 3)
    scale: float
    rot: np.ndarray  # (b, 3, 3)

    def denormalize(self, xyz_norm: np.ndarray) -> np.ndarray:
        x = np.asarray(xyz_norm) * self.scale
        x = np.einsum("b...i,bji->b...j", x, self.rot)  # x @ rot^T
        return x + self.center[:, None, :]

    def denormalize_orientations(self, orientations_norm: np.ndarray) -> np.ndarray:
        return np.einsum(
            "b...ij,bkj->b...ik", np.asarray(orientations_norm), self.rot
        )  # O @ rot^T


def _canonical_rotation(ca_centered: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Canonical pose of the weighted context CA cloud (batched): principal
    axes by descending eigenvalue, the first two signed by the third moment
    of the projections, the last by right-handedness, so that
    x_centered @ V does not depend on how the input was posed.  Fewer than
    3 context points: the identity."""
    denom = np.maximum(w.sum(1), 1.0)
    cov = (
        np.einsum("bl,bli,blj->bij", w, ca_centered, ca_centered)
        / denom[:, None, None]
    )
    _, eigvec = np.linalg.eigh(cov)  # ascending eigenvalues
    v = eigvec[:, :, ::-1].copy()  # columns = axes, descending variance
    for j in (0, 1):
        proj = np.einsum("bli,bi->bl", ca_centered, v[:, :, j])
        m3 = (w * proj**3).sum(1)
        v[:, :, j] *= np.where(m3 >= 0.0, 1.0, -1.0)[:, None]
    v[:, :, 2] = np.cross(v[:, :, 0], v[:, :, 1], axis=-1)
    degenerate = w.sum(1) < 3.0
    if degenerate.any():
        v[degenerate] = np.eye(3)
    return v.astype(np.float32)


def generation_mask_from_cdr(
    cdr_idx: np.ndarray, cdrs_to_generate: Sequence[str]
) -> np.ndarray:
    bad = set(cdrs_to_generate) - set(CDR_NAMES)
    if bad:
        raise ValueError(f"unknown CDRs {sorted(bad)}; must be in {CDR_NAMES}")
    wanted = np.array([int(CDR[c]) for c in cdrs_to_generate], cdr_idx.dtype)
    return np.isin(cdr_idx, wanted)


def normalize_sample(
    s: Dict[str, np.ndarray], cdrs_to_generate: Sequence[str]
) -> Dict[str, np.ndarray]:
    """One patch's normalized pose and masks: the patch's keys with xyz and
    orientations normalized (see the module docstring), plus
    generation_mask, norm_center and norm_rot.  Depends only on the patch
    and the CDR subset."""
    gen = generation_mask_from_cdr(s["cdr_idx"], cdrs_to_generate)
    gen = gen & s["residue_mask"].astype(bool)
    xyz = s["xyz"].astype(np.float32)
    orientations = s["orientations"].astype(np.float32)

    ctx = s["residue_mask"].astype(bool) & ~gen & s["atom_mask"][:, 1].astype(bool)
    w = ctx.astype(np.float32)[None]  # (1, L): the batched helpers
    denom = np.maximum(w.sum(1), 1.0)
    center = (xyz[None, :, 1, :] * w[..., None]).sum(1) / denom[:, None]
    xyz = xyz - center[0][None, None, :]
    rot = _canonical_rotation(xyz[None, :, 1, :], w)[0]
    xyz = np.einsum("lai,ij->laj", xyz, rot) / COORD_SCALE
    orientations = np.einsum("lij,jk->lik", orientations, rot)
    # masked atom slots carry zeros, whatever the file held
    xyz = np.where(s["atom_mask"][..., None].astype(bool), xyz, 0.0)

    out = dict(s)
    out["xyz"] = xyz.astype(np.float32)
    out["orientations"] = orientations.astype(np.float32)
    out["generation_mask"] = gen
    out["norm_center"] = center[0].astype(np.float32)
    out["norm_rot"] = rot
    return out


def assemble_batch(
    samples: List[Dict[str, np.ndarray]],
    cdrs_to_generate: Sequence[str] = ("H3",),
    device=None,
    normalize: bool = True,
) -> tuple[ProteinBatch, NormalizationInfo]:
    """Stack patch dicts into a ProteinBatch on `device` (the card unless
    named) and return it with the coordinate transform.  normalize: the
    samples not normalized yet are normalized first; False keeps the
    patches' angstroms and frames (identity transform, scale 1)."""
    device = resolve_device(device)
    if normalize:
        samples = [
            s if "norm_center" in s else normalize_sample(s, cdrs_to_generate)
            for s in samples
        ]
    stack = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if normalize:
        gen_mask = stack["generation_mask"].astype(bool)
        xyz, orientations = stack["xyz"], stack["orientations"]
        info = NormalizationInfo(center=stack["norm_center"], scale=COORD_SCALE,
                                 rot=stack["norm_rot"])
    else:
        b = stack["seq_idx"].shape[0]
        gen_mask = generation_mask_from_cdr(stack["cdr_idx"], cdrs_to_generate)
        gen_mask &= stack["residue_mask"].astype(bool)
        # masked atom slots carry zeros, whatever the file held
        xyz = np.where(stack["atom_mask"][..., None].astype(bool),
                       stack["xyz"].astype(np.float32), 0.0)
        orientations = stack["orientations"].astype(np.float32)
        info = NormalizationInfo(center=np.zeros((b, 3), np.float32), scale=1.0,
                                 rot=np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)))
    batch = ProteinBatch.from_numpy(dict(
        xyz=xyz,
        orientations=orientations,
        backbone_dihedrals=stack["backbone_dihedrals"].astype(np.float32),
        backbone_dihedrals_mask=stack["backbone_dihedrals_mask"].astype(bool),
        pairwise_dihedrals=None,
        atom_mask=stack["atom_mask"].astype(bool),
        seq_idx=stack["seq_idx"],
        chain_idx=stack["chain_idx"],
        residue_idx=stack["residue_idx"],
        residue_mask=stack["residue_mask"].astype(bool),
        generation_mask=gen_mask,
    ), device=device)
    return batch, info


class PatchDataset:
    """Index over preprocessed .npz patches (`cli/preprocess.py` writes
    them).  require_generated: samples whose generation mask would be
    empty are skipped.  cache: each sample's NORMALIZED arrays are kept in
    RAM after first use (~35 KB a 128-residue patch), so later epochs skip
    the compressed-npz decode and the pose normalization; it is valid
    because `normalize_sample` depends only on the sample and the CDR
    subset."""

    def __init__(
        self,
        paths: Sequence[str],
        cdrs_to_generate: Sequence[str] = ("H3",),
        require_generated: bool = True,
        cache: bool = False,
    ):
        bad = set(cdrs_to_generate) - set(CDR_NAMES)
        if bad:
            raise ValueError(f"unknown CDRs {sorted(bad)}; must be in {CDR_NAMES}")
        self.paths = list(paths)
        self.cdrs_to_generate = tuple(cdrs_to_generate)
        self.require_generated = require_generated
        self.cache = cache
        self._norm_cache: Dict[int, Dict[str, np.ndarray]] = {}

    @classmethod
    def from_dir(cls, data_dir: str, **kwargs) -> "PatchDataset":
        paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                       if f.endswith(".npz"))
        return cls(paths, **kwargs)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return load_patch(self.paths[i])

    def _sample(self, i: int, normalize: bool) -> Dict[str, np.ndarray]:
        if not normalize:
            return self[i]
        s = self._norm_cache.get(i)
        if s is None:
            s = normalize_sample(self[i], self.cdrs_to_generate)
            if self.cache:
                self._norm_cache[i] = s
        return s

    def _usable(self, s: Dict[str, np.ndarray]) -> bool:
        if not self.require_generated:
            return True
        gm = s.get("generation_mask")
        if gm is None:
            gm = generation_mask_from_cdr(s["cdr_idx"], self.cdrs_to_generate) \
                & s["residue_mask"].astype(bool)
        return bool(gm.any())

    def device_pool(self, normalize: bool = True) -> tuple[ProteinBatch, NormalizationInfo]:
        """The whole dataset as ONE host ProteinBatch (row i = the i-th
        usable sample) and its NormalizationInfo: the input of
        `DiffAb.pool_train_step`, which gathers each step's rows on the
        card, so a step moves b indices to the card instead of its
        features.  Skips what `batches` skips."""
        samples = [s for s in (self._sample(i, normalize) for i in range(len(self.paths)))
                   if self._usable(s)]
        return assemble_batch(samples, self.cdrs_to_generate, device="cpu",
                              normalize=normalize)

    def epoch_indices(
        self, batch_size: int, *, n_rows: int, shuffle: bool = True,
        seed: int = 0, drop_last: bool = True,
    ) -> Iterator[np.ndarray]:
        """Endless per-epoch (batch_size,) int32 row selections over a
        device pool of n_rows rows: the host side of the pool loop."""
        rng = np.random.default_rng(seed)
        while True:
            order = np.arange(n_rows)
            if shuffle:
                rng.shuffle(order)
            for i in range(0, n_rows - batch_size + 1, batch_size):
                yield order[i:i + batch_size].astype(np.int32)
            rem = n_rows % batch_size
            if rem and not drop_last:
                yield order[n_rows - rem:].astype(np.int32)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        epochs: Optional[int] = None,
        normalize: bool = True,
    ) -> Iterator[tuple[ProteinBatch, NormalizationInfo]]:
        """Host batches (CPU tensors) of `batch_size` usable samples, each
        epoch in a fresh order from np.random.default_rng(seed); endless
        when epochs is None."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self.paths))
            if shuffle:
                rng.shuffle(order)
            buf: List[Dict[str, np.ndarray]] = []
            for i in order:
                s = self._sample(int(i), normalize)
                if not self._usable(s):
                    continue
                buf.append(s)
                if len(buf) == batch_size:
                    yield assemble_batch(buf, self.cdrs_to_generate, device="cpu",
                                         normalize=normalize)
                    buf = []
            if buf and not drop_last:
                yield assemble_batch(buf, self.cdrs_to_generate, device="cpu",
                                     normalize=normalize)
            epoch += 1
