"""The featurized-batch schema (`diffab_pytorch_tpu/data/batch.py`).

A dataclass of tensors with the JAX package's fields, shapes and layouts.
`from_numpy` / `to_numpy` move one batch between the two packages in the
parity tests; `synthetic_batch` builds a random, internally consistent
batch from a numpy seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffab_pytorch_tpu_torch.constants import ATOM


@dataclasses.dataclass
class ProteinBatch:
    """One batch of L-residue patches: b = batch, L = residues, A = atoms."""

    xyz: torch.Tensor  # (b, L, A, 3) float — all-atom coordinates
    orientations: torch.Tensor  # (b, L, 3, 3) float — backbone frames
    backbone_dihedrals: torch.Tensor  # (b, L, 3) float
    backbone_dihedrals_mask: torch.Tensor  # (b, L, 3) bool
    pairwise_dihedrals: torch.Tensor | None  # (b, L, L, 2) or None
    atom_mask: torch.Tensor  # (b, L, A) bool
    seq_idx: torch.Tensor  # (b, L) int64 — amino-acid types
    chain_idx: torch.Tensor  # (b, L) int64 — 0 = padding
    residue_idx: torch.Tensor  # (b, L) int64
    residue_mask: torch.Tensor  # (b, L) bool
    generation_mask: torch.Tensor  # (b, L) bool

    @property
    def batch_size(self) -> int:
        return self.seq_idx.shape[0]

    @property
    def translations(self) -> torch.Tensor:
        """C-alpha coordinates (b, L, 3), the diffused translation variable."""
        return self.xyz[:, :, ATOM.CA, :]

    def _map(self, fn) -> "ProteinBatch":
        return ProteinBatch(**{
            f.name: (None if v is None else fn(v))
            for f in dataclasses.fields(self)
            for v in [getattr(self, f.name)]
        })

    def to(self, device, non_blocking: bool = False) -> "ProteinBatch":
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "ProteinBatch":
        """A copy in page-locked host memory, for asynchronous copies."""
        return self._map(lambda v: v.pin_memory())

    def gather_rows(self, idx: torch.Tensor) -> "ProteinBatch":
        """Rows `idx` ((b,) int64 on this batch's device) of every field:
        a step's batch out of a device-resident pool."""
        return self._map(lambda v: v.index_select(0, idx))

    @classmethod
    def from_numpy(cls, arrays, device="cpu") -> "ProteinBatch":
        """From a mapping (or object with attributes) of numpy-convertible
        arrays named like the fields; integer fields become int64."""
        get = (arrays.get if isinstance(arrays, dict)
               else lambda k: getattr(arrays, k))
        out = {}
        for f in dataclasses.fields(cls):
            v = get(f.name)
            if v is None:
                out[f.name] = None
                continue
            a = np.asarray(v)
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(**out)

    def to_numpy(self) -> dict:
        return {
            f.name: (None if v is None else v.detach().cpu().numpy())
            for f in dataclasses.fields(self)
            for v in [getattr(self, f.name)]
        }


def _uniform_rotations(rng: np.random.Generator, shape) -> np.ndarray:
    """Haar-random rotation matrices from normalized 4D Gaussian quaternions."""
    q = rng.normal(size=tuple(shape) + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def synthetic_batch_numpy(
    rng: np.random.Generator | int,
    batch_size: int = 2,
    n_residues: int = 128,
    n_atoms: int = 15,
    vocab_size: int = 21,
    n_generate: int = 16,
) -> dict:
    """Random but internally consistent batch as numpy arrays (orthonormal
    frames, CA at slot 1, one contiguous generated span in the middle, two
    chains).  Coordinates are unit-scale like the data pipeline's."""
    rng = np.random.default_rng(rng)
    b, L = batch_size, n_residues
    orientations = _uniform_rotations(rng, (b, L)).astype(np.float32)
    ca = rng.normal(size=(b, L, 1, 3)) * 1.2
    xyz = (ca + rng.normal(size=(b, L, n_atoms, 3)) * 0.15).astype(np.float32)
    start = L // 2 - n_generate // 2
    gen = np.zeros((b, L), bool)
    gen[:, start:start + n_generate] = True
    chain = np.ones((b, L), np.int64)
    chain[:, L // 2:] = 2
    return dict(
        xyz=xyz,
        orientations=orientations,
        backbone_dihedrals=rng.uniform(-np.pi, np.pi, (b, L, 3)).astype(np.float32),
        backbone_dihedrals_mask=np.ones((b, L, 3), bool),
        pairwise_dihedrals=rng.uniform(-np.pi, np.pi, (b, L, L, 2)).astype(np.float32),
        atom_mask=np.ones((b, L, n_atoms), bool),
        seq_idx=rng.integers(0, vocab_size - 1, (b, L)),
        chain_idx=chain,
        residue_idx=np.broadcast_to(np.arange(L), (b, L)).copy(),
        residue_mask=np.ones((b, L), bool),
        generation_mask=gen,
    )


def synthetic_batch(
    rng: np.random.Generator | int,
    batch_size: int = 2,
    n_residues: int = 128,
    n_atoms: int = 15,
    vocab_size: int = 21,
    n_generate: int = 16,
    device="cpu",
) -> ProteinBatch:
    """`synthetic_batch_numpy` as a ProteinBatch on `device`."""
    return ProteinBatch.from_numpy(
        synthetic_batch_numpy(rng, batch_size, n_residues, n_atoms,
                              vocab_size, n_generate),
        device=device,
    )
