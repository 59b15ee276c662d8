"""Frozen dataclass configuration (model / diffusion / data).

Mirrors `diffab_pytorch_tpu/config.py` field for field where a field
changes what the model computes; the defaults are the same.  The TPU
layout knobs of the JAX config (`use_pallas_attention`,
`onehot_pair_tables`, `split_pair_mlp0`, `fuse_pair_bias`, `remat_ipa`,
`remat_pair`) are exact re-groupings of the same arithmetic for XLA and
Mosaic and have no counterpart here.  Training options live with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from diffab_pytorch_tpu_torch.constants import (
    AA_VOCAB_SIZE,
    MAX_N_ATOMS_PER_RESIDUE,
    MAX_N_CHAINS,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Denoiser network hyperparameters (the reference's training preset)."""

    d_residue_emb: int = 128
    d_pair_emb: int = 64
    n_ipa_layers: int = 6
    d_scalar_per_head: int = 32
    n_query_point_per_head: int = 8
    n_value_point_per_head: int = 8
    n_head: int = 8
    use_pair_bias: bool = True
    n_atoms: int = MAX_N_ATOMS_PER_RESIDUE
    aa_vocab_size: int = AA_VOCAB_SIZE
    max_n_chains: int = MAX_N_CHAINS
    max_dist_to_consider: int = 32
    # atoms entering the pair distance feature; None = all n_atoms
    dist_atoms: int | None = None
    n_residue_dihedral_funcs: int = 3
    n_pair_dihedral_funcs: int = 2
    # dtype of the matmuls and activations; parameters stay float32
    compute_dtype: str = "float32"
    # False selects the attention-core kernel path (not ported yet)
    fuse_ipa_layer: bool | None = None
    # self-conditioning is not ported yet; True raises
    self_conditioning: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.compute_dtype
        ]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    T: int = 100
    s: float = 0.01
    beta_max: float = 0.999
    igso3_n_bins: int = 8192
    igso3_n_terms: int = 1024
    igso3_sigma_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    patch_size: int = 128
    cdrs_to_generate: Tuple[str, ...] = ("H3",)


@dataclasses.dataclass(frozen=True)
class DiffAbConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def default_config() -> DiffAbConfig:
    """The reference's full-size preset."""
    return DiffAbConfig()


def tiny_config() -> DiffAbConfig:
    """2 IPA blocks, d=32 — CPU-runnable end to end."""
    return DiffAbConfig(
        model=ModelConfig(
            d_residue_emb=32,
            d_pair_emb=16,
            n_ipa_layers=2,
            d_scalar_per_head=8,
            n_query_point_per_head=4,
            n_value_point_per_head=4,
            n_head=4,
        ),
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when no card is present and none was named — there is
    no silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
