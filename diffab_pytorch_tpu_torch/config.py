"""Frozen dataclass configuration (model / diffusion / data / training).

Mirrors `diffab_pytorch_tpu/config.py` field for field where a field
changes what the model or a training step computes; the defaults are the
same.  The TPU layout knobs of the JAX config (`use_pallas_attention`,
`onehot_pair_tables`, `split_pair_mlp0`, `fuse_pair_bias`, `remat_ipa`,
`remat_pair`) are exact re-groupings of the same arithmetic for XLA and
Mosaic and have no counterpart here.
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
    # None/True: the fused IPA-layer kernel; False: projections in plain
    # PyTorch and the attention-core kernel
    fuse_ipa_layer: bool | None = None
    # Self-conditioning: the denoiser also reads the previous step's
    # clean-state estimate (x0_hat in each residue's noisy frame, p(s_0)
    # unless self_conditioning_sequence is False, a validity flag), gated
    # to generated residues.  Where it enters: the fuse MLP (default, the
    # whole trunk), after the trunk into the geometry heads only
    # (sc_late_fusion), or a second fuse MLP and IPA stack feeding the
    # geometry heads (sc_split_trunk; exclusive with sc_late_fusion).
    self_conditioning: bool = False
    self_conditioning_sequence: bool = True
    sc_late_fusion: bool = False
    sc_split_trunk: bool = False

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
class TrainConfig:
    """Optimization configuration (`diffab_pytorch_tpu/config.py` TrainConfig).

    The update is the optax chain of the JAX harness: global-norm gradient
    clip (grad_clip_norm > 0) -> Adam normalization (betas, adam_eps) ->
    per-parameter update-RMS cap (update_clip_rms > 0) -> decoupled weight
    decay -> learning rate (constant, linear warmup, or warmup + cosine
    decay over lr_decay_steps, which include the warmup).  ema_decay > 0
    keeps an exponential moving average of the parameters.  mode_dropout
    = p presents a sample as fix-structure with probability p and as
    fix-sequence with probability p (p <= 0.5).

    The self-conditioning schedule (read when ModelConfig.self_conditioning
    is on): a share sc_rate of the samples (of the residues with
    sc_per_residue) is trained on the first pass's estimate; the share is
    0 for sc_onset_steps steps, then ramps linearly to sc_rate over
    sc_rate_warmup steps; the sequence losses of the conditioned rows are
    weighted by sc_seq_loss_weight."""

    batch_size: int = 16
    epochs: int = 60
    lr: float = 1e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    grad_clip_norm: float = 0.0
    update_clip_rms: float = 0.0
    ema_decay: float = 0.0
    # weight of the cross-entropy on the predicted p(s_0) beside the KL
    seq_ce_weight: float = 1.0
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_ratio: float = 0.0
    sc_rate: float = 0.5
    sc_onset_steps: int = 0
    sc_rate_warmup: int = 0
    sc_seq_loss_weight: float = 1.0
    sc_per_residue: bool = False
    mode_dropout: float = 0.0
    seed: int = 42
    val_pct: float = 0.1
    log_every: int = 50
    checkpoint_every: int = 1000
    checkpoint_dir: str = "checkpoints"


@dataclasses.dataclass(frozen=True)
class DiffAbConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def default_config() -> DiffAbConfig:
    """The reference's full-size preset."""
    return DiffAbConfig()


def production_config(steps: int = 12000, batch_size: int = 32,
                      seed: int = 42) -> DiffAbConfig:
    """The JAX package's measured-best training recipe: backbone-only pair
    distances (dist_atoms=4), d_pair_emb=48, bfloat16 compute; lr 6e-4 under
    warmup + cosine over `steps` (the real horizon), gradient-norm clip 1,
    update-RMS cap 1, parameter EMA 0.999, mode dropout 0.15."""
    return DiffAbConfig(
        model=dataclasses.replace(ModelConfig(), dist_atoms=4, d_pair_emb=48,
                                  compute_dtype="bfloat16"),
        train=dataclasses.replace(
            TrainConfig(), batch_size=batch_size, lr=6e-4,
            lr_warmup_steps=min(100, steps // 10), lr_decay_steps=steps,
            grad_clip_norm=1.0, update_clip_rms=1.0, ema_decay=0.999,
            mode_dropout=0.15, seed=seed,
        ),
    )


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
        train=TrainConfig(batch_size=2),
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
