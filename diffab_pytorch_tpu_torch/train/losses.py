"""Training losses (`diffab_pytorch_tpu/train/losses.py`).

All three losses are reduced by one scalar denominator per modality: the
count of generated-and-valid residues (at least 1).

  seq_loss           KL(true posterior || predicted posterior), summed over
                     the vocabulary; the predicted posterior is
                     q(s_{t-1} | s_t, p_hat(s_0)), passed in as log-probs
  translations_loss  squared error of the noise, summed over the 3 coords
  orientations_loss  squared error of R_pred^T R_true against I, summed
                     over the 9 entries
  seq_ce_loss        cross-entropy of p_hat(s_0) against s_0, added with
                     weight seq_ce_weight > 0

Mode dropout trains a sample as fix-structure or fix-sequence: the
per-modality masks `struct_gen_mask` / `seq_gen_mask` then drop the
supervision of the modality that was visible.  `seq_sample_weight` (b,)
or (b, L) re-weights the sequence terms (KL and cross-entropy) only, as a
weighted mean (the self-conditioning schedule's sc_seq_loss_weight).
"""

from __future__ import annotations

from typing import Dict

import torch


def orientation_discrepancy(pred_rotmat, target_rotmat):
    """(..., 3, 3) R_pred^T R_target against the identity: squared error,
    mean over the 9 entries."""
    disc = torch.einsum("...ij,...ik->...jk", pred_rotmat, target_rotmat)
    eye = torch.eye(3, dtype=disc.dtype, device=disc.device)
    return ((disc - eye) ** 2).mean(dim=(-1, -2))


def kl_divergence_from_logits(pred_logits, target_probs):
    """KL(target || softmax(pred_logits)) summed over the last axis."""
    return kl_divergence_from_log_probs(torch.log_softmax(pred_logits, dim=-1), target_probs)


def kl_divergence_from_log_probs(pred_log_probs, target_probs):
    """KL(target || pred) summed over the last axis, pred as log-probs."""
    t = torch.clamp(target_probs, min=1e-12)
    return (target_probs * (torch.log(t) - pred_log_probs)).sum(dim=-1)


def diffab_losses(
    denoised: Dict[str, torch.Tensor],
    seq_log_posterior_pred,  # (b, L, K)
    seq_posterior_true,  # (b, L, K)
    translations_eps_true,  # (b, L, 3)
    orientations_t0_true,  # (b, L, 3, 3)
    generation_mask,  # (b, L) bool
    residue_mask,  # (b, L) bool
    seq_idx_t0_true=None,  # (b, L), for the cross-entropy term
    seq_ce_weight: float = 0.0,
    seq_sample_weight=None,  # (b,) or (b, L): weight of the sequence terms
    seq_gen_mask=None,  # (b, L): positions of the sequence terms
    struct_gen_mask=None,  # (b, L): positions of the geometry terms
) -> Dict[str, torch.Tensor]:
    """The DiffAb losses with the shared masked-mean reduction, the optional
    cross-entropy on p_hat(s_0), and their sum under "loss"."""
    f32 = torch.float32
    if struct_gen_mask is None:
        struct_gen_mask = generation_mask
    if seq_gen_mask is None:
        seq_gen_mask = generation_mask
    loss_mask = (struct_gen_mask & residue_mask).to(f32)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    seq_mask = (seq_gen_mask & residue_mask).to(f32)
    if seq_sample_weight is not None:
        w = seq_sample_weight.to(f32)
        seq_mask = seq_mask * (w if w.ndim == 2 else w[:, None])
    seq_denom = torch.clamp(seq_mask.sum(), min=1.0)

    seq_elem = kl_divergence_from_log_probs(seq_log_posterior_pred, seq_posterior_true)
    seq_loss = (seq_elem * seq_mask).sum() / seq_denom
    trans_elem = ((denoised["translations_eps"] - translations_eps_true) ** 2).sum(dim=-1)
    translations_loss = (trans_elem * loss_mask).sum() / denom
    orient_elem = 9.0 * orientation_discrepancy(denoised["orientations_t0"],
                                                orientations_t0_true)
    orientations_loss = (orient_elem * loss_mask).sum() / denom

    out = {"seq_loss": seq_loss, "translations_loss": translations_loss,
           "orientations_loss": orientations_loss}
    total = seq_loss + translations_loss + orientations_loss
    if seq_ce_weight > 0.0:
        if seq_idx_t0_true is None:
            raise ValueError("seq_ce_weight > 0 requires seq_idx_t0_true")
        log_p0 = torch.log_softmax(denoised["seq_logits"], dim=-1)
        ce_elem = -torch.gather(log_p0, -1, seq_idx_t0_true[..., None])[..., 0]
        seq_ce_loss = (ce_elem * seq_mask).sum() / seq_denom
        out["seq_ce_loss"] = seq_ce_loss
        total = total + seq_ce_weight * seq_ce_loss
    out["loss"] = total
    return out
