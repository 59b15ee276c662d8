"""The DiffAb training harness (`diffab_pytorch_tpu/train/harness.py`):
forward noising, the loss, the optimizer, the train and eval steps.

The harness owns the model, the schedule and the IGSO(3) tables; the
training state is an explicit `TrainState` (step, parameters, optimizer
moments, EMA).  The model runs on the state's parameters through
`torch.func.functional_call`, so one model serves any state.  Every random
number of a step is in a `StepDraws` (timesteps, the mode-dropout uniform,
the three forward draws and, for a self-conditioned model, the
conditioning uniform): drawn from a `torch.Generator`, or injected by a
test that feeds the JAX package the same numbers.

A self-conditioned model trains in two passes inside one parametrisation
by the state's parameters (`DiffAbModel.forward(self_condition=...)`): the
context encoded once, a first denoise without gradients, its estimate
x0_hat (unclipped) and p(s_0) fed to the second for the samples (or
residues) whose uniform falls below the schedule's rate at the step.

The update is the JAX harness's optax chain, written out because
`torch.optim.Adam` cannot place a clip between its normalization and its
learning rate: global-norm clip -> Adam (optax's bias correction, eps
outside the square root) -> per-parameter update-RMS clip
(`clip_by_block_rms`) -> decoupled weight decay -> learning rate from the
schedule at the pre-update count; then the EMA blend
d * ema + (1 - d) * params.  Parameters, moments and EMA are updated in
place, which keeps one copy of each on the card.

Metric names are the JAX package's: {train,val}/{seq_loss,
translations_loss, orientations_loss, seq_ce_loss, loss}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch
from torch.func import functional_call

from diffab_pytorch_tpu_torch.config import DiffAbConfig, resolve_device
from diffab_pytorch_tpu_torch.data.batch import ProteinBatch
from diffab_pytorch_tpu_torch.diffusion import coordinate, orientation, sequence
from diffab_pytorch_tpu_torch.diffusion.orientation import make_orientation_tables
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule
from diffab_pytorch_tpu_torch.geometry.igso3 import AxisAngleNoise
from diffab_pytorch_tpu_torch.models.diffab import DiffAbModel
from diffab_pytorch_tpu_torch.train.losses import diffab_losses
from diffab_pytorch_tpu_torch.weights import init_parameters

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    """Adam state: the update count and the first and second moments, by
    parameter name."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # float32 leaves with requires_grad, updated in place
    opt_state: OptState
    ema_params: Params | None = None  # None when ema_decay == 0


class StepDraws(NamedTuple):
    """The random numbers of one loss evaluation on a (b, L) batch."""

    t: torch.Tensor  # (b,) int64 in [1, T]
    mode_u: torch.Tensor  # (b,) uniform in [0, 1), read when mode_dropout > 0
    gumbel: torch.Tensor  # (b, L, K) sequence forward draw
    coord: torch.Tensor  # (b, L, 3) coordinate noise eps
    orientation: AxisAngleNoise  # (b, L) axis-angle draw
    # (b,) or (b, L) uniform in [0, 1): the self-conditioning draw, drawn
    # only for a self-conditioned model
    sc_u: torch.Tensor | None = None

    def to(self, device) -> "StepDraws":
        return StepDraws(*(x.to(device) for x in self[:4]),
                         AxisAngleNoise(*(a.to(device) for a in self.orientation)),
                         None if self.sc_u is None else self.sc_u.to(device))


class NoisedSample(NamedTuple):
    t: torch.Tensor  # (b,)
    beta: torch.Tensor  # (b,)
    seq_idx_t: torch.Tensor  # (b, L)
    seq_posterior: torch.Tensor  # (b, L, K), the KL target
    translations_t: torch.Tensor  # (b, L, 3)
    translations_eps: torch.Tensor  # (b, L, 3), the MSE target
    orientations_t: torch.Tensor  # (b, L, 3, 3)


class DiffAb:
    """Model, schedule, IGSO(3) tables and optimizer settings of one
    training configuration, on the card unless `device` names another."""

    def __init__(self, config: DiffAbConfig | None = None, device=None):
        self.config = config or DiffAbConfig()
        p = self.config.train.mode_dropout
        if not 0.0 <= p <= 0.5:
            raise ValueError(
                f"TrainConfig.mode_dropout must be in [0, 0.5] (got {p}): the two "
                "fixed-modality tasks each take probability p out of [0, 2p)")
        t = self.config.train
        if t.lr_decay_steps > 0 and t.lr_decay_steps <= t.lr_warmup_steps:
            raise ValueError("lr_decay_steps includes the warmup and must exceed "
                             f"lr_warmup_steps ({t.lr_decay_steps} <= {t.lr_warmup_steps})")
        self.device = resolve_device(device)
        self.model = DiffAbModel(self.config.model, device=self.device)
        d = self.config.diffusion
        self.sched = cosine_variance_schedule(d.T, s=d.s, beta_max=d.beta_max,
                                              device=self.device)
        self.orientation_tables = make_orientation_tables(
            self.sched, n_bins=d.igso3_n_bins, n_terms=d.igso3_n_terms,
            sigma_threshold=d.igso3_sigma_threshold)

    # ------------------------------------------------------------------
    def init(self, seed: int | torch.Generator) -> TrainState:
        """A fresh state from a seeded init (`weights.init_parameters`, drawn
        on the CPU so one seed gives one model on any device): zero moments,
        EMA equal to the initial parameters."""
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        init_parameters(self.model, gen)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self.model.named_parameters()}
        zeros = lambda: {k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()}
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if self.config.train.ema_decay > 0 else None)
        return TrainState(step=0, params=params, opt_state=OptState(0, zeros(), zeros()),
                          ema_params=ema)

    def draw(self, batch: ProteinBatch, generator: torch.Generator) -> StepDraws:
        """One loss evaluation's random numbers, on the batch's device."""
        return self.draw_for(*batch.seq_idx.shape, generator, batch.seq_idx.device)

    def draw_for(self, b: int, L: int, generator: torch.Generator, device) -> StepDraws:
        """The random numbers of one loss evaluation on a (b, L) batch on
        `device` (the generator's device)."""
        kw = dict(generator=generator, device=device)
        u = torch.rand((b, L, self.config.model.aa_vocab_size), **kw)
        tiny = torch.finfo(u.dtype).tiny
        draws = StepDraws(
            t=torch.randint(1, self.config.diffusion.T + 1, (b,), **kw),
            mode_u=torch.rand((b,), **kw),
            gumbel=-torch.log(-torch.log(torch.clamp(u, min=tiny))),
            coord=torch.randn((b, L, 3), **kw),
            orientation=AxisAngleNoise.draw((b, L), generator, torch.float32, device),
        )
        if not self.config.model.self_conditioning:
            return draws
        shape = (b, L) if self.config.train.sc_per_residue else (b,)
        return draws._replace(sc_u=torch.rand(shape, **kw))

    # ------------------------------------------------------------------
    def add_noise(self, batch: ProteinBatch, draws: StepDraws,
                  seq_generation_mask=None, struct_generation_mask=None) -> NoisedSample:
        """All three forward diffusions at the drawn timesteps.  The two
        masks override which positions each modality noises (mode dropout);
        both default to the batch's generation mask."""
        sgm = batch.generation_mask if seq_generation_mask is None else seq_generation_mask
        stm = batch.generation_mask if struct_generation_mask is None else struct_generation_mask
        t = draws.t
        seq_idx_t, seq_posterior = sequence.diffuse_from_t0(
            self.sched, batch.seq_idx, t, sgm, self.config.model.aa_vocab_size,
            gumbel=draws.gumbel)
        translations_t, eps = coordinate.diffuse_from_t0(
            self.sched, batch.translations, t, stm, noise=draws.coord)
        orientations_t = orientation.diffuse_from_t0(
            self.orientation_tables, batch.orientations, t, stm, noise=draws.orientation)
        return NoisedSample(t=t, beta=self.sched.beta[t], seq_idx_t=seq_idx_t,
                            seq_posterior=seq_posterior, translations_t=translations_t,
                            translations_eps=eps, orientations_t=orientations_t)

    def sc_rate_at(self, step: int | None) -> float:
        """The self-conditioning rate at `step` (JAX `DiffAb._sc_rate`): 0
        until sc_onset_steps, then a linear ramp to sc_rate over
        sc_rate_warmup steps; step None (evaluation) gives sc_rate."""
        t = self.config.train
        if step is None or (t.sc_onset_steps == 0 and t.sc_rate_warmup == 0):
            return t.sc_rate
        prog = (step - t.sc_onset_steps) / max(t.sc_rate_warmup, 1)
        return t.sc_rate * min(max(prog, 0.0), 1.0)

    def loss_fn(self, params: Params, batch: ProteinBatch, draws: StepDraws,
                step: int | None = None):
        """One loss evaluation (JAX `DiffAb.loss_fn`): mode dropout, noise,
        encode, denoise (twice for a self-conditioned model, whose schedule
        reads `step`), losses.  Returns (loss, metrics)."""
        p = self.config.train.mode_dropout
        struct_visible = seq_visible = seq_gen = struct_gen = None
        if p > 0.0:
            u = draws.mode_u
            struct_visible = u < p  # fix-structure samples
            seq_visible = (u >= p) & (u < 2.0 * p)  # fix-sequence samples
            seq_gen = batch.generation_mask & ~seq_visible[:, None]
            struct_gen = batch.generation_mask & ~struct_visible[:, None]
        noised = self.add_noise(batch, draws, seq_gen, struct_gen)
        kwargs = dict(structure_visible=struct_visible, sequence_visible=seq_visible)
        sc_mask = None
        if self.config.model.self_conditioning:
            if draws.sc_u is None:
                raise ValueError("a self-conditioned model's StepDraws need sc_u")
            sc_mask = draws.sc_u < self.sc_rate_at(step)
            if struct_visible is not None:
                # no structure estimate where the geometry is given
                sv = struct_visible[:, None] if sc_mask.ndim == 2 else struct_visible
                sc_mask = sc_mask & ~sv
            kwargs["self_condition"] = lambda first: dict(
                sc_translations_x0=coordinate.predicted_x0(
                    self.sched, noised.translations_t, first["translations_eps"], draws.t),
                sc_seq_probs=first["seq_posterior"], sc_mask=sc_mask)
        denoised = functional_call(
            self.model, params,
            (batch, noised.seq_idx_t, noised.translations_t, noised.orientations_t,
             noised.beta), kwargs)
        seq_log_posterior_pred = sequence.log_posterior_from_predicted_t0(
            self.sched, noised.seq_idx_t, denoised["seq_posterior"], draws.t,
            batch.generation_mask if seq_gen is None else seq_gen)
        seq_w = None
        if sc_mask is not None and self.config.train.sc_seq_loss_weight != 1.0:
            seq_w = torch.where(sc_mask, self.config.train.sc_seq_loss_weight, 1.0)
        losses = diffab_losses(
            denoised, seq_log_posterior_pred, noised.seq_posterior,
            noised.translations_eps, batch.orientations, batch.generation_mask,
            batch.residue_mask, seq_idx_t0_true=batch.seq_idx,
            seq_ce_weight=self.config.train.seq_ce_weight,
            seq_sample_weight=seq_w, seq_gen_mask=seq_gen, struct_gen_mask=struct_gen)
        return losses["loss"], losses

    def loss_and_grads(self, params: Params, batch: ProteinBatch, draws: StepDraws,
                       step: int | None = None):
        """(loss, metrics, gradients by parameter name); a parameter the loss
        does not reach gets zeros, as under jax.grad."""
        loss, metrics = self.loss_fn(params, batch, draws, step)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True,
                                    materialize_grads=True)
        return loss, metrics, dict(zip(names, grads))

    # ------------------------------------------------------------------
    def learning_rate(self, count: int) -> float:
        """optax's warmup_cosine_decay_schedule / linear_schedule / constant
        at update count `count`."""
        t = self.config.train
        warm = t.lr_warmup_steps
        if t.lr_decay_steps > 0:
            if warm > 0 and count < warm:
                return -t.lr * (1.0 - count / warm) + t.lr
            span = t.lr_decay_steps - warm
            c = min(count - warm, span)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
            alpha = t.lr_min_ratio if t.lr != 0.0 else 0.0
            return t.lr * ((1.0 - alpha) * cosine + alpha)
        if warm > 0:
            return -t.lr * (1.0 - min(max(count, 0), warm) / warm) + t.lr
        return t.lr

    @torch.no_grad()
    def apply_gradients(self, state: TrainState, grads: Params) -> TrainState:
        """The optimizer update and the EMA blend, in place on the state's
        tensors; returns the state at step + 1.  Each stage runs on all
        parameters at once (`torch._foreach_*`), so the update is a few
        dozen launches rather than a dozen per parameter."""
        t = self.config.train
        names = list(state.params)
        params = [state.params[k] for k in names]
        mu = [state.opt_state.mu[k] for k in names]
        nu = [state.opt_state.nu[k] for k in names]
        g = [grads[k] for k in names]
        if t.grad_clip_norm > 0:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            scale = torch.where(g_norm < t.grad_clip_norm, torch.ones_like(g_norm),
                                t.grad_clip_norm / g_norm)
            g = torch._foreach_mul(g, scale)
        b1, b2 = t.betas
        count = state.opt_state.count + 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        # optax: (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
        den = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, t.adam_eps)
        u = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(u, den)
        if t.update_clip_rms > 0:
            rms = torch._foreach_mul(torch._foreach_norm(u),
                                     [1.0 / math.sqrt(x.numel()) for x in u])
            torch._foreach_div_(u, torch._foreach_clamp_min(
                torch._foreach_div(rms, t.update_clip_rms), 1.0))
        if t.weight_decay > 0:
            torch._foreach_add_(u, params, alpha=t.weight_decay)
        torch._foreach_add_(params, u, alpha=-self.learning_rate(state.opt_state.count))
        if state.ema_params is not None:
            ema = [state.ema_params[k] for k in names]
            torch._foreach_mul_(ema, t.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - t.ema_decay)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=OptState(count, state.opt_state.mu, state.opt_state.nu),
                          ema_params=state.ema_params)

    def train_step(self, state: TrainState, batch: ProteinBatch, draws: StepDraws):
        """Loss and gradients on the pre-update parameters, then the update;
        the self-conditioning schedule reads state.step.  Returns (state,
        {"train/...": 0-dim tensor}); reading a metric waits for the card."""
        _, metrics, grads = self.loss_and_grads(state.params, batch, draws, state.step)
        state = self.apply_gradients(state, grads)
        return state, {f"train/{k}": v.detach() for k, v in metrics.items()}

    def pool_train_step(self, state: TrainState, pool: ProteinBatch, idx: torch.Tensor,
                        draws: StepDraws):
        """`train_step` on rows `idx` ((b,) int64 on the pool's device) of a
        device-resident pool (`PatchDataset.device_pool` moved to the
        card): the rows are gathered on the card, so a step moves b
        indices to it instead of the batch's features.  On the same rows
        with the same draws it is `train_step` exactly."""
        return self.train_step(state, pool.gather_rows(idx), draws)

    @torch.no_grad()
    def eval_step(self, params: Params, batch: ProteinBatch, draws: StepDraws):
        """The loss without gradients; self-conditioning at the full rate."""
        _, metrics = self.loss_fn(params, batch, draws)
        return {f"val/{k}": v for k, v in metrics.items()}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _load(self, params: Params | None) -> None:
        if params is not None:
            self.model.load_state_dict(params)

    def sample(self, params: Params | None, batch: ProteinBatch,
               generator: torch.Generator | None = None, **kwargs):
        """Reverse-diffusion design or optimization (`sampling.sampler.sample`)
        with `params` loaded into the model (None: the model's own)."""
        from diffab_pytorch_tpu_torch.sampling.sampler import sample as _sample

        self._load(params)
        return _sample(self.model, self.sched, self.orientation_tables, batch,
                       generator=generator, device=self.device, **kwargs)

    def score_designs(self, params: Params | None, batch: ProteinBatch, designs,
                      generator: torch.Generator | None = None, **kwargs):
        """Likelihood-rank designs without ground truth
        (`sampling.scoring.score_designs`; lower is better, comparable
        within one target's designs) with `params` loaded into the model."""
        from diffab_pytorch_tpu_torch.sampling.scoring import score_designs as _score

        self._load(params)
        return _score(self.model, self.sched, self.orientation_tables, batch, designs,
                      generator=generator, device=self.device, **kwargs)
