"""Where the benchmark meets the port (`diffab_pytorch_tpu_torch`): its
configuration from a configuration file, its harness with the benchmark's
weights, its kernel build and its launch counter.  Nothing else of the
port is read."""

from __future__ import annotations

import torch


def diffab_config(conf: dict):
    """The port's DiffAbConfig from a configuration file's groups."""
    from diffab_pytorch_tpu_torch import config as C

    train = dict(conf["train"])
    train["betas"] = tuple(train["betas"])
    data = dict(conf["data"])
    data["cdrs_to_generate"] = tuple(data["cdrs_to_generate"])
    return C.DiffAbConfig(model=C.ModelConfig(**conf["model"]),
                          diffusion=C.DiffusionConfig(**conf["diffusion"]),
                          data=C.DataConfig(**data), train=C.TrainConfig(**train))


def build_kernels(device) -> None:
    """Build (first run) or load the port's CUDA kernels."""
    if device.type == "cuda":
        from diffab_pytorch_tpu_torch.ops import _build

        _build.build_all()


def harness(conf: dict, device):
    from diffab_pytorch_tpu_torch.train.harness import DiffAb

    return DiffAb(diffab_config(conf), device=device)


def param_shapes(h) -> dict:
    return {n: tuple(p.shape) for n, p in h.model.named_parameters()}


@torch.no_grad()
def load_params(h, params: dict) -> None:
    for n, p in h.model.named_parameters():
        p.copy_(params[n])


def k1_launches() -> int:
    """K1 launches booked so far (a captured graph's on every replay)."""
    from diffab_pytorch_tpu_torch.ops.ipa_fused_layer import fused_ipa_layer_packed

    return fused_ipa_layer_packed.launches


def train_state(h, params: dict):
    """A fresh training state on the benchmark's weights: zero moments, the
    EMA at the weights."""
    from diffab_pytorch_tpu_torch.train.harness import OptState, TrainState

    p = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    zeros = lambda: {n: torch.zeros_like(v) for n, v in params.items()}
    ema = {n: v.detach().clone() for n, v in params.items()} if h.config.train.ema_decay > 0 \
        else None
    return TrainState(step=0, params=p, opt_state=OptState(0, zeros(), zeros()), ema_params=ema)
