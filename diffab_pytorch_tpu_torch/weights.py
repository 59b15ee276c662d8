"""Parameters: transplant from a JAX parameter tree (and an optax
optimizer state), and a seeded init.

The port's module tree mirrors the flax tree name for name, so the map is
by leaf name:
  Dense  kernel (in, out)   -> Linear.weight (out, in), transposed
  Dense  bias               -> Linear.bias
  Embed  embedding          -> Embedding.weight
  gamma (raw; softplus is applied in the forward pass) -> gamma
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from diffab_pytorch_tpu_torch.models.layers import Embedding, Linear


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A torch state dict from a JAX DiffAbModel parameter tree (nested
    dicts of arrays, with or without the top-level "params" key)."""
    if "params" in tree:
        tree = tree["params"]
    state = {}
    for path, leaf in _flatten(tree):
        *mods, name = path
        a = np.array(leaf, dtype=np.float32)
        if name == "kernel":
            name, a = "weight", a.T
        elif name == "embedding":
            name = "weight"
        elif name not in ("bias", "gamma"):
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        state[".".join([*mods, name])] = torch.from_numpy(np.ascontiguousarray(a))
    return state


def opt_state_from_jax(opt_state):
    """The port's Adam state (`train.harness.OptState`) from an optax chain
    state as the JAX harness builds it: a tuple holding one
    ScaleByAdamState (count, mu, nu) among empty and schedule states, or
    that state itself; arrays may be numpy.  mu and nu map by the same
    names and transposes as `params_from_jax`."""
    from diffab_pytorch_tpu_torch.train.harness import OptState

    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = [s for s in parts if all(hasattr(s, a) for a in ("count", "mu", "nu"))]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the chain, found {len(adam)}")
    (s,) = adam
    return OptState(count=int(np.asarray(s.count)), mu=params_from_jax(s.mu),
                    nu=params_from_jax(s.nu))


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Load a JAX parameter tree into `model` by name; any missing or
    unused key, or a shape mismatch, raises."""
    state = params_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"parameter transplant: missing {missing}, unused {unused}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: model shape {tuple(own[k].shape)}, tree "
                             f"shape {tuple(v.shape)}")
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the flax defaults: Dense kernels truncated-normal
    LeCun (std 1/sqrt(fan_in)), biases 0, embeddings normal with std
    1/sqrt(features), the distance-width table 0, gamma softplus^-1(1).
    Draws on the CPU, then copies, so one seed gives one model anywhere."""
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            fan_in = mod.weight.shape[1]
            # truncated at 2 std; 0.8796 is the std of that truncated normal
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embedding):
            if name.endswith("pair2distcoef"):
                mod.weight.zero_()
            else:
                w = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(w / math.sqrt(mod.weight.shape[1]))
        if hasattr(mod, "gamma") and isinstance(mod.gamma, nn.Parameter):
            mod.gamma.fill_(math.log(math.e - 1.0))
    return model
