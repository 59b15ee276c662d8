"""The backward of a forward-only kernel: differentiate its plain version.

The JAX package's custom VJPs around its TPU kernels recompute the
identical jnp computation under `jax.vjp` (`ipa_pallas.py _bwd_layer`,
`_bwd_raw`); `recompute_grads` is that backward for a
`torch.autograd.Function` whose forward launched a kernel.
"""

from __future__ import annotations

import torch


def recompute_grads(plain_fn, saved, needs_grad, grads_out, *args):
    """Gradients of `plain_fn(*saved, *args)` with respect to the saved
    tensors flagged in `needs_grad`, given the output cotangents
    `grads_out` (None for an output that received none); None elsewhere."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(saved, needs_grad)]
        outs = plain_fn(*leaves, *args)
    pairs = [(o, g) for o, g in zip(outs, grads_out)
             if g is not None and o.requires_grad]
    wanted = [leaf for leaf, n in zip(leaves, needs_grad) if n]
    if not pairs or not wanted:
        return tuple(None for _ in saved)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if n else None for n in needs_grad)
