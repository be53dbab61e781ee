"""Shared helpers of the device-resident (vector) envs.

Counterpart of ``handyrl_tpu/envs/vector_common.py``, plus the random draws
the twins take.  A twin's state is a flat dict of tensors on one device,
lanes leading; its random numbers come from an explicit
``torch.Generator`` on that device, where the JAX twins take a key.  Each
twin draws through its own module-level names (``_uniform``, ``_gumbel``,
``_bernoulli``) bound to the functions below, so a test can replace them
with the JAX package's draws for the same key splits.
"""

from __future__ import annotations

import torch

# the smallest normal fp32: JAX draws its Gumbel uniforms from [tiny, 1)
TINY = torch.finfo(torch.float32).tiny


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1)."""
    return torch.rand(shape, generator=gen, device=device)


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u clamped to [tiny, 1) as
    ``jax.random.gumbel`` draws it (u = 0 would give -inf)."""
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=TINY)
    return -torch.log(-torch.log(u))


def bernoulli(gen: torch.Generator, shape, device, p: float = 0.5) -> torch.Tensor:
    """bool draws, True with probability ``p`` (``jax.random.bernoulli``:
    a uniform below ``p``)."""
    return torch.rand(shape, generator=gen, device=device) < p


def one_hot(index: torch.Tensor, n: int, dtype=torch.int8) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) (-1 for an absent cell)
    gives a row of zeros, where ``F.one_hot`` would raise."""
    return (index.unsqueeze(-1) == torch.arange(n, device=index.device)).to(dtype)


def reset_where_done(fresh, state):
    """Per-lane select: lanes flagged ``done`` in ``state`` take the
    ``fresh`` (re-initialised) leaves, the others pass through; the
    streaming auto-reset (runtime/device_rollout.py)."""
    done = state["done"]
    return {
        key: torch.where(done.view((-1,) + (1,) * (old.dim() - 1)), fresh[key], old)
        for key, old in state.items()
    }
