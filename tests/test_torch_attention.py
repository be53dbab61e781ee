"""The port's masked attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  The JAX side
runs as its own tests run it: the Pallas kernel in interpret mode, and its
einsum reference.  The port's side is its plain version and the autograd
function around the kernel (which takes the plain version for CPU
tensors).  Tolerances: forward 1e-5 (fp32, the same arithmetic in another
summation order), gradients 1e-4 (the chunked recompute backward sums T
terms per key).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.flash_attention import (
    masked_attention_reference as jax_reference,
    masked_flash_attention as jax_flash,
)
# the module: the ops package exports the function under the same name
port = importlib.import_module("handyrl_tpu_torch.ops.flash_attention")

CASES = [
    (128, 1 << 30, 1.0),   # tile-aligned, no eviction, fully observed
    (128, 8, 0.7),         # ring eviction + sparse observation masks
    (100, 16, 0.7),        # ragged T
]


def _inputs(seed, B, T, H, D, observed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    key_mask = (rng.random((B, T)) < observed).astype(np.float32)
    slopes = (2.0 ** -np.arange(1, H + 1)).astype(np.float32)
    return q, k, v, key_mask, slopes


@pytest.mark.parametrize("T,window,observed", CASES)
def test_forward_matches_jax(T, window, observed):
    q, k, v, km, sl = _inputs(7, 2, T, 2, 16, observed)
    want_flash = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, km, sl)), window=window))
    want_ref = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v, km, sl)), window=window))
    tq = [torch.from_numpy(x) for x in (q, k, v, km, sl)]
    got_ref = port.masked_attention_reference(*tq, window=window).numpy()
    got_fn = port.masked_flash_attention(*tq, window=window).numpy()
    for got in (got_ref, got_fn):
        np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_flash, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,window,observed", CASES)
def test_gradients_match_jax(T, window, observed):
    q, k, v, km, sl = _inputs(9, 2, T, 2, 16, observed)

    def jloss(fn):
        return lambda q, k, v: (fn(q, k, v, jnp.asarray(km), jnp.asarray(sl), window=window) ** 2).sum()

    want_flash = jax.grad(jloss(jax_flash), argnums=(0, 1, 2))(q, k, v)
    want_ref = jax.grad(jloss(jax_reference), argnums=(0, 1, 2))(q, k, v)

    tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = port.masked_flash_attention(*tq, torch.from_numpy(km), torch.from_numpy(sl), window=window)
    (out ** 2).sum().backward()
    for t, wf, wr in zip(tq, want_flash, want_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wf), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wr), rtol=1e-4, atol=1e-4)


def test_backward_chunks_match_autograd_of_reference():
    """The recompute backward at a chunk that does not divide T (the JAX
    rule shrinks it to a divisor) equals autograd through the plain version."""
    q, k, v, km, sl = _inputs(3, 2, 60, 2, 16, 0.6)
    grads = []
    for fn in (
        lambda *a: port.masked_flash_attention(*a, window=12, blk_q=16),
        lambda *a: port.masked_attention_reference(*a, window=12),
    ):
        tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*tq, torch.from_numpy(km), torch.from_numpy(sl)) ** 2).sum().backward()
        grads.append([t.grad for t in tq])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
