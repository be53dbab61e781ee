"""The port's plain flash attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  The JAX side
runs as its own tests run it: the Pallas kernel in interpret mode, its
custom VJP, and ``full_attention_reference``.  The port's side is its plain
version and the autograd function around the kernel (which takes the plain
version for CPU tensors).  Tolerances: forward 1e-5 (fp32, the same
arithmetic in another summation order), bf16 2e-2 (8 bits of mantissa on
O(1) outputs), gradients 1e-4 (the chunked recompute backward sums T terms
per key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.flash_attention import flash_attention as jax_flash
from handyrl_tpu.ops.ring_attention import full_attention_reference as jax_reference
from handyrl_tpu_torch.ops import flash_attention, full_attention_reference


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 2, 16), (1, 256, 4, 64), (1, 100, 2, 24)])
def test_forward_matches_jax(causal, shape):
    q, k, v = _qkv(0, *shape)
    jq = [jnp.asarray(x) for x in (q, k, v)]
    want_flash = np.asarray(jax_flash(*jq, causal))
    want_ref = np.asarray(jax_reference(*jq, causal))
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    for got in (flash_attention(*tq, causal), full_attention_reference(*tq, causal)):
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_flash, rtol=1e-5, atol=1e-5)


def test_bf16():
    """bf16 inputs give a bf16 output, within 2e-2 of the JAX reference on
    the same bf16-rounded inputs."""
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 2, 128, 2, 32)]
    out = flash_attention(*tq, True)
    assert out.dtype == torch.bfloat16
    jq = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in tq]
    want = np.asarray(jax_reference(*jq, True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(2, 1, 128, 2, 16)
    want = jax.grad(lambda q, k, v: (jax_flash(q, k, v, causal) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v))
    )
    tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention(*tq, causal) ** 2).sum().backward()
    for t, w in zip(tq, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blk_q", [32, 128])
def test_backward_chunks_match_autograd_of_reference(causal, blk_q):
    """The recompute backward at a query chunk of 32 or 128 equals autograd
    through the port's own plain version."""
    q, k, v = _qkv(3, 2, 128, 2, 24)
    grads = []
    for fn in (
        lambda *a: flash_attention(*a, causal, blk_q=blk_q),
        lambda *a: full_attention_reference(*a, causal),
    ):
        tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*tq) ** 2).sum().backward()
        grads.append([t.grad for t in tq])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_ragged_tiles_raise_as_in_jax(package):
    """T = 100 does not divide into tiles of 64 (ValueError in both
    packages); the default 128 clamps to 100 and runs."""
    q, k, v = _qkv(4, 1, 100, 2, 16)
    if package == "jax":
        fn, args = jax_flash, [jnp.asarray(x) for x in (q, k, v)]
    else:
        fn, args = flash_attention, [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="must divide into tiles"):
        fn(*args, True, 64, 64)
    with pytest.raises(ValueError, match="must divide into tiles"):
        fn(*args, True, 128, 64)
    assert tuple(fn(*args, True).shape) == (1, 100, 2, 16)
