"""The port's targets and loss against the JAX package's, on random batches
made with numpy from a seed.  fp32; tolerance 1e-5 relative (the reverse
recursions run the same operations in the same order), 1e-4 for the loss
sums over a whole batch and their gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.ops import compute_target as jax_target
from handyrl_tpu_torch.ops import compute_loss_from_outputs, compute_target

B, T, P, A = 3, 12, 2, 7


def _target_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    values, returns, rewards = f(B, T, P, 1), f(B, T, P, 1), f(B, T, P, 1)
    rhos = rng.uniform(0, 1, (B, T, P, 1)).astype(np.float32)
    cs = rng.uniform(0, 1, (B, T, P, 1)).astype(np.float32)
    masks = (rng.random((B, T, P, 1)) < 0.6).astype(np.float32)
    return values, returns, rewards, rhos, cs, masks


@pytest.mark.parametrize("algorithm", ["MC", "TD", "UPGO", "VTRACE"])
@pytest.mark.parametrize("with_rewards", [True, False])
def test_compute_target_matches_jax(algorithm, with_rewards):
    values, returns, rewards, rhos, cs, masks = _target_inputs(0)
    rewards = rewards if with_rewards else None
    want = jax_target(algorithm, values, returns, rewards, 0.7, 0.9, rhos, cs, masks)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = compute_target(algorithm, t(values), t(returns), t(rewards), 0.7, 0.9, t(rhos), t(cs), t(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_compute_target_without_baseline():
    values, returns, *_ = _target_inputs(1)
    r = torch.from_numpy(returns)
    got = compute_target("TD", None, r, None, 0.7, 0.9, None, None, None)
    assert got[0] is r and got[1] is r


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tmask = np.zeros((B, T, P, 1), np.float32)
    turn = rng.integers(0, P, (B, T))
    tmask[np.arange(B)[:, None], np.arange(T)[None], turn] = 1.0
    emask = np.ones((B, T, 1, 1), np.float32)
    emask[0, 8:] = 0.0
    amask = np.where(rng.random((B, T, P, A)) < 0.3, 1e32, 0.0).astype(np.float32)
    amask[..., 0] = 0.0
    outputs = {
        "policy": f(B, T, P, A) * tmask - amask,
        "value": np.tanh(f(B, T, P, 1)),
        "return": f(B, T, P, 1),
    }
    batch = {
        "action": rng.integers(0, A, (B, T, P, 1)).astype(np.int32) * (amask[..., :1] == 0),
        "selected_prob": rng.uniform(0.05, 1, (B, T, P, 1)).astype(np.float32),
        "episode_mask": emask,
        "turn_mask": tmask,
        "observation_mask": (rng.random((B, T, P, 1)) < 0.8).astype(np.float32),
        "outcome": rng.choice([-1.0, 0.0, 1.0], (B, 1, P, 1)).astype(np.float32),
        "return": f(B, T, P, 1),
        "reward": f(B, T, P, 1) * 0.01,
        "progress": np.linspace(0, 1, B * T, dtype=np.float32).reshape(B, T, 1),
    }
    return outputs, batch


@pytest.mark.parametrize("policy_target,value_target", [("TD", "TD"), ("UPGO", "VTRACE"), ("VTRACE", "MC")])
@pytest.mark.parametrize("turn_based", [True, False])
def test_loss_and_its_gradients_match_jax(policy_target, value_target, turn_based):
    outputs, batch = _loss_inputs(3)
    args = {"turn_based_training": turn_based, "lambda": 0.7, "gamma": 0.8,
            "policy_target": policy_target, "value_target": value_target,
            "entropy_regularization": 0.1, "entropy_regularization_decay": 0.1}

    def jtotal(outs):
        losses, dcnt = jax_loss(outs, jax.tree.map(jnp.asarray, batch), args)
        return losses["total"], (losses, dcnt)

    (_, (want, want_dcnt)), want_grads = jax.value_and_grad(jtotal, has_aux=True)(
        jax.tree.map(jnp.asarray, outputs))

    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    got, dcnt = compute_loss_from_outputs(touts, {k: torch.from_numpy(v) for k, v in batch.items()}, args)
    got["total"].backward()
    assert sorted(got) == sorted(want)
    assert dcnt.item() == float(want_dcnt)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    for k, t in touts.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grads[k]), rtol=1e-4, atol=1e-5, err_msg=k)
