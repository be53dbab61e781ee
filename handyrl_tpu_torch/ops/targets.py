"""Off-policy return/advantage targets (Monte Carlo, TD(lambda), UPGO, V-Trace).

Counterpart of ``handyrl_tpu/ops/targets.py``; the JAX package's reverse
``lax.scan``s are Python loops over T here.  All tensors are (B, T, P, C).
``lambda_ = lmb + (1 - lmb) * (1 - mask)``: unobserved steps pass the
bootstrap straight through.  The final-step bootstrap is ``returns[:, -1]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def monte_carlo(values, returns):
    return returns, returns - values


def _reverse_lambda(values, returns, rewards, lambda_, gamma, mix):
    """targets[t] = r[t] + gamma * mix(v[t+1], (1 - lam) v[t+1] + lam targets[t+1])."""
    T = values.shape[1]
    carry = returns[:, -1]
    ys = [carry]
    for t in range(T - 2, -1, -1):
        v1, lam = values[:, t + 1], lambda_[:, t + 1]
        tv = gamma * mix(v1, (1 - lam) * v1 + lam * carry)
        carry = tv if rewards is None else rewards[:, t] + tv
        ys.append(carry)
    targets = torch.stack(ys[::-1], dim=1)
    return targets, targets - values


def td_lambda(values, returns, rewards, lambda_, gamma):
    return _reverse_lambda(values, returns, rewards, lambda_, gamma, lambda v1, mixed: mixed)


def upgo(values, returns, rewards, lambda_, gamma):
    """UPGO: bootstrap from max(V, lambda-mixture)."""
    return _reverse_lambda(values, returns, rewards, lambda_, gamma, torch.maximum)


def vtrace(values, returns, rewards, lambda_, gamma, rhos, cs):
    """V-Trace targets and advantages (arXiv:1802.01561)."""
    r = rewards if rewards is not None else torch.zeros_like(values)
    bootstrap = returns[:, -1:]
    v_next = torch.cat([values[:, 1:], bootstrap], dim=1)
    deltas = rhos * (r + gamma * v_next - values)

    T = values.shape[1]
    carry = deltas[:, -1]
    ys = [carry]
    for t in range(T - 2, -1, -1):
        carry = deltas[:, t] + gamma * lambda_[:, t + 1] * cs[:, t] * carry
        ys.append(carry)
    vs = torch.stack(ys[::-1], dim=1) + values
    vs_next = torch.cat([vs[:, 1:], bootstrap], dim=1)
    return vs, r + gamma * vs_next - values


def compute_target(
    algorithm: str,
    values: Optional[torch.Tensor],
    returns: torch.Tensor,
    rewards: Optional[torch.Tensor],
    lmb: float,
    gamma: float,
    rhos: torch.Tensor,
    cs: torch.Tensor,
    masks: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on MC / TD / UPGO / VTRACE.  Without a value baseline, Monte
    Carlo returns are target and advantage."""
    if values is None:
        return returns, returns
    if algorithm == "MC":
        return monte_carlo(values, returns)

    lambda_ = lmb + (1 - lmb) * (1 - masks)

    if algorithm == "TD":
        return td_lambda(values, returns, rewards, lambda_, gamma)
    if algorithm == "UPGO":
        return upgo(values, returns, rewards, lambda_, gamma)
    if algorithm == "VTRACE":
        return vtrace(values, returns, rewards, lambda_, gamma, rhos, cs)
    raise ValueError(f"unknown target algorithm {algorithm!r}")
