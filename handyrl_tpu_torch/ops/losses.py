"""Policy-gradient loss core (a pure function of net outputs + batch).

Counterpart of ``handyrl_tpu/ops/losses.py``: clipped importance sampling
(rho/c capped at 1), two-player zero-sum value symmetrisation, the outcome
bootstrap beyond episode end, separate policy/value target algorithms, the
smooth-L1 return loss and entropy regularisation with progress decay.
``stop_gradient`` is ``detach``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .targets import compute_target


def _huber(x, delta: float = 1.0):
    """Smooth-L1 (beta = 1)."""
    absx = x.abs()
    return torch.where(absx < delta, 0.5 * x * x / delta, absx - 0.5 * delta)


def entropy_from_logits(logits):
    """Categorical entropy over the last axis; safe with -1e32 legal masks."""
    ls = torch.log_softmax(logits, dim=-1)
    return -(ls.exp() * ls).sum(dim=-1)


def compute_loss_from_outputs(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, Any],
    args: Dict[str, Any],
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Losses of already-trimmed outputs/batch (burn-in removed).

    outputs['policy'] must already be turn-masked and legal-action-masked
    (parallel/train_step.forward_prediction).  Returns (losses incl.
    'total', data count = turn mask sum)."""
    actions = batch["action"]            # (B, T, P, 1) int
    emasks = batch["episode_mask"]       # (B, T, 1, 1)
    tmasks = batch["turn_mask"]          # (B, T, P, 1)
    omasks = batch["observation_mask"]   # (B, T, P, 1)

    log_behavior = torch.log(batch["selected_prob"].clamp(1e-16, 1.0)) * emasks
    log_pi = torch.log_softmax(outputs["policy"], dim=-1)
    log_target = torch.gather(log_pi, -1, actions.long()) * emasks

    log_rhos = log_target.detach() - log_behavior
    rhos = torch.exp(log_rhos)
    clipped_rhos = rhos.clamp(0.0, 1.0)
    cs = rhos.clamp(0.0, 1.0)

    outputs_nograd = {k: v.detach() for k, v in outputs.items()}
    value_target_masks = omasks

    if "value" in outputs_nograd:
        values_nograd = outputs_nograd["value"]
        if args["turn_based_training"] and values_nograd.shape[2] == 2:
            # two-player zero-sum: each player's value is averaged with the
            # negation of the opponent's
            values_opp = -torch.flip(values_nograd, dims=[2])
            omasks_opp = torch.flip(omasks, dims=[2])
            values_nograd = (values_nograd * omasks + values_opp * omasks_opp) / (
                omasks + omasks_opp + 1e-8
            )
            value_target_masks = (omasks + omasks_opp).clamp(0.0, 1.0)
        # beyond episode end the target value is the final outcome
        outputs_nograd["value"] = values_nograd * emasks + batch["outcome"] * (1 - emasks)

    lmb, gamma = args["lambda"], args["gamma"]
    value_args = (outputs_nograd.get("value"), batch["outcome"], None, lmb, 1.0, clipped_rhos, cs, value_target_masks)
    return_args = (outputs_nograd.get("return"), batch["return"], batch["reward"], lmb, gamma, clipped_rhos, cs, omasks)

    targets, advantages = {}, {}
    targets["value"], advantages["value"] = compute_target(args["value_target"], *value_args)
    targets["return"], advantages["return"] = compute_target(args["value_target"], *return_args)
    if args["policy_target"] != args["value_target"]:
        _, advantages["value"] = compute_target(args["policy_target"], *value_args)
        _, advantages["return"] = compute_target(args["policy_target"], *return_args)

    total_advantages = clipped_rhos * (advantages["value"] + advantages["return"])

    losses: Dict[str, torch.Tensor] = {}
    dcnt = tmasks.sum()

    losses["p"] = (-log_target * total_advantages.detach() * tmasks).sum()
    if "value" in outputs:
        losses["v"] = (((outputs["value"] - targets["value"]) ** 2) * omasks).sum() / 2
    if "return" in outputs:
        losses["r"] = (_huber(outputs["return"] - targets["return"]) * omasks).sum()

    entropy = entropy_from_logits(outputs["policy"]) * tmasks.sum(dim=-1)  # (B, T, P)
    losses["ent"] = entropy.sum()

    # progress is (B, T, 1): broadcasts over the player axis of entropy
    progress_decay = 1 - batch["progress"] * (1 - args["entropy_regularization_decay"])
    entropy_loss = (entropy * progress_decay).sum() * -args["entropy_regularization"]

    base = losses["p"] + losses.get("v", 0.0) + losses.get("r", 0.0)
    losses["total"] = base + entropy_loss
    return losses, dcnt
