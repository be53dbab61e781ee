"""On-device evaluation: batched net-vs-baseline matches on the card.

Counterpart of ``handyrl_tpu/runtime/device_eval.py``.  The host evaluator
(runtime/evaluation.py) plays one game per worker thread through per-step
inference calls.  This is its device twin for envs with a streaming vector
twin: N lanes play the NET (greedy argmax, the host Agent's temperature-0
choice) on designated seats against a scripted baseline on the others,
``rulebase`` through the twin's ``rule_based_action_all`` or ``random``
through Gumbel-max over the legal mask, with streaming auto-reset, and only
(done, outcome) per step comes back.  The host counts exact outcomes, so
the learner's win-rate books take them unchanged.

Seats: ``net_seat`` gives the net's seat per lane, round-robin, the batched
counterpart of the host evaluation's first/second patterns.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..envs.vector_common import gumbel as _gumbel
from ..utils import tree_map
from .device_rollout import _ModuleHolder, _lane_mask, _stack_records

ILLEGAL = 1e32


def build_eval_stream_fn(venv, module, n_lanes: int, k_steps: int, opponent: str = "rulebase"):
    """``fn(state, hidden, net_seat, gen) -> (state, hidden, record)``: step
    ``k_steps`` game steps over ``n_lanes`` auto-resetting matches.

    ``net_seat`` is a (B,) tensor, the seat the net plays in each lane
    (every other seat runs the baseline).  The record holds ``done``
    (K, B) and ``outcome`` (K, B, P), final scores where done, the
    streaming rollout's contract for these fields."""
    if opponent == "rulebase" and not hasattr(venv, "rule_based_action_all"):
        raise ValueError(
            f"{getattr(venv, '__name__', type(venv).__name__)} has no "
            "rule_based_action_all device twin; use opponent='random'"
        )
    if opponent not in ("rulebase", "random"):
        raise ValueError(f"device eval opponent must be rulebase|random, got {opponent!r}")
    P = venv.num_players

    def fn(state, hidden, net_seat, gen):
        records = []
        seats = torch.arange(P, device=net_seat.device)
        for _ in range(k_steps):
            reset = state["done"]
            state = venv.reset_done(state, gen)
            if hidden is not None:
                hidden = tree_map(lambda h: torch.where(_lane_mask(reset, h), 0.0, h), hidden)
            obs = venv.observation(state)                # leaves (B, P, ...)
            B = state["done"].shape[0]
            flat = tree_map(lambda x: x.reshape((B * P,) + x.shape[2:]), obs)
            h_flat = (None if hidden is None
                      else tree_map(lambda h: h.reshape((B * P,) + h.shape[2:]), hidden))
            out = module(flat, h_flat)
            if hidden is not None:
                # the hidden state advances for every seat every step, as
                # the host Agent's with observation=True
                hidden = tree_map(lambda h, nh: nh.reshape(h.shape).to(h.dtype),
                                  hidden, out["hidden"])
            logits = out["policy"].float().reshape(B, P, -1)
            legal = venv.legal_mask_all(state)           # (B, P, A)
            masked = torch.where(legal, logits, logits - ILLEGAL)
            net_act = torch.argmax(masked, dim=-1)       # greedy
            if opponent == "rulebase":
                opp_act = venv.rule_based_action_all(state, gen).long()
            else:
                g = _gumbel(gen, masked.shape, masked.device)
                opp_act = torch.argmax(torch.where(legal, g, float("-inf")), dim=-1)
            is_net = seats[None, :] == net_seat[:, None]
            actions = torch.where(is_net, net_act, opp_act)
            state = venv.step(state, actions, gen)
            records.append({"done": state["done"], "outcome": venv.outcome_scores(state)})
        return state, hidden, _stack_records(records)

    return fn


class DeviceEvaluator(_ModuleHolder):
    """Reusable evaluator: counts the net seat's outcomes over at least
    ``num_games`` finished matches, as {outcome: count} like the host
    evaluation's totals (so the win-rate books apply).  It runs a module of
    its own, on the card unless ``device`` says otherwise."""

    def __init__(self, venv, module, n_lanes: int, opponent: str = "rulebase",
                 k_steps: int = 32, device=None):
        # fail at construction, not at the first evaluate(): the eval
        # stream drives the streaming contract, which episodic twins
        # (VectorTicTacToe) lack
        if not (hasattr(venv, "reset_done") and hasattr(venv, "step")):
            raise ValueError(
                f"DeviceEvaluator needs a streaming vector env "
                f"(reset_done/step hooks); "
                f"{getattr(venv, '__name__', type(venv).__name__)} is "
                "episodic; use host eval workers for this env"
            )
        super().__init__(module, device)
        self.venv = venv
        self.n_lanes = n_lanes
        self.opponent = opponent
        self._fn = build_eval_stream_fn(venv, self.module, n_lanes, k_steps, opponent=opponent)
        # the net's seat per lane, round-robin: the batched first/second balance
        self._net_seat_host = np.arange(n_lanes) % venv.num_players
        self._net_seat = torch.as_tensor(self._net_seat_host, device=self.device)

    def evaluate(self, params, num_games: int, gen: Union[torch.Generator, int],
                 max_calls: int = 64) -> Dict[float, int]:
        """Load ``params`` (None: keep the module's weights) and play until
        ``num_games`` matches finish (or ``max_calls`` blocks); returns the
        exact outcome counts of the net's seat.  ``gen`` is a generator on
        the evaluator's device or a seed for one."""
        self.load(params)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))
        venv = self.venv
        seat = self._net_seat_host
        counts: Dict[float, int] = {}
        games = 0
        with torch.inference_mode():
            state = venv.init(self.n_lanes, gen, self.device)
            hidden = self.module.initial_state((self.n_lanes, venv.num_players), self.device)
            for _ in range(max_calls):
                state, hidden, rec = self._fn(state, hidden, self._net_seat, gen)
                # an epoch-boundary evaluation reads (done, outcome) on the
                # host by design, once per block
                done = rec["done"].cpu().numpy()           # (K, B)
                outcome = rec["outcome"].cpu().numpy()     # (K, B, P)
                ks, bs = np.nonzero(done)
                for k, b in zip(ks, bs):
                    o = float(outcome[k, b, seat[b]])
                    counts[o] = counts.get(o, 0) + 1
                    games += 1
                if games >= num_games:
                    break
        return counts
