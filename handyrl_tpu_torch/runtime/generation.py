"""Self-play episode generation (actor side).

Counterpart of ``handyrl_tpu/runtime/generation.py``: per-turn inference
with per-player hidden state, legal-action masking (+1e32), softmax
sampling with Python's ``random``, immediate-reward collection and
discounted-return backfill.  Episodes come out columnar, in zlib-compressed
blocks of ``compress_steps`` steps, in the JAX package's byte format.

``models[player]`` is any object with ``inference(obs, hidden)`` and
``init_hidden()``: an ``InferenceModel`` (hidden stays on its device) or a
``RandomModel``.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import softmax, tree_map, tree_stack
from .replay import compress_block


def finalize_episode(rows, players, outcome, args, gen_args):
    """Columnar-finalize per-step rows into a compressed-block episode.

    ``rows`` are per-step dicts of per-player values (None = absent) with
    keys obs/prob/amask/action/value/reward plus a scalar "turn" index;
    ``gen_args`` supplies gamma and compress_steps.
    """
    P, T = len(players), len(rows)
    gamma = gen_args["gamma"]

    # discounted return-to-go per player
    returns = np.zeros((T, P), np.float32)
    for j, p in enumerate(players):
        acc = 0.0
        for t in range(T - 1, -1, -1):
            acc = (rows[t]["reward"][p] or 0.0) + gamma * acc
            returns[t, j] = acc

    obs_template = tree_map(
        np.zeros_like,
        next(o for row in rows for o in row["obs"].values() if o is not None),
    )
    amask_template = np.full_like(
        next(a for row in rows for a in row["amask"].values() if a is not None), 1e32
    )

    block_len = gen_args["compress_steps"]
    blocks = []
    for lo in range(0, T, block_len):
        chunk = rows[lo : lo + block_len]
        t = len(chunk)
        cols = {
            "prob": np.ones((t, P), np.float32),
            "action": np.zeros((t, P), np.int32),
            "amask": np.tile(amask_template, (t, P) + (1,) * amask_template.ndim),
            "value": np.zeros((t, P), np.float32),
            "reward": np.zeros((t, P), np.float32),
            "ret": returns[lo : lo + t],
            "tmask": np.zeros((t, P), np.float32),
            "omask": np.zeros((t, P), np.float32),
            "turn": np.asarray([row["turn"] for row in chunk], np.int32),
        }
        obs_leaves = []
        for i, row in enumerate(chunk):
            for j, p in enumerate(players):
                if row["obs"][p] is not None:
                    cols["omask"][i, j] = 1.0
                if row["value"][p] is not None:
                    cols["value"][i, j] = row["value"][p]
                if row["reward"][p] is not None:
                    cols["reward"][i, j] = row["reward"][p]
                if row["prob"][p] is not None:
                    cols["tmask"][i, j] = 1.0
                    cols["prob"][i, j] = row["prob"][p]
                    cols["action"][i, j] = row["action"][p]
                    cols["amask"][i, j] = row["amask"][p]
            obs_leaves.append(
                [row["obs"][p] if row["obs"][p] is not None else obs_template for p in players]
            )
        # [[tree per player] per step] -> tree with (t, P, ...) leaves
        cols["obs"] = tree_stack([tree_stack(step) for step in obs_leaves])
        blocks.append(compress_block(cols))

    return {
        "args": args,
        "steps": T,
        "players": players,
        "outcome": outcome,
        "blocks": blocks,
    }


class Generator:
    def __init__(self, env, args: Dict[str, Any]):
        self.env = env
        self.args = args

    def generate(self, models: Dict[int, Any], args: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        env = self.env
        players: List[int] = env.players()
        hidden = {p: models[p].init_hidden() for p in players}

        if env.reset():
            return None

        rows = []  # per-step dicts of per-player values (None = absent)
        while not env.terminal():
            row = {
                key: {p: None for p in players}
                for key in ("obs", "prob", "amask", "action", "value", "reward")
            }
            turn_players = env.turns()
            observers = env.observers()
            actions: Dict[int, Optional[int]] = {}

            for player in players:
                if player not in turn_players and player not in observers:
                    continue
                if (
                    player not in turn_players
                    and player in args["player"]
                    and not self.args["observation"]
                ):
                    continue
                obs = env.observation(player)
                outputs = models[player].inference(obs, hidden[player])
                hidden[player] = outputs.get("hidden")
                row["obs"][player] = obs
                if outputs.get("value") is not None:
                    row["value"][player] = float(np.asarray(outputs["value"]).reshape(-1)[0])

                if player in turn_players:
                    logits = np.asarray(outputs["policy"], dtype=np.float32)
                    legal = env.legal_actions(player)
                    amask = np.full_like(logits, 1e32)
                    amask[legal] = 0.0
                    probs = softmax(logits - amask)
                    action = random.choices(legal, weights=probs[legal])[0]
                    row["prob"][player] = float(probs[action])
                    row["amask"][player] = amask
                    row["action"][player] = int(action)
                    actions[player] = action

            if env.step(actions):
                return None

            reward = env.reward()
            for p in players:
                row["reward"][p] = reward.get(p)
            row["turn"] = players.index(turn_players[0]) if turn_players else 0
            rows.append(row)

        if not rows:
            return None
        return finalize_episode(rows, players, env.outcome(), args, self.args)
