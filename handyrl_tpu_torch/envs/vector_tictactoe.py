"""Vectorized TicTacToe as batched tensor transitions on one device.

Counterpart of ``handyrl_tpu/envs/vector_tictactoe.py``: the host env's
rules (envs/tictactoe.py) as branch-free tensor ops, so a whole population
of games steps on the card, the substrate of episodic on-device self-play
(runtime/device_rollout.py ``DeviceRollout``).  Every game the device plays
replays legally through the host env with the same outcome
(tests/test_torch_device_rollout.py).

State (per game, batch-leading):
    cells  (B, 9) int8   0 empty / +1 first player / -1 second player
    winner (B,)   int8   0 none / +-1
Transitions are total: stepping a finished game leaves it as it is.
"""

from __future__ import annotations

import torch

from .tictactoe import WIN_LINES

NUM_ACTIONS = 9
MAX_STEPS = 9
NUM_PLAYERS = 2


class VectorTicTacToe:
    """Stateless namespace of batched transition functions.

    Turns strictly alternate (the first player moves at even steps), so the
    player to move is derived from the Python-int step index."""

    num_actions = NUM_ACTIONS
    max_steps = MAX_STEPS
    num_players = NUM_PLAYERS

    @staticmethod
    def init(n_games: int, device="cpu"):
        return {
            "cells": torch.zeros((n_games, 9), dtype=torch.int8, device=device),
            "winner": torch.zeros((n_games,), dtype=torch.int8, device=device),
        }

    @staticmethod
    def color(step: int) -> int:
        """Stone colour moving at ``step`` (the host's BLACK first)."""
        return 1 if step % 2 == 0 else -1

    @staticmethod
    def turn_player(step: int) -> int:
        return step % 2

    @staticmethod
    def observation(state, step: int):
        """(B, 3, 3, 3) planes of the turn player, as the host env's
        turn-player view: [ones, my stones, opponent stones]."""
        me = VectorTicTacToe.color(step)
        grid = state["cells"].view(-1, 3, 3)
        return torch.stack(
            [torch.ones(grid.shape, device=grid.device), (grid == me).float(), (grid == -me).float()],
            dim=1,
        )

    @staticmethod
    def legal_mask(state):
        """(B, 9) bool: the empty cells."""
        return state["cells"] == 0

    @staticmethod
    def terminal(state, step: int):
        """(B,) bool: games finished before step ``step`` plays."""
        if step >= MAX_STEPS:
            return torch.ones_like(state["winner"], dtype=torch.bool)
        return state["winner"] != 0

    @staticmethod
    def apply(state, actions, step: int):
        """Play ``actions`` (B,) for the step's turn player in every running
        game; finished games pass through unchanged."""
        me = VectorTicTacToe.color(step)
        live = ~VectorTicTacToe.terminal(state, step)
        place = (actions.unsqueeze(-1) == torch.arange(9, device=actions.device)) & live[:, None]
        cells = torch.where(place, torch.full_like(state["cells"], me), state["cells"])
        lines = cells[:, torch.as_tensor(WIN_LINES, device=cells.device)]   # (B, 8, 3)
        won = (lines.sum(dim=-1) == 3 * me).any(dim=-1) & live
        winner = torch.where(won, torch.full_like(state["winner"], me), state["winner"])
        return {"cells": cells, "winner": winner}

    @staticmethod
    def outcome(state):
        """(B, 2) fp32 per-player scores, ordered as the host's players()."""
        w = state["winner"].float()
        return torch.stack([w, -w], dim=1)
