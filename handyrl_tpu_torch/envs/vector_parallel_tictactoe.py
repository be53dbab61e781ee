"""Vectorized Parallel (simultaneous-move) Tic-Tac-Toe on one device.

Counterpart of ``handyrl_tpu/envs/vector_parallel_tictactoe.py``, driven by
the streaming device rollout (runtime/device_rollout.py).  The host rules
(envs/parallel_tictactoe.py): both players submit a legal move every step,
the submitter whose move is played is drawn uniformly and plays it in their
colour, and the game ends on a completed line or a full board.

State (per lane):
    cells        (B, 9) int8   0 empty / +1 player 0 / -1 player 1
    winner       (B,)   int8
    last_chooser (B,)   int8   whose action was played last step (-1 none)
    active       (B, P) bool   both players until the game ends
    done         (B,)   bool
"""

from __future__ import annotations

import numpy as np
import torch

from .tictactoe import WIN_LINES
from .vector_common import bernoulli as _bernoulli
from .vector_common import reset_where_done

NUM_PLAYERS = 2
NUM_ACTIONS = 9
COLORS = (1, -1)  # player index -> stone colour (the host's BLACK, WHITE)


class VectorParallelTicTacToe:
    """Stateless namespace of batched transition functions."""

    num_actions = NUM_ACTIONS
    num_players = NUM_PLAYERS
    max_steps = 9
    simultaneous = True

    @staticmethod
    def init(n_lanes: int, gen=None, device="cpu"):
        del gen  # the empty board is deterministic
        return {
            "cells": torch.zeros((n_lanes, 9), dtype=torch.int8, device=device),
            "winner": torch.zeros((n_lanes,), dtype=torch.int8, device=device),
            "last_chooser": torch.full((n_lanes,), -1, dtype=torch.int8, device=device),
            "active": torch.ones((n_lanes, NUM_PLAYERS), dtype=torch.bool, device=device),
            "done": torch.zeros((n_lanes,), dtype=torch.bool, device=device),
        }

    @staticmethod
    def reset_done(state, gen):
        fresh = VectorParallelTicTacToe.init(state["done"].shape[0], gen, state["done"].device)
        return reset_where_done(fresh, state)

    @staticmethod
    def observation(state):
        """(B, P, 3, 3, 3): per-player planes [ones (every player acts), my
        stones, opponent stones] (the host's observation())."""
        grid = state["cells"].view(-1, 1, 3, 3)
        colors = torch.tensor(COLORS, dtype=torch.int8, device=grid.device)[None, :, None, None]
        mine = (grid == colors).float()
        theirs = (grid == -colors).float()
        return torch.stack([torch.ones_like(mine), mine, theirs], dim=2)

    @staticmethod
    def legal_mask_all(state):
        """(B, P, 9) bool: the empty cells, the same for both players."""
        empty = state["cells"] == 0
        return empty[:, None, :].expand(empty.shape[0], NUM_PLAYERS, 9)

    @staticmethod
    def step(state, actions, gen):
        """Draw one submitter per lane and play their action in their colour
        (the host's step()); finished lanes pass through unchanged."""
        B = actions.shape[0]
        device = actions.device
        live = ~state["done"] & (state["winner"] == 0)
        chooser = _bernoulli(gen, (B,), device).long()              # 0/1
        action = torch.gather(actions.long(), 1, chooser[:, None])[:, 0]
        color = torch.where(chooser == 0, 1, -1).to(torch.int8)

        place = (action[:, None] == torch.arange(9, device=device)) & live[:, None]
        cells = torch.where(place, color[:, None], state["cells"])

        lines = cells[:, torch.as_tensor(WIN_LINES, device=device)]     # (B, 8, 3)
        won = (lines.sum(dim=-1) == 3 * color[:, None].long()).any(dim=-1) & live
        winner = torch.where(won, color, state["winner"])

        full = (cells != 0).all(dim=1)
        ended = (winner != 0) | full
        return {
            "cells": cells,
            "winner": winner,
            "last_chooser": torch.where(live, chooser.to(torch.int8), state["last_chooser"]),
            "active": (~ended)[:, None].expand(state["active"].shape),
            "done": state["done"] | ended,
        }

    # -- streaming-rollout hooks --------------------------------------------

    @staticmethod
    def record(state):
        return {"cells": state["cells"], "last_chooser": state["last_chooser"]}

    @staticmethod
    def outcome_scores(state):
        """(B, P): (+1, -1) for a player-0 win, (-1, +1) for player 1, zeros
        for a draw (the host's outcome())."""
        w = state["winner"].float()
        return torch.stack([w, -w], dim=1)

    @staticmethod
    def view_obs(compact, player):
        """One player's planes per row on the device: ``compact['cells']``
        (N, T, 9) and ``player`` (N,) -> (N, T, 3, 3, 3), the planes of
        observation()/episode_obs() for that player (the device replay's
        hook).  Unmasked: the caller applies the observation mask."""
        cells = compact["cells"].to(torch.int8)
        grid = cells.view(cells.shape[:2] + (3, 3))
        colors = torch.tensor(COLORS, dtype=torch.int8, device=cells.device)
        color = colors[player.long()][:, None, None, None]
        mine = (grid == color).float()
        theirs = (grid == -color).float()
        return torch.stack([torch.ones_like(mine), mine, theirs], dim=2)

    @staticmethod
    def episode_obs(compact, active):
        """(T, P, 3, 3, 3) from the recorded cells (numpy), mirroring
        observation()."""
        cells = compact["cells"].astype(np.int8)
        grid = cells.reshape(-1, 1, 3, 3)
        colors = np.asarray(COLORS, np.int8)[None, :, None, None]
        mine = (grid == colors).astype(np.float32)
        theirs = (grid == -colors).astype(np.float32)
        obs = np.stack([np.ones_like(mine), mine, theirs], axis=2)
        return obs * active[..., None, None, None]
