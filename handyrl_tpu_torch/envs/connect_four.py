"""Connect Four: two players, turn-based, gravity drops on a 6x7 board.

The port's copy of the host environment of ``examples/connect_four.py``
(actions 0..6 = columns, '1'..'7' strings, three (6, 7) observation
planes, delta sync by the last column played), registered as ``env:
ConnectFour``.  Its net is ``SimpleConvNet(filters=48, blocks=4,
num_actions=7)``.  Its device twin is lifted from the pure numpy rules
``ConnectFourRules`` by ``envs/autovec.py``: there is no hand-written one.

    python -m handyrl_tpu_torch.envs.connect_four   # random self-play games
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from .base import BaseEnvironment

ROWS, COLS = 6, 7
CONNECT = 4


class Environment(BaseEnvironment):
    """Two-player gravity-drop four-in-a-row on a 6x7 board."""

    def __init__(self, args=None):
        super().__init__(args)
        self.reset()

    # -- core state ---------------------------------------------------------

    def reset(self, args=None):
        self.board = np.zeros((ROWS, COLS), np.int8)  # 0 empty, 1 / -1 stones
        self.color = 1
        self.win_color = 0
        self.moves: List[int] = []
        return None

    def play(self, action, player=None):
        col = int(action)
        row = int(np.count_nonzero(self.board[:, col] == 0)) - 1
        self.board[row, col] = self.color
        self.moves.append(col)
        if self._wins(row, col):
            self.win_color = self.color
        self.color = -self.color
        return None

    def _wins(self, row: int, col: int) -> bool:
        c = self.board[row, col]
        for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
            run = 1
            for sgn in (1, -1):
                r, q = row + sgn * dr, col + sgn * dc
                while 0 <= r < ROWS and 0 <= q < COLS and self.board[r, q] == c:
                    run += 1
                    r += sgn * dr
                    q += sgn * dc
            if run >= CONNECT:
                return True
        return False

    def terminal(self) -> bool:
        return self.win_color != 0 or len(self.moves) == ROWS * COLS

    def outcome(self) -> Dict[int, float]:
        if self.win_color == 0:
            return {0: 0.0, 1: 0.0}
        winner = 0 if self.win_color == 1 else 1
        return {winner: 1.0, 1 - winner: -1.0}

    # -- interface ----------------------------------------------------------

    def players(self) -> List[int]:
        return [0, 1]

    def turn(self) -> int:
        return 0 if self.color == 1 else 1

    def legal_actions(self, player=None) -> List[int]:
        return [c for c in range(COLS) if self.board[0, c] == 0]

    def action2str(self, action, player=None) -> str:
        return str(int(action) + 1)

    def str2action(self, s, player=None) -> int:
        return int(s) - 1

    def observation(self, player=None):
        """(3, 6, 7) planes: own stones, opponent stones, side-to-move;
        ``player=None`` is the turn player's view."""
        if player is None:
            player = self.turn()
        mine = 1 if player == 0 else -1
        return np.stack([
            (self.board == mine).astype(np.float32),
            (self.board == -mine).astype(np.float32),
            np.full((ROWS, COLS), float(self.color == mine), np.float32),
        ])

    def rule_based_action(self, player=None, key=None) -> int:
        """Win in one if possible, else block, else random."""
        legal = self.legal_actions()
        for want in (self.color, -self.color):
            for col in legal:
                row = int(np.count_nonzero(self.board[:, col] == 0)) - 1
                self.board[row, col] = want
                won = self._wins(row, col)
                self.board[row, col] = 0
                if won:
                    return col
        return random.choice(legal)

    # -- network battle mode (delta sync) ------------------------------------

    def diff_info(self, player=None):
        return self.moves[-1] if self.moves else None

    def update(self, info, reset: bool):
        if reset:
            self.reset()
        if info is not None:
            self.play(info)

    # -- model hookup ---------------------------------------------------------

    def action_size(self) -> int:
        return COLS

    def default_net(self):
        from ..models import SimpleConvNet

        return SimpleConvNet(filters=48, blocks=4, num_actions=COLS, board=ROWS * COLS)

    @staticmethod
    def vector_env():
        """The device twin for on-device self-play (``device_rollout_games``):
        the autovec lift of ``ConnectFourRules`` (memoized)."""
        from .autovec import autovectorize

        return autovectorize(ConnectFourRules)

    def __str__(self) -> str:
        return "\n".join("".join(".XO"[v] for v in row) for row in self.board)


class ConnectFourRules:
    """Pure single-game numpy rules, the autovec source of the twin: the
    same rules as ``Environment``, written to the liftability contract
    (envs/autovec.py).  Turns strictly alternate, so the step index is a
    python int and turn math is plain python.

    State (one game): ``board`` (6, 7) int8 (0 empty / +1 first player /
    -1 second), ``winner`` () int8 (0 none / +-1).
    """

    num_actions = COLS
    max_steps = ROWS * COLS
    num_players = 2

    @staticmethod
    def _color(step: int) -> int:
        return 1 if step % 2 == 0 else -1

    @staticmethod
    def init():
        return {
            "board": np.zeros((ROWS, COLS), np.int8),
            "winner": np.zeros((), np.int8),
        }

    @staticmethod
    def observation(state, step: int):
        """(3, 6, 7) turn-player planes, the host ``observation()`` at
        acting time: own stones, opponent stones, side-to-move (always mine
        when acting)."""
        me = ConnectFourRules._color(step)
        board = state["board"]
        return np.stack(
            [
                (board == me).astype(np.float32),
                (board == -me).astype(np.float32),
                np.ones((ROWS, COLS), np.float32),
            ]
        )

    @staticmethod
    def legal_mask(state):
        """(7,) bool: the columns whose top cell is empty."""
        return state["board"][0, :] == 0

    @staticmethod
    def terminal(state, step: int):
        return (state["winner"] != 0) | (step >= ROWS * COLS)

    @staticmethod
    def _connects(stones):
        """Any 4-in-a-row in a (6, 7) bool plane, as sums of four shifted
        slices per direction (static shapes, no loops)."""
        s = stones.astype(np.int8)
        h = s[:, :-3] + s[:, 1:-2] + s[:, 2:-1] + s[:, 3:]
        v = s[:-3, :] + s[1:-2, :] + s[2:-1, :] + s[3:, :]
        d = s[:-3, :-3] + s[1:-2, 1:-2] + s[2:-1, 2:-1] + s[3:, 3:]
        u = s[3:, :-3] + s[2:-1, 1:-2] + s[1:-2, 2:-1] + s[:-3, 3:]
        return (
            (h == CONNECT).any()
            | (v == CONNECT).any()
            | (d == CONNECT).any()
            | (u == CONNECT).any()
        )

    @staticmethod
    def apply(state, action, step: int):
        """Gravity-drop ``action`` for the step's colour.  A full column
        (illegal, excluded by legal_mask) gives row -1, which the equality
        masks match nowhere, so the drop is a no-op (integer indexing
        ``board[row, action]`` would wrap -1 to the bottom row)."""
        me = ConnectFourRules._color(step)
        board = state["board"]
        empties = (board == 0).sum(axis=0)                    # (7,)
        row = empties[action] - 1
        cell = (np.arange(ROWS)[:, None] == row) & (np.arange(COLS)[None, :] == action)
        board = np.where(cell, np.int8(me), board)
        won = ConnectFourRules._connects(board == me)
        winner = np.where(won, np.int8(me), state["winner"]).astype(np.int8)
        return {"board": board, "winner": winner}

    @staticmethod
    def outcome(state):
        """(2,) float32 per-player scores, in the host ``outcome()``'s order."""
        w = state["winner"].astype(np.float32)
        return np.stack([w, -w])


if __name__ == "__main__":
    env = Environment()
    for _ in range(3):
        env.reset()
        while not env.terminal():
            env.play(random.choice(env.legal_actions()))
        print(env)
        print(env.outcome())
