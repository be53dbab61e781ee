"""Connect Four: two players, turn-based, gravity drops on a 6x7 board.

The port's copy of the host environment of ``examples/connect_four.py``
(actions 0..6 = columns, '1'..'7' strings, three (6, 7) observation
planes, delta sync by the last column played), registered as ``env:
ConnectFour``.  Its net is ``SimpleConvNet(filters=48, blocks=4,
num_actions=7)``.  The pure numpy rules the JAX package lifts into a device
twin (``ConnectFourRules``) are not ported.

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

    def __str__(self) -> str:
        return "\n".join("".join(".XO"[v] for v in row) for row in self.board)


if __name__ == "__main__":
    env = Environment()
    for _ in range(3):
        env.reset()
        while not env.terminal():
            env.play(random.choice(env.legal_actions()))
        print(env)
        print(env.outcome())
