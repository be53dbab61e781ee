"""Tic-Tac-Toe: two players, turn-based, zero-sum.

The port's copy of the host environment of ``handyrl_tpu/envs/tictactoe.py``
(actions 0..8 = row * 3 + col, 'A1'-style strings, three 3x3 observation
planes), on a flat 9-cell board with a table of the winning lines.
``vector_env()`` returns its device twin (envs/vector_tictactoe.py).
"""

from __future__ import annotations

import numpy as np

from .base import BaseEnvironment

# the 8 winning index triples on the flat board
WIN_LINES = np.array(
    [
        [0, 1, 2], [3, 4, 5], [6, 7, 8],  # rows
        [0, 3, 6], [1, 4, 7], [2, 5, 8],  # cols
        [0, 4, 8], [2, 4, 6],             # diagonals
    ],
    dtype=np.int64,
)
LINES_THROUGH = [[i for i, line in enumerate(WIN_LINES) if a in line] for a in range(9)]

ROWS, COLS = "ABC", "123"


class Environment(BaseEnvironment):
    BLACK, WHITE = 1, -1
    _GLYPH = {0: "_", 1: "O", -1: "X"}

    def __init__(self, args=None):
        super().__init__(args)
        self.reset()

    def reset(self, args=None):
        self.cells = np.zeros(9, dtype=np.int8)
        self.to_move = self.BLACK
        self.winner = 0  # +1 black, -1 white, 0 none
        self.history: list[int] = []

    # -- codecs -------------------------------------------------------------

    def action2str(self, a, player=None):
        return ROWS[a // 3] + COLS[a % 3]

    def str2action(self, s, player=None):
        return ROWS.index(s[0]) * 3 + COLS.index(s[1])

    def __str__(self):
        grid = self.cells.reshape(3, 3)
        lines = ["  " + " ".join(COLS)]
        for r in range(3):
            lines.append(ROWS[r] + " " + " ".join(self._GLYPH[int(v)] for v in grid[r]))
        lines.append("record = " + " ".join(self.action2str(a) for a in self.history))
        return "\n".join(lines)

    # -- transitions --------------------------------------------------------

    def play(self, action, player=None):
        self.cells[action] = self.to_move
        if any(self.cells[line].sum() == 3 * self.to_move for line in WIN_LINES[LINES_THROUGH[action]]):
            self.winner = self.to_move
        self.to_move = -self.to_move
        self.history.append(action)

    # -- replica sync -------------------------------------------------------

    def diff_info(self, player=None):
        return self.action2str(self.history[-1]) if self.history else ""

    def update(self, info, reset):
        if reset:
            self.reset()
        else:
            self.play(self.str2action(info))

    # -- game state ---------------------------------------------------------

    def turn(self):
        return len(self.history) % 2

    def terminal(self):
        return self.winner != 0 or len(self.history) == 9

    def outcome(self):
        if self.winner == self.BLACK:
            return {0: 1, 1: -1}
        if self.winner == self.WHITE:
            return {0: -1, 1: 1}
        return {0: 0, 1: 0}

    def legal_actions(self, player=None):
        return np.flatnonzero(self.cells == 0).tolist()

    def players(self):
        return [0, 1]

    @staticmethod
    def vector_env():
        """The device-resident twin (batched tensor transitions), for
        episodic on-device self-play (runtime/device_rollout.py)."""
        from .vector_tictactoe import VectorTicTacToe

        return VectorTicTacToe

    def observation(self, player=None):
        """3 planes (C, 3, 3): [is-my-turn-view, my stones, opponent stones]."""
        my_view = player is None or player == self.turn()
        me = self.to_move if my_view else -self.to_move
        grid = self.cells.reshape(3, 3)
        return np.stack(
            [
                np.full((3, 3), 1.0 if my_view else 0.0),
                grid == me,
                grid == -me,
            ]
        ).astype(np.float32)

    def action_size(self):
        return 9

    def default_net(self):
        from ..models import SimpleConvNet

        return SimpleConvNet()
