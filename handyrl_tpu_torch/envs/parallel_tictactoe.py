"""Parallel (simultaneous-move) Tic-Tac-Toe.

The port's copy of ``handyrl_tpu/envs/parallel_tictactoe.py``: both players
submit an action every step, and one of the submitted actions, chosen
uniformly with ``random``, is played for its submitter.  It exercises the
simultaneous-move path (``turns()`` lists every player) with TicTacToe's
net.  The device twin (``vector_env``) is not ported.
"""

from __future__ import annotations

import random

import numpy as np

from .tictactoe import COLS, LINES_THROUGH, ROWS, WIN_LINES
from .tictactoe import Environment as TicTacToe


class Environment(TicTacToe):
    _COLOR_CHAR = {1: "O", -1: "X"}

    def __str__(self):
        grid = self.cells.reshape(3, 3)
        lines = ["  " + " ".join(COLS)]
        for r in range(3):
            lines.append(ROWS[r] + " " + " ".join(self._GLYPH[int(v)] for v in grid[r]))
        return "\n".join(lines)

    def step(self, actions):
        chooser = random.choice(list(actions.keys()))
        self._apply(actions[chooser], chooser)

    def _apply(self, action, player):
        color = (self.BLACK, self.WHITE)[player]
        self.cells[action] = color
        if any(self.cells[line].sum() == 3 * color for line in WIN_LINES[LINES_THROUGH[action]]):
            self.winner = color
        self.history.append((color, action))

    def diff_info(self, player=None):
        if not self.history:
            return ""
        color, action = self.history[-1]
        return self.action2str(action) + ":" + self._COLOR_CHAR[color]

    def update(self, info, reset):
        if reset:
            self.reset()
        else:
            move, glyph = info.split(":")
            self._apply(self.str2action(move), "OX".index(glyph))

    def turn(self):
        raise NotImplementedError("simultaneous game: use turns()")

    def turns(self):
        return self.players()

    def observation(self, player=None):
        """Per-player view: [a plane of ones (every player acts), my stones,
        the opponent's]."""
        color = self.BLACK if player in (None, 0) else self.WHITE
        grid = self.cells.reshape(3, 3)
        return np.stack(
            [np.ones((3, 3)), grid == color, grid == -color]
        ).astype(np.float32)


if __name__ == "__main__":
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p)) for p in e.turns()})
        print(e)
        print(e.outcome())
