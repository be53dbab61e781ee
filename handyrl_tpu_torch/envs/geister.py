"""Geister — 2-player imperfect-information board game.

Behavioral parity with reference handyrl/envs/geister.py:169-537: same action
encoding (move = dir*36 + square in the mover's rotated frame, with
direction order [up, left, right, down]; set = 144 + layout index into the
70 = C(8,4) blue-piece layouts), same per-step reward (-0.01 both players),
200-ply draw, win by goal escape / capturing all enemy blues / being fed all
enemy reds, and the same 18-scalar + 7-plane observation with a 180-degree
rotated view for White.

Implementation is piece-table based: parallel arrays ``pos``/``kind``/
``alive`` indexed by piece id (0-7 Black, 8-15 White) plus a board of piece
ids as the single source of truth, rather than the reference's
board-of-codes + counts bookkeeping.

The port's copy of ``handyrl_tpu/envs/geister.py``, rule for rule.  Its
default net is the DRC ``GeisterNet``; ``net: transformer`` picks the memory
transformer.  The device twin (``vector_env``) is not ported.
"""

from __future__ import annotations

import itertools
import random

import numpy as np

from .base import BaseEnvironment

BLACK, WHITE = 0, 1
BLUE, RED = 0, 1
SIZE = 6
NUM_MOVE_ACTIONS = 4 * SIZE * SIZE  # 144
NUM_SET_ACTIONS = 70

# Direction order matches the reference action encoding: up, left, right, down.
DIRS = np.array([(-1, 0), (0, -1), (0, 1), (1, 0)], dtype=np.int32)

# The 70 ways to pick which 4 of a player's 8 pieces are blue.
LAYOUTS = list(itertools.combinations(range(8), 4))

COL_CHARS, ROW_CHARS = "ABCDEF", "123456"

# Home squares (x, y) in placement order for each color.
_HOME = {
    BLACK: [(1, 1), (2, 1), (3, 1), (4, 1), (1, 0), (2, 0), (3, 0), (4, 0)],
    WHITE: [(4, 4), (3, 4), (2, 4), (1, 4), (4, 5), (3, 5), (2, 5), (1, 5)],
}

# Escape (goal) squares lie just off-board at each player's far corners.
_GOALS = {
    BLACK: ((-1, 5), (6, 5)),
    WHITE: ((-1, 0), (6, 0)),
}


def _on_board(x, y):
    return 0 <= x < SIZE and 0 <= y < SIZE


class Environment(BaseEnvironment):
    def __init__(self, args=None):
        super().__init__(args)
        self.reset()

    def reset(self, args=None):
        self.game_args = args or {}
        self.board = np.full((SIZE, SIZE), -1, dtype=np.int32)  # piece id or -1
        self.pos = np.full((16, 2), -1, dtype=np.int32)
        self.kind = np.zeros(16, dtype=np.int32)   # BLUE/RED (guess for hidden opponents)
        self.alive = np.zeros(16, dtype=bool)
        self.color = BLACK
        self.ply = -2                              # two placement plies before ply 0
        self.win_color = None                      # BLACK / WHITE / 2 (draw)
        self.moves: list[int] = []
        self.last_captured_kind = None
        self.layout_of = {}                        # color -> layout idx (-1 = hidden)
        # True remaining pieces per (color, kind).  Kept as explicit state —
        # NOT derived from guessed kinds — so replicas stay correct: every
        # layout has exactly 4 blue + 4 red, and captures are disclosed with
        # their true type, so these counts never rely on hidden information.
        self.counts = np.zeros((2, 2), dtype=np.int32)

    # -- coordinate/action codecs ------------------------------------------

    @staticmethod
    def _to_frame(p, color):
        """Map a board position into ``color``'s frame (White sees 180-rot)."""
        return (SIZE - 1 - p[0], SIZE - 1 - p[1]) if color == WHITE else (p[0], p[1])

    _from_frame = _to_frame  # the rotation is an involution

    @staticmethod
    def _frame_dir(d, color):
        return 3 - d if color == WHITE else d

    def _encode_move(self, board_pos, d, color):
        fx, fy = self._to_frame(board_pos, color)
        return self._frame_dir(d, color) * 36 + fx * 6 + fy

    def _decode_move(self, action, color):
        sq, d = action % 36, action // 36
        src = self._from_frame((sq // 6, sq % 6), color)
        d = self._frame_dir(d, color)
        dst = (src[0] + int(DIRS[d][0]), src[1] + int(DIRS[d][1]))
        return src, dst, d

    def action2str(self, a, player=None):
        if a >= NUM_MOVE_ACTIONS:
            return "s%d" % (a - NUM_MOVE_ACTIONS)
        src, dst, _ = self._decode_move(a, player)
        return self._pos_str(src) + self._pos_str(dst)

    def str2action(self, s, player=None):
        if s.startswith("s"):
            return NUM_MOVE_ACTIONS + int(s[1:])
        src = self._str_pos(s[:2])
        dst = self._str_pos(s[2:])
        if dst is None:  # goal escape: the unique goal square adjacent to src
            dst = next(
                g for g in _GOALS[player]
                if abs(g[0] - src[0]) + abs(g[1] - src[1]) == 1
            )
        delta = (dst[0] - src[0], dst[1] - src[1])
        d = next(i for i, dd in enumerate(DIRS) if (int(dd[0]), int(dd[1])) == delta)
        return self._encode_move(src, d, player)

    @staticmethod
    def _pos_str(p):
        return COL_CHARS[p[0]] + ROW_CHARS[p[1]] if _on_board(*p) else "**"

    @staticmethod
    def _str_pos(s):
        if s == "**":
            return None
        return (COL_CHARS.index(s[0]), ROW_CHARS.index(s[1]))

    # -- display ------------------------------------------------------------

    def __str__(self):
        glyphs = {(BLACK, BLUE): "B", (BLACK, RED): "R", (WHITE, BLUE): "b", (WHITE, RED): "r"}
        rows = ["  " + " ".join(ROW_CHARS)]
        for x in range(SIZE):
            cells = []
            for y in range(SIZE):
                pid = self.board[x, y]
                if pid < 0:
                    cells.append("_")
                else:
                    c = pid // 8
                    cells.append(glyphs[(c, int(self.kind[pid]))] if self.layout_of.get(c, -1) >= 0 else "*")
            rows.append(COL_CHARS[x] + " " + " ".join(cells))
        counts = self._piece_counts()
        rows.append(
            "remained = B:%d R:%d b:%d r:%d"
            % (counts[BLACK][BLUE], counts[BLACK][RED], counts[WHITE][BLUE], counts[WHITE][RED])
        )
        rows.append("turn = %-3d color = %s" % (self.ply, "BW"[self.color]))
        return "\n".join(rows)

    def _piece_counts(self):
        return {BLACK: list(self.counts[BLACK]), WHITE: list(self.counts[WHITE])}

    # -- transitions --------------------------------------------------------

    def _place(self, layout):
        """Apply a set action for the current color (layout < 0 = hidden/random)."""
        self.layout_of[self.color] = layout
        blues = set(LAYOUTS[layout if layout >= 0 else random.randrange(NUM_SET_ACTIONS)])
        for i, square in enumerate(_HOME[self.color]):
            pid = self.color * 8 + i
            self.pos[pid] = square
            self.kind[pid] = BLUE if i in blues else RED
            self.alive[pid] = True
            self.board[square] = pid
        self.counts[self.color] = (4, 4)
        self.color ^= 1
        self.ply += 1

    def _capture(self, pid):
        self.board[tuple(self.pos[pid])] = -1
        self.pos[pid] = (-1, -1)
        self.alive[pid] = False
        self.counts[pid // 8, int(self.kind[pid])] -= 1

    def play(self, action, player=None):
        if self.ply < 0:
            return self._place(action - NUM_MOVE_ACTIONS)

        src, dst, _ = self._decode_move(action, self.color)
        pid = int(self.board[src])
        self.last_captured_kind = None

        if not _on_board(*dst):
            # Escape through the goal: immediate win for the mover.
            self._capture(pid)
            self.win_color = self.color
        else:
            victim = int(self.board[dst])
            if victim >= 0:
                self._capture(victim)
                self.last_captured_kind = int(self.kind[victim])
                enemy = victim // 8
                if self.counts[enemy, int(self.kind[victim])] == 0:
                    # All enemy blues captured -> mover wins;
                    # all enemy reds captured -> mover loses (got baited).
                    self.win_color = self.color if self.kind[victim] == BLUE else enemy
            self.board[src] = -1
            self.board[dst] = pid
            self.pos[pid] = dst

        self.color ^= 1
        self.ply += 1
        self.moves.append(action)

        if self.ply >= 200 and self.win_color is None:
            self.win_color = 2  # draw

    # -- replica sync -------------------------------------------------------

    def diff_info(self, player=None):
        mover = (self.ply - 1) % 2
        info = {}
        if not self.moves:
            if self.ply > -2:  # at least one placement happened
                info["set"] = self.layout_of[mover] if player == mover else -1
        else:
            info["move"] = self.action2str(self.moves[-1], mover)
            if player == mover and self.last_captured_kind is not None:
                info["captured"] = "BR"[self.last_captured_kind]
        return info

    def update(self, info, reset):
        if reset:
            self.game_args = {**self.game_args, **info}
            self.reset(info)
        elif "set" in info:
            self._place(info["set"])
        elif "move" in info:
            action = self.str2action(info["move"], self.color)
            if "captured" in info:
                # Disclose the true type of the piece we just captured.
                _, dst, _ = self._decode_move(action, self.color)
                victim = int(self.board[dst])
                self.kind[victim] = "BR".index(info["captured"])
            self.play(action)

    # -- game state ---------------------------------------------------------

    def turn(self):
        return self.ply % 2

    def terminal(self):
        return self.win_color is not None

    def reward(self):
        return {p: -0.01 for p in self.players()}

    def outcome(self):
        if self.win_color == BLACK:
            return {0: 1, 1: -1}
        if self.win_color == WHITE:
            return {0: -1, 1: 1}
        return {0: 0, 1: 0}

    def _move_ok(self, color, ptype, src, dst):
        if _on_board(*dst):
            victim = int(self.board[dst])
            return victim < 0 or victim // 8 != color
        # Off-board moves are legal only for blues escaping through own goal.
        return ptype == BLUE and tuple(dst) in [tuple(g) for g in _GOALS[color]]

    def legal_actions(self, player=None):
        if self.ply < 0:
            return list(range(NUM_MOVE_ACTIONS, NUM_MOVE_ACTIONS + NUM_SET_ACTIONS))
        actions = []
        c = self.color
        for pid in range(c * 8, c * 8 + 8):
            if not self.alive[pid]:
                continue
            src = (int(self.pos[pid][0]), int(self.pos[pid][1]))
            ptype = int(self.kind[pid])
            for d in range(4):
                dst = (src[0] + int(DIRS[d][0]), src[1] + int(DIRS[d][1]))
                if self._move_ok(c, ptype, src, dst):
                    actions.append(self._encode_move(src, d, c))
        return actions

    def players(self):
        return [0, 1]

    # -- features -----------------------------------------------------------

    def observation(self, player=None):
        """{'scalar': (18,), 'board': (7, 6, 6)} from ``player``'s viewpoint."""
        my_view = player is None or player == self.turn()
        me = self.color if my_view else self.color ^ 1
        opp = me ^ 1
        counts = self._piece_counts()

        def onehot4(n):
            return [1.0 if n == i else 0.0 for i in range(1, 5)]

        scalar = np.array(
            [1.0 if me == BLACK else 0.0, 1.0 if my_view else 0.0]
            + onehot4(counts[me][BLUE]) + onehot4(counts[me][RED])
            + onehot4(counts[opp][BLUE]) + onehot4(counts[opp][RED]),
            dtype=np.float32,
        )

        owner = np.where(self.board >= 0, self.board // 8, -1)
        ptype = np.where(self.board >= 0, self.kind[np.clip(self.board, 0, 15)], -1)
        omniscient = player is None
        planes = np.stack(
            [
                np.ones((SIZE, SIZE)),
                owner == me,
                owner == opp,
                (owner == me) & (ptype == BLUE),
                (owner == me) & (ptype == RED),
                ((owner == opp) & (ptype == BLUE)) if omniscient else np.zeros((SIZE, SIZE), dtype=bool),
                ((owner == opp) & (ptype == RED)) if omniscient else np.zeros((SIZE, SIZE), dtype=bool),
            ]
        ).astype(np.float32)

        if me == WHITE:
            planes = np.rot90(planes, k=2, axes=(1, 2)).copy()

        return {"scalar": scalar, "board": planes}

    def action_size(self):
        return 214  # 144 move + 70 layout logits

    def transformer_spec(self):
        return {"num_actions": self.action_size(), "with_return": True}

    def default_net(self):
        from ..models import GeisterNet

        return GeisterNet()


if __name__ == "__main__":
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
