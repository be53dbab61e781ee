"""Hungry Geese: a 4-player simultaneous-move survival game on a 7x11 torus.

The port's copy of the host environment of ``handyrl_tpu/envs/hungry_geese.py``,
a standalone numpy implementation of the kaggle rules:

* 4 geese, each a list of cells on a 7x11 torus; 2 food on the board.
* Each step every active goose moves its head N/S/W/E.  Reversing the
  previous action, running into its own body, or starving to length 0
  kills a goose.
* Eating food grows the goose (the tail is not popped); every 40th step
  every goose loses a tail cell (hunger).
* After all moves, a head that shares a cell with any other goose cell dies.
* The game ends when at most one goose is active, or after 199 steps.
* Rank reward ``(steps survived) * 100 + length``; the outcome is +-1/3
  per opponent beaten / beaten by.

Observation: 17 planes (7, 11): head, tail tip, whole body and previous
head of each goose, rotated so that the acting player's channels come
first, then food.  The device twin (``vector_env``) is not ported.
"""

from __future__ import annotations

import random

import numpy as np

from .base import BaseEnvironment

ROWS, COLS = 7, 11
NUM_CELLS = ROWS * COLS
NUM_AGENTS = 4
HUNGER_RATE = 40
MIN_FOOD = 2
MAX_STEPS = 199  # kaggle's episode_steps=200 counts the initial state
RANK_SCALE = 100  # above any goose's length, so survival time dominates

ACTIONS = ["NORTH", "SOUTH", "WEST", "EAST"]
_MOVES = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}


def _translate(cell: int, direction: int) -> int:
    r, c = divmod(cell, COLS)
    dr, dc = _MOVES[direction]
    return ((r + dr) % ROWS) * COLS + (c + dc) % COLS


class Environment(BaseEnvironment):
    ACTION = ACTIONS  # kaggle's name

    def __init__(self, args=None):
        super().__init__(args)
        self.reset()

    def reset(self, args=None):
        cells = random.sample(range(NUM_CELLS), NUM_AGENTS + MIN_FOOD)
        self.geese = [[c] for c in cells[:NUM_AGENTS]]
        self.food = list(cells[NUM_AGENTS:])
        self.active = [True] * NUM_AGENTS
        self.rank_rewards = [RANK_SCALE + 1] * NUM_AGENTS  # step 1 * scale + length 1
        self.step_count = 0
        self.last_actions: dict[int, int] = {}
        self.prev_heads = [None] * NUM_AGENTS

    # -- codecs -------------------------------------------------------------

    def action2str(self, a, player=None):
        return ACTIONS[a]

    def str2action(self, s, player=None):
        return ACTIONS.index(s)

    def __str__(self):
        glyph = np.full((ROWS, COLS), ".", dtype=object)
        for cell in self.food:
            glyph[divmod(cell, COLS)] = "f"
        for p, goose in enumerate(self.geese):
            for cell in goose[1:]:
                glyph[divmod(cell, COLS)] = str(p)
            if goose:
                glyph[divmod(goose[0], COLS)] = "@"
        lines = ["step %d" % self.step_count]
        lines += ["".join(row) for row in glyph]
        lines.append(" ".join(str(len(g) or "-") for g in self.geese))
        return "\n".join(lines)

    # -- transitions --------------------------------------------------------

    def step(self, actions):
        self.step_count += 1
        t = self.step_count
        self.prev_heads = [g[0] if g else None for g in self.geese]
        acted = {p: (actions.get(p) or 0) for p in self.players()}

        for p in self.players():
            if not self.active[p]:
                continue
            goose = self.geese[p]
            action = acted[p]
            if self.last_actions.get(p) is not None and action == _OPPOSITE[self.last_actions[p]]:
                self._kill(p)  # reversed into its own neck
                continue
            head = _translate(goose[0], action)
            if head in self.food:
                self.food.remove(head)  # grows: the tail stays
            else:
                goose.pop()
            if head in goose:
                self._kill(p)  # ran into its own body
                continue
            goose.insert(0, head)
            if t % HUNGER_RATE == 0:
                goose.pop()
                if not goose:
                    self._kill(p)  # starved
                    continue

        # collisions between geese: a head on a cell that any goose holds twice
        occupancy = np.zeros(NUM_CELLS, dtype=np.int32)
        for goose in self.geese:
            for cell in goose:
                occupancy[cell] += 1
        for p in self.players():
            if self.active[p] and occupancy[self.geese[p][0]] > 1:
                self._kill(p)

        # rank rewards move only after every death of this step: a goose that
        # dies at step t keeps its reward of step t - 1
        for p in self.players():
            if self.active[p]:
                self.rank_rewards[p] = (t + 1) * RANK_SCALE + len(self.geese[p])

        self._spawn_food()

        if sum(self.active) <= 1 or self.step_count >= MAX_STEPS:
            self.active = [False] * NUM_AGENTS

        self.last_actions = acted

    def _kill(self, p):
        self.active[p] = False
        self.geese[p] = []

    def _spawn_food(self):
        occupied = {c for g in self.geese for c in g} | set(self.food)
        free = [c for c in range(NUM_CELLS) if c not in occupied]
        while len(self.food) < MIN_FOOD and free:
            cell = random.choice(free)
            free.remove(cell)
            self.food.append(cell)

    # -- replica sync -------------------------------------------------------

    def diff_info(self, player=None):
        return {
            "geese": [list(g) for g in self.geese],
            "food": list(self.food),
            "active": list(self.active),
            "rank_rewards": list(self.rank_rewards),
            "step_count": self.step_count,
            "last_actions": dict(self.last_actions),
            "prev_heads": list(self.prev_heads),
        }

    def update(self, info, reset):
        if reset:
            self.reset()
        self.geese = [list(g) for g in info["geese"]]
        self.food = list(info["food"])
        self.active = list(info["active"])
        self.rank_rewards = list(info["rank_rewards"])
        self.step_count = info["step_count"]
        self.last_actions = {int(k): v for k, v in info["last_actions"].items()}
        self.prev_heads = list(info["prev_heads"])

    # -- game state ---------------------------------------------------------

    def turns(self):
        return [p for p in self.players() if self.active[p]]

    def terminal(self):
        return not any(self.active)

    def outcome(self):
        """Pairwise rank outcome: +1/3 per opponent beaten, -1/3 per loss."""
        out = {p: 0.0 for p in self.players()}
        for p in self.players():
            for q in self.players():
                if p == q:
                    continue
                if self.rank_rewards[p] > self.rank_rewards[q]:
                    out[p] += 1 / (NUM_AGENTS - 1)
                elif self.rank_rewards[p] < self.rank_rewards[q]:
                    out[p] -= 1 / (NUM_AGENTS - 1)
        return out

    def legal_actions(self, player=None):
        return list(range(len(ACTIONS)))

    def players(self):
        return list(range(NUM_AGENTS))

    def rule_based_action(self, player, key=None):
        """Greedy food-seeker: step toward the nearest food, avoiding cells
        that any goose's body holds, never reversing; boxed in, a random
        move that does not reverse."""
        goose = self.geese[player]
        if not goose:
            return 0
        head = goose[0]
        blocked = {c for g in self.geese for c in g}
        last = self.last_actions.get(player)
        best, best_dist = None, 10 ** 9
        for d in range(4):
            if last is not None and d == _OPPOSITE[last]:
                continue
            nxt = _translate(head, d)
            if nxt in blocked:
                continue
            dist = min((self._torus_dist(nxt, f) for f in self.food), default=0)
            if dist < best_dist:
                best, best_dist = d, dist
        if best is None:
            candidates = [d for d in range(4) if last is None or d != _OPPOSITE[last]]
            best = random.choice(candidates or [0])
        return best

    @staticmethod
    def _torus_dist(a, b):
        ar, ac = divmod(a, COLS)
        br, bc = divmod(b, COLS)
        dr = min((ar - br) % ROWS, (br - ar) % ROWS)
        dc = min((ac - bc) % COLS, (bc - ac) % COLS)
        return dr + dc

    # -- features -----------------------------------------------------------

    def observation(self, player=None):
        """(17, 7, 11) planes; the acting player's channels come first."""
        if player is None:
            player = 0
        planes = np.zeros((NUM_AGENTS * 4 + 1, NUM_CELLS), dtype=np.float32)
        for p, goose in enumerate(self.geese):
            ch = (p - player) % NUM_AGENTS
            if goose:
                planes[ch, goose[0]] = 1          # head
                planes[4 + ch, goose[-1]] = 1     # tail tip
                planes[8 + ch, goose] = 1         # whole body
            if self.prev_heads[p] is not None:
                planes[12 + ch, self.prev_heads[p]] = 1
        planes[16, self.food] = 1
        return planes.reshape(-1, ROWS, COLS)

    def action_size(self):
        return 4

    def default_net(self):
        from ..models import GeeseNet

        return GeeseNet()


if __name__ == "__main__":
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p)) for p in e.turns()})
        print(e)
        print(e.outcome())
