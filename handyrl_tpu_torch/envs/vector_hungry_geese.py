"""Vectorized Hungry Geese as batched tensor transitions on one device.

Counterpart of ``handyrl_tpu/envs/vector_hungry_geese.py``: the host env's
rules (envs/hungry_geese.py) as branch-free tensor ops, so whole
populations of 4-goose games live and step on the card: the substrate of
streaming on-device self-play (runtime/device_rollout.py) and of the
on-device evaluator (runtime/device_eval.py).

State (per lane, batch-leading), the JAX twin's dtypes:
    cells     (B, P, MAXLEN) int32  circular body buffer; position
                                    (head_ptr + i) % MAXLEN = i-th cell
                                    from the head, valid for i < length
    head_ptr  (B, P) int32
    length    (B, P) int32          0 for dead geese
    occ       (B, P, C) int8        per-goose body occupancy
    active    (B, P) bool
    last_action (B, P) int32        -1 before the first move
    prev_head (B, P) int32          -1 when absent
    rank      (B, P) int32          (steps survived + 1) * 100 + length
    food      (B, C) int8           food occupancy
    step      (B,) int32            the host's step_count
    done      (B,) bool             game over; the lane awaits its reset

Transitions are total: stepping a finished lane is a no-op.  Every gather
reads an index that is in range by construction (head pointers are taken
modulo MAXLEN, absent cells are clipped before they index a table), and
one-hots of an absent cell (-1) are zero rows, as ``jax.nn.one_hot`` gives.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .hungry_geese import (
    COLS,
    HUNGER_RATE,
    MAX_STEPS,
    MIN_FOOD,
    NUM_AGENTS,
    NUM_CELLS,
    RANK_SCALE,
    ROWS,
    _MOVES,
)
from .vector_common import gumbel as _gumbel
from .vector_common import one_hot, reset_where_done
from .vector_common import uniform as _uniform

MAXLEN = NUM_CELLS  # a goose can at most fill the board

# TRANS[cell, action] -> the destination cell on the torus (host _translate)
_TRANS = np.zeros((NUM_CELLS, 4), np.int32)
for _c in range(NUM_CELLS):
    _r, _cc = divmod(_c, COLS)
    for _a, (_dr, _dc) in enumerate(_MOVES):
        _TRANS[_c, _a] = ((_r + _dr) % ROWS) * COLS + (_cc + _dc) % COLS
_OPPOSITE = np.asarray([1, 0, 3, 2], np.int32)

# DIST[a, b] -> torus manhattan distance (host _torus_dist)
_DIST = np.zeros((NUM_CELLS, NUM_CELLS), np.int32)
for _a in range(NUM_CELLS):
    _ar, _ac = divmod(_a, COLS)
    for _b in range(NUM_CELLS):
        _br, _bc = divmod(_b, COLS)
        _DIST[_a, _b] = min((_ar - _br) % ROWS, (_br - _ar) % ROWS) + min(
            (_ac - _bc) % COLS, (_bc - _ac) % COLS
        )


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(TRANS, OPPOSITE, DIST, rotation index) on ``device``; the rotation
    index ROT[p, q] = (q + p) % P lists player p's view order of the geese
    (jnp.roll(x, -p) over the goose axis)."""
    rot = (np.arange(NUM_AGENTS)[None, :] + np.arange(NUM_AGENTS)[:, None]) % NUM_AGENTS
    return tuple(torch.as_tensor(t, device=device)
                 for t in (_TRANS, _OPPOSITE, _DIST, rot.astype(np.int64)))


def _cell_onehot(cell):
    """(..., C) int8 one-hot over the board cells; -1 gives zeros."""
    return one_hot(cell, NUM_CELLS)


def _take(x, index):
    """x[..., index] along the last axis (``take_along_axis``), int64 index."""
    return torch.gather(x, -1, index.long())


class VectorHungryGeese:
    """Stateless namespace of batched transition functions.

    ``simultaneous = True``: every active player acts every step."""

    num_actions = 4
    num_players = NUM_AGENTS
    max_steps = MAX_STEPS
    simultaneous = True
    board_shape = (ROWS, COLS)

    # -- lane (re)initialisation -------------------------------------------

    @staticmethod
    def init(n_lanes: int, gen, device="cpu"):
        """Fresh games: 4 spawns and MIN_FOOD food on distinct cells drawn
        uniformly (the host's random.sample), as the top NUM_AGENTS +
        MIN_FOOD of per-cell uniforms.  A stable descending sort puts the
        lower index first on a tie, as ``lax.top_k`` does."""
        u = _uniform(gen, (n_lanes, NUM_CELLS), device)
        picks = torch.sort(u, dim=1, descending=True, stable=True).indices[:, :NUM_AGENTS + MIN_FOOD]
        spawns = picks[:, :NUM_AGENTS]                      # (B, P)
        food_cells = picks[:, NUM_AGENTS:]                  # (B, MIN_FOOD)

        B = n_lanes
        cells = torch.zeros((B, NUM_AGENTS, MAXLEN), dtype=torch.int32, device=device)
        cells[:, :, 0] = spawns.to(torch.int32)
        occ = _cell_onehot(spawns)                          # (B, P, C)
        food = _cell_onehot(food_cells).sum(dim=1).to(torch.int8)
        return {
            "cells": cells,
            "head_ptr": torch.zeros((B, NUM_AGENTS), dtype=torch.int32, device=device),
            "length": torch.ones((B, NUM_AGENTS), dtype=torch.int32, device=device),
            "occ": occ,
            "active": torch.ones((B, NUM_AGENTS), dtype=torch.bool, device=device),
            "last_action": torch.full((B, NUM_AGENTS), -1, dtype=torch.int32, device=device),
            "prev_head": torch.full((B, NUM_AGENTS), -1, dtype=torch.int32, device=device),
            "rank": torch.full((B, NUM_AGENTS), RANK_SCALE + 1, dtype=torch.int32, device=device),
            "food": food,
            "step": torch.zeros((B,), dtype=torch.int32, device=device),
            "done": torch.zeros((B,), dtype=torch.bool, device=device),
        }

    @staticmethod
    def reset_done(state, gen):
        """Re-initialise every lane whose game has finished (the streaming
        auto-reset: no step is spent on a dead lane)."""
        fresh = VectorHungryGeese.init(state["done"].shape[0], gen, state["done"].device)
        return reset_where_done(fresh, state)

    # -- views --------------------------------------------------------------

    @staticmethod
    def head_cell(state):
        """(B, P) int32 current head cell, -1 for empty geese."""
        head = _take(state["cells"], state["head_ptr"][..., None])[..., 0]
        return torch.where(state["length"] > 0, head, -1)

    @staticmethod
    def tail_cell(state):
        """(B, P) int32 current tail-tip cell, -1 for empty geese."""
        idx = torch.remainder(state["head_ptr"] + state["length"] - 1, MAXLEN)
        tail = _take(state["cells"], idx[..., None])[..., 0]
        return torch.where(state["length"] > 0, tail, -1)

    @staticmethod
    def observation(state):
        """(B, P, 17, 7, 11) fp32: the host env's 17 planes for every
        player: head / tail / body / previous head per goose with the goose
        axis rotated so the viewing player comes first, then food."""
        rot = _tables(state["occ"].device)[3]
        geese = torch.stack(
            [
                _cell_onehot(VectorHungryGeese.head_cell(state)),
                _cell_onehot(VectorHungryGeese.tail_cell(state)),
                state["occ"],
                _cell_onehot(state["prev_head"]),
            ],
            dim=1,
        ).float()                                            # (B, 4 kinds, P, C)
        B = geese.shape[0]
        views = geese[:, :, rot].permute(0, 2, 1, 3, 4)      # (B, P view, 4, P, C)
        views = views.reshape(B, NUM_AGENTS, 4 * NUM_AGENTS, NUM_CELLS)
        food = state["food"].float()[:, None, None, :].expand(B, NUM_AGENTS, 1, NUM_CELLS)
        obs = torch.cat([views, food], dim=2)                # (B, P, 17, C)
        return obs.view(B, NUM_AGENTS, 4 * NUM_AGENTS + 1, ROWS, COLS)

    # -- transition ---------------------------------------------------------

    @staticmethod
    def step(state, actions, gen):
        """Play ``actions`` (B, P) for every active goose; finished lanes
        pass through unchanged.  The host's step() phase for phase,
        including its sequential food: when several geese reach the same
        food, only the lowest-indexed one eats, and the others pop their
        tails."""
        trans, opposite, _, _ = _tables(state["occ"].device)
        actions = actions.to(torch.int32)
        tg = state["step"] + 1                                   # (B,)
        active = state["active"]                                 # (B, P)
        head0 = VectorHungryGeese.head_cell(state)               # (B, P)
        new_prev_head = torch.where(state["length"] > 0, head0, -1)

        # phase 1: reversal deaths (into the goose's own neck)
        last = state["last_action"]
        reversal = active & (last >= 0) & (actions == opposite[last.clamp(0, 3).long()])
        movers = active & ~reversal

        # phase 2: movement, food and self-collision
        new_head = trans[head0.clamp(0, NUM_CELLS - 1).long(), actions.clamp(0, 3).long()]
        eat = movers & (_take(state["food"], new_head) > 0)
        # contested food goes to the lowest-indexed goose only: a goose
        # loses its claim if a lower-indexed mover eats the same cell
        same_cell = (new_head[:, :, None] == new_head[:, None, :]) & eat[:, :, None] & eat[:, None, :]
        lower = torch.tril(torch.ones((NUM_AGENTS, NUM_AGENTS), dtype=torch.bool,
                                      device=eat.device), diagonal=-1)   # q < p
        eat = eat & ~(same_cell & lower).any(dim=2)
        pop = movers & ~eat
        tail0 = VectorHungryGeese.tail_cell(state)
        occ = state["occ"] - _cell_onehot(tail0) * pop[..., None].to(torch.int8)
        length = state["length"] - pop.to(torch.int32)

        self_col = movers & (_take(occ, new_head[..., None])[..., 0] > 0)
        insert = movers & ~self_col
        head_ptr = torch.where(insert, torch.remainder(state["head_ptr"] - 1, MAXLEN),
                               state["head_ptr"])
        slot = one_hot(head_ptr, MAXLEN, torch.bool) & insert[..., None]
        cells = torch.where(slot, new_head[..., None], state["cells"])
        occ = occ + _cell_onehot(new_head) * insert[..., None].to(torch.int8)
        length = length + insert.to(torch.int32)

        # phase 3: hunger every HUNGER_RATE-th step, after the move;
        # starving to zero kills
        hunger = insert & (torch.remainder(tg, HUNGER_RATE) == 0)[:, None]
        tail1_idx = torch.remainder(head_ptr + length - 1, MAXLEN)
        tail1 = _take(cells, tail1_idx[..., None])[..., 0]
        occ = occ - _cell_onehot(tail1) * hunger[..., None].to(torch.int8)
        length = length - hunger.to(torch.int32)
        starve = hunger & (length == 0)

        alive = active & ~(reversal | self_col | starve)
        occ = occ * alive[..., None].to(torch.int8)
        length = length * alive.to(torch.int32)

        # phase 4: cross-goose collisions: a head on a cell covered by more
        # than one goose cell dies; dead bodies are already off the board
        total_occ = occ.sum(dim=1)                               # (B, C)
        collide = alive & (_take(total_occ, new_head) > 1)
        alive = alive & ~collide
        occ = occ * alive[..., None].to(torch.int8)
        length = length * alive.to(torch.int32)

        # food eaten this step is gone even if the eater then died
        eaten = (_cell_onehot(new_head) * eat[..., None].to(torch.int8)).sum(dim=1)
        food = state["food"] * (eaten == 0).to(torch.int8)

        # phase 5: rank credit only for survivors of the whole step
        rank = torch.where(alive, (tg + 1)[:, None] * RANK_SCALE + length, state["rank"])

        # phase 6: food respawn to MIN_FOOD on uniformly random free cells;
        # two conditional Gumbel-max draws
        total_occ = occ.sum(dim=1)
        free = (total_occ == 0) & (food == 0)                    # (B, C)
        n_food = food.sum(dim=1, dtype=torch.int32)              # (B,)
        neg_inf = torch.tensor(float("-inf"), device=free.device)
        g1 = torch.where(free, _gumbel(gen, free.shape, free.device), neg_inf)
        cand1 = torch.argmax(g1, dim=1)
        do1 = (n_food < MIN_FOOD) & free.any(dim=1)
        food = food | (_cell_onehot(cand1) * do1[:, None].to(torch.int8))
        free = free & ~((_cell_onehot(cand1) > 0) & do1[:, None])
        g2 = torch.where(free, _gumbel(gen, free.shape, free.device), neg_inf)
        cand2 = torch.argmax(g2, dim=1)
        do2 = (n_food + do1.to(torch.int32) < MIN_FOOD) & free.any(dim=1)
        food = food | (_cell_onehot(cand2) * do2[:, None].to(torch.int8))

        # phase 7: the episode ends with at most one survivor or at the
        # step cap, which deactivates everyone
        ended = (alive.sum(dim=1) <= 1) | (tg >= MAX_STEPS)
        active_next = alive & ~ended[:, None]

        return {
            "cells": cells,
            "head_ptr": head_ptr,
            "length": length,
            "occ": occ,
            "active": active_next,
            # the host keeps the acted actions of every player, 0 for the
            # absent ones; only active geese ever read it again
            "last_action": torch.where(active, actions, 0),
            "prev_head": new_prev_head,
            "rank": rank,
            "food": food,
            "step": tg,
            "done": state["done"] | ended,
        }

    # -- streaming-rollout hooks (runtime/device_rollout.py) ----------------

    @staticmethod
    def legal_mask_all(state):
        """(B, P, A) bool: every direction is always legal (reversing is
        legal but lethal, the host's legal_actions)."""
        B, P = state["active"].shape
        return torch.ones((B, P, 4), dtype=torch.bool, device=state["active"].device)

    @staticmethod
    def rule_based_action_all(state, gen):
        """(B, P) int32 greedy food-seeker for every seat, the twin of the
        host's ``rule_based_action``: step towards the nearest food by torus
        manhattan distance, never reverse, avoid every goose cell; the first
        direction wins a tie (the host's strict-< scan over d in 0..3, and
        ``argmin`` returns the first minimum).  Boxed in: a uniformly random
        direction that does not reverse, as the host's random.choice."""
        trans, opposite, dist, _ = _tables(state["occ"].device)
        B, P = state["active"].shape
        head = VectorHungryGeese.head_cell(state)                # (B, P)
        occ_any = state["occ"].sum(dim=1) > 0                    # (B, C)
        food = state["food"] > 0                                 # (B, C)
        nxt = trans[head.clamp(0, NUM_CELLS - 1).long()].long()  # (B, P, 4)
        last = state["last_action"]
        dirs = torch.arange(4, device=nxt.device)
        reverse = (last >= 0)[..., None] & (dirs == opposite[last.clamp(0, 3).long()][..., None])
        blocked = _take(occ_any, nxt.view(B, P * 4)).view(B, P, 4)
        big = torch.tensor(1e9, device=nxt.device)
        fdist = torch.where(food[:, None, None, :], dist[nxt].float(), big).amin(dim=-1)
        # the host's min(..., default=0): no food makes every distance 0
        fdist = torch.where(food.any(dim=-1)[:, None, None], fdist, 0.0)
        valid = ~reverse & ~blocked
        best = torch.argmin(torch.where(valid, fdist, big), dim=-1)
        boxed = ~valid.any(dim=-1)                               # (B, P)
        g = _gumbel(gen, (B, P, 4), nxt.device)
        rnd = torch.argmax(torch.where(reverse, -big, g), dim=-1)
        return torch.where(boxed, rnd, best).to(torch.int32)

    @staticmethod
    def record(state):
        """Compact per-step fields from which the host rebuilds the
        17-plane observations (~40x smaller than the planes)."""
        return {
            "occ": state["occ"],
            "head": VectorHungryGeese.head_cell(state).to(torch.int8),
            "tail": VectorHungryGeese.tail_cell(state).to(torch.int8),
            "prev_head": state["prev_head"].to(torch.int8),
            "food": state["food"],
        }

    @staticmethod
    def outcome_scores(state):
        """(B, P) pairwise rank outcome (+-1/(P-1) per opponent beaten or
        beaten by), the host's outcome(); final where ``done``."""
        rank = state["rank"]
        gt = (rank[:, :, None] > rank[:, None, :]).sum(dim=2, dtype=torch.int32)
        lt = (rank[:, :, None] < rank[:, None, :]).sum(dim=2, dtype=torch.int32)
        return (gt - lt).float() / (NUM_AGENTS - 1)

    @staticmethod
    def view_obs(compact, player):
        """One selected player's planes per row on the device: ``compact``
        leaves are (N, T, ...) windows of the record() fields, ``player``
        (N,).  Returns (N, T, 17, 7, 11) fp32, the planes of
        observation()/episode_obs() for that player (the device replay's
        hook).  Unmasked: the caller applies the observation mask."""
        occ = compact["occ"].float()                             # (N, T, P, C)
        heads = _cell_onehot(compact["head"].long()).float()
        tails = _cell_onehot(compact["tail"].long()).float()
        prev = _cell_onehot(compact["prev_head"].long()).float()
        food = compact["food"].float()                           # (N, T, C)
        N, T = food.shape[:2]
        order = torch.remainder(player.long()[:, None]
                                + torch.arange(NUM_AGENTS, device=food.device), NUM_AGENTS)
        idx = order[:, None, :, None].expand(N, T, NUM_AGENTS, NUM_CELLS)

        def roll_p(x):
            return torch.gather(x, 2, idx)

        planes = torch.cat([roll_p(heads), roll_p(tails), roll_p(occ), roll_p(prev),
                            food[:, :, None, :]], dim=2)        # (N, T, 17, C)
        return planes.view(N, T, 4 * NUM_AGENTS + 1, ROWS, COLS)

    @staticmethod
    def episode_obs(compact, active):
        """(T, P, 17, 7, 11) observation planes rebuilt from the compact
        record (numpy), exactly as the host env builds them."""
        occ = compact["occ"].astype(np.float32)                  # (T, P, C)
        head = compact["head"].astype(np.int32)
        tail = compact["tail"].astype(np.int32)
        prev = compact["prev_head"].astype(np.int32)
        food = compact["food"].astype(np.float32)                # (T, C)

        cell_ids = np.arange(NUM_CELLS, dtype=np.int32)
        heads_oh = (head[..., None] == cell_ids).astype(np.float32)
        tails_oh = (tail[..., None] == cell_ids).astype(np.float32)
        prev_oh = (prev[..., None] == cell_ids).astype(np.float32)
        food_pl = food[:, None, :]

        views = []
        for p in range(NUM_AGENTS):
            planes = np.concatenate(
                [
                    np.roll(heads_oh, -p, axis=1),
                    np.roll(tails_oh, -p, axis=1),
                    np.roll(occ, -p, axis=1),
                    np.roll(prev_oh, -p, axis=1),
                    food_pl,
                ],
                axis=1,
            )                                                    # (T, 4 * P + 1, C)
            views.append(planes * active[:, p, None, None])
        obs = np.stack(views, axis=1)                            # (T, P, planes, C)
        return obs.reshape(obs.shape[:3] + (ROWS, COLS))

    # -- host-side helpers (parity tests) -----------------------------------

    @staticmethod
    def body_list(state, lane: int, player: int):
        """The ordered body cells, head first, as the host env stores them."""
        cells = state["cells"][lane, player].cpu().numpy()
        ptr = int(state["head_ptr"][lane, player])
        length = int(state["length"][lane, player])
        return [int(cells[(ptr + i) % MAXLEN]) for i in range(length)]
