"""Vectorized Geister as batched tensor transitions on one device.

Counterpart of ``handyrl_tpu/envs/vector_geister.py``: the host env's rules
(envs/geister.py) as branch-free tensor ops.  Whole populations of games,
each possibly in another phase (piece placement at ply -2/-1, mid-game,
finished), step together, every branch a masked update.  It drives the
streaming device rollout (runtime/device_rollout.py) with the recurrent
DRC net.

* Actions: 144 moves (dir * 36 + square in the MOVER's frame; White sees
  the board rotated 180 degrees, frame_sq = 35 - sq, frame_dir = 3 - d)
  and 70 placement layouts (the C(8, 4) blue assignments).
* Captures disclose nothing here: the device holds the true state, and
  information is hidden where observations are built, as the host's
  per-player planes hide it.
* A game is won by a blue escaping through the goal, by capturing every
  enemy blue, or by losing every own red to the enemy; 200 plies draw;
  both players get -0.01 per step.

State (per lane):
    board  (B, 36) int8   piece id 0..15 or -1 (6x6 in x*6+y order)
    pos    (B, 16) int8   square of each piece, -1 when off the board
    kind   (B, 16) int8   BLUE 0 / RED 1 (true kinds)
    alive  (B, 16) bool
    counts (B, 2, 2) int8 remaining per (colour, kind)
    ply    (B,) int32     starts at -2 (two placement plies)
    win    (B,) int8      -1 none / 0 Black / 1 White / 2 draw
    active (B, 2) bool    one-hot of the player to act (zeros when done)
    done   (B,) bool
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .vector_common import one_hot, reset_where_done

NUM_PLAYERS = 2
BLUE, RED = 0, 1
SIZE = 6
NUM_SQUARES = 36
NUM_MOVE_ACTIONS = 144
NUM_ACTIONS = 214
MAX_PLY = 200
STEP_REWARD = -0.01

# (x, y) deltas in the host's order [up, left, right, down]
_DIRS = np.array([(-1, 0), (0, -1), (0, 1), (1, 0)], np.int64)

# home squares (x*6+y) in placement order per colour (the host's _HOME)
_HOME = np.array(
    [
        [1 * 6 + 1, 2 * 6 + 1, 3 * 6 + 1, 4 * 6 + 1, 1 * 6 + 0, 2 * 6 + 0, 3 * 6 + 0, 4 * 6 + 0],
        [4 * 6 + 4, 3 * 6 + 4, 2 * 6 + 4, 1 * 6 + 4, 4 * 6 + 5, 3 * 6 + 5, 2 * 6 + 5, 1 * 6 + 5],
    ],
    np.int64,
)

# layout index -> which of the 8 home slots hold blue pieces (host LAYOUTS)
_LAYOUT_BLUES = np.zeros((70, 8), bool)
for _i, _combo in enumerate(itertools.combinations(range(8), 4)):
    _LAYOUT_BLUES[_i, list(_combo)] = True


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(HOME, LAYOUT_BLUES, DIRX, DIRY) on ``device``."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in (_HOME, _LAYOUT_BLUES, _DIRS[:, 0].copy(), _DIRS[:, 1].copy()))


def _floordiv(x, n):
    """Python's floor division (``jnp`` //), also for negative x."""
    return torch.div(x, n, rounding_mode="floor")


def _frame_sq(sq, color):
    """Board square <-> mover-frame square (White: 180-degree rotation)."""
    return torch.where(color == 1, 35 - sq, sq)


def _frame_dir(d, color):
    return torch.where(color == 1, 3 - d, d)


def _obs_from_fields(board, kind, counts, ply):
    """Both players' views from the raw state / record fields (board
    (M, 36), kind (M, 16), counts (M, 2, 2), ply (M,)), as the host's
    observation(): colour bit, my-view bit, 4x onehot4 piece counts; 7
    planes with the opponent's piece types hidden; White sees the board
    rotated 180 degrees."""
    M = board.shape[0]
    device = board.device
    c = torch.remainder(ply, 2).long()
    board = board.long()
    occupied = board >= 0
    owner = torch.where(occupied, _floordiv(board, 8), -1)      # (M, 36)
    ptype = torch.where(occupied, torch.gather(kind.long(), 1, board.clamp(0, 15)), -1)
    counts = counts.long()
    ones_to_four = torch.arange(1, 5, device=device)

    def onehot4(n):  # (M,) -> (M, 4) for the values 1..4
        return (n[:, None] == ones_to_four).float()

    scalars, boards = [], []
    for p in range(NUM_PLAYERS):
        me, opp = p, 1 - p
        scalar = torch.cat(
            [
                torch.full((M, 1), 1.0 if me == 0 else 0.0, device=device),
                (c == p).float()[:, None],
                onehot4(counts[:, me, BLUE]),
                onehot4(counts[:, me, RED]),
                onehot4(counts[:, opp, BLUE]),
                onehot4(counts[:, opp, RED]),
            ],
            dim=1,
        )
        zeros = torch.zeros((M, NUM_SQUARES), device=device)
        planes = torch.stack(
            [
                torch.ones((M, NUM_SQUARES), device=device),
                (owner == me).float(),
                (owner == opp).float(),
                ((owner == me) & (ptype == BLUE)).float(),
                ((owner == me) & (ptype == RED)).float(),
                zeros,
                zeros,
            ],
            dim=1,
        )                                                        # (M, 7, 36)
        if p == 1:  # a 180-degree rotation reverses the flat index
            planes = planes.flip(-1)
        scalars.append(scalar)
        boards.append(planes.view(M, 7, SIZE, SIZE))
    return {"scalar": torch.stack(scalars, dim=1), "board": torch.stack(boards, dim=1)}


class VectorGeister:
    """Stateless namespace of batched transition functions."""

    num_actions = NUM_ACTIONS
    num_players = NUM_PLAYERS
    max_steps = MAX_PLY + 2
    simultaneous = False          # strict alternation; the rollout samples the turn player
    step_reward = STEP_REWARD

    @staticmethod
    def init(n_lanes: int, gen=None, device="cpu"):
        del gen  # the placement layouts come from the policy, not the env
        B = n_lanes
        active = torch.zeros((B, NUM_PLAYERS), dtype=torch.bool, device=device)
        active[:, 0] = True
        return {
            "board": torch.full((B, NUM_SQUARES), -1, dtype=torch.int8, device=device),
            "pos": torch.full((B, 16), -1, dtype=torch.int8, device=device),
            "kind": torch.zeros((B, 16), dtype=torch.int8, device=device),
            "alive": torch.zeros((B, 16), dtype=torch.bool, device=device),
            "counts": torch.zeros((B, 2, 2), dtype=torch.int8, device=device),
            "ply": torch.full((B,), -2, dtype=torch.int32, device=device),
            "win": torch.full((B,), -1, dtype=torch.int8, device=device),
            "active": active,
            "done": torch.zeros((B,), dtype=torch.bool, device=device),
        }

    @staticmethod
    def reset_done(state, gen):
        fresh = VectorGeister.init(state["done"].shape[0], gen, state["done"].device)
        return reset_where_done(fresh, state)

    # -- transition ---------------------------------------------------------

    @staticmethod
    def step(state, actions, gen=None):
        """Apply the turn player's action in every running lane; placement
        and move plies are masked branches of one update (the host's
        play())."""
        del gen
        device = actions.device
        home_t, layout_blues, dirx, diry = _tables(device)
        live = ~state["done"] & (state["win"] == -1)
        c = torch.remainder(state["ply"], 2).long()              # turn colour
        a = torch.gather(actions.long(), 1, c[:, None])[:, 0]

        board, pos = state["board"], state["pos"]
        kind, alive, counts = state["kind"], state["alive"], state["counts"]
        win = state["win"]

        # ---- placement branch (ply < 0, the host's _place) -----------------
        setting = live & (state["ply"] < 0)
        layout = (a - NUM_MOVE_ACTIONS).clamp(0, 69)
        blues = layout_blues[layout]                             # (B, 8)
        pids = c[:, None] * 8 + torch.arange(8, device=device)   # (B, 8)
        homes = home_t[c]                                        # (B, 8)
        sm = setting[:, None]
        pos = pos.scatter(1, pids, torch.where(sm, homes.to(torch.int8),
                                               torch.gather(pos, 1, pids)))
        kind = kind.scatter(1, pids, torch.where(
            sm, torch.where(blues, BLUE, RED).to(torch.int8), torch.gather(kind, 1, pids)))
        alive = alive.scatter(1, pids, sm | torch.gather(alive, 1, pids))
        board = board.scatter(1, homes, torch.where(sm, pids.to(torch.int8),
                                                    torch.gather(board, 1, homes)))
        mine_color = (torch.arange(2, device=device) == c[:, None])[:, :, None]   # (B, 2, 1)
        counts = torch.where(mine_color & sm[:, :, None], torch.full_like(counts, 4), counts)

        # ---- move branch (ply >= 0, the host's play) -----------------------
        moving = live & (state["ply"] >= 0)
        sq = torch.remainder(a, NUM_SQUARES)
        d = _floordiv(a, NUM_SQUARES).clamp(0, 3)
        src = _frame_sq(sq, c)
        dr = _frame_dir(d, c)
        sx, sy = _floordiv(src, SIZE), torch.remainder(src, SIZE)
        nx, ny = sx + dirx[dr], sy + diry[dr]
        onb = (nx >= 0) & (nx < SIZE) & (ny >= 0) & (ny < SIZE)
        dst = nx.clamp(0, SIZE - 1) * SIZE + ny.clamp(0, SIZE - 1)

        pid = torch.gather(board, 1, src[:, None])[:, 0].long()
        pid_safe = pid.clamp(0, 15)

        # a blue escaping through the goal: the mover is removed and wins
        escape = moving & ~onb
        # a normal move, possibly capturing the enemy piece on dst
        normal = moving & onb
        victim = torch.gather(board, 1, dst[:, None])[:, 0].long()
        cap = normal & (victim >= 0)
        victim_safe = victim.clamp(0, 15)
        vkind = torch.gather(kind, 1, victim_safe[:, None])[:, 0].long()

        # captures (the host's _capture): the victim off the board, counts--
        removed = torch.where(cap, victim_safe, torch.where(escape, pid_safe, 16))
        rem_valid = cap | escape
        rem_idx = removed.clamp(0, 15)
        rem_hot = one_hot(rem_idx, 16, torch.bool) & rem_valid[:, None]
        pos = torch.where(rem_hot, torch.full_like(pos, -1), pos)
        alive = alive & ~rem_hot
        rem_color = _floordiv(rem_idx, 8)
        rem_kind = torch.gather(kind, 1, rem_idx[:, None])[:, 0].long()
        rem_ck = one_hot(rem_color * 2 + rem_kind, 4, torch.int8).view(-1, 2, 2)
        counts = counts - rem_ck * rem_valid[:, None, None].to(torch.int8)

        # the board: clear src (escape or move), then place pid at dst
        board = torch.where(one_hot(src, NUM_SQUARES, torch.bool) & moving[:, None],
                            torch.full_like(board, -1), board)
        board = torch.where(one_hot(dst, NUM_SQUARES, torch.bool) & normal[:, None],
                            pid.to(torch.int8)[:, None], board)
        pos = torch.where(one_hot(pid_safe, 16, torch.bool) & normal[:, None],
                          dst.to(torch.int8)[:, None], pos)

        # wins: an escape -> the mover; the last enemy blue captured -> the
        # mover; the last enemy red captured (the mover was baited) -> the enemy
        enemy = c ^ 1
        left = torch.gather(counts.view(-1, 4), 1, (enemy * 2 + vkind)[:, None])[:, 0]
        wiped = cap & (left == 0)
        c8, enemy8 = c.to(torch.int8), enemy.to(torch.int8)
        win = torch.where(escape, c8, win)
        win = torch.where(wiped & (vkind == BLUE), c8, win)
        win = torch.where(wiped & (vkind == RED), enemy8, win)

        ply = state["ply"] + live.to(torch.int32)
        win = torch.where(live & (ply >= MAX_PLY) & (win == -1), torch.full_like(win, 2), win)

        done = state["done"] | (win != -1)
        next_c = torch.remainder(ply, 2).long()
        active = one_hot(next_c, NUM_PLAYERS, torch.bool) & ~done[:, None]
        return {
            "board": board,
            "pos": pos,
            "kind": kind,
            "alive": alive,
            "counts": counts,
            "ply": ply,
            "win": win,
            "active": active,
            "done": done,
        }

    # -- legality -----------------------------------------------------------

    @staticmethod
    def legal_mask_all(state):
        """(B, P, 214) bool.  The turn player's row is the true legal set
        (the host's legal_actions); the idle player's row is all True
        (sampled but never played: the rollout masks it out)."""
        board = state["board"]
        device = board.device
        _, _, dirx, diry = _tables(device)
        B = board.shape[0]
        c = torch.remainder(state["ply"], 2).long()
        setting = state["ply"] < 0

        # move legality for all 16 pieces x 4 directions, for the turn colour
        pos = state["pos"].long()                                # (B, 16)
        owner = _floordiv(torch.arange(16, device=device), 8)[None, :]
        mine = state["alive"] & (owner == c[:, None])
        px, py = _floordiv(pos, SIZE), torch.remainder(pos, SIZE)
        nx = px[:, :, None] + dirx                               # (B, 16, 4)
        ny = py[:, :, None] + diry
        onb = (nx >= 0) & (nx < SIZE) & (ny >= 0) & (ny < SIZE)
        dst = nx.clamp(0, SIZE - 1) * SIZE + ny.clamp(0, SIZE - 1)
        dst_pid = torch.gather(board, 1, dst.view(B, 64)).view(B, 16, 4).long()
        ok_onb = onb & ((dst_pid < 0) | (_floordiv(dst_pid, 8) != c[:, None, None]))
        # off the board: blues escaping through their own goal squares
        # (Black exits at y=5, White at y=0, via x=-1 or x=6)
        goal_y = torch.where(c == 0, SIZE - 1, 0)[:, None, None]
        off_goal = ~onb & ((nx == -1) | (nx == SIZE)) & (ny == goal_y)
        blue = state["kind"] == BLUE
        valid = mine[:, :, None] & (ok_onb | (off_goal & blue[:, :, None]))   # (B, 16, 4)

        fsq = _frame_sq(pos, c[:, None])                         # (B, 16)
        fdir = _frame_dir(torch.arange(4, device=device)[None, None, :], c[:, None, None])
        idx = (fdir * NUM_SQUARES + fsq[:, :, None]).clamp(0, NUM_MOVE_ACTIONS - 1)

        # each (piece, direction) of a live piece has its own action, so a
        # sum over the scatter only ever meets zeros from dead pieces
        move_mask = torch.zeros((B, NUM_ACTIONS), dtype=torch.int32, device=device)
        move_mask = move_mask.scatter_add(1, idx.view(B, 64), valid.view(B, 64).to(torch.int32)) > 0
        set_mask = (torch.arange(NUM_ACTIONS, device=device) >= NUM_MOVE_ACTIONS)[None, :] \
            & setting[:, None]
        turn_row = torch.where(setting[:, None], set_mask, move_mask)
        turn = one_hot(c, NUM_PLAYERS, torch.bool)[:, :, None]   # (B, P, 1)
        return torch.where(turn, turn_row[:, None, :], True)

    # -- observation --------------------------------------------------------

    @staticmethod
    def observe_mask(state):
        """(B, P): both players observe every step (the DRC hidden state
        advances for the idle player too, as host generation with
        ``observation: true``)."""
        return (~state["done"])[:, None].expand(state["active"].shape)

    @staticmethod
    def observation(state):
        """{'scalar': (B, P, 18), 'board': (B, P, 7, 6, 6)}: per-player
        views, as the host's observation()."""
        return _obs_from_fields(state["board"], state["kind"], state["counts"], state["ply"])

    # -- streaming-rollout hooks --------------------------------------------

    @staticmethod
    def record(state):
        return {
            "board": state["board"],
            "kind": state["kind"],
            "counts": state["counts"],
            "ply": state["ply"],
        }

    @staticmethod
    def outcome_scores(state):
        """(B, P): +-1 for a win, zeros for a draw (the host's outcome())."""
        w = state["win"]
        black = (w == 0).float() - (w == 1).float()
        return torch.stack([black, -black], dim=1)

    @staticmethod
    def episode_obs(compact, observing):
        """The {'scalar', 'board'} tree (T, P, ...) rebuilt from the compact
        record (numpy), mirroring observation()."""
        board = compact["board"].astype(np.int32)            # (T, 36)
        kind = compact["kind"].astype(np.int32)              # (T, 16)
        counts = compact["counts"].astype(np.int32)          # (T, 2, 2)
        ply = compact["ply"].astype(np.int32)                # (T,)
        T = board.shape[0]
        c = ply % 2
        occupied = board >= 0
        owner = np.where(occupied, board // 8, -1)
        ptype = np.where(occupied, kind[np.arange(T)[:, None], np.clip(board, 0, 15)], -1)

        def onehot4(n):
            return (n[:, None] == np.arange(1, 5)[None, :]).astype(np.float32)

        scalars, boards = [], []
        for p in range(NUM_PLAYERS):
            me, opp = p, 1 - p
            scalar = np.concatenate(
                [
                    np.full((T, 1), 1.0 if me == 0 else 0.0, np.float32),
                    (c == p).astype(np.float32)[:, None],
                    onehot4(counts[:, me, BLUE]),
                    onehot4(counts[:, me, RED]),
                    onehot4(counts[:, opp, BLUE]),
                    onehot4(counts[:, opp, RED]),
                ],
                axis=1,
            )
            planes = np.stack(
                [
                    np.ones((T, NUM_SQUARES), np.float32),
                    (owner == me).astype(np.float32),
                    (owner == opp).astype(np.float32),
                    ((owner == me) & (ptype == BLUE)).astype(np.float32),
                    ((owner == me) & (ptype == RED)).astype(np.float32),
                    np.zeros((T, NUM_SQUARES), np.float32),
                    np.zeros((T, NUM_SQUARES), np.float32),
                ],
                axis=1,
            )
            if p == 1:
                planes = planes[:, :, ::-1]
            ob = observing[:, p, None]
            scalars.append(scalar * ob)
            boards.append(planes.reshape(T, 7, SIZE, SIZE) * ob[..., None, None])
        return {"scalar": np.stack(scalars, axis=1), "board": np.stack(boards, axis=1)}
