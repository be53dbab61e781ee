"""On-device self-play: env stepping, inference and sampling on the card.

Counterpart of ``handyrl_tpu/runtime/device_rollout.py``.  The host actor
plane (runtime/worker.py + inference_engine.py) pays one host round trip
and a step of host Python per move.  For envs with a device twin
(envs/vector_*.py) the games live on the card instead: B games step
together, actions are sampled on the card by Gumbel-max over the
legal-masked logits, and the host only turns finished games into the
standard columnar episodes of the replay store (numpy blocks: no CUDA
tensor reaches the episode feed).

Two rollouts:

* ``DeviceRollout``: episodic whole-horizon calls for a strictly
  alternating twin whose step index is a Python int (VectorTicTacToe, 9
  plies): one call plays n_games games to their end.
* ``StreamingDeviceRollout``: persistent lanes for twins with the
  streaming hooks (``record``/``reset_done``/``step``: HungryGeese,
  ParallelTicTacToe, Geister).  Each call advances every lane k_steps game
  steps; a lane resets the step after its game ends, recurrent hidden
  state is kept per (lane, player), zeroed on reset and committed where
  the player observed.  The call is pipelined one deep: the records of
  block N are copied to pinned host memory behind its launches and read
  in the next call, after block N+1 is launched.

Both rollouts run a module of their own (a copy made at construction),
loaded from the params a caller hands ``generate``; in the learner those
are the model server's published epoch snapshot, never the trainer's
module, which Adam updates in place.  Behaviour matches the host
Generator (runtime/generation.py): temperature-1 softmax sampling over the
legal-masked logits in fp32, the behaviour prob, action mask and value per
acting player, discounted returns of a constant step reward.  On one card
there is no mesh: the JAX rollouts' ``mesh`` argument has no counterpart.
"""

from __future__ import annotations

import copy
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..envs.vector_common import gumbel as _gumbel
from ..utils import resolve_device, tree_map
from .replay import compress_block

ILLEGAL = 1e32


def _select(logits, legal, gen):
    """Gumbel-max sampling at temperature 1 over the legal-masked fp32
    logits: (action int64, its softmax prob)."""
    masked = torch.where(legal, logits, logits - ILLEGAL)
    g = _gumbel(gen, masked.shape, masked.device)
    action = torch.argmax(masked + g, dim=-1)
    probs = torch.softmax(masked, dim=-1)
    prob = torch.gather(probs, -1, action.unsqueeze(-1)).squeeze(-1)
    return action, prob


def _stack_records(records):
    """A list of per-step record dicts -> one dict of (K, ...) tensors."""
    return {key: torch.stack([r[key] for r in records]) for key in records[0]}


class HostRecord:
    """A dict of device tensors on its way to the host.

    On the card every leaf is copied into pinned host memory with
    ``non_blocking=True`` and an event is recorded behind the copies;
    ``numpy()`` waits on that event only, so the caller can launch more
    work before it reads.  On the CPU the leaves are the host tensors
    already.  ``device_ms`` is the device time between ``start`` (an event
    recorded before the block's first launch) and the end of the copies."""

    def __init__(self, record: Dict[str, torch.Tensor], start=None):
        self.start = start
        self.event = None
        if next(iter(record.values())).is_cuda:
            self.host = {}
            for key, value in record.items():
                buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                buf.copy_(value, non_blocking=True)
                self.host[key] = buf
            self.event = torch.cuda.Event(enable_timing=start is not None)
            self.event.record()
        else:
            self.host = record

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def numpy(self) -> Dict[str, np.ndarray]:
        self.wait()
        return {key: value.numpy() for key, value in self.host.items()}

    def device_ms(self):
        if self.event is None or self.start is None:
            return None
        self.wait()
        return self.start.elapsed_time(self.event)


def _timing_event(device):
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def build_selfplay_fn(venv, module, n_games: int, device):
    """Whole-horizon device self-play for a VectorTicTacToe-style twin.

    Returns ``fn(gen) -> columns``: time-major device tensors over the full
    max_steps horizon, unrolled over the Python-int step index:
        obs    (T, B, ...)  the turn player's observation
        prob   (T, B)       behaviour probability of the selected action
        action (T, B) int32
        amask  (T, B, A)    0 legal / 1e32 illegal at selection time
        value  (T, B)       critic output at acting time
        alive  (T, B)       1.0 while the game was still running
        outcome (B, P)      final per-player scores
    """

    def fn(gen):
        records = []
        state = venv.init(n_games, device)
        for t in range(venv.max_steps):
            alive = ~venv.terminal(state, t)
            obs = venv.observation(state, t)
            out = module(obs, None)
            logits = out["policy"].float()
            legal = venv.legal_mask(state)
            action, prob = _select(logits, legal, gen)
            value = out.get("value")
            records.append({
                "obs": obs,
                "prob": prob,
                "action": action.to(torch.int32),
                "amask": torch.where(legal, 0.0, ILLEGAL),
                "value": value[:, 0].float() if value is not None else torch.zeros_like(prob),
                "alive": alive.float(),
            })
            state = venv.apply(state, action, t)
        columns = _stack_records(records)
        columns["outcome"] = venv.outcome(state)
        return columns

    return fn


def columns_to_episodes(host_cols: Dict[str, Any], venv, args: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Episodic device columns -> standard columnar episodes (the schema of
    the Generator's episodes) for the replay store."""
    P = venv.num_players
    A = venv.num_actions
    alive = np.asarray(host_cols["alive"])               # (T, B)
    lengths = alive.sum(axis=0).astype(np.int32)         # (B,)
    outcome = np.asarray(host_cols["outcome"])           # (B, P)
    obs = np.asarray(host_cols["obs"])                   # (T, B, ...)
    prob = np.asarray(host_cols["prob"])
    action = np.asarray(host_cols["action"])
    amask = np.asarray(host_cols["amask"])
    value = np.asarray(host_cols["value"])

    block_len = args["compress_steps"]
    players = list(range(P))
    episodes = []
    for b in range(obs.shape[1]):
        T = int(lengths[b])
        if T == 0:
            continue
        blocks = []
        for lo in range(0, T, block_len):
            hi = min(lo + block_len, T)
            t = hi - lo
            ts = np.arange(lo, hi)
            tp = ts % P                                   # the turn player per step
            cols = {
                "prob": np.ones((t, P), np.float32),
                "action": np.zeros((t, P), np.int32),
                "amask": np.full((t, P, A), ILLEGAL, np.float32),
                "value": np.zeros((t, P), np.float32),
                "reward": np.zeros((t, P), np.float32),
                "ret": np.zeros((t, P), np.float32),
                "tmask": np.zeros((t, P), np.float32),
                "omask": np.zeros((t, P), np.float32),
                "turn": tp.astype(np.int32),
            }
            rows = np.arange(t)
            cols["prob"][rows, tp] = prob[ts, b]
            cols["action"][rows, tp] = action[ts, b]
            cols["amask"][rows, tp] = amask[ts, b]
            cols["value"][rows, tp] = value[ts, b]
            cols["tmask"][rows, tp] = 1.0
            cols["omask"][rows, tp] = 1.0
            obs_block = np.zeros((t, P) + obs.shape[2:], np.float32)
            obs_block[rows, tp] = obs[ts, b]
            cols["obs"] = obs_block
            blocks.append(compress_block(cols))
        episodes.append({
            "args": {"player": players, "model_id": {p: -1 for p in players}},
            "steps": T,
            "players": players,
            "outcome": {p: float(outcome[b, p]) for p in players},
            "blocks": blocks,
        })
    return episodes


class _ModuleHolder:
    """The rollouts' and the evaluator's own copy of the module, on their device, in eval mode."""

    def __init__(self, module, device):
        self.device = resolve_device(device)
        self.module = copy.deepcopy(module).to(self.device).eval()

    def load(self, params) -> None:
        """Copy ``params`` (a state dict, e.g. a published epoch snapshot)
        into this module; None keeps the weights it has."""
        if params is not None:
            self.module.load_state_dict(params)


class DeviceRollout(_ModuleHolder):
    """Episodic rollout: each ``generate`` plays ``n_games`` whole games in
    one pass over the horizon and returns them as episodes."""

    def __init__(self, venv, module, args: Dict[str, Any], n_games: int = 256, device=None):
        super().__init__(module, device)
        self.venv = venv
        self.args = args
        self.n_games = n_games
        self._fn = build_selfplay_fn(venv, self.module, n_games, self.device)
        self.timing: Dict[str, float] = {}

    def generate(self, params, gen: torch.Generator) -> List[Dict[str, Any]]:
        """Load ``params`` (None: keep the module's weights), play one batch
        of games, and return it as episodes: one host round trip per batch
        is this rollout's contract."""
        self.load(params)
        t0 = time.perf_counter()
        with torch.inference_mode():
            start = _timing_event(self.device)
            host = HostRecord(self._fn(gen), start)
        t1 = time.perf_counter()
        cols = host.numpy()
        t2 = time.perf_counter()
        episodes = columns_to_episodes(cols, self.venv, self.args)
        self.timing = {"launch_ms": (t1 - t0) * 1e3, "wait_ms": (t2 - t1) * 1e3,
                       "device_ms": host.device_ms(),
                       "assemble_ms": (time.perf_counter() - t2) * 1e3}
        return episodes


# ---------------------------------------------------------------------------
# Streaming rollout for twins with the streaming hooks
# ---------------------------------------------------------------------------


def _lane_mask(mask, h):
    """``mask`` (B,) or (B, P) broadcast over the trailing dims of ``h``."""
    return mask.view(mask.shape + (1,) * (h.dim() - mask.dim()))


def build_streaming_fn(venv, module, n_lanes: int, k_steps: int, use_observe_mask: bool = True):
    """Streaming self-play for a twin with the streaming hooks:
    ``fn(state, hidden, gen) -> (state, hidden, record)`` steps ``k_steps``
    game steps over ``n_lanes`` persistent lanes, resetting finished lanes
    at the start of each step, so no step is spent on a dead game.  The
    record holds the compact per-step fields of ``venv.record`` (occupancy,
    heads and food for HungryGeese, not the observation planes), from which
    the host rebuilds the observations.

    Works for simultaneous-move twins (every active player acts) and
    strictly alternating ones (``state['active']`` one-hots the turn
    player, VectorGeister); a recurrent module (the DRC ConvLSTM) carries
    hidden state per (lane, player) across steps and calls, zeroed on a
    lane's reset and committed only where the player observed, as the host
    Generator keeps its per-player hidden state."""
    P = venv.num_players
    observe = use_observe_mask and hasattr(venv, "observe_mask")

    def fn(state, hidden, gen):
        records = []
        for _ in range(k_steps):
            reset = state["done"]
            state = venv.reset_done(state, gen)
            if hidden is not None:
                # fresh games start from zero hidden (the host's init_hidden)
                hidden = tree_map(lambda h: torch.where(_lane_mask(reset, h), 0.0, h), hidden)
            active = state["active"]                         # (B, P) acting mask
            # observe_mask (the non-acting players' views) applies only
            # under ``observation: true``; otherwise the host Generator
            # records the acting players only, and so does this path
            observing = venv.observe_mask(state) if observe else active
            obs = venv.observation(state)                    # leaves (B, P, ...)
            B = active.shape[0]
            flat = tree_map(lambda x: x.reshape((B * P,) + x.shape[2:]), obs)
            h_flat = (None if hidden is None
                      else tree_map(lambda h: h.reshape((B * P,) + h.shape[2:]), hidden))
            out = module(flat, h_flat)
            if hidden is not None:
                # commit where observed, keep elsewhere (as the train step does)
                hidden = tree_map(
                    lambda h, nh: torch.where(_lane_mask(observing, h),
                                              nh.reshape(h.shape).to(h.dtype), h),
                    hidden, out["hidden"],
                )
            logits = out["policy"].float().reshape(B, P, -1)
            legal = venv.legal_mask_all(state)               # (B, P, A) bool
            action, prob = _select(logits, legal, gen)
            value = out.get("value")
            record = {
                "active": active,
                "observing": observing,
                "legal": legal,
                "action": action.to(torch.int32),
                "prob": prob,
                "value": value.float().reshape(B, P) if value is not None else torch.zeros_like(prob),
            }
            record.update(venv.record(state))                # the twin's compact fields
            state = venv.step(state, action, gen)
            record["done"] = state["done"]                   # reset_done cleared stale flags
            record["outcome"] = venv.outcome_scores(state)   # final where done
            records.append(record)
        return state, hidden, _stack_records(records)

    return fn


def _streaming_episode(venv, steps: List[tuple], done_rec, done_k: int, lane: int,
                       args: Dict[str, Any]) -> Dict[str, Any]:
    """One finished lane as a standard columnar episode.

    ``steps`` is the lane's buffered [(record, k_start, k_end)] spans,
    possibly over several calls; observations are rebuilt on the host from
    the twin's compact record fields (``venv.episode_obs``)."""
    P = venv.num_players
    T = sum(k1 - k0 for _, k0, k1 in steps)
    b = lane

    def gather(name, dtype=None):
        out = np.concatenate([rec[name][k0:k1, b] for rec, k0, k1 in steps])
        return out if dtype is None else out.astype(dtype)

    action = gather("action", np.int32)    # (T, P)
    prob = gather("prob", np.float32)
    value = gather("value", np.float32)
    active = gather("active", np.float32)  # (T, P) 0/1: acted this step
    observing = gather("observing", np.float32)
    legal = gather("legal")                # (T, P, A) bool
    compact = {
        name: gather(name)
        for name in steps[0][0]
        if name not in ("active", "observing", "legal", "action", "prob", "value", "done",
                        "outcome")
    }
    obs = venv.episode_obs(compact, observing)       # (T, P, ...)

    final = np.asarray(done_rec["outcome"][done_k][b], np.float32)
    players = list(range(P))
    outcome = {p: float(final[p]) for p in players}

    # a constant per-step reward (Geister's -0.01) and its discounted
    # return-to-go; rewards accrue to every player each step
    step_reward = float(getattr(venv, "step_reward", 0.0))
    reward = np.full((T, P), step_reward, np.float32)
    ret = np.zeros((T, P), np.float32)
    if step_reward:
        acc = np.zeros(P, np.float32)
        for t in range(T - 1, -1, -1):
            acc = reward[t] + args["gamma"] * acc
            ret[t] = acc

    block_len = args["compress_steps"]
    blocks = []
    for lo in range(0, T, block_len):
        hi = min(lo + block_len, T)
        act = active[lo:hi]
        obsv = observing[lo:hi]
        amask = np.where(legal[lo:hi] & (act[..., None] > 0), 0.0, ILLEGAL).astype(np.float32)
        cols = {
            "obs": tree_map(lambda x: x[lo:hi], obs),
            "prob": np.where(act > 0, prob[lo:hi], 1.0).astype(np.float32),
            "action": (action[lo:hi] * (act > 0)).astype(np.int32),
            "amask": amask,
            "value": (value[lo:hi] * obsv).astype(np.float32),
            "reward": reward[lo:hi],
            "ret": ret[lo:hi],
            "tmask": act.astype(np.float32),
            "omask": obsv.astype(np.float32),
            "turn": np.argmax(act, axis=1).astype(np.int32),
        }
        blocks.append(compress_block(cols))

    return {
        "args": {"player": players, "model_id": {p: -1 for p in players}},
        "steps": T,
        "players": players,
        "outcome": outcome,
        "blocks": blocks,
    }


def make_device_rollout(venv, module, args: Dict[str, Any], n_games: int, device=None):
    """The rollout for a twin: persistent streaming lanes for twins
    with the streaming hooks (VectorHungryGeese, VectorParallelTicTacToe,
    VectorGeister), else episodic whole-horizon calls (VectorTicTacToe)."""
    if hasattr(venv, "record"):
        return StreamingDeviceRollout(venv, module, args, n_lanes=n_games, device=device)
    if module.initial_state((1,)) is not None:
        # the episodic rollout steps with hidden=None (a fresh state every
        # ply): a stateful policy self-plays without memory here.  The
        # recorded behaviour probs are still the true behaviour policy, so
        # training stays sound, but the data is not what host actors
        # (which carry hidden) would generate; say so
        print(
            "[handyrl_tpu_torch] episodic device rollout steps a stateful model "
            "(RNN/KV-cache) with a fresh hidden state every ply: self-play "
            "is memoryless on this rollout; for memory-faithful device "
            "self-play give the env a streaming vector twin (record/"
            "reset_done/step hooks), or use host actors",
            file=sys.stderr,
        )
    return DeviceRollout(venv, module, args, n_games, device=device)


class StreamingDeviceRollout(_ModuleHolder):
    """Persistent-lane self-play for twins with the streaming hooks.

    Each ``generate`` advances every lane ``k_steps`` game steps and
    returns the episodes that finished one call earlier; games in progress
    carry over.  Lanes reset the step after their game ends, so the card's
    work does not depend on the episodes' lengths.

    Params may change between calls (the learner publishes new epochs);
    games in flight finish under the newest params and are credited to the
    model id the caller stamps when they come back: the same staleness the
    off-policy corrections absorb."""

    def __init__(self, venv, module, args: Dict[str, Any], n_lanes: int = 256,
                 k_steps: int = 32, device=None):
        super().__init__(module, device)
        self.venv = venv
        self.args = args
        self.n_lanes = n_lanes
        self.k_steps = k_steps
        self._fn = build_streaming_fn(venv, self.module, n_lanes, k_steps,
                                      use_observe_mask=bool(args.get("observation", False)))
        self._state = None
        self._hidden = None
        self._pending = None         # the block in flight (one-call pipeline)
        self._partial: List[List[tuple]] = [[] for _ in range(n_lanes)]
        self.game_steps = 0          # lifetime game steps (>= 1 player acting)
        self.player_steps = 0        # lifetime per-player acting steps
        self.timing: Dict[str, float] = {}

    def launch(self, params, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Load ``params`` (None: keep the module's weights) and launch the
        next block of k_steps steps; returns its records, (K, B, ...)
        tensors on the device (the device replay ingests them there)."""
        self.load(params)
        with torch.inference_mode():
            if self._state is None:
                self._state = self.venv.init(self.n_lanes, gen, self.device)
                self._hidden = self.module.initial_state(
                    (self.n_lanes, self.venv.num_players), self.device)
            state, hidden, record = self._fn(self._state, self._hidden, gen)
        # commit only once the whole block is launched: a block that raises
        # leaves the lanes as they were
        self._state, self._hidden = state, hidden
        return record

    def generate(self, params, gen: torch.Generator) -> List[Dict[str, Any]]:
        """Load ``params`` (None: keep the module's weights), launch the
        next block of k_steps steps, and return the episodes that finished
        in the block before it.  The previous block's records were copied
        to pinned memory behind its launches, so the host reads them after
        this block is launched, while the card works through it."""
        self.load(params)
        t0 = time.perf_counter()
        start = _timing_event(self.device)
        record = self.launch(None, gen)
        with torch.inference_mode():
            pending = HostRecord(record, start)
        prev, self._pending = self._pending, pending
        t1 = time.perf_counter()
        self.timing = {"launch_ms": (t1 - t0) * 1e3}
        if prev is None:
            return []
        record = prev.numpy()
        t2 = time.perf_counter()
        self.timing.update(wait_ms=(t2 - t1) * 1e3, device_ms=prev.device_ms())

        active = record["active"]                    # (K, B, P)
        self.game_steps += int((active.sum(axis=2) > 0).sum())
        self.player_steps += int(active.sum())

        # span bookkeeping: one (record, k0, k1) entry per lane per call in
        # the common case, not one append per lane per step
        episodes = []
        done = record["done"]                        # (K, B)
        lane_has_done = done.any(axis=0)
        K = self.k_steps
        for b in range(self.n_lanes):
            if not lane_has_done[b]:
                self._partial[b].append((record, 0, K))
                continue
            seg = 0
            for kd in np.flatnonzero(done[:, b]):
                kd = int(kd)
                self._partial[b].append((record, seg, kd + 1))
                episodes.append(_streaming_episode(self.venv, self._partial[b], record, kd, b,
                                                   self.args))
                self._partial[b] = []
                seg = kd + 1        # the lane resets at kd + 1 (the next episode)
            if seg < K:
                self._partial[b].append((record, seg, K))
        self.timing["assemble_ms"] = (time.perf_counter() - t2) * 1e3
        return episodes

    def drain(self) -> None:
        """Wait for the block in flight (its copies to the host included)."""
        if self._pending is not None:
            self._pending.wait()
