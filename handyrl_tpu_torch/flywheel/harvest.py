"""Serving-side harvest: served sessions assembled into training episodes.

Counterpart of ``handyrl_tpu/flywheel/harvest.py``.  The serving server
sees every observation (each ``infer`` frame) and every policy and value
(each reply); the client reports what only it knows: the sampled action,
the legal set, the step rewards, the turn player and the outcome.  The
recorder binds one game's per-player sessions into a harvest episode,
captures both directions at those two seams, and finalizes through the
port's ``runtime.generation.finalize_episode``: a harvested episode is
byte-identical to the self-play encoding of the same trajectory.

Guards, each counted, never silent:

* a step whose acting player has no captured policy or legal set marks the
  episode malformed (``dropped_malformed`` at close);
* a close without a well-sized outcome, an episode with no step, or one
  idle past ``ttl_s`` counts as ``dropped_truncated``;
* every kept episode carries the epoch that served it (``model_epoch``)
  for the learner's staleness bound.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.generation import finalize_episode
from ..utils import softmax

__all__ = ["HarvestError", "HarvestRecorder"]


class HarvestError(ValueError):
    """A bad harvest frame (unknown hid, malformed payload): the client gets
    a ``bad_request`` error reply."""


class _OpenEpisode:
    __slots__ = ("hid", "players", "sids", "rows", "pending", "model_epoch", "malformed",
                 "touched")

    def __init__(self, hid: str, players: Sequence[int], sids: Sequence[str]):
        self.hid = hid
        self.players: List[int] = [int(p) for p in players]
        self.sids: Dict[str, int] = {str(s): int(p) for s, p in zip(sids, players)}
        self.rows: List[Dict[str, Any]] = []
        # per-player captures since the last closed step: {player: {obs, policy, value}}
        self.pending: Dict[int, Dict[str, Any]] = {}
        self.model_epoch: Optional[int] = None  # the first served epoch seen
        self.malformed: Optional[str] = None
        self.touched = time.monotonic()


class HarvestRecorder:
    """Assembles served sessions into Generator-format episodes."""

    def __init__(self, gen_args: Dict[str, Any], max_open: int = 256, max_complete: int = 4096,
                 ttl_s: float = 600.0, obs_spec_fn=None):
        # gamma, compress_steps and obs_int8: what finalize reads of the
        # train args; obs_spec_fn only under obs_int8, as the Generator has it
        self.gen_args = dict(gen_args)
        self.obs_spec_fn = obs_spec_fn
        self.max_open = int(max_open)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._open: Dict[str, _OpenEpisode] = {}
        self._by_sid: Dict[str, _OpenEpisode] = {}
        self._complete: deque = deque(maxlen=max(1, int(max_complete)))
        self._hid_n = 0
        self.harvested = 0
        self.dropped_malformed = 0
        self.dropped_truncated = 0
        self.pulled = 0

    # -- lifecycle ------------------------------------------------------------

    def open_episode(self, players: Sequence[int], sids: Sequence[str]) -> str:
        if not players or len(players) != len(sids):
            raise HarvestError(
                f"harvest_open needs parallel players/sids lists, got {len(players or ())} "
                f"players / {len(sids or ())} sids"
            )
        with self._lock:
            if len(self._open) >= self.max_open:
                # a client leak must not grow the server without bound: the
                # oldest open episode goes, counted truncated
                oldest = min(self._open.values(), key=lambda e: e.touched)
                self._drop_locked(oldest, truncated=True)
            self._hid_n += 1
            hid = f"h{self._hid_n}"
            ep = _OpenEpisode(hid, players, sids)
            self._open[hid] = ep
            for sid in ep.sids:
                self._by_sid[sid] = ep
        return hid

    def _unbind_locked(self, ep: _OpenEpisode) -> None:
        self._open.pop(ep.hid, None)
        for sid in ep.sids:
            if self._by_sid.get(sid) is ep:
                self._by_sid.pop(sid, None)

    def _drop_locked(self, ep: _OpenEpisode, truncated: bool) -> None:
        self._unbind_locked(ep)
        if truncated:
            self.dropped_truncated += 1
        else:
            self.dropped_malformed += 1

    def sweep(self, now: Optional[float] = None) -> int:
        """Drop open episodes idle past ``ttl_s`` (counted truncated);
        returns how many."""
        now = time.monotonic() if now is None else now
        with self._lock:
            stale = [e for e in self._open.values() if now - e.touched > self.ttl_s]
            for ep in stale:
                self._drop_locked(ep, truncated=True)
        return len(stale)

    # -- the two serving-seam captures ---------------------------------------

    def capture_request(self, sid: Optional[str], obs: Any) -> None:
        """The infer seam: the observation of the session's player.  A sid
        bound to no open episode is a plain serving session: nothing."""
        if sid is None:
            return
        with self._lock:
            ep = self._by_sid.get(sid)
            if ep is None:
                return
            ep.pending.setdefault(ep.sids[sid], {})["obs"] = obs
            ep.touched = time.monotonic()

    def capture_reply(self, sid: Optional[str], served: Any, out: Any) -> None:
        """The reply seam: the policy and value produced for the session's
        pending observation, and the serving epoch."""
        if sid is None or not isinstance(out, dict):
            return
        with self._lock:
            ep = self._by_sid.get(sid)
            if ep is None:
                return
            cap = ep.pending.setdefault(ep.sids[sid], {})
            if out.get("policy") is not None:
                cap["policy"] = np.asarray(out["policy"], dtype=np.float32)
            value = out.get("value")
            if value is not None:
                # the Generator's scalarization
                cap["value"] = float(np.asarray(value).reshape(-1)[0])
            if ep.model_epoch is None and isinstance(served, int):
                ep.model_epoch = served
            ep.touched = time.monotonic()

    # -- the client-reported step and close -----------------------------------

    def step(self, hid: str, actions: Sequence[Optional[int]],
             legal: Sequence[Optional[Sequence[int]]], rewards: Sequence[Optional[float]],
             turn: Optional[int]) -> int:
        """Close one step from the pending captures and the client's
        actions, legal sets and rewards, as one Generator-format row.
        Returns the episode's step count."""
        with self._lock:
            ep = self._open.get(hid)
            if ep is None:
                raise HarvestError(f"unknown harvest episode {hid!r}")
            ep.touched = time.monotonic()
            players = ep.players
            if not (len(actions) == len(legal) == len(rewards) == len(players)):
                ep.malformed = "step arity mismatch"
                return len(ep.rows)
            row: Dict[str, Any] = {
                key: {p: None for p in players}
                for key in ("obs", "prob", "amask", "action", "value", "reward")
            }
            for p, cap in ep.pending.items():
                if "obs" in cap:
                    row["obs"][p] = cap["obs"]
                if cap.get("value") is not None:
                    row["value"][p] = cap["value"]
            for j, p in enumerate(players):
                if rewards[j] is not None:
                    row["reward"][p] = float(rewards[j])
                action = actions[j]
                if action is None:
                    continue
                logits = (ep.pending.get(p) or {}).get("policy")
                legal_j = legal[j]
                if logits is None or not legal_j:
                    # a prob made up here would poison the importance weights
                    ep.malformed = (f"step {len(ep.rows)}: player {p} acted without a "
                                    "captured policy/legal set")
                    continue
                # the Generator's masking and probability
                amask = np.full_like(logits, 1e32)
                amask[np.asarray(legal_j, dtype=np.int64)] = 0.0
                probs = softmax(logits - amask)
                row["prob"][p] = float(probs[int(action)])
                row["amask"][p] = amask
                row["action"][p] = int(action)
            row["turn"] = players.index(int(turn)) if turn is not None else 0
            ep.rows.append(row)
            ep.pending = {}
            return len(ep.rows)

    def close(self, hid: str, outcome: Optional[Sequence[float]]) -> Optional[Dict[str, Any]]:
        """Finalize the episode through the Generator's recipe and queue it
        for pull; None when it was dropped (counted)."""
        with self._lock:
            ep = self._open.get(hid)
            if ep is None:
                raise HarvestError(f"unknown harvest episode {hid!r}")
            self._unbind_locked(ep)
            if ep.malformed is not None:
                self.dropped_malformed += 1
                print(f"flywheel: dropped malformed episode {hid} ({ep.malformed})")
                return None
            if outcome is None or len(outcome) != len(ep.players) or not ep.rows:
                self.dropped_truncated += 1
                print(f"flywheel: dropped truncated episode {hid} ({len(ep.rows)} steps, "
                      f"outcome {'missing' if outcome is None else 'mis-sized'})")
                return None
            players = ep.players
            epoch = ep.model_epoch if ep.model_epoch is not None else 0
        # outside the lock: zlib over the whole trajectory
        outcome_map = {p: float(outcome[j]) for j, p in enumerate(players)}
        args = {"player": list(players), "model_id": {p: epoch for p in players},
                "harvest": True}
        try:
            episode = finalize_episode(ep.rows, players, outcome_map, args, self.gen_args,
                                       obs_spec_fn=self.obs_spec_fn)
        except Exception as exc:
            with self._lock:
                self.dropped_malformed += 1
            print(f"flywheel: dropped unfinalizable episode {hid} ({type(exc).__name__}: {exc})")
            return None
        episode["model_epoch"] = epoch
        with self._lock:
            self._complete.append(episode)
            self.harvested += 1
        return episode

    # -- the learner's pull ---------------------------------------------------

    def pull(self, max_episodes: int = 64) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
        """Up to ``max_episodes`` completed episodes (ownership passes to the
        caller) and the cumulative counters."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            while self._complete and len(out) < max(1, int(max_episodes)):
                out.append(self._complete.popleft())
            self.pulled += len(out)
            counts = self._stats_locked()
        return out, counts

    def _stats_locked(self) -> Dict[str, int]:
        return {
            "flywheel_episodes": self.harvested,
            "flywheel_open": len(self._open),
            "flywheel_queued": len(self._complete),
            "flywheel_dropped_malformed": self.dropped_malformed,
            "flywheel_dropped_truncated": self.dropped_truncated,
            "flywheel_pulled": self.pulled,
        }

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return self._stats_locked()
