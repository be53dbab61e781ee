"""On-card replay: self-play records -> training batches, all on the card.

Counterpart of ``handyrl_tpu/runtime/device_replay.py``.  The streaming
self-play path (runtime/device_rollout.py) sends every episode to the host
(episode assembly, the EpisodeStore) and back (make_batch and a fresh
upload per update).  This module keeps the data on the card:

    StreamingDeviceRollout.launch   records (K, B, ...)   [card]
      -> DeviceReplay.ingest into per-lane step RINGS     [card, ~40 launches]
      -> sample windows + assemble the batch + train step [card]

Only scalar counters reach the host (copied to pinned memory behind the
ingest and read one ingest later).

Ring invariants, as in the JAX package:

* Every lane writes one record per game step (finished lanes reset, so
  there are no gaps): the write head is one host integer ``g`` (the global
  step count) and slot ``s`` of every lane holds global step ``g-1 -
  ((g-1-s) mod S)``.
* Slots are overwritten oldest first and windows only read forward, so
  invalidating the slot being overwritten is exact.
* Episode ids are global start steps (``ep_start_g``), unique per lane, so
  finalising an episode (``ep_end_g``, ``valid``) is one masked compare.

The JAX ingest is a ``lax.scan`` over the K steps; here the K records of
each field go into the rings in one or two slice copies (the slots of
consecutive steps are contiguous modulo S), and the episode bookkeeping
of the K steps is a cumulative max/min over the block, which the CPU tests
hold to the JAX scan leaf for leaf across a ring wrap.

Two window modes (``turn_based_training``): ``ff`` (simultaneous-move
twins with ``view_obs``, feed-forward nets, ``burn_in_steps: 0``, one target
player per window: ``_sample_batch``) and ``turn`` (twins with
``view_obs_all``, all players, recurrent nets and the transformer
included; burn-in rows are real earlier steps and the train step warms the
hidden state from zeros over them: ``_sample_batch_turn``).

Threads.  The rollout thread (or the stage's feeder) ingests while the
trainer samples, both on the card's default stream, so enqueue order is
execution order.  One lock per replay is held around the enqueue of each
ingest's ring writes and of each sample's gathers: a sample can then never
read a window that an ingest has half written.  The rings are written in
place (JAX donates them instead), so every batch leaf is a fresh tensor
made by advanced indexing, never a view, and the train step that follows
runs outside the lock.  Random draws come from a ``torch.Generator`` on
the card, through ``_draw_starts`` and ``_draw_players``, which the CPU
tests replace with the JAX draws of the same keys.  On one card there is
no mesh: the JAX constructor's ``mesh`` and lane-sharding checks have no
counterpart, and ``sample_host`` (the multi-process path) waits for
ROADMAP A8.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import resolve_device, tree_leaves, tree_map
from .device_rollout import HostRecord

ILLEGAL = 1e32

# record fields consumed positionally by the ring (everything else the
# streaming fn emits is a twin's compact field, stored as it is)
_CONTROL = ("done",)

# per-step arrays the samplers read by name; every other record field is a
# compact field handed to the twin's observation hook.  "reward"/"ret" are
# optional: streaming rollouts derive a constant step reward in closed form
# (_step_returns), host-born episodes (DeviceEpisodeStage) carry columns
_RECORD_FIELDS = ("active", "observing", "legal", "action", "prob", "value",
                  "outcome", "reward", "ret")

def _zero_counters() -> Dict[str, Any]:
    return {"episodes": 0, "game_steps": 0, "player_steps": 0,
            "outcome_sum": 0.0, "outcome_sq_sum": 0.0}


def _draw_starts(gen: torch.Generator, ok: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` flat indices drawn uniformly, with replacement, among the True
    entries of the flat bool ``ok`` (JAX: ``categorical`` over 0/-inf
    logits).  An inverse CDF on the card: no host sync, and never an index
    out of range (an all-False ``ok``, which the warm-up gates exclude,
    gives index 0 rather than a device-side assert)."""
    counts = torch.cumsum(ok.to(torch.int64), 0)
    u = torch.rand(n, generator=gen, device=ok.device, dtype=torch.float64)
    r = torch.floor(u * counts[-1]).to(torch.int64)
    return torch.searchsorted(counts, r, right=True).clamp_(max=ok.numel() - 1)


def _draw_players(gen: torch.Generator, n: int, num_players: int, device) -> torch.Tensor:
    """One target player per window, uniform (JAX: ``randint``)."""
    return torch.randint(0, num_players, (n,), generator=gen, device=device)


def _slot_gsteps(g: int, S: int, device) -> torch.Tensor:
    """Global step held by each slot: the latest write < g congruent to the
    slot index mod S (meaningful only where valid; callers guard)."""
    s = torch.arange(S, dtype=torch.int32, device=device)
    return g - 1 - torch.remainder(g - 1 - s, S)


def _eligibility(rings, forward_steps: int, burn_in_steps: int = 0) -> torch.Tensor:
    """(B, S) bool: slots that are legal window starts: part of a finished
    resident episode, with in-episode index inside the host sampler's
    ``train_start`` range [0, max(0, steps - forward_steps)]; with burn-in
    the window also reads back min(burn_in, index) steps, which must still
    be resident."""
    valid = rings["valid"]
    S = valid.shape[1]
    g = rings["g"]
    gs = _slot_gsteps(g, S, valid.device)[None, :]          # (1, S)
    idx_in_ep = gs - rings["ep_start_g"]                     # (B, S)
    ep_len = rings["ep_end_g"] - rings["ep_start_g"] + 1
    max_start = torch.clamp(ep_len - forward_steps, min=0)
    ok = valid & (idx_in_ep <= max_start)
    if burn_in_steps:
        lookback = torch.clamp(idx_in_ep, max=burn_in_steps)
        ok = ok & (gs - lookback >= g - S)
    return ok


def _draw_windows(rings, gen: torch.Generator, batch_size: int, forward_steps: int,
                  burn_in: int) -> Dict[str, Any]:
    """The window geometry of both modes: eligible train_starts drawn
    uniformly, per-row in-episode indices and liveness over the (burn_in +
    forward) window, and the per-step record arrays gathered.  Rows with
    ``i_t < 0`` are burn-in underflow (before the episode start); rows
    with ``post`` are past the episode end."""
    valid = rings["valid"]
    S = valid.shape[1]
    T = burn_in + forward_steps
    device = valid.device

    ok = _eligibility(rings, forward_steps, burn_in)
    flat = _draw_starts(gen, ok.reshape(-1), batch_size)
    lane = torch.div(flat, S, rounding_mode="floor")        # (N,) int64
    slot = torch.remainder(flat, S)                          # train_start slot

    gs0 = _slot_gsteps(rings["g"], S, device)[slot]          # (N,) train_start g
    ep_start = rings["ep_start_g"][lane, slot]
    ep_end = rings["ep_end_g"][lane, slot]
    idx0 = gs0 - ep_start                                    # in-episode index

    j = torch.arange(T, dtype=torch.int32, device=device)
    i_t = idx0[:, None] - burn_in + j[None, :]               # (N, T)
    gstep = ep_start[:, None] + i_t                          # (N, T) global step
    live_b = (i_t >= 0) & (gstep <= ep_end[:, None])
    wslots = torch.remainder(slot[:, None] - burn_in + j[None, :], S)   # (N, T) int64
    rows = lane[:, None]

    def gather(x):                                           # (B, S, ...) -> (N, T, ...), a copy
        return x[rows, wslots]

    rec = rings["rec"]
    # the final outcome lives in the episode's end slot (younger than the
    # train_start, so resident whenever the start's valid flag is)
    end_slot = torch.remainder(slot + (ep_end - gs0), S)
    out = {
        "lane": lane, "slot": slot, "i_t": i_t, "gstep": gstep,
        "ep_end": ep_end,
        "ep_len": (ep_end - ep_start + 1).float(),
        "live_b": live_b, "live": live_b.float(),
        "post": gstep > ep_end[:, None],
        "active": gather(rec["active"]).float(),
        "observing": gather(rec["observing"]).float(),
        "prob": gather(rec["prob"]),
        "value": gather(rec["value"]),
        "action": gather(rec["action"]),
        "legal": gather(rec["legal"]),
        "outcome": rec["outcome"][lane, end_slot],           # (N, P)
        "compact": {k: gather(v) for k, v in rec.items() if k not in _RECORD_FIELDS},
    }
    for k in ("reward", "ret"):   # explicit columns of host-born episodes
        if k in rec:
            out[k] = gather(rec[k])
    return out


def _step_returns(venv, gamma: float, w: Dict[str, Any]):
    """Constant per-step reward and its discounted return-to-go on live rows
    (the reverse accumulation of _streaming_episode, in closed form), zero
    elsewhere.  Rows past the end are zeroed by selection, not by a product:
    there ``gamma ** n_t`` has a negative exponent, which overflows fp32 some
    400 rows past the end (0.8 ** -400), and 0 * inf would be NaN (the JAX
    product does that on windows that long)."""
    step_reward = float(getattr(venv, "step_reward", 0.0))
    if not step_reward:
        zeros = torch.zeros(w["live"].shape, device=w["live"].device)
        return zeros, zeros
    n_t = (w["ep_end"][:, None] - w["gstep"] + 1).float()
    if gamma == 1.0:
        ret = step_reward * n_t
    else:
        ret = step_reward * (1 - torch.pow(gamma, n_t)) / (1 - gamma)
    live = w["live_b"]
    return w["live"] * step_reward, torch.where(live, ret, 0.0)


def _sample_batch(rings, gen: torch.Generator, batch_size: int, venv, args: Dict[str, Any],
                  debug: Optional[list] = None) -> Dict[str, Any]:
    """A (batch_size, T, 1, ...) training batch from the rings: the card's
    sample_window + make_batch for the simultaneous / feed-forward /
    single-target-player configuration."""
    P = venv.num_players
    w = _draw_windows(rings, gen, batch_size, args["forward_steps"], 0)
    player = _draw_players(gen, batch_size, P, w["lane"].device)
    if debug is not None:
        debug.append({"lane": w["lane"], "slot": w["slot"], "player": player})
    live_b, live = w["live_b"], w["live"]
    rows = torch.arange(batch_size, device=player.device)

    def pick_player(x):                                      # (N, T, P, ...) -> (N, T, ...)
        return x[rows, :, player]

    act_p = pick_player(w["active"])
    obs_p = pick_player(w["observing"])
    prob_p = pick_player(w["prob"])
    value_p = pick_player(w["value"])
    action_p = pick_player(w["action"])
    legal_p = pick_player(w["legal"])                        # (N, T, A)
    outcome_p = w["outcome"][rows, player]                   # (N,)

    tmask = live * act_p
    omask = live * obs_p
    # leaves (N, T, ...): one tensor for the twins, a tree for host-born
    # episodes whose observation is structured (DeviceEpisodeStage)
    planes = venv.view_obs(w["compact"], player)
    obs = tree_map(
        lambda x: (x * omask.reshape(omask.shape + (1,) * (x.dim() - 2)))[:, :, None], planes)

    amask = torch.where(legal_p & (tmask[..., None] > 0), 0.0, ILLEGAL).float()[:, :, None]
    if "reward" in w:
        reward = pick_player(w["reward"]) * live
        ret = pick_player(w["ret"]) * live
    else:
        reward, ret = _step_returns(venv, args["gamma"], w)
    progress = torch.where(live_b, w["i_t"].float() / w["ep_len"][:, None], 1.0)

    def exp(x):                                              # (N, T) -> (N, T, 1, 1)
        return x[:, :, None, None]

    return {
        "observation": obs,
        "selected_prob": exp(torch.where(tmask > 0, prob_p, 1.0)),
        "value": exp(torch.where(live_b, value_p * obs_p, outcome_p[:, None])),
        "action": exp(torch.where(tmask > 0, action_p, 0).to(torch.int32)),
        "outcome": outcome_p[:, None, None, None],
        "reward": exp(reward),
        "return": exp(ret),
        "episode_mask": exp(live),
        "turn_mask": exp(tmask),
        "observation_mask": exp(omask),
        "action_mask": amask,
        "progress": progress[:, :, None],
    }


def _sample_batch_turn(rings, gen: torch.Generator, batch_size: int, venv,
                       args: Dict[str, Any], debug: Optional[list] = None) -> Dict[str, Any]:
    """All-player windows: the card's sample_window + make_batch for
    ``turn_based_training: true`` with ``observation: true`` (target players
    = all).  Windows span burn_in + forward_steps rows with the host's three
    padding regions: zeros before the episode start, live data, and
    outcome-frozen rows past its end."""
    burn_in = args.get("burn_in_steps", 0)
    T = burn_in + args["forward_steps"]
    P = venv.num_players

    w = _draw_windows(rings, gen, batch_size, args["forward_steps"], burn_in)
    if debug is not None:
        debug.append({"lane": w["lane"], "slot": w["slot"],
                      "player": torch.full((batch_size,), -1, dtype=torch.int64)})
    live_b, live, outcome = w["live_b"], w["live"], w["outcome"]

    act = live[..., None] * w["active"]                      # (N, T, P)
    obsv = live[..., None] * w["observing"]

    planes = venv.view_obs_all(w["compact"])                 # leaves (N, T, P, ...)
    obs = tree_map(lambda x: x * obsv.reshape(obsv.shape + (1,) * (x.dim() - 3)), planes)

    amask = torch.where(w["legal"] & (act[..., None] > 0), 0.0, ILLEGAL).float()

    if "reward" in w:
        reward_col = (w["reward"] * live[..., None])[..., None]   # (N, T, P, 1)
        ret_col = (w["ret"] * live[..., None])[..., None]
    else:
        reward, ret = _step_returns(venv, args["gamma"], w)
        reward_col = reward[:, :, None, None].expand(batch_size, T, P, 1).contiguous()
        ret_col = ret[:, :, None, None].expand(batch_size, T, P, 1).contiguous()

    # live rows carry the recorded value (x observing), rows past the end
    # freeze at the outcome, burn-in underflow rows are 0
    value_b = torch.where(
        live_b[..., None], w["value"] * obsv,
        torch.where(w["post"][..., None], outcome[:, None, :], 0.0))
    progress = torch.where(live_b, w["i_t"].float() / w["ep_len"][:, None], 1.0)

    return {
        "observation": obs,
        "selected_prob": torch.where(act > 0, w["prob"], 1.0)[..., None],
        "value": value_b[..., None],
        "action": torch.where(act > 0, w["action"], 0).to(torch.int32)[..., None],
        "outcome": outcome[:, None, :, None],
        "reward": reward_col,
        "return": ret_col,
        "episode_mask": live[:, :, None, None],
        "turn_mask": act[..., None],
        "observation_mask": obsv[..., None],
        "action_mask": amask,
        "progress": progress[:, :, None],
    }


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class DeviceReplay:
    """Per-lane ring buffers on the card, with ingest and sample-and-train.

    ``slots`` is the ring length in steps per lane; an episode longer than
    the ring keeps its newest ``slots`` steps sampleable."""

    def __init__(self, venv, module, args: Dict[str, Any], n_lanes: int, slots: int = 1024,
                 device=None):
        name = getattr(venv, "__name__", type(venv).__name__)
        if not hasattr(venv, "record"):
            raise ValueError(
                f"device_replay needs a vector env with compact-record "
                f"streaming hooks; {name} lacks them"
            )
        if args.get("turn_based_training", True):
            self.mode = "turn"
            if not args.get("observation", False):
                raise ValueError(
                    "device_replay with turn_based_training: true requires "
                    "observation: true (both players' views recorded; the "
                    "turn-player-gather batch layout keeps the host path)"
                )
            if not hasattr(venv, "view_obs_all"):
                raise ValueError(
                    f"device_replay (turn-based) needs {name}.view_obs_all "
                    "(device-side all-player observation reconstruction)"
                )
            min_slots = args.get("burn_in_steps", 0) + args["forward_steps"]
            if slots <= min_slots:
                raise ValueError(
                    f"device_replay_slots must exceed burn_in_steps + "
                    f"forward_steps = {min_slots}"
                )
        else:
            self.mode = "ff"
            if not getattr(venv, "simultaneous", False):
                raise ValueError(
                    "device_replay with turn_based_training: false needs a "
                    f"simultaneous-move vector env; {name} is turn-based"
                )
            if not hasattr(venv, "view_obs"):
                raise ValueError(
                    f"device_replay needs {name}.view_obs (device-side "
                    "single-player observation reconstruction)"
                )
            if module.initial_state((1, 1)) is not None:
                raise ValueError(
                    "recurrent nets need whole-window hidden warmup — use "
                    "turn_based_training: true (all-player windows) or the "
                    "host path"
                )
            if args.get("burn_in_steps", 0) != 0:
                raise ValueError(
                    "device_replay with turn_based_training: false requires "
                    "burn_in_steps: 0"
                )
        self.venv = venv
        self.args = args
        self.n_lanes = n_lanes
        self.slots = slots
        self.device = resolve_device(device)
        # held around the enqueue of every ring write and every gather
        self.lock = threading.Lock()
        self.rings: Optional[Dict[str, Any]] = None   # built from the first records
        self._pending: Optional[HostRecord] = None    # the last ingest's stats
        self.counters = _zero_counters()
        # deferred stats (ingest_counted(defer=True)): read one ingest late,
        # so the read overlaps the next ingest instead of waiting on its own
        self._stats_fifo: deque = deque()

    # -- rings and ingest ---------------------------------------------------

    def _init_rings(self, records: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Rings matching one step's record layout; plain tensors even when
        the first ingest runs under inference mode (the trainer reads them
        outside it)."""
        B, S, device = self.n_lanes, self.slots, self.device
        with torch.inference_mode(False):
            return {
                "rec": {k: torch.zeros((B, S) + tuple(v.shape[2:]), dtype=v.dtype, device=device)
                        for k, v in records.items() if k not in _CONTROL},
                "ep_start_g": torch.full((B, S), -1, dtype=torch.int32, device=device),
                "ep_end_g": torch.full((B, S), -1, dtype=torch.int32, device=device),
                "valid": torch.zeros((B, S), dtype=torch.bool, device=device),
                "cur_start_g": torch.zeros((B,), dtype=torch.int32, device=device),
                "g": 0,
            }

    def _write(self, records: Dict[str, torch.Tensor]) -> None:
        """Fold K steps into the rings, as the JAX scan of K write_steps.

        The episode id entering step t is the running max of ``g+1`` over
        the done steps before it (or the lane's current id), and the end of
        the episode holding step t is the first done step at or after it: a
        cumulative max forward and a cumulative min backward.  Only the last
        min(K, S) steps reach the rings (earlier ones would be overwritten
        in the same block); older slots of the episode in progress are
        finalised by their id."""
        rings = self.rings
        S = self.slots
        g0 = rings["g"]
        done = records["done"].to(torch.bool)                    # (K, B)
        K = done.shape[0]
        gk = torch.arange(g0, g0 + K, dtype=torch.int64, device=self.device)[:, None]
        cur = rings["cur_start_g"].to(torch.int64)
        after = torch.cummax(torch.where(done, gk + 1, cur[None, :]), dim=0).values
        start = torch.cat([cur[None, :], after[:-1]])            # (K, B) id at each step
        big = torch.iinfo(torch.int64).max
        end = torch.cummin(torch.where(done, gk, big).flip(0), dim=0).values.flip(0)
        end = torch.where(end == big, -1, end)                   # (K, B) -1: unfinished

        W = min(K, S)
        p0 = (g0 + K - W) % S
        n1 = min(W, S - p0)

        def put(ring, src):                                      # src (K, B, ...)
            src = src[K - W:].transpose(0, 1)
            ring[:, p0:p0 + n1] = src[:, :n1]
            if n1 < W:
                ring[:, :W - n1] = src[:, n1:]

        for k, v in records.items():
            if k not in _CONTROL:
                put(rings["rec"][k], v)
        put(rings["ep_start_g"], start)
        put(rings["ep_end_g"], end)
        put(rings["valid"], end >= 0)
        # the episode in progress when the block began ends at the lane's
        # first done step: every resident slot of it is finalised
        mine = (rings["ep_start_g"] == rings["cur_start_g"][:, None]) & done.any(0)[:, None]
        rings["ep_end_g"].copy_(torch.where(mine, end[0][:, None].to(torch.int32),
                                            rings["ep_end_g"]))
        rings["valid"] |= mine
        rings["cur_start_g"].copy_(after[-1])
        rings["g"] = g0 + K

    @staticmethod
    def _stats(records: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        done = records["done"].to(torch.bool)                    # (K, B)
        active = records["active"].to(torch.int64)               # (K, B, P)
        outcome = records["outcome"].float()
        donef = done[..., None].float()
        return {
            "episodes": done.sum(),
            "game_steps": (active.sum(dim=2) > 0).sum(),
            "player_steps": active.sum(),
            # the mean self-play outcome over finished episodes, per player
            "outcome_sum": (outcome * donef).sum(dim=(0, 1)),
            "outcome_sq_sum": (outcome ** 2 * donef).sum(),
        }

    def ingest(self, records) -> HostRecord:
        """Fold a (K, B, ...) record batch (one rollout launch, or a chunk of
        host-born episodes as numpy) into the rings.  Returns the block's
        stats on their way to the host (``.numpy()`` waits for them).
        Host-born records cross to the card before the lock is taken."""
        records = {k: _as_tensor(v, self.device) for k, v in records.items()}
        with self.lock, torch.no_grad():
            if self.rings is None:
                self.rings = self._init_rings(records)
            self._write(records)
            stats = HostRecord(self._stats(records))
            self._pending = stats
        return stats

    def _account(self, stats: HostRecord) -> Dict[str, np.ndarray]:
        """Read one ingest's stats on the host (waits for that ingest only)
        and fold them into the cumulative counters."""
        host = stats.numpy()
        self.counters["episodes"] += int(host["episodes"])
        self.counters["game_steps"] += int(host["game_steps"])
        self.counters["player_steps"] += int(host["player_steps"])
        self.counters["outcome_sum"] += float(host["outcome_sum"].sum())
        self.counters["outcome_sq_sum"] += float(host["outcome_sq_sum"])
        return host

    def ingest_counted(self, records, defer: bool = False):
        """``ingest`` and the host read of its stats, added to ``counters``.

        ``defer=True`` reads the stats of ingest N only after ingest N+1 has
        been enqueued, so the rollout thread never waits on its own ingest;
        it returns the PREVIOUS ingest's stats (None on the first call), and
        ``flush_counted`` reads the tail.  The totals are the same either
        way."""
        stats = self.ingest(records)
        if not defer:
            return self._account(stats)
        self._stats_fifo.append(stats)
        if len(self._stats_fifo) < 2:
            return None
        return self._account(self._stats_fifo.popleft())

    def flush_counted(self) -> Optional[Dict[str, float]]:
        """Read and account every deferred ingest still pending; their
        aggregate, or None when nothing was pending."""
        agg: Optional[Dict[str, float]] = None
        while self._stats_fifo:
            stats = self._account(self._stats_fifo.popleft())
            if agg is None:
                agg = _zero_counters()
            agg["episodes"] += int(stats["episodes"])
            agg["game_steps"] += int(stats["game_steps"])
            agg["player_steps"] += int(stats["player_steps"])
            agg["outcome_sum"] += float(stats["outcome_sum"].sum())
            agg["outcome_sq_sum"] += float(stats["outcome_sq_sum"])
        return agg

    def drain(self) -> None:
        """Wait for the last ingest (its stats' copies to the host included)."""
        if self._pending is not None:
            self._pending.wait()

    def eligible_count(self) -> int:
        """Sampleable window starts (a host sync: for warm-up gates, not per
        step)."""
        if self.rings is None:
            return 0
        with self.lock:
            total = _eligibility(self.rings, self.args["forward_steps"],
                                 self.args.get("burn_in_steps", 0)).sum()
        return int(total)

    # -- sample + train ------------------------------------------------------

    def _sample(self, gen: torch.Generator, batch_size: int, debug: Optional[list] = None):
        fn = _sample_batch_turn if self.mode == "turn" else _sample_batch
        with self.lock, torch.no_grad():
            return fn(self.rings, gen, batch_size, self.venv, self.args, debug)

    def sample(self, gen: torch.Generator, batch_size: int, with_info: bool = False):
        """``batch_size`` windows sampled and assembled from the rings, with
        (``with_info``) each row's lane, train_start slot and target player
        (-1: all players) as numpy."""
        info: Optional[list] = [] if with_info else None
        batch = self._sample(gen, batch_size, info)
        if with_info:
            return batch, {k: v.cpu().numpy() for k, v in info[0].items()}
        return batch

    def train_fn(self, ctx, fused_steps: int = 1):
        """``fn(gen, lr) -> metrics``: ``fused_steps`` sample+SGD updates from
        the current rings, metrics summed over them (as
        ``TrainContext.train_steps``).  Each update samples under the lock
        and steps outside it; the step's one read of its metrics keeps the
        trainer at most one update ahead of the card."""
        B = self.args["batch_size"]

        def fn(gen: torch.Generator, lr: float) -> Dict[str, float]:
            total: Dict[str, float] = {}
            for _ in range(fused_steps):
                metrics = ctx.train_step(self._sample(gen, B), lr)
                for key, value in metrics.items():
                    total[key] = total.get(key, 0.0) + value
            return total

        return fn


# -- host-born episodes: episodes -> rings -------------------------------------


class EpisodeObsView:
    """A venv-like view for host-born episodes staged into rings.

    Host-born episodes carry their whole observation planes, so those live
    in the ring as they are (tree leaves flattened in sorted-key order into
    ``obs<i>`` fields) and the "reconstruction" is a gather by player.
    ``simultaneous`` means make_batch's non-turn-based layout (one target
    player per window), defined for any env's episodes; ``step_reward`` is
    unused, the ring carries the generator's reward/return columns."""

    simultaneous = True
    step_reward = 0.0
    # DeviceReplay's constructor only probes for the streaming hook
    record = None

    def __init__(self, num_players: int, obs_template, n_obs_leaves: int, obs_spec=None):
        self.num_players = num_players
        self._template = obs_template
        self._n = n_obs_leaves
        # obs_int8: the per-leaf (scale, zero_point) the episodes' planes were
        # quantized under (they carry it as obs_scale / obs_zero); None = the
        # rings hold the planes at their own dtype
        self._spec = obs_spec

    def _tree(self, compact: Dict[str, Any]):
        leaves = iter([compact[f"obs{i}"] for i in range(self._n)])
        tree = tree_map(lambda _: next(leaves), self._template)
        if self._spec is not None:
            # the rings stay int8; the sampled windows widen on the card
            from ..models.quantize import dequantize_obs_tree

            tree = dequantize_obs_tree(tree, self._spec)
        return tree

    def view_obs(self, compact: Dict[str, Any], player: torch.Tensor):
        rows = torch.arange(player.shape[0], device=player.device)
        return tree_map(lambda x: x[rows, :, player], self._tree(compact))

    def view_obs_all(self, compact: Dict[str, Any]):
        return self._tree(compact)                           # leaves (N, T, P, ...)


class DeviceEpisodeStage:
    """Host-born episodes uploaded once into DeviceReplay rings.

        episode (decoded dict, or its wire-codec bytes)
          -> per-step record columns, queued per lane  [host, once]
          -> (chunk, lanes) ingest calls               [one upload per chunk]
          -> windows sampled and assembled on the card by the same samplers
             as the streaming path

    Every lane advances one slot per global step, so episodes queue per
    lane (the shortest queue first) and a chunk flushes only when every
    lane has ``chunk_steps`` steps queued: an episode occupies a contiguous
    lane-local span whose indices equal the ring's global steps.  Keep
    ``n_lanes * chunk_steps`` well below ``minimum_episodes`` x the typical
    episode length, or the first batch waits on generation."""

    def __init__(self, module, args: Dict[str, Any], n_lanes: int = 8, slots: int = 1024,
                 chunk_steps: int = 64, track_episodes: bool = False, device=None):
        # DeviceReplay's argument checks, here, eagerly: the replay itself is
        # built from the first episode on the feeder thread, too late for
        # make_pipeline's loud fallback
        if args.get("turn_based_training", True):
            if not args.get("observation", False):
                raise ValueError(
                    "batch_pipeline: device with turn_based_training: true "
                    "requires observation: true (all-player windows; the "
                    "turn-player-gather batch layout keeps the host path)"
                )
            min_slots = args.get("burn_in_steps", 0) + args["forward_steps"]
            if slots <= min_slots:
                raise ValueError(
                    f"device_stage_slots must exceed burn_in_steps + "
                    f"forward_steps = {min_slots}"
                )
        else:
            if module.initial_state((1, 1)) is not None:
                raise ValueError(
                    "batch_pipeline: device with a recurrent net needs "
                    "turn_based_training: true (whole-window hidden warmup)"
                )
            if args.get("burn_in_steps", 0) != 0:
                raise ValueError(
                    "batch_pipeline: device with turn_based_training: false "
                    "requires burn_in_steps: 0"
                )
        self.module = module
        self.args = args
        self.n_lanes = n_lanes
        self.slots = slots
        self.chunk_steps = int(chunk_steps)
        self.device = resolve_device(device)
        self.replay: Optional[DeviceReplay] = None
        self._view: Optional[EpisodeObsView] = None
        # per-lane FIFO of [record dict with (T, ...) numpy leaves, offset]
        self._queues: List[List[list]] = [[] for _ in range(n_lanes)]
        self._qlen = [0] * n_lanes     # steps queued, not flushed
        self._qtotal = [0] * n_lanes   # steps ever queued = the ring g of the next
        self.episodes_staged = 0
        self.steps_staged = 0
        self.chunks_flushed = 0
        # (g0, g1, episode) spans per lane, for tests (unbounded over a run)
        self.spans: Optional[List[list]] = [[] for _ in range(n_lanes)] if track_episodes else None

    # -- episode intake ------------------------------------------------------

    def add_blob(self, blob: bytes) -> None:
        """Stage one episode from its wire-codec bytes."""
        from . import codec

        self.add_episode(codec.loads(blob))

    def add_episode(self, episode: Dict[str, Any]) -> None:
        """Decode one columnar episode into per-step record arrays and queue
        it on the shortest lane."""
        from .batch import _concat_columns
        from .replay import decompress_block

        cols = _concat_columns([decompress_block(b) for b in episode["blocks"]])
        T = int(episode["steps"])
        P = cols["prob"].shape[1]
        outcome = np.asarray([episode["outcome"][p] for p in episode["players"]], np.float32)
        done = np.zeros((T,), bool)
        done[-1] = True
        rec = {
            "active": cols["tmask"].astype(np.float32),
            "observing": cols["omask"].astype(np.float32),
            "legal": cols["amask"] == 0.0,
            "action": cols["action"].astype(np.int32),
            "prob": cols["prob"].astype(np.float32),
            "value": cols["value"].astype(np.float32),
            "reward": cols["reward"].astype(np.float32),
            "ret": cols["ret"].astype(np.float32),
            "outcome": np.broadcast_to(outcome, (T, P)).copy(),
            "done": done,
        }
        obs_leaves = tree_leaves(cols["obs"])
        for i, leaf in enumerate(obs_leaves):
            rec[f"obs{i}"] = np.asarray(leaf)
        if self.replay is None:
            from ..models.quantize import episode_obs_spec

            self._view = EpisodeObsView(P, tree_map(lambda _: None, cols["obs"]), len(obs_leaves),
                                        obs_spec=episode_obs_spec(episode))
            self.replay = DeviceReplay(self._view, self.module, self.args, self.n_lanes,
                                       slots=self.slots, device=self.device)
        lane = min(range(self.n_lanes), key=lambda i: self._qlen[i])
        if self.spans is not None:
            self.spans[lane].append((self._qtotal[lane], self._qtotal[lane] + T - 1, episode))
        self._queues[lane].append([rec, 0])
        self._qlen[lane] += T
        self._qtotal[lane] += T
        self.episodes_staged += 1
        self.steps_staged += T

    # -- chunk assembly and flush ---------------------------------------------

    def _take(self, lane: int, k: int) -> Dict[str, np.ndarray]:
        """Pop ``k`` steps off a lane's queue (possibly across episodes) as
        one record dict with (k, ...) leaves."""
        q = self._queues[lane]
        parts: List[Dict[str, np.ndarray]] = []
        left = k
        while left > 0:
            rec, off = q[0]
            T = rec["done"].shape[0]
            take = min(left, T - off)
            parts.append({key: val[off:off + take] for key, val in rec.items()})
            if off + take == T:
                q.pop(0)
            else:
                q[0][1] = off + take
            left -= take
        self._qlen[lane] -= k
        if len(parts) == 1:
            return parts[0]
        return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}

    def ready(self) -> bool:
        """True when every lane has a full chunk queued."""
        return self.replay is not None and min(self._qlen) >= self.chunk_steps

    def flush(self) -> int:
        """Fold every complete (chunk, lanes) block into the rings; returns
        the number of chunks ingested (stats read one chunk late)."""
        n = 0
        K = self.chunk_steps
        while self.ready():
            chunks = [self._take(lane, K) for lane in range(self.n_lanes)]
            records = {key: np.stack([c[key] for c in chunks], axis=1) for key in chunks[0]}
            self.replay.ingest_counted(records, defer=True)
            self.chunks_flushed += 1
            n += 1
        return n

    def eligible(self) -> int:
        """Sampleable window starts now resident (a host sync)."""
        if self.replay is None:
            return 0
        return self.replay.eligible_count()

    def drain(self) -> None:
        """Account the deferred stats and wait for the last ingest."""
        if self.replay is not None:
            self.replay.flush_counted()
            self.replay.drain()

