"""Quality plane: live win-rate ledger, promotion gate, quality sentinel.

Counterpart of ``handyrl_tpu/flywheel/quality.py``.  Serving-side; the
training side only reads the signal files.

* ``QualityLedger``: per-snapshot live outcome books on the league's
  ``PayoffMatrix`` (every serving epoch plays the pseudo-member ``"live"``)
  plus a windowed EMA per epoch, the ``quality_wp{epoch}`` metrics.
* ``QualityController``: the watch loop's beat when the flywheel is on.  A
  new verified snapshot is staged as a candidate (``router.stage``: resident
  and addressable, latest unchanged); the server shadow-routes
  ``shadow_fraction`` of latest-addressed traffic to it; after
  ``promote_games`` live games on its books, win points at or above
  ``promote_winrate`` promote it, anything less demotes it and writes a
  rollback signal.  With ``gate_promotions: false`` the beat is the plain
  ``maybe_refresh``.
* the sentinel: after a promotion the displaced incumbent stays resident.
  If the promoted snapshot's live EMA sinks more than ``demote_drop`` under
  the incumbent's baseline, the router demotes back to the incumbent and a
  rollback signal is written for the trainer (``FLYWHEEL_ROLLBACK.json``).
  A promotion that holds through ``4 * quality_window`` games is confirmed.

Signal files live in the model dir and are written atomically;
``SERVING.json`` feeds ``serving_pinned_epochs``, so ``gc_snapshots`` never
collects what the serving tier routes.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Set

from ..league.matchmaker import PayoffMatrix
from ..runtime.checkpoint import (
    CheckpointError,
    atomic_write_bytes,
    latest_verified_epoch,
    load_verified_params,
)

__all__ = [
    "QualityLedger",
    "QualityController",
    "ROLLBACK_FILE",
    "SERVING_FILE",
    "read_rollback_signal",
    "write_rollback_signal",
    "read_serving_state",
    "write_serving_state",
    "serving_pinned_epochs",
]

ROLLBACK_FILE = "FLYWHEEL_ROLLBACK.json"
SERVING_FILE = "SERVING.json"


# -- the signal files (serving tier -> trainer and GC) ------------------------

def write_rollback_signal(model_dir: str, bad_epoch: int, target_epoch: int,
                          reason: str) -> int:
    """Flag ``bad_epoch`` as regressed on live traffic, ``target_epoch`` as
    the verified landing point.  ``seq`` grows by one per signal, so the
    learner adopts each exactly once.  Returns the seq written."""
    path = os.path.join(model_dir, ROLLBACK_FILE)
    prior = read_rollback_signal(model_dir)
    seq = (prior.get("seq", 0) if prior else 0) + 1
    atomic_write_bytes(path, json.dumps({
        "seq": seq,
        "bad_epoch": int(bad_epoch),
        "target_epoch": int(target_epoch),
        "reason": str(reason),
    }, indent=2).encode())
    return seq


def read_rollback_signal(model_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(model_dir, ROLLBACK_FILE)
    try:
        with open(path, "r") as f:
            data = json.load(f)
    except FileNotFoundError:
        return None
    except (ValueError, OSError) as exc:
        # writes are atomic, so this is corruption: said loudly, not fatal
        print(f"flywheel: unreadable rollback signal {path}: {exc}")
        return None
    return data if isinstance(data, dict) else None


def write_serving_state(model_dir: str, latest: Optional[int], candidate: Optional[int],
                        incumbent: Optional[int]) -> None:
    """The epochs the serving tier routes now, for the GC pin."""
    atomic_write_bytes(
        os.path.join(model_dir, SERVING_FILE),
        json.dumps({"latest": latest, "candidate": candidate, "incumbent": incumbent},
                   indent=2).encode(),
    )


def read_serving_state(model_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(model_dir, SERVING_FILE), "r") as f:
            data = json.load(f)
    except (FileNotFoundError, ValueError, OSError):
        return None
    return data if isinstance(data, dict) else None


def serving_pinned_epochs(model_dir: str) -> Set[int]:
    """Epochs ``gc_snapshots`` must not collect because the serving tier
    routes them: the latest, a staged candidate, and the incumbent a
    promotion displaced (the sentinel's demote target)."""
    state = read_serving_state(model_dir) or {}
    pinned: Set[int] = set()
    for key in ("latest", "candidate", "incumbent"):
        value = state.get(key)
        if isinstance(value, int) and value > 0:
            pinned.add(value)
    return pinned


# -- live outcome books -------------------------------------------------------

def _name(epoch: int) -> str:
    return f"epoch_{int(epoch)}"


class QualityLedger:
    """Per-snapshot live outcomes.  Outcomes in [-1, 1] fold to win points
    in [0, 1].  Two views per epoch: exact win points over every recorded
    game (the gate's verdict) and an EMA with ``alpha = 2 / (window + 1)``
    (the sentinel's drift detector)."""

    def __init__(self, window: int = 32):
        self.window = max(1, int(window))
        self._alpha = 2.0 / (self.window + 1.0)
        self._matrix = PayoffMatrix()
        self._ema: Dict[int, float] = {}
        # PayoffMatrix.matches counts whole matches only, not record_score
        self._games = 0
        self._lock = threading.Lock()

    def record(self, epoch: int, outcome: float) -> None:
        epoch = int(epoch)
        if epoch <= 0:
            return  # id 0 is the fresh-init/random route, not a snapshot
        score = min(1.0, max(0.0, (float(outcome) + 1.0) / 2.0))
        with self._lock:
            self._matrix.record_score(_name(epoch), "live", score, 1.0 - score)
            self._games += 1
            prev = self._ema.get(epoch)
            self._ema[epoch] = score if prev is None else prev + self._alpha * (score - prev)

    def games(self, epoch: int) -> int:
        with self._lock:
            return self._matrix.games(_name(epoch), "live")

    def win_points(self, epoch: int) -> Optional[float]:
        with self._lock:
            return self._matrix.win_points(_name(epoch), "live")

    def ema(self, epoch: int) -> Optional[float]:
        with self._lock:
            return self._ema.get(int(epoch))

    def total_games(self) -> int:
        with self._lock:
            return self._games

    def snapshot(self) -> Dict[str, float]:
        """The ``quality_wp{epoch}`` metric family."""
        with self._lock:
            out: Dict[str, float] = {}
            for epoch in self._ema:
                wp = self._matrix.win_points(_name(epoch), "live")
                if wp is not None:
                    out[f"quality_wp{epoch}"] = wp
            return out


# -- promotion gate and quality sentinel --------------------------------------

class QualityController:
    """Drives the router from live quality verdicts: ``tick()`` is the watch
    loop's beat, ``record_outcome`` the server's outcome seam."""

    def __init__(self, router, model_dir: str, cfg: Dict[str, Any],
                 ledger: Optional[QualityLedger] = None):
        self.router = router
        self.model_dir = model_dir
        self.gate = bool(cfg.get("gate_promotions", True))
        self.promote_winrate = float(cfg.get("promote_winrate", 0.55))
        self.promote_games = int(cfg.get("promote_games", 16))
        self.quality_window = int(cfg.get("quality_window", 32))
        self.demote_drop = float(cfg.get("demote_drop", 0.15))
        self.shadow_fraction = float(cfg.get("shadow_fraction", 0.25))
        self.ledger = ledger or QualityLedger(self.quality_window)
        self._lock = threading.Lock()
        # games already on a candidate's books when it was staged: the
        # verdict counts only the games it served
        self._candidate_base = 0
        self._rejected: Set[int] = set()
        # the sentinel's watch: the promoted epoch and its incumbent's bar
        self._watch_epoch: Optional[int] = None
        self._baseline: Optional[float] = None
        self._watch_base_games = 0
        self.promotions = 0
        self.gate_failures = 0
        self.demotions = 0

    def record_outcome(self, epoch: Any, outcome: Any) -> None:
        try:
            self.ledger.record(int(epoch), float(outcome))
        except (TypeError, ValueError):
            raise ValueError(
                f"report_outcome needs an int epoch and a float outcome, got {epoch!r} / "
                f"{outcome!r}"
            )

    def candidate_id(self) -> Optional[int]:
        return self.router.candidate_id()

    def tick(self) -> Optional[str]:
        """One watch-loop beat; returns a line saying what happened (staged,
        promoted, gate failed, demoted), else None.  Never raises."""
        try:
            event = self._tick_inner()
        except Exception as exc:
            print(f"flywheel: quality tick failed: {exc}")
            return None
        try:
            write_serving_state(self.model_dir, self.router.latest_id(),
                                self.router.candidate_id(), self.router.incumbent_id())
        except OSError as exc:
            print(f"flywheel: serving-state write failed: {exc}")
        return event

    def _tick_inner(self) -> Optional[str]:
        if not self.gate:
            published = self.router.maybe_refresh()
            return f"published epoch {published}" if published else None
        candidate = self.router.candidate_id()
        if candidate is None:
            return self._maybe_stage()
        return self._judge(candidate)

    def _maybe_stage(self) -> Optional[str]:
        newest = latest_verified_epoch(self.model_dir)
        current = self.router.latest_id() or 0
        if newest <= 0 or newest <= current or newest in self._rejected:
            return self._sentinel()
        try:
            params = load_verified_params(self.model_dir, newest, pre_verified=True)
        except (CheckpointError, OSError) as exc:
            print(f"flywheel: refusing to stage epoch {newest}: {exc}")
            return self._sentinel()
        self.router.stage(newest, params)
        with self._lock:
            self._candidate_base = self.ledger.games(newest)
        return f"staged candidate epoch {newest}"

    def _judge(self, candidate: int) -> Optional[str]:
        games = self.ledger.games(candidate) - self._candidate_base
        if games < self.promote_games:
            return self._sentinel()
        wp = self.ledger.win_points(candidate)
        incumbent = self.router.latest_id()
        if wp is not None and wp >= self.promote_winrate:
            # the sentinel's bar: the incumbent's live EMA when displaced, or
            # the bar the candidate just cleared when it has no books
            baseline = self.ledger.ema(incumbent) if incumbent else None
            self.router.promote_candidate()
            with self._lock:
                self._watch_epoch = candidate
                self._baseline = baseline if baseline is not None else self.promote_winrate
                self._watch_base_games = self.ledger.games(candidate)
                self.promotions += 1
            return (f"promoted epoch {candidate} (wp {wp:.3f} >= {self.promote_winrate} over "
                    f"{games} games)")
        self.router.demote_candidate()
        with self._lock:
            self._rejected.add(candidate)
            self.gate_failures += 1
        write_rollback_signal(self.model_dir, candidate, incumbent or 0, "gate_failed")
        return (f"gate failed for epoch {candidate} (wp {-1.0 if wp is None else wp:.3f} < "
                f"{self.promote_winrate} over {games} games)")

    def _sentinel(self) -> Optional[str]:
        """Demote a promoted snapshot whose live quality fell past the drop
        bound."""
        with self._lock:
            watch, baseline, base_games = (self._watch_epoch, self._baseline,
                                           self._watch_base_games)
        if watch is None or baseline is None:
            return None
        if self.router.latest_id() != watch or self.router.incumbent_id() is None:
            return None  # already demoted or superseded
        games = self.ledger.games(watch) - base_games
        if games < self.quality_window:
            return None
        live = self.ledger.ema(watch)
        if live is None or live >= baseline - self.demote_drop:
            # a promotion that holds through 4 EMA windows is confirmed: an
            # unbounded watch would demote every promotion in the end
            if games >= 4 * self.quality_window:
                with self._lock:
                    if self._watch_epoch == watch:
                        self._watch_epoch = None
                        self._baseline = None
            return None
        incumbent = self.router.incumbent_id()
        self.router.demote_latest()
        with self._lock:
            self._rejected.add(watch)
            self._watch_epoch = None
            self._baseline = None
            self.demotions += 1
        seq = write_rollback_signal(self.model_dir, watch, incumbent or 0, "quality_regression")
        return (f"quality regression: demoted epoch {watch} (live wp {live:.3f} < baseline "
                f"{baseline:.3f} - {self.demote_drop}), restored incumbent {incumbent}, "
                f"rollback signal seq {seq}")

    def stats_record(self) -> Dict[str, float]:
        with self._lock:
            record: Dict[str, float] = {
                "quality_promotions": self.promotions,
                "quality_gate_failures": self.gate_failures,
                "quality_demotions": self.demotions,
                "quality_games": self.ledger.total_games(),
                "quality_candidate": self.router.candidate_id() or 0,
                "quality_incumbent": self.router.incumbent_id() or 0,
            }
        record.update(self.ledger.snapshot())
        return record
