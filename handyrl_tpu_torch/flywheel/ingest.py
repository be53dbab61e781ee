"""Learner-side harvest ingest: served episodes pulled into training.

Counterpart of ``handyrl_tpu/flywheel/ingest.py``.  A daemon thread beside
the learner polls the serving tier's ``harvest_pull``, applies the learner's
guards and submits what survives through the learner's own request queue,
so harvested episodes take self-play's ``feed_episodes`` path (the store,
the generation books, the epoch cadence).

* **staleness**: an episode served ``staleness_epochs`` or more behind the
  current model epoch is dropped (``flywheel_ingest_stale``);
* **shape**: a blob missing the episode keys is dropped loudly
  (``flywheel_ingest_malformed``);
* **budget**: under ``harvest_fraction < 1`` at most
  ``round(fraction * update_episodes)`` episodes per model epoch go in, the
  rest wait for the next epoch's budget (and its staleness check); at 1.0
  the feed is unthrottled.

The serving tier may start after the learner, restart or drain: the poll
loop reconnects (``utils/retry.py``'s ``retry_call``, then a backoff up to
10 s) for as long as it runs, and counts instead of raising.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..utils.retry import retry_call

__all__ = ["HarvestIngestor"]

_REQUIRED_KEYS = ("args", "steps", "players", "outcome", "blocks")
_TRANSPORT_FAULTS = (ConnectionError, OSError, TimeoutError)


class HarvestIngestor:
    """Polls a serving endpoint for harvested episodes and feeds them to the
    learner.  ``submit(episodes)`` delivers a batch (blocking until taken);
    ``current_epoch()`` reads the model epoch for the staleness bound;
    ``make_client()`` builds a connected client with ``harvest_pull(n)`` and
    ``close()``, injectable so tests run without sockets."""

    def __init__(self, cfg: Dict[str, Any], submit: Callable[[List[Dict[str, Any]]], None],
                 current_epoch: Callable[[], int], make_client: Callable[[], Any]):
        self.staleness_epochs = max(1, int(cfg.get("staleness_epochs", 4)))
        self.poll_s = float(cfg.get("harvest_poll_s", 1.0))
        self.max_pull = max(1, int(cfg.get("harvest_max_pull", 64)))
        fraction = float(cfg.get("harvest_fraction", 0.5))
        update_episodes = int(cfg.get("update_episodes", 0))
        # per-epoch budget; None = unthrottled
        self.epoch_budget: Optional[int] = (
            None if fraction >= 1.0 or update_episodes <= 0
            else max(0, round(fraction * update_episodes))
        )
        self._submit = submit
        self._current_epoch = current_epoch
        self._make_client = make_client
        self._client: Any = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._budget_epoch = -1
        self._budget_left = 0
        # over-budget episodes wait for the next epoch's budget and re-enter
        # through the staleness check
        self._deferred: List[Dict[str, Any]] = []
        self.ingested = 0
        self.dropped_stale = 0
        self.dropped_malformed = 0
        self.server_counts: Dict[str, int] = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "HarvestIngestor":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="flywheel-ingest")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the poll loop and join it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._close_client()

    def _close_client(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    # -- the poll loop ----------------------------------------------------------

    def _connect(self) -> Any:
        return retry_call(self._make_client, attempts=2, base_delay=min(self.poll_s, 0.5),
                          max_delay=2.0, retry_on=_TRANSPORT_FAULTS, sleep=self._stop.wait)

    def _loop(self) -> None:
        backoff = min(self.poll_s, 0.5)
        while not self._stop.is_set():
            try:
                if self._client is None:
                    self._client = self._connect()
                    backoff = min(self.poll_s, 0.5)
                episodes, counts = self._client.harvest_pull(self.max_pull)
                if counts:
                    self.server_counts = dict(counts)
                if episodes:
                    self.ingest(episodes)
                if self._stop.wait(self.poll_s):
                    return
            except _TRANSPORT_FAULTS:
                # the serving tier is absent or draining: starvation shows as
                # a flat flywheel_ingested, never as a learner crash
                self._close_client()
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2.0, 10.0)
            except Exception as exc:
                print(f"flywheel: ingest poll failed: {exc}")
                self._close_client()
                if self._stop.wait(max(self.poll_s, 1.0)):
                    return

    # -- the guarded feed -------------------------------------------------------

    def ingest(self, episodes: List[Any]) -> int:
        """Apply the learner's guards and submit the survivors; returns how
        many were submitted."""
        current = int(self._current_epoch())
        with self._lock:
            deferred, self._deferred = self._deferred, []
        fresh: List[Dict[str, Any]] = []
        for episode in deferred + list(episodes):
            if not isinstance(episode, dict) or any(k not in episode for k in _REQUIRED_KEYS):
                with self._lock:
                    self.dropped_malformed += 1
                keys = (sorted(episode)[:8] if isinstance(episode, dict)
                        else type(episode).__name__)
                print(f"flywheel: dropped malformed harvested blob (keys {keys})")
                continue
            if current - int(episode.get("model_epoch", 0)) >= self.staleness_epochs:
                with self._lock:
                    self.dropped_stale += 1
                continue
            fresh.append(episode)
        if not fresh:
            return 0
        fresh = self._apply_budget(current, fresh)
        if not fresh:
            return 0
        self._submit(fresh)
        with self._lock:
            self.ingested += len(fresh)
        return len(fresh)

    def _apply_budget(self, current: int, episodes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if self.epoch_budget is None:
            return episodes
        with self._lock:
            if current != self._budget_epoch:
                self._budget_epoch = current
                self._budget_left = self.epoch_budget
            take = max(0, min(self._budget_left, len(episodes)))
            self._budget_left -= take
            # past ~4 pulls of backlog the oldest are the next stale drops
            self._deferred = (self._deferred + episodes[take:])[-4 * self.max_pull:]
        return episodes[:take]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            record = {
                "flywheel_ingested": self.ingested,
                "flywheel_ingest_stale": self.dropped_stale,
                "flywheel_ingest_malformed": self.dropped_malformed,
            }
            record.update(self.server_counts)
        return record
