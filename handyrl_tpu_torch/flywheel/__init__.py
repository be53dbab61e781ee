"""The data flywheel: served traffic back into training, behind quality guards.

Counterpart of ``handyrl_tpu/flywheel/``:

* ``harvest.py``: the serving server assembles per-session transitions into
  episodes through the self-play recipe (``finalize_episode``), byte for
  byte the self-play encoding, for the learner to pull;
* ``quality.py``: the per-snapshot live win-rate ledger, the promotion gate
  and the quality sentinel with its rollback signal;
* ``ingest.py``: the learner's pull loop with its staleness, shape and
  budget guards, feeding ``feed_episodes``.

``FlywheelPlane`` is the serving server's one attachment point.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .harvest import HarvestError, HarvestRecorder
from .ingest import HarvestIngestor
from .quality import (
    ROLLBACK_FILE,
    SERVING_FILE,
    QualityController,
    QualityLedger,
    read_rollback_signal,
    read_serving_state,
    serving_pinned_epochs,
    write_rollback_signal,
    write_serving_state,
)

__all__ = [
    "FlywheelPlane",
    "HarvestError",
    "HarvestRecorder",
    "HarvestIngestor",
    "QualityController",
    "QualityLedger",
    "ROLLBACK_FILE",
    "SERVING_FILE",
    "read_rollback_signal",
    "write_rollback_signal",
    "read_serving_state",
    "write_serving_state",
    "serving_pinned_epochs",
]


class FlywheelPlane:
    """What the serving server needs, behind one object: harvest episode
    assembly, shadow routing, the promotion gate and the sentinel.  Built by
    ``serve_main`` under ``flywheel.enabled``; without it the server acts as
    it did."""

    def __init__(self, router, model_dir: str, cfg: Dict[str, Any], gen_args: Dict[str, Any],
                 obs_spec_fn=None):
        self.cfg = dict(cfg)
        self.recorder = HarvestRecorder(
            gen_args,
            max_open=int(cfg.get("harvest_max_open", 256)),
            ttl_s=float(cfg.get("harvest_ttl_s", 600.0)),
            obs_spec_fn=obs_spec_fn,
        )
        self.quality = QualityController(router, model_dir, cfg)
        # a deterministic shadow slice (no RNG on the serve path): each
        # latest-addressed request adds the fraction, and each time the sum
        # crosses 1 one request goes to the candidate
        self._shadow_acc = 0.0

    def shadow_model(self, model_id: Any) -> Any:
        """A latest-addressed request rewritten to the staged candidate for
        the configured share of traffic.  Pinned, ensemble and random
        requests pass untouched."""
        if model_id not in (None, -1):
            return model_id
        candidate = self.quality.candidate_id()
        fraction = self.quality.shadow_fraction
        if candidate is None or fraction <= 0.0:
            return model_id
        self._shadow_acc += fraction
        if self._shadow_acc >= 1.0:
            self._shadow_acc -= 1.0
            return candidate
        return model_id

    def capture_request(self, sid: Optional[str], obs: Any) -> None:
        self.recorder.capture_request(sid, obs)

    def capture_reply(self, sid: Optional[str], served: Any, out: Any) -> None:
        self.recorder.capture_reply(sid, served, out)

    def tick(self) -> Optional[str]:
        """The watch loop's beat: the TTL sweep, then the quality beat."""
        self.recorder.sweep()
        return self.quality.tick()

    def stats_record(self) -> Dict[str, float]:
        record: Dict[str, float] = dict(self.recorder.stats())
        record.update(self.quality.stats_record())
        return record
