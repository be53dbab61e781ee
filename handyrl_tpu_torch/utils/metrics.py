"""metrics.jsonl: the key registry, the crash-tolerant append, the reader.

Counterpart of ``handyrl_tpu/utils/metrics.py``.  Writers append one JSON
record per line with a flush and an fsync per record, so a kill mid-append
leaves at most one half-written line, and only at the tail; ``read_metrics``
skips that one line and raises on a malformed line anywhere else.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List

# The keys a record may carry.  Readers treat every key as optional (older
# records lack newer keys; null values are legal).  The serve_* and
# session_* keys are the serving server's periodic health records
# (serving/server.py, fleet/sessions.py), exact keys as in the JAX package.
METRIC_KEYS = frozenset({
    # identity / cadence
    "epoch", "steps", "episodes", "episodes_per_sec", "updates_per_sec",
    # evaluation / generation books
    "win_rate", "eval_games", "generation_mean", "generation_std",
    # trainer loop
    "loss", "train_steps_per_sec", "input_wait_frac", "input_wait_warmup_s",
    "mfu", "device_mean_episode_len",
    # live pipeline / plane topology
    "pipeline", "plane",
    # serving plane: the learner's substitution count and the serving
    # server's periodic record
    "serve_snapshot_substituted", "serve_requests", "serve_replies",
    "serve_shed", "serve_deadline_miss", "serve_batches", "serve_depth",
    "serve_qps", "serve_p50_ms", "serve_p99_ms", "serve_hot_swaps",
    "serve_models", "serve_connections", "serve_errors",
    # server-resident session cache: residency gauges and cumulative
    # lifecycle / eviction / restore / affinity-miss / migration counters
    "session_resident", "session_spilled", "session_opened",
    "session_closed", "session_evictions", "session_restored",
    "session_affinity_miss", "session_spill_drops",
    "session_migrated_in", "session_migrated_out",
    # the fleet router's periodic record (fleet/router_tier.py): traffic,
    # replica liveness (fleet_replica_lost counts loss events, the
    # _live/_warming keys are gauges), swaps, scaling, migrations, retries
    "fleet_requests", "fleet_replies", "fleet_errors", "fleet_qps",
    "fleet_replicas", "fleet_replicas_live", "fleet_replicas_warming",
    "fleet_replica_lost", "fleet_sessions", "fleet_hot_swaps",
    "fleet_scale_ups", "fleet_scale_downs", "fleet_migrations",
    "fleet_sessions_migrated", "fleet_migration_ms",
    "fleet_failover_retries", "fleet_preempt_drains", "fleet_poll_retries",
    # the data flywheel, serving side (flywheel/harvest.py, cumulative
    # harvest books) and its quality plane (flywheel/quality.py)
    "flywheel_episodes", "flywheel_open", "flywheel_queued",
    "flywheel_dropped_malformed", "flywheel_dropped_truncated",
    "flywheel_pulled",
    "quality_promotions", "quality_gate_failures", "quality_demotions",
    "quality_games", "quality_candidate", "quality_incumbent",
    # the data flywheel, learner side (flywheel/ingest.py, the rollbacks
    # the quality signal asked for)
    "flywheel_ingested", "flywheel_ingest_stale",
    "flywheel_ingest_malformed", "flywheel_rollbacks",
    # the int8 rung of a serving server (models/quantize.py)
    "lowprec_weight_dtype", "lowprec_calib_batches",
    "lowprec_calib_max_dev", "lowprec_calib_mean_dev",
    # the span tracer's cumulative counters (utils/trace.py)
    "trace_spans", "trace_dropped",
    # both clocks, stamped by append_metrics_record
    "ts", "t_mono",
})
# key families: one prefix registers the family
METRIC_KEY_PREFIXES = ("pipe_", "plane_", "sentinel_", "quality_wp")


def append_metrics_record(path: str, record: Dict[str, Any]) -> None:
    """Append ``record`` as one line, flushed and fsynced, stamped with the
    wall clock (``ts``) and the monotonic clock (``t_mono``) unless it
    carries them already."""
    record.setdefault("ts", round(time.time(), 6))
    record.setdefault("t_mono", round(time.monotonic(), 6))
    line = json.dumps(record, default=float) + "\n"
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass


def read_metrics(path: str, strict: bool = False) -> List[Dict[str, Any]]:
    """The records of a metrics.jsonl.  A truncated final line is skipped
    with a note on stderr unless ``strict``; invalid JSON on any earlier
    line raises ``ValueError``."""
    with open(path) as f:
        lines = f.readlines()
    records: List[Dict[str, Any]] = []
    last = len(lines) - 1
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == last and not strict:
                print(f"[handyrl_tpu_torch] {path}: dropping truncated final line "
                      "(half-written record from a killed run)", file=sys.stderr)
                break
            raise
    return records
