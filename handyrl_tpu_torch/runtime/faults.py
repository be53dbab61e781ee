"""Fault injection from the environment (``HANDYRL_FAULT_*``).

Counterpart of ``handyrl_tpu/runtime/faults.py``: the same variables, the
same values and the same ``ValueError`` for a malformed one (a typo'd
injection that silently did nothing would fake a green end-to-end test).
Each is parsed where it is used (the trainer, the learner, a serving
replica), never at import, so a test can set it right before it builds
the object.

* ``HANDYRL_FAULT_NAN_AT_STEP="N"`` or ``"N:M"``: the lr is NaN for the
  update steps [N, N+M) (M defaults to 1); the sentinel must skip them.
* ``HANDYRL_FAULT_WEDGE_ROLLOUT="N"`` or ``"N:all"``: after N rollout
  blocks the device rollout thread stops making progress (first thread
  generation only, or every one); the learner's watchdog must notice.
* ``HANDYRL_FAULT_SIGTERM_AT_STEP="N"``: the trainer SIGTERMs its own
  process once the step counter reaches N, driving the learner's drain.
* ``HANDYRL_FAULT_SIGTERM_REPLICA="N"``: a serving replica SIGTERMs its
  own process after its N-th reply, driving the preemption drain that the
  fleet router answers by migrating its sessions.
* ``HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH="E:R"`` (bare ``"E"`` = rank
  0): the learner process of rank R dies hard (``os._exit``) when its
  model epoch reaches E, a lost host; the survivors find it through the
  health plane (parallel/health.py), the coordinator drain-saves, and
  every survivor exits 75.
* ``HANDYRL_FAULT_WEDGE_PROCESS="E:R"``: the same trigger, but rank R
  freezes instead: its heartbeats stop, its trainer stops joining
  collectives, its threads stay up.  The survivors escape through the
  heartbeat timeout or the collective watchdog, never hang.
* ``HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH="E"``: the learner saves a
  negated snapshot at epoch E (the flywheel's gate must catch it).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _get(name: str) -> Optional[str]:
    raw = os.environ.get(name, "").strip()
    return raw or None


def nan_window() -> Optional[Tuple[int, int]]:
    """(first_step, n_steps) to poison with a NaN lr, or None."""
    raw = _get("HANDYRL_FAULT_NAN_AT_STEP")
    if raw is None:
        return None
    if ":" in raw:
        start, count = raw.split(":", 1)
        return int(start), max(1, int(count))
    return int(raw), 1


def wedge_rollout() -> Optional[Tuple[int, bool]]:
    """(after_n_blocks, every_generation) for the rollout wedge, or None."""
    raw = _get("HANDYRL_FAULT_WEDGE_ROLLOUT")
    if raw is None:
        return None
    if ":" in raw:
        after, scope = raw.split(":", 1)
        if scope != "all":
            raise ValueError(f"HANDYRL_FAULT_WEDGE_ROLLOUT={raw!r}: expected 'N' or 'N:all'")
        return int(after), True
    return int(raw), False


def sigterm_at_step() -> Optional[int]:
    """The update step at which the trainer SIGTERMs its own process."""
    raw = _get("HANDYRL_FAULT_SIGTERM_AT_STEP")
    return None if raw is None else int(raw)


def sigterm_replica() -> Optional[int]:
    """The reply count after which a serving replica SIGTERMs its own
    process, or None."""
    raw = _get("HANDYRL_FAULT_SIGTERM_REPLICA")
    if raw is None:
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HANDYRL_FAULT_SIGTERM_REPLICA={raw!r}: expected an int reply count") from None
    if n < 1:
        raise ValueError(f"HANDYRL_FAULT_SIGTERM_REPLICA={raw!r}: reply count must be >= 1")
    return n


def _epoch_rank(name: str) -> Optional[Tuple[int, int]]:
    """An ``"E:R"`` (epoch, rank) injection; bare ``"E"`` is rank 0."""
    raw = _get(name)
    if raw is None:
        return None
    epoch, _, rank = raw.partition(":")
    try:
        return int(epoch), int(rank) if rank else 0
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected 'EPOCH' or 'EPOCH:RANK' (ints)") from None


def poison_snapshot_epoch() -> Optional[int]:
    """The model epoch at which a sabotaged snapshot is saved."""
    raw = _get("HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH")
    if raw is None:
        return None
    try:
        epoch = int(raw)
    except ValueError:
        raise ValueError(
            f"HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH={raw!r}: expected an int model epoch"
        ) from None
    if epoch < 1:
        raise ValueError(f"HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH={raw!r}: epoch must be >= 1")
    return epoch


def kill_process_at_epoch() -> Optional[Tuple[int, int]]:
    """(epoch, rank) at which that process dies hard."""
    return _epoch_rank("HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH")


def wedge_process_at_epoch() -> Optional[Tuple[int, int]]:
    """(epoch, rank) at which that process freezes (silent, not dead)."""
    return _epoch_rank("HANDYRL_FAULT_WEDGE_PROCESS")
