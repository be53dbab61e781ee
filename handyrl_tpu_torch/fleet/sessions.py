"""Server-resident recurrent session cache.

Counterpart of ``handyrl_tpu/fleet/sessions.py``.  A session pins a
recurrent hidden state (the DRC's (h, c), the transformer's KV cache) next
to the model: ``open`` mints a session id, every ``infer`` carrying that
sid reads its hidden state from here and writes the next one back, and the
wire carries only the observation and the policy/value outputs.

* Resident entries are tensors on the serving engine's device (``_pin``
  copies each leaf there), so the next batch stacks them on the device.
* Over ``capacity`` the least recently used session is evicted to a
  host-side spill ring of numpy arrays (``spill_capacity``): device memory
  is the scarce tier, host memory the cheap one.
* A spilled session's next infer copies it back (counted
  ``session_restored``), bit for bit.
* A session absent from both tiers (spill overflow, or a sid this cache
  never saw) is an affinity miss: it restarts from the initial state and
  is counted once per loss event (the sid is re-adopted fresh).
* ``export_all`` hands every session over as numpy and clears the cache;
  ``adopt`` lands migrated sessions in the spill tier, so their next infer
  restores them through the same counted path.

``device=None`` keeps everything host-side, as numpy.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..models.inference import as_device_tensor, as_host_array as _host
from ..utils import tree_map
from ..utils.trace import trace_event

__all__ = ["SessionCache"]


class SessionCache:
    """LRU session store: device-resident hidden state keyed by session id,
    with a bounded host-side spill ring as the second tier."""

    def __init__(self, capacity: int = 1024, spill_capacity: int = 4096, device=None):
        self.capacity = max(1, int(capacity))
        self.spill_capacity = max(0, int(spill_capacity))
        # the pin target; the serving server adopts the engine's device on
        # first use (the router places engines, not this cache)
        self.device = device
        # sid -> hidden tree (device tensors when a device is set)
        self._resident: "OrderedDict[str, Any]" = OrderedDict()
        # sid -> host numpy tree (evicted, awaiting restore or overflow)
        self._spill: "OrderedDict[str, Any]" = OrderedDict()
        # opened but not yet stored: their first lookup is a fresh start,
        # not an affinity miss
        self._fresh: set = set()
        self._lock = threading.Lock()
        # sids are unique across replicas: a random prefix per cache
        self._prefix = os.urandom(4).hex()
        self._next = 0
        self.opened = 0
        self.closed = 0
        self.evictions = 0
        self.restored = 0
        self.affinity_misses = 0
        self.spill_drops = 0
        self.migrated_in = 0
        self.migrated_out = 0

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> str:
        """Mint a session id.  No capacity is taken until the first
        ``store``."""
        with self._lock:
            self._next += 1
            self.opened += 1
            sid = f"s{self._prefix}-{self._next}"
            self._fresh.add(sid)
            return sid

    def close(self, sid: str) -> bool:
        """Release the session (both tiers); True if it existed.  A double
        close or a stale sid is a no-op and not counted."""
        with self._lock:
            was_fresh = sid in self._fresh
            self._fresh.discard(sid)
            hit = bool(
                (self._resident.pop(sid, None) is not None)
                | (self._spill.pop(sid, None) is not None)
            ) or was_fresh
            self.closed += 1 if hit else 0
            return hit

    # -- the infer seams -----------------------------------------------------

    def lookup(self, sid: str) -> Tuple[Optional[Any], str]:
        """The session's hidden state for its next infer, and how it was
        found: ``resident``, ``restored`` (from the spill ring), ``fresh``
        (opened here, not yet stored) or ``miss`` (lost).  Fresh and miss
        return None, which the engine replaces by the initial state; only
        a miss is counted, and the sid is then fresh until its next store.
        """
        with self._lock:
            hidden = self._resident.get(sid)
            if hidden is not None:
                self._resident.move_to_end(sid)
                return hidden, "resident"
            spilled = self._spill.pop(sid, None)
            if spilled is None and sid in self._fresh:
                return None, "fresh"
        if spilled is None:
            with self._lock:
                self.affinity_misses += 1
                self._fresh.add(sid)
            return None, "miss"
        t0 = time.monotonic()
        hidden = self._pin(spilled)
        trace_event("session.restore", time.monotonic() - t0, t0=t0, plane="fleet")
        with self._lock:
            self.restored += 1
            self._resident[sid] = hidden
            self._resident.move_to_end(sid)
            self._evict_over_capacity()
        return hidden, "restored"

    def store(self, sid: str, hidden: Any) -> None:
        """Write the session's next hidden state (the engine's output row,
        host-side after the batch's fetch), copied to the device here."""
        if hidden is None:
            return
        pinned = self._pin(hidden)
        with self._lock:
            self._fresh.discard(sid)
            # a stateless-override infer can land while an older copy sits
            # in the spill ring: drop the stale copy
            self._spill.pop(sid, None)
            self._resident[sid] = pinned
            self._resident.move_to_end(sid)
            self._evict_over_capacity()

    def _pin(self, hidden: Any) -> Any:
        if self.device is None:
            return tree_map(_host, hidden)
        return tree_map(lambda x: as_device_tensor(x, self.device), hidden)

    def _evict_over_capacity(self) -> None:
        """Caller holds the lock.  LRU residents spill to the host ring; the
        ring drops its oldest beyond spill_capacity (those sessions come
        back as counted affinity misses)."""
        while len(self._resident) > self.capacity:
            old_sid, old_hidden = self._resident.popitem(last=False)
            self.evictions += 1
            if self.spill_capacity <= 0:
                self.spill_drops += 1
                continue
            self._spill[old_sid] = tree_map(_host, old_hidden)
            self._spill.move_to_end(old_sid)
            while len(self._spill) > self.spill_capacity:
                self._spill.popitem(last=False)
                self.spill_drops += 1

    # -- migration ------------------------------------------------------------

    def export_all(self) -> Dict[str, Any]:
        """Every session as a numpy tree, and the cache cleared: ownership
        passes to the caller.  Returns ``{"sessions": {sid: tree}, "fresh":
        [sid, ...]}``; opened but never stored sids travel too, so they
        stay fresh on the successor.  A straggler infer after the export is
        a counted affinity miss, never a second copy."""
        with self._lock:
            resident = list(self._resident.items())
            spilled = list(self._spill.items())
            fresh = sorted(self._fresh)
            self._resident.clear()
            self._spill.clear()
            self._fresh.clear()
            self.migrated_out += len(resident) + len(spilled)
        sessions: Dict[str, Any] = {}
        # spill-ring entries first, residents last: the successor keeps the
        # order, so the hotter tier stays newest in its ring
        for sid, hidden in spilled + resident:
            sessions[sid] = tree_map(_host, hidden)
        return {"sessions": sessions, "fresh": fresh}

    def adopt(self, sessions: Dict[str, Any], fresh=()) -> int:
        """Land migrated sessions (another cache's ``export_all``) in the
        spill tier; returns the number of stateful sessions adopted."""
        t0 = time.monotonic()
        with self._lock:
            for sid in fresh:
                self._fresh.add(sid)
            for sid, hidden in (sessions or {}).items():
                self._fresh.discard(sid)
                if self.spill_capacity > 0:
                    self._spill[sid] = tree_map(_host, hidden)
                    self._spill.move_to_end(sid)
                else:
                    self._resident[sid] = self._pin(hidden)
                    self._resident.move_to_end(sid)
            self.migrated_in += len(sessions or {})
            while len(self._spill) > self.spill_capacity:
                self._spill.popitem(last=False)
                self.spill_drops += 1
            self._evict_over_capacity()
            n = len(sessions or {})
        trace_event("session.migrate", time.monotonic() - t0, t0=t0, plane="fleet", sessions=n)
        return n

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "session_resident": len(self._resident),
                "session_spilled": len(self._spill),
                "session_opened": self.opened,
                "session_closed": self.closed,
                "session_evictions": self.evictions,
                "session_restored": self.restored,
                "session_affinity_miss": self.affinity_misses,
                "session_spill_drops": self.spill_drops,
                "session_migrated_in": self.migrated_in,
                "session_migrated_out": self.migrated_out,
            }
