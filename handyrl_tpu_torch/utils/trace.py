"""Span tracing of the hot paths: where the time goes inside an epoch.

Counterpart of ``handyrl_tpu/utils/trace.py``, with the same file schema,
so ``scripts/trace_export.py`` turns the port's ``trace.jsonl`` into the
same Chrome trace as the JAX package's::

    from handyrl_tpu_torch.utils.trace import trace_span

    with trace_span("train_step", plane="learner"):
        metrics = ctx.train_step(batch, lr)

* Off by default and free when off: ``trace_span`` then returns one shared
  no-op object (an attribute check, no allocation, no torch call), and
  ``trace_event`` returns at once.
* Never blocking when on: a span appends one small dict to a bounded ring
  under a lock held for the append only; a full ring drops the span and
  counts it (``trace_dropped``).  A background thread flushes the ring to
  ``trace.jsonl``, one ``write`` per batch, so a kill leaves at most one
  truncated last line, which ``read_trace`` tolerates.
* With ``annotate_device`` each span also enters
  ``torch.profiler.record_function`` under its name, so the host spans
  bracket the kernels in a profiler capture (``profile_dir``).
* In a run of several processes rank N > 0 writes ``trace.rankN.jsonl``
  (an actor host of rank R ``trace.rank{1000+R}.jsonl``).  Their spans:
  ``cadence.agree_step``, ``cadence.agree_stop``, ``cadence.agree_rollback``
  (each the whole rendezvous: under skew, the wait for the slowest rank),
  ``collective.all_reduce`` (the gradient bucket), ``dispatch.wait`` /
  ``dispatch.run`` (parallel/mesh.py), ``health.heartbeat``, and the
  gateway's ``plane.param_publish``, ``plane.record_xfer`` and
  ``plane.param_fetch``.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer",
    "configure",
    "shutdown",
    "enabled",
    "current_path",
    "trace_span",
    "trace_event",
    "trace_stats",
    "read_trace",
    "META_NAME",
]

TRACE_SCHEMA_VERSION = 1
# the first line of every trace.jsonl: the wall-clock <-> monotonic anchor
# the exporter aligns processes by
META_NAME = "__trace_meta__"


class _NullSpan:
    """The disabled path's context manager: one shared instance."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_ts", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._ann = None

    def __enter__(self) -> "_Span":
        ann_cls = self._tracer._annotation
        if ann_cls is not None:
            # entered first, so the profiler's range brackets the span's window
            ann = ann_cls(self._name)
            ann.__enter__()
            self._ann = ann
        self._ts = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur = time.monotonic() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._ts, self._t0, dur, self._attrs)
        return False


class Tracer:
    """The process's span recorder behind ``trace_span``; ``spans`` and
    ``dropped`` are cumulative (the ``trace_*`` metrics)."""

    def __init__(self) -> None:
        self.enabled = False
        self.path: Optional[str] = None
        self.ring_size = 4096
        self.flush_interval = 0.5
        self.rank = 0
        self.spans = 0
        self.dropped = 0
        self._annotation = None      # torch.profiler.record_function when armed
        self._ring: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._file = None
        self._atexit_registered = False

    def configure(self, cfg: Optional[Dict[str, Any]], rank: int = 0) -> bool:
        """Arm (or disarm) tracing from a ``train_args.trace`` dict; True
        when it came up enabled.  An unwritable path raises ``ValueError``
        naming the key: a run asked to trace fails at its start."""
        self.shutdown()
        cfg = dict(cfg or {})
        if not cfg.get("enabled"):
            return False
        path = str(cfg.get("path") or "trace.jsonl")
        rank = int(rank)
        if rank > 0:
            root, ext = os.path.splitext(path)
            path = f"{root}.rank{rank}{ext or '.jsonl'}"
        try:
            f = open(path, "a")
        except OSError as exc:
            raise ValueError(
                f"train_args.trace.path={path!r} is not writable ({type(exc).__name__}: {exc}); "
                "tracing was asked for, so an unwritable sink is a startup error"
            ) from exc
        self._file = f
        self.path = path
        self.rank = rank
        self.ring_size = max(1, int(cfg.get("ring_size", 4096)))
        self.flush_interval = max(0.01, float(cfg.get("flush_interval", 0.5)))
        self.spans = 0
        self.dropped = 0
        self._annotation = None
        if cfg.get("annotate_device", True):
            import torch.profiler

            self._annotation = torch.profiler.record_function
        # the anchor goes to the file, not the ring: it stays the first
        # line even if the ring later overflows
        meta = {"name": META_NAME, "version": TRACE_SCHEMA_VERSION, "ts": time.time(),
                "t_mono": time.monotonic(), "rank": self.rank, "pid": os.getpid()}
        f.write(json.dumps(meta) + "\n")
        f.flush()
        self._stop = threading.Event()
        self.enabled = True
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True,
                                         name="trace-flusher")
        self._flusher.start()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self.shutdown)
        return True

    def shutdown(self) -> None:
        """Disarm: stop and join the flusher, write the ring's tail, close
        the file.  Safe to call again."""
        if not self.enabled and self._file is None:
            return
        self.enabled = False
        self._stop.set()
        flusher, self._flusher = self._flusher, None
        if flusher is not None and flusher is not threading.current_thread():
            flusher.join(timeout=2.0)
        self.flush()
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def _record(self, name: str, ts: float, t0: float, dur: float,
                attrs: Optional[Dict[str, Any]]) -> None:
        rec: Dict[str, Any] = {
            "name": name,
            "ts": round(ts, 6),
            "t_mono": round(t0, 6),
            "dur_s": round(dur, 9),
            "thread": threading.current_thread().name,
            "rank": self.rank,
        }
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            if len(self._ring) >= self.ring_size:
                self.dropped += 1   # never block a hot path on the flusher
                return
            self._ring.append(rec)
            self.spans += 1

    def flush(self) -> None:
        """Write the ring to the file in one ``write``, flushed, with a
        best-effort fsync."""
        with self._lock:
            if not self._ring:
                return
            batch, self._ring = self._ring, []
        f = self._file
        if f is None:
            return
        try:
            f.write("".join(json.dumps(r, default=float) + "\n" for r in batch))
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        except (OSError, ValueError):
            pass  # a closed sink must not kill the instrumented thread

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()


_TRACER = Tracer()


def configure(cfg: Optional[Dict[str, Any]], rank: int = 0) -> bool:
    return _TRACER.configure(cfg, rank)


def shutdown() -> None:
    _TRACER.shutdown()


def enabled() -> bool:
    return _TRACER.enabled


def current_path() -> Optional[str]:
    """The armed tracer's file (rank suffix applied), or None."""
    return _TRACER.path if _TRACER.enabled else None


def trace_span(name: str, **attrs: Any):
    """A span around a hot-path section: the shared no-op object when
    tracing is off; on, it records name, wall and monotonic start,
    duration, thread and rank.  Keyword attrs should be cheap constants."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _Span(_TRACER, name, attrs or None)


def trace_event(name: str, dur_s: float, t0: Optional[float] = None, **attrs: Any) -> None:
    """Record an already measured duration as a span (a seam that times
    itself anyway, or a lifecycle that starts and ends on different
    threads).  ``t0`` is its start on ``time.monotonic()``; by default
    now - ``dur_s``."""
    tracer = _TRACER
    if not tracer.enabled:
        return
    now = time.monotonic()
    start = now - dur_s if t0 is None else t0
    tracer._record(name, time.time() - (now - start), start, dur_s, attrs or None)


def trace_stats() -> Dict[str, int]:
    """The tracer's cumulative counters (the ``trace_*`` metrics)."""
    return {"trace_spans": _TRACER.spans, "trace_dropped": _TRACER.dropped}


def read_trace(path: str, strict: bool = False) -> List[Dict[str, Any]]:
    """The records of a trace.jsonl.  A truncated last line is dropped with
    a note on stderr unless ``strict``; invalid JSON on any earlier line
    raises ``ValueError``."""
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
                print(f"[handyrl_tpu_torch] {path}: dropping truncated final trace line "
                      "(half-written record from a killed run)", file=sys.stderr)
                break
            raise
    return records
