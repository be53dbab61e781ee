"""Serving-plane client: pipelined request/reply over one framed socket.

Counterpart of ``handyrl_tpu/serving/client.py``, numpy over
``runtime/connection.py``, frame for frame the JAX package's protocol: a
client of either package talks to a server of either.  Every frame carries
a ``rid`` and one receiver thread resolves the matching future, so a caller
can keep many requests outstanding (``submit``) or block on one
(``infer``).  A shed or a missed deadline on the server reaches the caller
as ``ServingError`` with the wire ``kind``.

* ``stall_timeout`` fails every pending future with ``kind="stalled"``
  when the server sends no byte for that long while requests are pending;
  an idle connection is never reaped.
* A reply whose ``rid`` is missing or unknown is counted in
  ``replies_orphaned`` and warned about once.
* Sessions: ``open_session`` pins recurrent hidden state on the server;
  ``submit(..., sid=...)`` then carries only the observation.
* Server notices without a rid (``draining``) go to ``on_notice``.
* The data flywheel's frames (``harvest_*``, ``report_outcome``) are sent
  as the JAX client sends them; a server without the flywheel, as the
  port's is, answers each with a ``bad_request`` error.
"""

from __future__ import annotations

import socket
import sys
import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

from ..models.inference import as_host_array
from ..runtime.connection import connect_socket_connection

__all__ = ["ServingClient", "ServingError"]


class ServingError(RuntimeError):
    """Server-reported request failure; ``kind`` is the wire tag (shed /
    deadline / stopped / bad_request / swap_failed / stalled / ...)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(f"[{kind}] {msg}")
        self.kind = kind


class ServingClient:
    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 retry_seconds: float = 0.0,
                 stall_timeout: Optional[float] = None,
                 on_notice=None):
        self.conn = connect_socket_connection(
            host, int(port), timeout=timeout, retry_seconds=retry_seconds
        )
        self.stall_timeout = None if not stall_timeout else float(stall_timeout)
        # called on the receiver thread: a handler must hand off, not block
        self.on_notice = on_notice
        self._lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._rid = 0
        self._closed = False
        self.replies_orphaned = 0
        self._orphan_warned = False
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True, name="serve-client-recv"
        )
        self._recv_thread.start()

    # -- plumbing -----------------------------------------------------------

    def _recv_loop(self) -> None:
        while True:
            try:
                kind, data = self.conn.recv(timeout=self.stall_timeout)
            except socket.timeout:
                # no bytes for stall_timeout: an idle connection keeps
                # listening (no partial frame was consumed); with requests
                # pending the peer is wedged, so fail them and close
                with self._lock:
                    n_pending = len(self._pending)
                if n_pending == 0:
                    continue
                self._fail_all(ServingError(
                    "stalled",
                    f"server sent no bytes for {self.stall_timeout:.1f}s "
                    f"with {n_pending} request(s) pending",
                ))
                self.conn.close()
                return
            except Exception:
                self._fail_all(ConnectionResetError("serving connection lost"))
                return
            if kind == "heartbeat" or kind == "__hb__":
                continue
            if kind == "draining":
                hook = self.on_notice
                if hook is not None:
                    try:
                        hook(kind, data if isinstance(data, dict) else {})
                    except Exception:
                        pass  # the receiver thread outlives a bad hook
                continue
            rid = (data or {}).get("rid") if isinstance(data, dict) else None
            with self._lock:
                fut = self._pending.pop(rid, None)
            if fut is None or fut.done():
                self.replies_orphaned += 1
                if not self._orphan_warned:
                    self._orphan_warned = True
                    print(f"serving client: orphaned reply frame (kind={kind!r}, rid={rid!r}) "
                          "— counting in replies_orphaned; further orphans are silent",
                          file=sys.stderr)
                continue
            if kind == "error":
                fut.set_exception(ServingError(data.get("kind", "error"), data.get("msg", "")))
            elif kind == "stats":
                fut.set_result(data.get("stats"))
            else:  # result / swapped / session / session_closed / ...
                fut.set_result(data)

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    def _send(self, req: str, data: Dict[str, Any]) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                fut.set_exception(ConnectionResetError("client closed"))
                return fut
            self._rid += 1
            rid = self._rid
            self._pending[rid] = fut
        try:
            self.conn.send((req, dict(data, rid=rid)))
        except Exception as exc:
            with self._lock:
                self._pending.pop(rid, None)
            if not fut.done():
                fut.set_exception(exc)
        return fut

    # -- API ----------------------------------------------------------------

    def submit(self, obs, model=-1, hidden=None, slo_ms: Optional[float] = None,
               sid: Optional[str] = None) -> Future:
        """Asynchronous inference; resolves to {"model": served_id, "out":
        numpy tree}.  With ``sid`` the server reads and writes the session's
        hidden state, and the wire carries none of it."""
        data: Dict[str, Any] = {"model": model, "obs": obs}
        if hidden is not None:
            data["hidden"] = hidden
        if slo_ms is not None:
            data["slo_ms"] = float(slo_ms)
        if sid is not None:
            data["sid"] = sid
        return self._send("infer", data)

    def infer(self, obs, model=-1, hidden=None, slo_ms: Optional[float] = None,
              sid: Optional[str] = None, timeout: float = 60.0) -> Dict[str, Any]:
        return self.submit(obs, model, hidden, slo_ms, sid).result(timeout=timeout)

    def open_session(self, model=-1, timeout: float = 30.0) -> str:
        """Open a server-resident recurrent session; returns its sid."""
        return self._send("open_session", {"model": model}).result(timeout=timeout)["sid"]

    def close_session(self, sid: str, timeout: float = 30.0) -> Dict[str, Any]:
        return self._send("close_session", {"sid": sid}).result(timeout=timeout)

    def stats(self, timeout: float = 30.0) -> Dict[str, Any]:
        return self._send("stats", {}).result(timeout=timeout)

    def swap(self, model_id: int, params=None, timeout: float = 300.0) -> Dict[str, Any]:
        """Hot-swap the latest to ``model_id``: ``params`` is a state dict
        (name -> tensor or array, sent as numpy), or None to have the server
        load ``{model_id}.ckpt`` from its model dir, digest-verified.
        Blocks until the standby engine is warm and the flip happened."""
        data: Dict[str, Any] = {"id": int(model_id)}
        if params is not None:
            # the codec carries numpy, never a tensor
            data["params"] = {name: as_host_array(v) for name, v in params.items()}
        return self._send("swap", data).result(timeout=timeout)

    def export_sessions(self, timeout: float = 60.0) -> Dict[str, Any]:
        """Pull the server's whole session cache: {"sessions": {sid: numpy
        hidden tree}, "fresh": [...], "count"}.  The server clears its
        cache: ownership passes to the caller."""
        return self._send("export_sessions", {}).result(timeout=timeout)

    def import_sessions(self, sessions: Dict[str, Any], fresh=(),
                        timeout: float = 60.0) -> Dict[str, Any]:
        """Hand migrated sessions to a server, which adopts them into its
        spill tier."""
        return self._send("import_sessions", {
            "sessions": sessions or {}, "fresh": list(fresh),
        }).result(timeout=timeout)

    # -- the data flywheel's frames -----------------------------------------

    def harvest_open(self, players, sids, timeout: float = 30.0) -> str:
        """Bind one game's per-player sessions into a harvest episode;
        returns the harvest id."""
        return self._send("harvest_open", {
            "players": list(players), "sids": list(sids),
        }).result(timeout=timeout)["hid"]

    def harvest_step(self, hid: str, actions, legal, rewards, turn,
                     timeout: float = 30.0) -> int:
        """Close one step with the client's half (sampled actions, legal
        actions, rewards, the turn player); returns the steps so far."""
        return self._send("harvest_step", {
            "hid": hid, "actions": list(actions), "legal": list(legal),
            "rewards": list(rewards), "turn": turn,
        }).result(timeout=timeout)["steps"]

    def harvest_close(self, hid: str, outcome, timeout: float = 60.0) -> bool:
        """Finish the episode with per-player outcomes (None: abandoned);
        returns whether the episode was kept."""
        return self._send("harvest_close", {
            "hid": hid, "outcome": None if outcome is None else list(outcome),
        }).result(timeout=timeout)["kept"]

    def harvest_pull(self, max_episodes: int = 64,
                     timeout: float = 60.0) -> Tuple[list, Dict[str, Any]]:
        """Take up to ``max_episodes`` finished harvest episodes and the
        server's harvest counters."""
        reply = self._send("harvest_pull", {"max": int(max_episodes)}).result(timeout=timeout)
        return reply.get("episodes") or [], reply.get("counts") or {}

    def report_outcome(self, model: int, outcome: float, timeout: float = 30.0) -> None:
        """Book one finished game's outcome in [-1, 1] against the epoch
        that served it."""
        self._send("report_outcome", {
            "model": int(model), "outcome": float(outcome),
        }).result(timeout=timeout)

    def pending_count(self) -> int:
        """Requests in flight on this connection."""
        with self._lock:
            return len(self._pending)

    def wire_bytes(self) -> Tuple[int, int]:
        """(sent, received) frame bytes on this connection so far."""
        return self.conn.bytes_sent, self.conn.bytes_received

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self.conn.close()
        self._fail_all(ConnectionResetError("client closed"))
