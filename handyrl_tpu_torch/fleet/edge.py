"""The edge replica: an exported artifact served as fleet capacity.

Counterpart of ``handyrl_tpu/fleet/edge.py``.  ``models/export.py`` freezes
a policy into a ``.pt2`` program; this module puts one behind the serving
wire protocol, so the fleet router (``router_tier.py``) can register it with
the ``edge`` tag as feed-forward capacity: sessions, wire hidden state and
hot swaps never land here.  It runs on the card unless the caller names
another device, as the JAX edge runs its artifact on JAX's default backend.

No continuous batcher: ``edge_workers`` threads each run batch-1 inference,
and the router's load scoring (the queue depth in the stats frame) keeps
the replica from being oversubscribed.
"""

from __future__ import annotations

import queue as _queue
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..runtime.connection import (
    QueueCommunicator,
    accept_socket_connections,
    open_socket_connection,
)
from ..utils import tree_map
from ..utils.trace import trace_event

__all__ = ["EdgeReplica", "edge_main"]


class EdgeReplica(QueueCommunicator):
    """A wire-compatible serving backend over one frozen artifact.

    It answers ``infer`` (feed-forward only: a ``sid`` or a wire ``hidden``
    is ``bad_request``) and ``stats`` (a ``serve_*`` record, so the router's
    scoring reads it as it reads a full replica); ``swap``,
    ``open_session`` and every other frame are ``bad_request``."""

    def __init__(self, model, port: int = 9995, workers: int = 2):
        super().__init__(recv_timeout=None, send_queue_size=1024)
        self.model = model
        self.port = int(port)
        self.workers = max(1, int(workers))
        self.bound_port: Optional[int] = None
        self._stats_lock = threading.Lock()
        self.requests_in = 0
        self.replies = 0
        self.errors: Dict[str, int] = {}
        self._depth = 0
        self._sock = None
        self._threads: List[threading.Thread] = []

    def run(self) -> "EdgeReplica":
        self._sock = open_socket_connection(self.port)
        self._sock.listen(1024)
        self.bound_port = self._sock.getsockname()[1]
        targets = [(self._accept_loop, "edge-accept")] + [
            (self._serve_loop, f"edge-worker-{i}") for i in range(self.workers)]
        for target, name in targets:
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, timeout: float = 5.0) -> None:
        """Close the socket and join the threads this replica started."""
        super().shutdown()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout)

    def _accept_loop(self) -> None:
        for conn in accept_socket_connections(timeout=0.5, sock=self._sock):
            if conn is None:
                if self.shutdown_flag:
                    break
                continue
            self.add_connection(conn)

    def _serve_loop(self) -> None:
        # inference mode is per thread; the artifact names its device on
        # every tensor it makes
        with torch.inference_mode():
            while not self.shutdown_flag:
                try:
                    conn, frame = self.recv(timeout=0.3)
                except _queue.Empty:
                    continue
                try:
                    req, data = frame
                except (TypeError, ValueError):
                    continue
                if req == "heartbeat" or req == "__hb__":
                    continue
                if not isinstance(data, dict):
                    data = {}
                rid = data.get("rid")
                try:
                    if req == "infer":
                        self._handle_infer(conn, rid, data)
                    elif req == "stats":
                        self.send(conn, ("stats", {"rid": rid, "stats": self.stats_record()}))
                    else:
                        # an edge artifact is immutable and stateless
                        self._error(conn, rid, "bad_request",
                                    f"edge replica cannot serve {req!r} (frozen feed-forward "
                                    "artifact)")
                except Exception as exc:
                    # the workers are the capacity: no frame may kill one
                    self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_infer(self, conn, rid, data: Dict[str, Any]) -> None:
        with self._stats_lock:
            self.requests_in += 1
            self._depth += 1
        try:
            if data.get("sid") is not None or data.get("hidden") is not None:
                self._error(conn, rid, "bad_request",
                            "edge replica is feed-forward only (no session cache, no recurrent "
                            "state): route stateful requests to a full serving replica")
                return
            t0 = time.monotonic()
            obs = tree_map(lambda x: np.asarray(x)[None], data.get("obs"))
            out = tree_map(lambda x: np.asarray(x)[0], self.model.inference_batch(obs))
            trace_event("serve.request", time.monotonic() - t0, t0=t0, plane="fleet", ok=True,
                        edge=True)
            with self._stats_lock:
                self.replies += 1
            # model 0: the one frozen artifact, no router generation to report
            self.send(conn, ("result", {"rid": rid, "model": 0, "out": out}))
        finally:
            with self._stats_lock:
                self._depth -= 1

    def _error(self, conn, rid, kind: str, msg: str) -> None:
        with self._stats_lock:
            self.errors[kind] = self.errors.get(kind, 0) + 1
        self.send(conn, ("error", {"rid": rid, "kind": kind, "msg": msg}))

    def stats_record(self) -> Dict[str, Any]:
        """``serve_*`` keys, the subset an artifact backend can report."""
        with self._stats_lock:
            return {
                "serve_requests": self.requests_in,
                "serve_replies": self.replies,
                "serve_depth": self._depth,
                "serve_shed": 0,
                "serve_errors": sum(self.errors.values()),
                "serve_connections": self.connection_count(),
            }


def edge_main(args: Dict[str, Any], device=None) -> int:
    """``--edge [ARTIFACT]``: serve a frozen ``.pt2`` (or ``.onnx``) artifact
    as fleet edge capacity on ``fleet.edge_port``, on the card unless
    ``device`` says otherwise; register it in ``fleet.replicas`` with the
    ``edge`` tag.  SIGTERM or Ctrl-C stops it (exit 0)."""
    from ..models.export import load_artifact

    fleet_cfg = args["train_args"].get("fleet", {})
    path = args.get("edge_model") or fleet_cfg.get("edge_model")
    if not path:
        raise ValueError("no edge artifact: pass it on the command line "
                         "(main --edge model.pt2) or set fleet.edge_model")
    model = load_artifact(str(path), device=device)
    replica = EdgeReplica(model, port=int(fleet_cfg.get("edge_port", 9995)),
                          workers=int(fleet_cfg.get("edge_workers", 2))).run()
    print(f"edge: serving {path} on port {replica.bound_port} ({replica.workers} workers, "
          f"device {model.device})", flush=True)
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread: no handler
    try:
        while not stop.wait(timeout=1.0):
            pass
        print("edge: SIGTERM, shutting down", flush=True)
    except KeyboardInterrupt:
        print("edge: shutting down", flush=True)
    finally:
        if model.device.type == "cuda":
            print("edge: peak device memory "
                  f"{torch.cuda.max_memory_allocated(model.device) / 1e9:.3f} GB allocated",
                  flush=True)
        replica.shutdown()
    return 0
