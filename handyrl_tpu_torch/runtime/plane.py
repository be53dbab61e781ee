"""The actor/learner planes: versioned params out, self-play records in.

Counterpart of ``handyrl_tpu/runtime/plane.py``.  Two flows cross between
the actor side and the learner side:

* params, learner -> actors: ``PlaneParamCache`` holds a versioned copy on
  an actor device; ``lag`` says how many learner updates behind it is;
* records, actors -> learner: ``RecordTransfer`` moves a rollout's (K, B,
  ...) record batch onto the learner's device, where ``DeviceReplay``'s
  rings take it.

Both count their bytes.  The split plane that would run them between two
cards of one process (``plane: split``) is still refused (ROADMAP A8, it
needs a learner card beside the actor cards); they are here for the
gateway's ``inner``.

**Actor hosts** (the JAX package's pod-slice rung 2): ``PlaneGateway`` is
the learner's TCP server and ``PlaneClient`` the actor host's side.  Params
go out as monotonically versioned snapshots (an actor polls with the
version it holds; the gateway answers bytes only when it has a newer one);
records come in and land in the learner's rings through the same ingest
its own rollout uses.  Actor hosts stay outside the learner's process
group by design: a lost actor host is a throughput degrade (the survivors
absorb its games), never a collective left waiting.

The wire is the JAX package's, byte for byte: a JSON header line
``{"kind": ..., "nbytes": N, ...}``, then N payload bytes, an npz of the
tree's leaves keyed by their ``"\\x1f"``-joined dict paths.  Every request
gets one reply; a gateway that is stopping answers ``{"kind": "stop"}``
and the client leaves cleanly, while a dead socket is the loud path.
"""

from __future__ import annotations

import io
import json
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.trace import trace_span


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_bytes(tree) -> int:
    return sum(int(x.numel() * x.element_size()) if torch.is_tensor(x) else int(x.nbytes)
               for x in _leaves(tree))


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    return tree.to(device, copy=True)


class PlaneParamCache:
    """A versioned copy of the learner's params on an actor device.  The
    learner's thread publishes between steps; the actor's thread reads
    ``latest()``.  Versions are learner step counts and only advance."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._params = None
        self.version = -1
        self.refreshes = 0
        self.bytes_transferred = 0

    def publish(self, params, version: int) -> None:
        version = int(version)
        with self._lock:
            if version <= self.version:
                raise ValueError(f"param version must advance monotonically: "
                                 f"{version} <= {self.version}")
            fresh = _tree_to(params, self.device)
            self._params = fresh
            self.version = version
            self.refreshes += 1
            self.bytes_transferred += _tree_bytes(fresh)

    def latest(self) -> Tuple[int, Any]:
        """(version, params on the actor device) of the newest publish."""
        with self._lock:
            if self._params is None:
                raise RuntimeError("PlaneParamCache.latest() before first publish")
            return self.version, self._params

    def lag(self, learner_steps: int) -> int:
        """How many learner updates behind the actor's params are."""
        return max(0, int(learner_steps) - self.version) if self.refreshes else 0


class RecordTransfer:
    """Actor -> learner: a record batch moved onto the learner's device,
    with byte accounting."""

    def __init__(self, learner_device):
        self.device = torch.device(learner_device)
        self.transfers = 0
        self.bytes_transferred = 0

    def __call__(self, records: Dict[str, Any]) -> Dict[str, Any]:
        moved = _tree_to(records, self.device)
        self.transfers += 1
        self.bytes_transferred += _tree_bytes(moved)
        return moved


class PlaneStats:
    """Cumulative counters of the actor loop, read (and diffed per epoch)
    by the learner's metrics record."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {
            "actor_dispatches": 0.0,
            "actor_busy_s": 0.0,     # in rollout launches and ingest
            "actor_idle_s": 0.0,     # backpressure sleeps and server waits
            "param_lag_sum": 0.0,    # summed over rollout launches
        }

    def bump(self, **kv: float) -> None:
        with self._lock:
            for k, v in kv.items():
                self._c[k] += v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._c)


# -- actor hosts: the TCP transport ------------------------------------------


def resolve_plane_port(dist_args: Dict[str, Any]) -> int:
    """The gateway's TCP port: ``distributed.plane_port`` when set, else
    the health port + 1."""
    port = int(dist_args.get("plane_port") or 0)
    if port:
        return port
    from ..parallel.health import resolve_health_port

    return resolve_health_port(dist_args) + 1


def _as_numpy(node, path: str) -> np.ndarray:
    if torch.is_tensor(node):
        if node.dtype == torch.bfloat16:
            raise ValueError(f"plane transport: {path!r} is bfloat16, which npz cannot carry")
        return node.detach().cpu().numpy()
    return np.asarray(node)


def _pack_tree(tree) -> bytes:
    """A nested dict of arrays (numpy or tensors) -> npz bytes, keyed by
    joined dict paths.  Dicts only, so neither side ships a treedef; any
    other container raises at the sender."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                if "\x1f" in str(k):
                    raise ValueError(f"tree key {k!r} contains the path separator")
                walk(v, path + "\x1f" + str(k) if path else str(k))
            return
        if isinstance(node, (list, tuple)):
            raise ValueError("plane transport trees must be nested dicts of arrays "
                             f"(got {type(node).__name__} at {path!r})")
        flat[path] = _as_numpy(node, path)

    walk(tree, "")
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _unpack_tree(payload: bytes) -> Dict[str, Any]:
    """npz bytes -> a nested dict of numpy arrays."""
    out: Dict[str, Any] = {}
    with np.load(io.BytesIO(payload)) as z:
        for key in z.files:
            node = out
            parts = key.split("\x1f")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def _send_msg(wfile, header: Dict[str, Any], payload: bytes = b"") -> int:
    """One header line and its payload; returns the bytes written."""
    header = dict(header, nbytes=len(payload))
    line = (json.dumps(header) + "\n").encode()
    wfile.write(line + payload)
    wfile.flush()
    return len(line) + len(payload)


def _recv_msg(rfile) -> Tuple[Optional[Dict[str, Any]], bytes, int]:
    """(header, payload, bytes read); header None on a closed peer."""
    line = rfile.readline()
    if not line:
        return None, b"", 0
    header = json.loads(line)
    n = int(header.get("nbytes", 0))
    payload = rfile.read(n) if n else b""
    if len(payload) != n:
        raise ConnectionError(f"plane transport: truncated payload ({len(payload)}/{n} bytes)")
    return header, payload, len(line) + n


class PlaneGateway:
    """The learner's side: versioned params out, records in.

    The trainer publishes through ``publish(params, version)``, the
    surface of ``PlaneParamCache`` (to which it delegates when ``inner``
    is set): the publish keeps a reference under the lock and returns; the
    serialization happens on a serving thread at the first poll of that
    version.  ``on_records`` receives each decoded record tree on a
    serving thread.  An actor host that disconnects after its hello counts
    in ``actor_host_losses`` and the run goes on; after ``begin_stop`` or
    ``stop`` every request is answered "stop", and the hosts leave 0.
    """

    def __init__(self, dist_args: Dict[str, Any],
                 on_records: Callable[[Dict[str, Any]], None],
                 inner: Optional[PlaneParamCache] = None):
        self._port = resolve_plane_port(dist_args)
        self.on_records = on_records
        self.inner = inner
        self._lock = threading.Lock()
        self._params = None          # newest published tree (a reference)
        self._packed: Optional[Tuple[int, bytes]] = None  # (version, npz), made lazily
        self.version = -1
        self.refreshes = 0
        self._stop = threading.Event()
        self._stopping = threading.Event()  # answer "stop" from here on
        self._server: Optional[socket.socket] = None
        self._threads: list = []
        self._conns: list = []
        self.bytes_in = 0
        self.bytes_out = 0
        self.record_batches = 0
        self.record_bytes = 0
        self._record_t: Optional[Tuple[float, float]] = None   # first, last arrival
        self.param_fetches = 0
        self.actor_hosts = 0         # connected now (after hello)
        self.actor_hosts_seen = 0
        self.actor_host_losses = 0

    @property
    def port(self) -> int:
        return self._port

    # -- the trainer's side (PlaneParamCache's surface) ------------------------

    def publish(self, params, version: int) -> None:
        version = int(version)
        if self.inner is not None:
            # the local copy first: it holds the monotonicity check, and a
            # raise leaves the gateway untouched
            self.inner.publish(params, version)
        with self._lock:
            if self.inner is None and version <= self.version:
                raise ValueError(f"param version must advance monotonically: "
                                 f"{version} <= {self.version}")
            self._params = params
            self.version = version
            self.refreshes += 1
            self._packed = None      # serialized at the next poll

    def latest(self):
        if self.inner is not None:
            return self.inner.latest()
        with self._lock:
            if self._params is None:
                raise RuntimeError("PlaneGateway.latest() before first publish")
            return self.version, self._params

    def lag(self, learner_steps: int) -> int:
        return max(0, int(learner_steps) - self.version) if self.refreshes else 0

    @property
    def record_span_s(self) -> float:
        """Seconds from the first record batch's arrival to the last one's."""
        with self._lock:
            return 0.0 if self._record_t is None else self._record_t[1] - self._record_t[0]

    @property
    def bytes_transferred(self) -> int:
        with self._lock:
            inner = self.inner.bytes_transferred if self.inner is not None else 0
        return self.bytes_in + self.bytes_out + inner

    def _packed_params(self) -> Tuple[int, bytes]:
        """(version, npz) of the newest publish, serialized once per
        version, on a serving thread."""
        with self._lock:
            if self._packed is not None and self._packed[0] == self.version:
                return self._packed
            version, params = self.version, self._params
        with trace_span("plane.param_publish", plane="plane", version=version):
            payload = _pack_tree(params)
        with self._lock:
            if self._packed is None or self._packed[0] < version:
                self._packed = (version, payload)
            return self._packed

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("", self._port))
        self._server.listen(8)
        self._server.settimeout(0.5)
        t = threading.Thread(target=self._accept_loop, daemon=True, name="plane-gateway-accept")
        t.start()
        self._threads.append(t)
        print(f"plane gateway: listening on port {self._port}", flush=True)

    def begin_stop(self) -> None:
        """The run is ending: answer every further request "stop" (the
        actor hosts leave 0), still serving until ``stop``."""
        self._stopping.set()

    def stop(self, timeout: float = 10.0, goodbye_s: float = 5.0) -> None:
        """Stop serving and join the threads: the connected hosts first get
        up to ``goodbye_s`` to hear "stop" on their next request and leave
        cleanly, then open connections are closed."""
        self._stopping.set()
        deadline = time.monotonic() + goodbye_s
        while self.actor_hosts > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        self._stop.set()
        server, self._server = self._server, None
        if server is not None:
            try:
                server.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            server = self._server
            if server is None:
                return
            try:
                conn, _addr = server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True,
                                 name="plane-gateway-serve")
            self._threads = [x for x in self._threads if x.is_alive()] + [t]
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(300.0)
        with self._lock:
            self._conns.append(conn)
        rfile = conn.makefile("rb")
        wfile = conn.makefile("wb")
        hello = False
        try:
            while not self._stop.is_set():
                header, payload, n_in = _recv_msg(rfile)
                if header is None:
                    break   # the peer closed
                with self._lock:
                    self.bytes_in += n_in
                if self._stopping.is_set():
                    _send_msg(wfile, {"kind": "stop"})
                    break   # a clean goodbye, not a loss
                kind = header.get("kind")
                if kind == "hello":
                    hello = True
                    with self._lock:
                        self.actor_hosts += 1
                        self.actor_hosts_seen += 1
                    print(f"plane gateway: actor host connected ({header.get('host', '?')}, "
                          f"{self.actor_hosts} live)", flush=True)
                    n = _send_msg(wfile, {"kind": "ok", "version": self.version})
                elif kind == "records":
                    with trace_span("plane.record_xfer", plane="plane", nbytes=len(payload),
                                    direction="in"):
                        self.on_records(_unpack_tree(payload))
                    with self._lock:
                        self.record_batches += 1
                        self.record_bytes += len(payload)
                        now = time.monotonic()
                        self._record_t = (self._record_t or (now, now))[0], now
                    n = _send_msg(wfile, {"kind": "ok", "version": self.version})
                elif kind == "params":
                    have = int(header.get("have", -1))
                    version, packed = (self._packed_params()
                                       if self.version > have and self._params is not None
                                       else (self.version, b""))
                    if version > have:
                        with self._lock:
                            self.param_fetches += 1
                    n = _send_msg(wfile, {"kind": "params", "version": version},
                                  packed if version > have else b"")
                else:
                    n = _send_msg(wfile, {"kind": "error", "error": f"unknown kind {kind!r}"})
                with self._lock:
                    self.bytes_out += n
        except (OSError, ValueError, ConnectionError) as e:
            if not self._stop.is_set():
                print(f"[handyrl_tpu_torch] plane gateway: actor connection error: {e}",
                      file=sys.stderr)
        finally:
            if hello:
                with self._lock:
                    self.actor_hosts -= 1
                    if not self._stopping.is_set():
                        # a loss, not a goodbye: throughput degrades, the
                        # run goes on
                        self.actor_host_losses += 1
                        print("[handyrl_tpu_torch] plane gateway: actor host LOST "
                              f"({self.actor_hosts} live; survivors absorb its game quota)",
                              file=sys.stderr, flush=True)
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            for f in (rfile, wfile):
                try:
                    f.close()
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass


class PlaneClient:
    """The actor host's side of the gateway: one blocking request/reply
    socket.  Methods return None once the gateway said "stop" (the run's
    clean end); a dead socket raises ``ConnectionError``."""

    def __init__(self, dist_args: Dict[str, Any], timeout: float = 300.0):
        from ..parallel.health import _split_address

        self._host = _split_address(dist_args["coordinator_address"])[0]
        self._port = resolve_plane_port(dist_args)
        self._timeout = float(timeout)
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._wfile = None
        self._lock = threading.Lock()
        self.bytes_in = 0
        self.bytes_out = 0
        self.param_version = -1
        self.stopped = False

    def connect(self, retry_for: float = 60.0) -> int:
        """Dial the gateway (retrying: the learner may still be starting),
        say hello, return the gateway's param version."""
        deadline = time.monotonic() + float(retry_for)
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((self._host, self._port), timeout=self._timeout)
                break
            except OSError as e:
                last = e
                time.sleep(0.5)
        else:
            raise ConnectionError(f"plane gateway at {self._host}:{self._port} unreachable "
                                  f"for {retry_for:.0f}s: {last}")
        sock.settimeout(self._timeout)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wfile = sock.makefile("wb")
        import platform

        reply, _payload = self._roundtrip({"kind": "hello", "host": platform.node()})
        if reply is None:
            return -1
        self.param_version = int(reply.get("version", -1))
        return self.param_version

    def _roundtrip(self, header: Dict[str, Any], payload: bytes = b""):
        """(reply header, reply payload); a None header once stopped."""
        with self._lock:
            if self.stopped:
                return None, b""
            if self._wfile is None:
                raise ConnectionError("plane client is not connected")
            self.bytes_out += _send_msg(self._wfile, header, payload)
            reply, rpayload, n_in = _recv_msg(self._rfile)
            self.bytes_in += n_in
            if reply is None:
                raise ConnectionError("plane gateway closed the connection")
            if reply.get("kind") == "stop":
                self.stopped = True
                return None, b""
            if reply.get("kind") == "error":
                raise ConnectionError(f"plane gateway: {reply.get('error')}")
            return reply, rpayload

    def ship_records(self, records: Dict[str, Any]) -> Optional[int]:
        """Send one record tree; returns the gateway's param version (the
        poll hint), or None once the run is stopping."""
        with trace_span("plane.record_xfer", plane="plane", direction="out"):
            payload = _pack_tree(records)
            reply, _ = self._roundtrip({"kind": "records"}, payload)
        if reply is None:
            return None
        return int(reply.get("version", -1))

    def poll_params(self, have: Optional[int] = None):
        """(version, params or None): params come back only when the
        gateway holds a newer version than ``have`` (default: the newest
        this client has).  None once the run is stopping."""
        have = self.param_version if have is None else int(have)
        with trace_span("plane.param_fetch", plane="plane", have=have):
            reply, payload = self._roundtrip({"kind": "params", "have": have})
        if reply is None:
            return None
        version = int(reply.get("version", -1))
        if not payload:
            return version, None
        self.param_version = version
        return version, _unpack_tree(payload)

    def close(self) -> None:
        with self._lock:
            for f in (self._rfile, self._wfile):
                try:
                    if f is not None:
                        f.close()
                except OSError:
                    pass
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            self._sock = self._rfile = self._wfile = None
