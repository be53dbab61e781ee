"""The actor/learner planes: versioned params out, self-play records in.

Counterpart of ``handyrl_tpu/runtime/plane.py``.  Under ``plane: split``
self-play runs on actor members of its own (parallel/mesh.py
``split_mesh``: streams of their own on the rank's card, or cards of their
own) while the learner member trains, and two flows cross between them:

* params, learner -> actors: ``PlaneParamCache`` holds a versioned copy on
  the actor members' devices, published by the trainer every
  ``param_refresh_updates`` updates; ``lag`` says how many learner updates
  behind it is;
* records, actors -> learner: ``RecordTransfer`` moves a rollout's (K, B,
  ...) record batch onto the learner member, where ``DeviceReplay``'s rings
  take it.

Both count their bytes.  The learner's params change in place at every
step (JAX's arrays never do), so a publish copies them on the learner's own
stream, after the step that made them and before the next one writes them,
and marks the copy with an event; the actor reads a copy only once its
event has completed, so neither stream ever waits on the other.  A record
batch crosses once its block is complete (the rollout thread waits, the
learner's stream does not), as a copy enqueued on the learner's stream.  A
tensor read on one stream and freed by another thread is handed over with
``record_stream``.

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

import contextlib
import io
import json
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, PlaneMember
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
    """A copy of ``tree`` on ``device``, enqueued on the calling thread's
    current stream."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    return tree.detach().to(device, copy=True)


def _ready_event(device: torch.device, timing: bool = False):
    """An event behind the calling thread's work on ``device`` (None on
    the CPU, where work is done when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=timing)
    event.record(torch.cuda.current_stream(device))
    return event


def _members(where):
    """A Mesh, a list of plane members or devices, or one -> a list."""
    if isinstance(where, Mesh):
        where = where.devices
    if not isinstance(where, (list, tuple)):
        where = [where]
    return list(where)


def _device_of(member) -> torch.device:
    return member.device if isinstance(member, PlaneMember) else torch.device(member)


class PlaneParamCache:
    """A versioned copy of the learner's params for the actor members (one
    copy per distinct device among them).  The trainer's thread publishes
    between steps; an actor's thread reads ``latest(member)``, which hands
    out the newest copy whose copy has completed (waiting only for the
    first), readable on the member's stream.  Versions are learner step
    counts and only advance; ``version`` and ``lag`` follow the newest
    publish, as the JAX cache's do."""

    def __init__(self, actors):
        self.members = _members(actors)
        self.devices = list(dict.fromkeys(_device_of(m) for m in self.members))
        self.device = self.devices[0]
        self._lock = threading.Lock()
        self._pending = None   # (version, {device: params}, {device: event})
        self._ready = None     # the newest copy an actor may read
        self.version = -1
        self.refreshes = 0
        self.bytes_transferred = 0
        # (start, ready) events of the newest copies on a card, for copy_ms
        self._timed: deque = deque(maxlen=64)

    def publish(self, params, version: int) -> None:
        """Copy ``params`` to the actor devices on this thread's current
        stream (the learner's: the copy sits between the step that made
        the params and the one that next writes them) and stamp it
        ``version``.  A copy not yet read is replaced outright."""
        version = int(version)
        with self._lock:
            if version <= self.version:
                raise ValueError(f"param version must advance monotonically: "
                                 f"{version} <= {self.version}")
            start = _ready_event(self.device, timing=True)
            copies = {d: _tree_to(params, d) for d in self.devices}
            events = {d: _ready_event(d, timing=d == self.device) for d in self.devices}
            if start is not None:
                self._timed.append((start, events[self.device]))
            self._pending = (version, copies, events)
            self.version = version
            self.refreshes += 1
            # the JAX cache counts a replicated copy once
            self.bytes_transferred += _tree_bytes(copies[self.device])

    def newest(self):
        """(version, params on the first actor device, its event) of the
        newest publish, read or not."""
        with self._lock:
            entry = self._pending or self._ready
        if entry is None:
            raise RuntimeError("PlaneParamCache.newest() before first publish")
        version, copies, events = entry
        return version, copies[self.device], events[self.device]

    def latest(self, member=None) -> Tuple[int, Any]:
        """(version, params on ``member``'s device) of the newest copy that
        has landed; ``member``'s stream (or the calling thread's current
        one) is ordered after the copy, and the allocator keeps the copy's
        memory until that stream is past its reads."""
        with self._lock:
            pending = self._pending
            if pending is not None:
                events = [e for e in pending[2].values() if e is not None]
                if self._ready is None:
                    for e in events:   # the first publish: wait for it
                        e.synchronize()
                if self._ready is None or all(e.query() for e in events):
                    self._ready, self._pending = pending, None
            if self._ready is None:
                raise RuntimeError("PlaneParamCache.latest() before first publish")
            version, copies, events = self._ready
        device = _device_of(member) if member is not None else self.device
        params, event = copies[device], events[device]
        if event is not None:
            stream = getattr(member, "stream", None) or torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in _leaves(params):
                t.record_stream(stream)
        return version, params

    def lag(self, learner_steps: int) -> int:
        """How many learner updates behind the newest publish is."""
        return max(0, int(learner_steps) - self.version) if self.refreshes else 0

    def copy_ms(self) -> Optional[float]:
        """The mean device time of the newest copies to the first actor
        device (waits for them; None on the CPU)."""
        with self._lock:
            timed = list(self._timed)
        if not timed:
            return None
        times = []
        for start, ready in timed:
            ready.synchronize()
            times.append(start.elapsed_time(ready))
        return sum(times) / len(times)


class RecordTransfer:
    """Actor -> learner: a record batch moved onto the learner member, with
    byte accounting.  ``ready`` (an event behind the block on the actor's
    stream) is waited for on the host, by the rollout thread alone; the
    copy is then enqueued on the learner member's stream (on the same card
    an ordered copy, across cards a real one), which thus never waits on
    the actor's, and the source stays allocated until the copy has read
    it."""

    def __init__(self, learner):
        self.member = learner if isinstance(learner, PlaneMember) else None
        self.device = _device_of(learner)
        self.transfers = 0
        self.bytes_transferred = 0

    def __call__(self, records: Dict[str, Any], ready=None) -> Dict[str, Any]:
        if ready is not None:
            ready.synchronize()
        stream = None if self.member is None else self.member.stream
        with (torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()):
            moved = _tree_to(records, self.device)
            if stream is not None:
                for t in _leaves(records):
                    if torch.is_tensor(t) and t.is_cuda:
                        t.record_stream(stream)
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


def _snapshot(params):
    """(a copy of ``params``, an event behind it): the trainer's params
    change in place at its next step, so the gateway keeps a copy, made on
    the publishing thread's current stream."""
    copy = _tree_to(params, next(
        (t.device for t in _leaves(params) if torch.is_tensor(t)), torch.device("cpu")))
    device = next((t.device for t in _leaves(copy)), torch.device("cpu"))
    return copy, _ready_event(device)


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

    The trainer publishes through ``publish(params, version)`` every
    ``param_refresh_updates`` updates, the surface of ``PlaneParamCache``
    (to which it delegates when ``inner`` is set, under ``plane: split``):
    the publish keeps a copy (the inner cache's, else its own, made on the
    publishing thread's stream) and returns; the serialization happens on a
    serving thread at the first poll of that version.  ``on_records`` receives each decoded record tree on a
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
        self._params = None          # newest published tree (a copy)
        self._ready = None           # the event behind that copy (on a card)
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
        inner = self.inner
        if inner is not None:
            # the local copy first: it holds the monotonicity check, and a
            # raise leaves the gateway untouched; its copy is the snapshot
            inner.publish(params, version)
            _v, snap, ready = inner.newest()
        else:
            snap, ready = None, None
        with self._lock:
            if inner is None:
                if version <= self.version:
                    raise ValueError(f"param version must advance monotonically: "
                                     f"{version} <= {self.version}")
                snap, ready = _snapshot(params)
            self._params, self._ready = snap, ready
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
            version, params, ready = self.version, self._params, self._ready
        with trace_span("plane.param_publish", plane="plane", version=version):
            if ready is not None:
                ready.synchronize()
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
