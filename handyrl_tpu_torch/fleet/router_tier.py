"""The fleet's front end: session-affinity routing over N serving replicas.

Counterpart of ``handyrl_tpu/fleet/router_tier.py``, frame for frame.  One
entry port takes ``ServingClient`` connections and proxies their
rid-pipelined frames to ``ServingServer`` replicas, speaking the replica
protocol as an ordinary client (one pipelined ``ServingClient`` per
replica), so a replica needs no fleet awareness.

* Balancing: a new session or a stateless request goes to the live replica
  with the lowest load score, the queue depth plus the shed rate of its
  ``stats`` frame, polled every ``stats_poll_s`` (each poll retried
  through ``utils/retry.py`` before a replica may be declared lost).
* Affinity: an ``infer`` with a ``sid`` follows the session to the replica
  that holds its hidden state.  When that replica dies, the session is
  re-pointed to a survivor, which serves it from a fresh state and counts
  the affinity miss.
* Failure: a replica that drops its connection, or stays silent past
  ``replica_stall_s`` with requests pending, fails its in-flight requests
  with ``replica_lost``, leaves the rotation and is rejoined with
  exponential backoff.  An in-flight stateless request is retried once on
  a survivor; a session request keeps the error (at most once).
* Swap: a ``swap`` frame propagates replica by replica, each running its
  own warm-then-flip, so the tier drops nothing.
* Warm-then-admit: a connected replica takes no traffic until its probe
  sees a published engine (``serve_models`` >= 1).
* Retire, planned (``retire``, the autoscaler's scale-down) or on a
  replica's ``draining`` notice (its preemption): seal it, park its
  sessions' infers, drain its in-flight requests, pull its session cache
  (``export_sessions``), land it in a successor's spill ring
  (``import_sessions``), flip affinity, replay the parked infers.  No
  session is lost and the miss counter does not move.
* Capabilities: a replica tagged ``edge`` takes only feed-forward traffic;
  stateful routes and swaps skip it.

Every thread the router starts (accept, dispatch, poll, metrics, admit,
rejoin, drain, the control pool) is joined by ``shutdown``.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional

from ..runtime.connection import (
    FramedConnection,
    QueueCommunicator,
    accept_socket_connections,
    open_socket_connection,
)
from ..serving.client import ServingClient, ServingError
from ..utils.metrics import append_metrics_record
from ..utils.retry import retry_call
from ..utils.trace import trace_event

__all__ = ["FleetRouter", "ReplicaSpec", "fleet_main"]

# a shed in the last poll window outweighs ~100 queued requests: shedding
# shows the replica is already past its SLO capacity
_SHED_WEIGHT = 100.0
# the pause before a lost stateless request is re-sent to a survivor
_RETRY_BACKOFF_S = 0.05
# session infers parked during their owner's migration; beyond this the
# router re-routes (loudly) instead of buffering without bound
_PARK_BOUND = 1024


class ReplicaSpec:
    """One replica's address and capability tags."""

    __slots__ = ("host", "port", "tags", "name")

    def __init__(self, host: str, port: int, tags=()):
        self.host = str(host)
        self.port = int(port)
        self.tags = frozenset(str(t) for t in tags)
        self.name = f"{self.host}:{self.port}"

    @classmethod
    def parse(cls, entry) -> "ReplicaSpec":
        """A 'host:port' string or a {'host', 'port', 'tags'?} dict, the two
        spellings of ``fleet.replicas``."""
        if isinstance(entry, cls):
            return entry
        if isinstance(entry, str):
            host, _, port = entry.rpartition(":")
            return cls(host or "127.0.0.1", int(port))
        return cls(entry["host"], entry["port"], entry.get("tags", ()))


class _Replica:
    """One replica's live state: its proxy client, liveness, admission,
    and its last polled load score."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.client: Optional[ServingClient] = None
        self.alive = False
        # connected but not admitted: no traffic until the warm probe passes
        self.admitted = False
        # sealed: out of every new pick (retiring or draining)
        self.sealed = False
        # migrating: infers of its sessions park (under the affinity lock)
        # until affinity flips to the successor
        self.migrating = False
        # spawned by the autoscaler's factory (a retire stops the process);
        # configured replicas are the operator's
        self.spawned = False
        self.parked: List = []
        self.load = 0.0
        self.picked = 0  # tie-break: equal loads are picked in turn
        self._last_stats: Dict[str, Any] = {}
        self.lock = threading.Lock()

    @property
    def is_edge(self) -> bool:
        return "edge" in self.spec.tags

    def score_from(self, stats: Dict[str, Any]) -> float:
        """The load score of a stats record: queue depth plus the shed rate
        over the window since the previous poll."""
        prev = self._last_stats
        self._last_stats = stats
        depth = float(stats.get("serve_depth") or 0.0)
        shed = float(stats.get("serve_shed") or 0.0)
        requests = float(stats.get("serve_requests") or 0.0)
        d_shed = max(0.0, shed - float(prev.get("serve_shed") or 0.0))
        d_req = max(1.0, requests - float(prev.get("serve_requests") or 0.0))
        return depth + _SHED_WEIGHT * (d_shed / d_req)


class FleetRouter(QueueCommunicator):
    """The entry port's front end, proxying infer, stats, swap and session
    frames to a fleet of serving replicas."""

    def __init__(self, fleet_cfg: Dict[str, Any], metrics_path: Optional[str] = None,
                 replica_factory=None):
        cfg = dict(fleet_cfg or {})
        # reply bursts to a pipelining client are the product, not a fault
        super().__init__(recv_timeout=None, send_queue_size=1024)
        self.port = int(cfg.get("port", 9996))
        self.bound_port: Optional[int] = None
        self.stats_poll_s = float(cfg.get("stats_poll_s", 2.0))
        self.poll_retry_attempts = int(cfg.get("poll_retry_attempts", 3))
        self.poll_retry_backoff_s = float(cfg.get("poll_retry_backoff_s", 0.1))
        self.replica_stall_s = float(cfg.get("replica_stall_s", 30.0))
        self.backoff_s = float(cfg.get("rejoin_backoff_s", 1.0))
        self.backoff_max_s = float(cfg.get("rejoin_backoff_max_s", 30.0))
        self.stats_interval = float(cfg.get("stats_interval", 30.0))
        self.migrate_timeout_s = float(cfg.get("migrate_timeout_s", 30.0))
        self.autoscale_cfg = dict(cfg.get("autoscale") or {})
        self._factory = replica_factory
        self._autoscaler = None
        self._metrics_path = metrics_path
        self._replicas_lock = threading.Lock()
        self.replicas: List[_Replica] = [_Replica(ReplicaSpec.parse(e))
                                         for e in cfg.get("replicas", ())]
        if not self.replicas and not (self.autoscale_cfg.get("enabled")
                                      and replica_factory is not None):
            raise ValueError("fleet.replicas is empty — nothing to route to "
                             "(and no autoscale factory to spawn from)")
        # sid -> the replica holding its hidden state
        self._affinity: Dict[str, _Replica] = {}
        self._affinity_lock = threading.Lock()
        # blocking control work (sessions, swaps, stats fan-out, polls) runs
        # here, never on the dispatch thread
        self._ctl_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="fleet-ctl")
        self._stop = threading.Event()
        self._rejoining: set = set()
        self._stats_lock = threading.Lock()
        self.requests_in = 0
        self.replies = 0
        self.errors: Dict[str, int] = {}
        self.sessions_routed = 0
        self.replicas_lost = 0
        self.hot_swaps = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.migrations = 0
        self.sessions_migrated = 0
        self.last_migration_ms = 0.0
        self.failover_retries = 0
        self.preempt_drains = 0
        self.poll_retries = 0
        self._stats_t0 = time.monotonic()
        self._stats_served0 = 0
        self._sock = None
        self._threads: List[threading.Thread] = []
        self._threads_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def _thread(self, target, *args, name=None, **kwargs) -> threading.Thread:
        """Start a daemon thread that ``shutdown`` joins."""
        t = threading.Thread(target=target, args=args, kwargs=kwargs, daemon=True, name=name)
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return t

    def run(self, connect_timeout: float = 30.0) -> "FleetRouter":
        """Connect the replicas (each retried for ``connect_timeout``, they
        may still be starting), wait until one is warm, then bind the entry
        port and serve.  With autoscaling armed, first spawn up to
        ``min_replicas`` from the factory."""
        if self.autoscale_cfg.get("enabled") and self._factory is not None:
            want = int(self.autoscale_cfg.get("min_replicas", 1))
            have = sum(1 for r in self._reps() if not r.is_edge)
            for _ in range(max(0, want - have)):
                self._spawn_replica()
        for rep in self._reps():
            if rep.alive:
                continue  # connected by _spawn_replica
            try:
                self._connect(rep, retry_seconds=connect_timeout)
            except OSError as exc:
                # down at the start is the same as lost later
                print(f"fleet: replica {rep.spec.name} unreachable at start ({exc}); "
                      "rejoining in background")
                self._mark_lost(rep)
                continue
            self._thread(self._admit_loop, rep, name=f"fleet-admit-{rep.spec.name}")
        if not any(r.alive for r in self._reps()):
            self.shutdown()
            raise ConnectionError("fleet: no replica reachable at startup")
        # bind only once a replica is warm: earlier, the first requests would
        # be shed into cold engines
        deadline = time.monotonic() + connect_timeout
        while not any(r.admitted for r in self._reps()) and time.monotonic() < deadline:
            time.sleep(0.02)
        if not any(r.admitted for r in self._reps()):
            self.shutdown()
            raise ConnectionError(
                f"fleet: no replica became warm (admitted) within {connect_timeout:.0f}s — is a "
                "model published?")
        self._sock = open_socket_connection(self.port)
        self._sock.listen(1024)
        self.bound_port = self._sock.getsockname()[1]
        self._thread(self._accept_loop, name="fleet-accept")
        self._thread(self._dispatch, name="fleet-dispatch")
        self._thread(self._poll_loop, name="fleet-poll")
        if self._metrics_path and self.stats_interval > 0:
            self._thread(self._metrics_loop, name="fleet-metrics")
        if self.autoscale_cfg.get("enabled") and self._factory is not None:
            from .autoscale import Autoscaler

            self._autoscaler = Autoscaler(self, self.autoscale_cfg).start()
        return self

    def shutdown(self) -> None:
        """Stop serving: the autoscaler (joined), the entry socket, every
        proxy client (their pending requests fail at once), the control
        pool and every router thread, joined."""
        super().shutdown()
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._close_clients()
        if self._autoscaler is not None:
            self._autoscaler.stop()   # joins a tick in flight
            self._close_clients()     # and whatever it connected meanwhile
        self._ctl_pool.shutdown(wait=True, cancel_futures=True)
        me = threading.current_thread()
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            if t is not me:
                t.join(timeout=max(10.0, self.migrate_timeout_s))

    def _close_clients(self) -> None:
        for rep in self._reps():
            with rep.lock:
                client, rep.client, rep.alive = rep.client, None, False
            if client is not None:
                client.close()

    def _accept_loop(self) -> None:
        for conn in accept_socket_connections(timeout=0.5, sock=self._sock):
            if conn is None:
                if self.shutdown_flag:
                    break
                continue
            self.add_connection(conn)

    # -- the replicas ---------------------------------------------------------

    def _reps(self) -> List[_Replica]:
        """A snapshot of the replica list, which the autoscaler changes."""
        with self._replicas_lock:
            return list(self.replicas)

    def _connect(self, rep: _Replica, retry_seconds: float = 0.0) -> None:
        client = ServingClient(
            rep.spec.host, rep.spec.port, retry_seconds=retry_seconds,
            # a silent replica fails its pending requests by name
            stall_timeout=self.replica_stall_s or None,
            # the draining notice arrives on the client's receiver thread
            on_notice=lambda kind, data, r=rep: self._on_replica_notice(r, kind, data),
        )
        with rep.lock:
            rep.client = client
            rep.alive = True
            # a (re)connected replica earns admission again: a relaunched
            # process comes back cold
            rep.admitted = False
            rep.sealed = False
            rep.migrating = False
            rep.parked = []
            rep.load = 0.0

    def _replica_stats(self, rep: _Replica) -> Optional[Dict[str, Any]]:
        """A replica's stats frame, transport failures retried within
        ``poll_retry_attempts``; a ``ServingError`` (the replica answering
        with a failure) propagates at once."""
        client = rep.client
        if client is None:
            raise ConnectionError("replica has no client")

        def _count(i, exc):
            with self._stats_lock:
                self.poll_retries += 1

        return retry_call(
            lambda: client.stats(timeout=max(self.stats_poll_s * 4, 10.0)),
            attempts=self.poll_retry_attempts,
            base_delay=self.poll_retry_backoff_s,
            retry_on=(ConnectionError, OSError, TimeoutError, FuturesTimeout),
            on_retry=_count,
            sleep=self._stop.wait,
        )

    def _admit_loop(self, rep: _Replica) -> None:
        """The warm probe: poll until the replica's engine is published
        (``serve_models`` >= 1; an edge replica is warm once it answers),
        then admit it.  One not warm within ``autoscale.warm_timeout_s`` is
        marked lost."""
        warm_timeout = float(self.autoscale_cfg.get("warm_timeout_s", 120.0))
        deadline = time.monotonic() + warm_timeout
        poll = max(0.05, min(self.stats_poll_s, 0.5))
        while not self.shutdown_flag and rep.alive and not rep.sealed:
            if rep.client is None:
                return
            try:
                stats = self._replica_stats(rep)
            except Exception:
                self._mark_lost(rep)
                return
            stats = stats or {}
            if rep.is_edge or float(stats.get("serve_models") or 0) >= 1:
                rep.load = rep.score_from(stats)
                rep.admitted = True
                print(f"fleet: replica {rep.spec.name} admitted (warm)", flush=True)
                return
            if time.monotonic() > deadline:
                print(f"fleet: replica {rep.spec.name} never became warm within "
                      f"{warm_timeout:.0f}s — marking lost")
                self._mark_lost(rep)
                return
            self._stop.wait(poll)

    def _mark_lost(self, rep: _Replica) -> None:
        """Reap a dead replica, count the loss, schedule its rejoin.
        Idempotent under racing reporters."""
        with rep.lock:
            was_alive, rep.alive = rep.alive, False
            client, rep.client = rep.client, None
        if client is not None:
            client.close()
        if was_alive:
            with self._stats_lock:
                self.replicas_lost += 1
            print(f"fleet: replica {rep.spec.name} lost; re-routing its sessions, rejoining "
                  "with backoff", flush=True)
        if self.shutdown_flag:
            return
        with self._stats_lock:
            if rep in self._rejoining:
                return
            self._rejoining.add(rep)
        self._thread(self._rejoin_loop, rep, name=f"fleet-rejoin-{rep.spec.name}")

    def _rejoin_loop(self, rep: _Replica) -> None:
        """Exponential backoff, capped, until shutdown: a restarted replica
        rejoins the rotation on its own."""
        backoff = self.backoff_s
        try:
            while not self._stop.wait(backoff):
                try:
                    self._connect(rep)
                    print(f"fleet: replica {rep.spec.name} rejoined (warming before "
                          "re-admission)", flush=True)
                    self._admit_loop(rep)
                    return
                except OSError:
                    backoff = min(backoff * 2.0, self.backoff_max_s)
        finally:
            with self._stats_lock:
                self._rejoining.discard(rep)

    def _live(self, stateful: bool) -> List[_Replica]:
        return [r for r in self._reps()
                if r.alive and r.admitted and not r.sealed and not (stateful and r.is_edge)]

    def _pick(self, stateful: bool) -> Optional[_Replica]:
        """The lowest-load eligible replica; None when none is live."""
        t0 = time.monotonic()
        candidates = self._live(stateful)
        if not candidates:
            return None
        rep = min(candidates, key=lambda r: (r.load, r.picked))
        rep.picked += 1
        trace_event("fleet.route", time.monotonic() - t0, t0=t0, plane="fleet",
                    replicas=len(candidates))
        return rep

    def _poll_loop(self) -> None:
        """The balancing signal: each replica's stats polled on a pool task
        of its own, so one stalled replica delays no other's score."""
        while not self._stop.wait(self.stats_poll_s):
            for rep in self._reps():
                if rep.alive and not rep.sealed:
                    try:
                        self._ctl_pool.submit(self._poll_one, rep)
                    except RuntimeError:
                        return  # the pool is shut down

    def _poll_one(self, rep: _Replica) -> None:
        if rep.client is None:
            return
        try:
            stats = self._replica_stats(rep)
        except Exception:
            if not self.shutdown_flag:
                self._mark_lost(rep)
            return
        rep.load = rep.score_from(stats or {})

    # -- request dispatch ----------------------------------------------------

    def _submit(self, fn, *args) -> None:
        """A task for the control pool; dropped once the pool is shut down."""
        try:
            self._ctl_pool.submit(fn, *args)
        except RuntimeError:
            pass

    def _dispatch(self) -> None:
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
                    self._handle_infer(conn, data)
                elif req == "open_session":
                    self._submit(self._handle_open_session, conn, data)
                elif req == "close_session":
                    self._submit(self._handle_close_session, conn, data)
                elif req == "stats":
                    self._submit(self._handle_stats, conn, rid)
                elif req == "swap":
                    self._submit(self._handle_swap, conn, data)
                else:
                    self._error(conn, rid, "bad_request", f"unknown request {req!r}")
            except Exception as exc:
                # no frame may kill the dispatch thread
                self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_infer(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        with self._stats_lock:
            self.requests_in += 1
        arrival = time.monotonic()
        rid = data.get("rid")
        sid = data.get("sid")
        stateful = sid is not None or data.get("hidden") is not None
        rep = None
        if sid is not None:
            # the affinity read and the migration park are one step under
            # the lock the retire flips affinity under: no request reaches
            # the old owner after its state was exported
            with self._affinity_lock:
                rep = self._affinity.get(sid)
                if rep is not None and rep.migrating:
                    if len(rep.parked) < _PARK_BOUND:
                        rep.parked.append((conn, data))
                        return
                    rep = None  # the park is full: re-route, loudly
            if rep is not None and (not rep.alive or rep.sealed):
                rep = None  # its owner died or is retiring
        if rep is None:
            rep = self._pick(stateful)
            if rep is None:
                self._error(conn, rid, "no_replica",
                            f"no live replica can serve this request (stateful={stateful})")
                return
            if sid is not None:
                # re-pointed (first infer, or its owner lost): the new owner
                # serves it fresh and counts the affinity miss
                with self._affinity_lock:
                    self._affinity[sid] = rep
        self._proxy(conn, rep, data, arrival)

    def _proxy(self, conn: FramedConnection, rep: _Replica, data: Dict[str, Any],
               arrival: float, retried: bool = False) -> None:
        rid = data.get("rid")
        client = rep.client
        if client is None:
            self._error(conn, rid, "replica_lost", f"replica {rep.spec.name} lost before proxy")
            return
        fut = client.submit(data.get("obs"), data.get("model", -1), data.get("hidden"),
                            data.get("slo_ms"), sid=data.get("sid"))
        fut.add_done_callback(
            lambda f, c=conn, p=rep, d=data, a=arrival, rt=retried: self._relay(c, p, f, d, a, rt))

    def _relay(self, conn: FramedConnection, rep: _Replica, fut: Future, data: Dict[str, Any],
               arrival: float, retried: bool = False) -> None:
        """A proxied infer's reply: forward it under the front client's rid.
        A transport failure means the replica is gone: a stateless request
        is retried once on a survivor, a session request fails with
        ``replica_lost``."""
        rid = data.get("rid")
        exc = fut.exception()
        trace_event("fleet.proxy", time.monotonic() - arrival, t0=arrival, plane="fleet",
                    ok=exc is None, replica=rep.spec.name)
        if exc is None:
            d = fut.result()
            reply = {"rid": rid, "model": d.get("model"), "out": d.get("out")}
            if "sid" in d:
                reply["sid"] = d["sid"]
            with self._stats_lock:
                self.replies += 1
            self.send(conn, ("result", reply))
            return
        if isinstance(exc, ServingError) and exc.kind != "stalled":
            # a request-level failure (shed, deadline, ...) is the replica
            # working as designed: forward it
            self._error(conn, rid, exc.kind, str(exc))
            return
        self._mark_lost(rep)
        if data.get("sid") is None and not retried and not self.shutdown_flag:
            # no server-side state moved: safe to re-run once
            with self._stats_lock:
                self.failover_retries += 1
            self._submit(self._retry_stateless, conn, data, arrival)
            return
        self._error(conn, rid, "replica_lost",
                    f"replica {rep.spec.name} lost mid-request ({type(exc).__name__}: {exc})")

    def _retry_stateless(self, conn: FramedConnection, data: Dict[str, Any],
                         arrival: float) -> None:
        self._stop.wait(_RETRY_BACKOFF_S)
        rep = self._pick(stateful=data.get("hidden") is not None)
        if rep is None:
            self._error(conn, data.get("rid"), "replica_lost",
                        "stateless retry found no live replica")
            return
        self._proxy(conn, rep, data, arrival, retried=True)

    # -- migration, preemption, scaling ----------------------------------------

    def _on_replica_notice(self, rep: _Replica, kind: str, data: Dict[str, Any]) -> None:
        """A replica's pushed notice (on its client's receiver thread: hand
        off).  ``draining`` is a preempted replica asking for its sessions
        to be rescued within its drain deadline."""
        if kind != "draining" or self.shutdown_flag:
            return
        with self._stats_lock:
            self.preempt_drains += 1
        print(f"fleet: replica {rep.spec.name} is draining (preempted) — migrating its "
              "sessions to a survivor", flush=True)
        # a thread of its own: the handoff may take migrate_timeout_s
        self._thread(self._retire_replica, rep, reason="preempted", remove=False,
                     name=f"fleet-drain-{rep.spec.name}")

    def retire(self, rep: _Replica) -> int:
        """Planned retire: seal, drain, migrate its sessions to a successor,
        stop.  Returns the sessions migrated."""
        return self._retire_replica(rep, reason="retire", remove=True)

    def _retire_replica(self, rep: _Replica, reason: str = "retire",
                        remove: bool = True) -> int:
        """The zero-loss retire, in this order:

        1. seal and mark migrating, under the affinity lock: no new pick,
           its sessions' infers park;
        2. drain its in-flight requests (their stores land before their
           replies, so the export sees every step);
        3. export its session cache and land it in a successor's spill ring;
        4. flip affinity to the successor and replay the parked infers
           (restored bit for bit, no affinity miss);
        5. drop the replica (scale-down: its process too; preemption: the
           slot stays and the rejoin loop chases a relaunch).
        """
        t_start = time.monotonic()
        with self._affinity_lock:
            if rep.sealed:
                return 0  # already retiring
            rep.sealed = True
            rep.migrating = True
        migrated = 0
        succ: Optional[_Replica] = None
        client = rep.client
        try:
            if client is not None and rep.alive:
                deadline = time.monotonic() + self.migrate_timeout_s
                while client.pending_count() > 0 and time.monotonic() < deadline:
                    time.sleep(0.005)
                exported = client.export_sessions(timeout=self.migrate_timeout_s)
                sessions = exported.get("sessions") or {}
                fresh = exported.get("fresh") or []
                if sessions or fresh:
                    succ = self._pick(stateful=True)
                    if succ is not None and succ.client is not None:
                        succ.client.import_sessions(sessions, fresh,
                                                    timeout=self.migrate_timeout_s)
                        migrated = len(sessions)
                    else:
                        succ = None
                        print(f"fleet: retire of {rep.spec.name}: no live successor for "
                              f"{len(sessions)} session(s) — they will re-open fresh "
                              "(counted misses)", flush=True)
        except Exception as exc:
            succ = None
            print(f"fleet: session migration off {rep.spec.name} failed "
                  f"({type(exc).__name__}: {exc}) — its sessions will re-open fresh "
                  "(counted misses)", flush=True)
        # flip and release under the lock the park takes: after this no
        # request reaches the exported owner
        with self._affinity_lock:
            parked, rep.parked = rep.parked, []
            for s, owner in list(self._affinity.items()):
                if owner is rep:
                    if succ is not None:
                        self._affinity[s] = succ
                    else:
                        del self._affinity[s]
            rep.migrating = False
        handoff_ms = (time.monotonic() - t_start) * 1000.0
        with self._stats_lock:
            self.migrations += 1
            self.sessions_migrated += migrated
            self.last_migration_ms = handoff_ms
        trace_event("fleet.migrate", handoff_ms / 1000.0, t0=t_start, plane="fleet",
                    sessions=migrated, reason=reason)
        for pconn, pdata in parked:
            self._submit(self._handle_infer, pconn, pdata)
        print(f"fleet: replica {rep.spec.name} retired ({reason}): {migrated} session(s) "
              "migrated" + (f" to {succ.spec.name}" if succ is not None else "")
              + f" in {handoff_ms:.0f}ms, {len(parked)} parked infer(s) replayed", flush=True)
        if remove:
            with self._replicas_lock:
                try:
                    self.replicas.remove(rep)
                except ValueError:
                    pass
            with rep.lock:
                client, rep.client, rep.alive = rep.client, None, False
            if client is not None:
                client.close()
            if rep.spawned and self._factory is not None:
                try:
                    self._factory.stop(rep.spec)
                except Exception as exc:
                    print(f"fleet: factory stop of {rep.spec.name} failed: "
                          f"{type(exc).__name__}: {exc}")
        else:
            # a preempted configured replica keeps its slot; the rejoin loop
            # chases the relaunched process, which is warm-probed again
            self._mark_lost(rep)
        return migrated

    def _spawn_replica(self) -> Optional[_Replica]:
        """A replica from the factory, warming; it joins the rotation when
        its probe passes."""
        if self._factory is None:
            return None
        try:
            spec = self._factory.spawn()
        except Exception as exc:
            print(f"fleet: replica spawn failed: {type(exc).__name__}: {exc}")
            return None
        rep = _Replica(ReplicaSpec.parse(spec))
        rep.spawned = True
        try:
            self._connect(rep, retry_seconds=10.0)
        except OSError as exc:
            print(f"fleet: spawned replica {rep.spec.name} unreachable ({exc}); stopping it")
            try:
                self._factory.stop(rep.spec)
            except Exception:
                pass
            return None
        with self._replicas_lock:
            self.replicas.append(rep)
        self._thread(self._admit_loop, rep, name=f"fleet-admit-{rep.spec.name}")
        return rep

    def scale_up(self, reason: str = "") -> bool:
        rep = self._spawn_replica()
        if rep is None:
            return False
        with self._stats_lock:
            self.scale_ups += 1
        print(f"fleet: scale-up -> {rep.spec.name} (warming; admitted when warm){reason}",
              flush=True)
        return True

    def scale_down(self, reason: str = "") -> bool:
        """Retire the newest spawned replica through the migration path;
        configured replicas are the operator's floor."""
        cands = [r for r in self._reps() if r.spawned and r.alive and not r.sealed]
        if not cands:
            return False
        rep = cands[-1]
        with self._stats_lock:
            self.scale_downs += 1
        print(f"fleet: scale-down -> retiring {rep.spec.name}{reason}", flush=True)
        self._retire_replica(rep, reason="scale-down", remove=True)
        return True

    # -- control frames (pool) ----------------------------------------------

    def _handle_open_session(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        rid = data.get("rid")
        try:
            rep = self._pick(stateful=True)
            if rep is None or rep.client is None:
                self._error(conn, rid, "no_replica", "no live stateful replica to host the session")
                return
            sid = rep.client.open_session(model=data.get("model", -1))
            with self._affinity_lock:
                self._affinity[sid] = rep
            with self._stats_lock:
                self.sessions_routed += 1
            self.send(conn, ("session", {"rid": rid, "sid": sid}))
        except Exception as exc:
            self._error(conn, rid, "replica_lost",
                        f"open_session failed: {type(exc).__name__}: {exc}")

    def _handle_close_session(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        rid = data.get("rid")
        sid = data.get("sid")
        with self._affinity_lock:
            rep = self._affinity.pop(sid, None)
        existed = False
        try:
            if rep is not None and rep.alive and rep.client is not None:
                existed = bool(rep.client.close_session(sid).get("existed", False))
        except Exception:
            pass  # its owner died with it: closed by definition
        self.send(conn, ("session_closed", {"rid": rid, "sid": sid, "existed": existed}))

    def _handle_stats(self, conn: FramedConnection, rid) -> None:
        try:
            per_replica = {}
            for rep in self._reps():
                client = rep.client
                if rep.alive and client is not None:
                    try:
                        per_replica[rep.spec.name] = client.stats(timeout=10.0)
                    except Exception:
                        self._mark_lost(rep)
            stats = dict(self.stats_record(), replicas=per_replica)
            self.send(conn, ("stats", {"rid": rid, "stats": stats}))
        except Exception as exc:
            self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_swap(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        """The fleet-wide swap, replica by replica: each warms and flips
        while the others serve at full capacity."""
        rid = data.get("rid")
        sid = data.get("id")
        warm_ms_total = 0.0
        flipped = 0
        try:
            for rep in self._reps():
                if rep.is_edge or not rep.alive or rep.sealed:
                    continue  # an edge artifact takes no params; a retiring
                    # replica's engine goes with it
                client = rep.client
                if client is None:
                    continue
                reply = client.swap(sid, data.get("params"))
                warm_ms_total += float(reply.get("warm_ms") or 0.0)
                flipped += 1
            if flipped == 0:
                self._error(conn, rid, "swap_failed", "no live swap-capable replica")
                return
            with self._stats_lock:
                self.hot_swaps += 1
            self.send(conn, ("swapped", {"rid": rid, "id": sid, "warm_ms": warm_ms_total,
                                         "replicas": flipped}))
        except Exception as exc:
            # a fleet of mixed versions: loud, with the progress made
            self._error(conn, rid, "swap_failed",
                        f"{flipped} replica(s) flipped, then {type(exc).__name__}: {exc}")

    def _error(self, conn: FramedConnection, rid, kind: str, msg: str) -> None:
        with self._stats_lock:
            self.errors[kind] = self.errors.get(kind, 0) + 1
        self.send(conn, ("error", {"rid": rid, "kind": kind, "msg": msg}))

    # -- stats / metrics -----------------------------------------------------

    def stats_record(self, advance_window: bool = False) -> Dict[str, Any]:
        """One metrics.jsonl record of the front end's health; every key is
        in ``utils.metrics.METRIC_KEYS``."""
        now = time.monotonic()
        with self._stats_lock:
            replies = self.replies
            dt = max(now - self._stats_t0, 1e-6)
            served_delta = replies - self._stats_served0
            if advance_window:
                self._stats_t0 = now
                self._stats_served0 = replies
            record: Dict[str, Any] = {
                "fleet_requests": self.requests_in,
                "fleet_replies": replies,
                "fleet_errors": sum(self.errors.values()),
                "fleet_qps": round(served_delta / dt, 2),
                "fleet_replica_lost": self.replicas_lost,
                "fleet_sessions": self.sessions_routed,
                "fleet_hot_swaps": self.hot_swaps,
                "fleet_scale_ups": self.scale_ups,
                "fleet_scale_downs": self.scale_downs,
                "fleet_migrations": self.migrations,
                "fleet_sessions_migrated": self.sessions_migrated,
                "fleet_migration_ms": round(self.last_migration_ms, 2),
                "fleet_failover_retries": self.failover_retries,
                "fleet_preempt_drains": self.preempt_drains,
                "fleet_poll_retries": self.poll_retries,
            }
        reps = self._reps()
        record.update(
            fleet_replicas=len(reps),
            fleet_replicas_live=sum(1 for r in reps if r.alive),
            fleet_replicas_warming=sum(1 for r in reps if r.alive and not r.admitted),
        )
        return record

    def _metrics_loop(self) -> None:
        while not self._stop.wait(self.stats_interval):
            try:
                append_metrics_record(self._metrics_path,
                                      self.stats_record(advance_window=True))
            except Exception as exc:
                print(f"fleet: metrics write failed: {type(exc).__name__}: {exc}")


def fleet_main(args: Dict[str, Any], device=None) -> int:
    """``--fleet``: the front end over ``fleet.replicas`` (start each with
    ``--serve`` first).  With ``fleet.autoscale.enabled`` it also spawns and
    retires serving processes of its own against the shed-rate SLO, on the
    card unless ``device`` says otherwise (without a card it raises, as
    every entry point does).  Serves until SIGTERM or Ctrl-C; returns 0."""
    import signal

    from ..utils import resolve_device, trace

    device = resolve_device(device)
    train = args["train_args"]
    fleet_cfg = train["fleet"]
    if trace.configure(train.get("trace")):
        print(f"fleet: trace spans -> {trace.current_path()}")
    factory = None
    if fleet_cfg["autoscale"]["enabled"]:
        from .autoscale import ProcessReplicaFactory

        factory = ProcessReplicaFactory(args, device=device)
        print("fleet: autoscale armed (local process replicas)")
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread
    router = None
    try:
        router = FleetRouter(fleet_cfg, metrics_path=train.get("metrics_path"),
                             replica_factory=factory).run()
        specs = ", ".join(r.spec.name + ("[edge]" if r.is_edge else "") for r in router._reps())
        print(f"fleet: entry port {router.bound_port} over replicas {specs}", flush=True)
        while not stop.wait(1.0):
            pass
        print("fleet: SIGTERM — shutting down", flush=True)
    except KeyboardInterrupt:
        print("fleet: shutting down")
    finally:
        if router is not None:
            router.shutdown()
        if factory is not None:
            factory.close()
        trace.shutdown()
    return 0
