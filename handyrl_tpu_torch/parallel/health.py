"""Cross-host health plane: peer heartbeats + a collective-timeout watchdog.

The port's own copy of ``handyrl_tpu/parallel/health.py`` (stdlib only,
the same wire and the same verdicts); the port imports nothing of the JAX
package.  Under ``torch.distributed`` a lost or frozen peer process is, by default, an
INDEFINITE hang: every surviving process blocks inside the next collective
waiting for a participant that will never arrive.  This module bounds that
failure.  Two independent detectors run beside the training threads:

* **Heartbeats** (``HostHealthPlane``): the coordinator (process 0) serves
  a tiny TCP health port (default: coordinator port + 1); every other
  process sends a one-line JSON heartbeat each ``heartbeat_interval``
  seconds.  A peer silent past ``heartbeat_timeout`` is declared LOST on
  the coordinator; the loss is echoed to the surviving peers in the
  heartbeat acks so they stop too.  A follower whose heartbeats go
  unanswered past the timeout declares the COORDINATOR lost.  Heartbeat
  threads never touch a device, so they keep beating while the trainer is
  wedged inside a dead collective — which is exactly when they matter.

* **Collective watchdog** (``CollectiveWatchdog``): the trainer arms it
  around every cross-process dispatch; a dispatch still in flight after
  ``collective_timeout`` seconds means a peer stopped participating (a
  wedged-but-not-dead host keeps heartbeating), and the watchdog fires.

Either detector ends in the learner's ``_host_fault``: the coordinator
drain-saves a manifest-verified checkpoint from the last consistent host
snapshot and every survivor exits ``EXIT_RESUMABLE`` (75) — a wedged
collective cannot be cancelled from Python, so a loud bounded exit with a
verified resume point is the strongest recovery a host-side supervisor can
offer (the PaLM skip-and-rollback discipline extended from bad steps to
dead hosts; docs/fault_tolerance.md §Multi-host failure matrix).

Everything here is stdlib sockets + threads, so the monitor logic is
unit-testable socket-free (tests/test_torch_distributed.py).
"""

from __future__ import annotations

import json
import select
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional


def _split_address(address: str) -> tuple:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


def resolve_health_port(dist_args: Dict[str, Any]) -> int:
    """The health plane's TCP port: ``distributed.health_port`` when set,
    else coordinator port + 1 (one launcher knob covers both planes)."""
    port = int(dist_args.get("health_port") or 0)
    if port:
        return port
    return _split_address(dist_args["coordinator_address"])[1] + 1


class CollectiveWatchdog:
    """Bounds the time any armed section may stay in flight.

    The trainer arms it immediately before a cross-process dispatch and
    disarms it when the dispatch returns; a monitor thread fires
    ``on_timeout(tag)`` once if an armed section outlives ``timeout``
    seconds.  The first step's warm-up (kernel builds, allocator) is excluded by the CALLER
    (arm only after the first completed step — the plane-watchdog
    compile-grace pattern); pre-first-step peer deaths are the heartbeat
    plane's job.  ``timeout <= 0`` disables the watchdog entirely.
    """

    def __init__(self, timeout: float, on_timeout: Callable[[str], None],
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._tag = ""
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.timeout <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._monitor, daemon=True, name="collective-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @property
    def fired(self) -> bool:
        return self._fired

    def arm(self, tag: str) -> None:
        with self._lock:
            self._armed_at = self._clock()
            self._tag = tag

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None

    def check(self, now: Optional[float] = None) -> bool:
        """One monitor tick (public for socket-free unit tests); True once
        the watchdog has fired."""
        if self.timeout <= 0:
            return False
        with self._lock:
            armed_at, tag, fired = self._armed_at, self._tag, self._fired
            if fired or armed_at is None:
                return fired
            age = (self._clock() if now is None else now) - armed_at
            if age <= self.timeout:
                return False
            self._fired = True
        self.on_timeout(
            f"collective '{tag}' still in flight after {age:.1f}s "
            f"(> collective_timeout {self.timeout:.0f}s) — a peer process "
            "stopped participating"
        )
        return True

    def _monitor(self) -> None:
        tick = max(0.05, min(1.0, self.timeout / 8.0))
        while not self._stop.is_set():
            time.sleep(tick)
            if self.check():
                return


class HostHealthPlane:
    """Peer liveness over a dedicated TCP port, beside torch.distributed.

    Role follows the process index: process 0 runs the server/monitor
    half, everyone else the heartbeat-client half.  ``on_fault(reason,
    kind)`` is invoked AT MOST ONCE (kinds: ``"peer_loss"`` /
    ``"coordinator_loss"``); cumulative counters live in ``events`` and
    feed the learner's ``dist_*`` metrics keys.
    """

    def __init__(self, dist_args: Dict[str, Any], process_id: int,
                 num_processes: int,
                 on_fault: Callable[[str, str], None],
                 clock: Callable[[], float] = time.monotonic):
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.on_fault = on_fault
        self.interval = float(dist_args.get("heartbeat_interval") or 0.0)
        self.timeout = float(dist_args.get("heartbeat_timeout") or 30.0)
        self.enabled = self.interval > 0 and self.num_processes > 1
        self._host = _split_address(dist_args["coordinator_address"])[0] \
            if dist_args.get("coordinator_address") else "127.0.0.1"
        self._port = resolve_health_port(dist_args) if self.enabled else 0
        self._clock = clock
        self._stop = threading.Event()
        self._beat = threading.Event()   # cleared by the wedge fault
        self._beat.set()
        self._faulted = False
        self._fault_lock = threading.Lock()
        self._threads: list = []
        self._server: Optional[socket.socket] = None
        # coordinator books: rank -> last heartbeat arrival (monotonic)
        self.last_seen: Dict[int, float] = {}
        self._conn_by_rank: Dict[int, socket.socket] = {}
        self.lost: set = set()
        self._last_miss_bump: Dict[int, float] = {}
        self._started_at: Optional[float] = None
        self.events: Dict[str, int] = {
            "heartbeat_misses": 0,
            "peer_losses": 0,
            "coordinator_losses": 0,
        }
        # -- cross-host metric relay (observability.rank_metrics) ---------
        # follower side: the next heartbeat carries this snapshot once;
        # coordinator side: rank -> (snapshot, arrival monotonic).  metrics.jsonl is
        # coordinator-only — this is how follower ranks
        # get back INTO it, as rank_* aggregates, without a second
        # transport (the beats are already flowing)
        self._pending_metrics: Optional[Dict[str, Any]] = None
        self._metrics_lock = threading.Lock()
        # rank -> (snapshot, arrival) — written by per-connection serve
        # threads, read at epoch boundaries: every access holds
        # _metrics_lock (a first-beat insert racing the learner's fold
        # would otherwise die on dict-changed-size)
        self.peer_metrics: Dict[int, tuple] = {}
        # report-cadence EMA for the staleness verdict: snapshots arrive
        # once per EPOCH, not per beat, so "stale" must key off the
        # observed aggregation period (the beat interval only floors it)
        self._agg_period: Optional[float] = None
        self._last_agg_at: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self.enabled:
            return
        self._started_at = self._clock()
        if self.process_id == 0:
            self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._server.bind(("", self._port))
            self._server.listen(self.num_processes + 2)
            self._server.settimeout(0.5)
            self._spawn(self._accept_loop, "health-accept")
            self._spawn(self._monitor_loop, "health-monitor")
        else:
            self._spawn(self._client_loop, "health-heartbeat")

    def stop(self) -> None:
        self._stop.set()
        server, self._server = self._server, None
        if server is not None:
            try:
                server.close()
            except OSError:
                pass

    def stop_heartbeats(self) -> None:
        """Freeze this process's health-plane traffic WITHOUT tearing the
        plane down — the wedge fault's hook (a frozen host goes silent;
        it does not close its sockets).  On a follower the outgoing beats
        stop; on the COORDINATOR the server half stops acking (and its
        monitor stops declaring losses — a frozen host declares nothing),
        so the documented follower-side detector (beats unanswered past
        heartbeat_timeout -> coordinator_loss) really is reachable under
        HANDYRL_FAULT_WEDGE_PROCESS on rank 0."""
        self._beat.clear()

    def disarm(self) -> None:
        """The run concluded coherently on EVERY process (the cadence's
        agreed stop/drain boundary reached all ranks): from here peer
        silence is expected teardown, not a host fault.  Teardown is not
        lockstep — worker joins, final fetches and checkpoint writes skew
        the ranks by arbitrary seconds, so a still-armed plane would
        misread the first rank to stop answering (or beating) as a lost
        host and os._exit(75) out of a CLEAN run.  Threads keep running
        until stop(); they just can no longer declare a loss."""
        with self._fault_lock:
            self._faulted = True

    # -- cross-host metric relay ---------------------------------------------

    def offer_metrics(self, snapshot: Dict[str, Any]) -> None:
        """Follower side: queue one per-epoch metric snapshot to ride the
        next heartbeat (newest wins — the relay is a health signal, not a
        lossless stream).  A no-op on a disabled plane."""
        with self._metrics_lock:
            self._pending_metrics = dict(snapshot)

    def _take_pending_metrics(self) -> Optional[Dict[str, Any]]:
        with self._metrics_lock:
            snap, self._pending_metrics = self._pending_metrics, None
            return snap

    def _restore_pending_metrics(self, snap: Optional[Dict[str, Any]]) -> None:
        """A failed send must not lose the epoch's snapshot — restore it
        unless a newer one was offered meanwhile."""
        if snap is None:
            return
        with self._metrics_lock:
            if self._pending_metrics is None:
                self._pending_metrics = snap

    def note_peer_metrics(self, rank: int, snapshot: Dict[str, Any],
                          now: Optional[float] = None) -> None:
        """Coordinator side: file a follower's metric snapshot (public for
        socket-free unit tests; ``_serve_peer`` is the wire caller)."""
        at = self._clock() if now is None else now
        with self._metrics_lock:
            self.peer_metrics[int(rank)] = (dict(snapshot), at)

    def rank_aggregates(self, own: Dict[str, Any],
                        now: Optional[float] = None) -> Dict[str, Any]:
        """Coordinator side: fold the per-rank snapshots (self = rank 0,
        fresh; followers = last relayed) into the ``rank_*`` metrics keys.

        The staleness fields are the point: a WEDGED-but-heartbeating
        follower keeps acking but its trainer stops, so its relayed epoch/
        steps freeze and ``rank_report_age_s_max`` grows past the epoch
        cadence — visible in metrics.jsonl long before the collective
        watchdog's bound fires (the JAX package's docs/observability.md §Rank aggregates).

        Snapshots arrive once per EPOCH (a follower one boundary behind is
        the healthy steady state), so the stale verdict keys off the
        OBSERVED aggregation cadence: a report older than 2.5x the period
        EMA — floored at 3 heartbeat intervals for second-scale epochs —
        is stale.  The bound uses the EMA from BEFORE this call's gap, so
        a host-fault fold minutes after the last boundary judges against
        the healthy cadence, not the wedge-stretched gap.
        """
        now = self._clock() if now is None else now
        reports = [(0, dict(own), now)]
        with self._metrics_lock:
            peers = sorted(self.peer_metrics.items())
        for rank, (snap, at) in peers:
            reports.append((rank, snap, at))
        # pre-update EMA -> stale bound; then fold this call's gap in
        stale_bound = (
            max(3.0 * max(self.interval, 1e-6), 2.5 * self._agg_period)
            if self._agg_period is not None
            else None  # first fold: no cadence observed, no stale verdict
        )
        if self._last_agg_at is not None and now > self._last_agg_at:
            gap = now - self._last_agg_at
            self._agg_period = (
                gap if self._agg_period is None
                else 0.5 * self._agg_period + 0.5 * gap
            )
        self._last_agg_at = now
        out: Dict[str, Any] = {"rank_reports": len(reports)}

        def fold(key: str, values, digits: int = 4) -> None:
            vals = [float(v) for v in values if v is not None]
            if not vals:
                return
            out[f"rank_{key}_min"] = round(min(vals), digits)
            out[f"rank_{key}_max"] = round(max(vals), digits)
            out[f"rank_{key}_mean"] = round(sum(vals) / len(vals), digits)

        fold("epoch", [s.get("epoch") for _, s, _ in reports], 0)
        fold("steps", [s.get("steps") for _, s, _ in reports], 0)
        fold("train_steps_per_sec",
             [s.get("train_steps_per_sec") for _, s, _ in reports])
        fold("input_wait_frac",
             [s.get("input_wait_frac") for _, s, _ in reports])
        ages = [max(0.0, now - at) for _, _, at in reports]
        out["rank_report_age_s_max"] = round(max(ages), 2)
        # ranks (self included via its 0 age) whose report outlived the
        # cadence-derived bound: the wedged-follower flag.  The raw max
        # age above is always reported, so operators can judge even on
        # the first fold (where no bound exists yet)
        out["rank_stale_reports"] = (
            sum(1 for a in ages if a > stale_bound)
            if stale_bound is not None else 0
        )
        out["rank_missing_reports"] = self.num_processes - len(reports)
        return out

    def _spawn(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        # per-connection _serve_peer threads arrive once per follower
        # RECONNECT — unpruned, a flapping peer grows this list forever
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)
        t.start()

    def _fault(self, reason: str, kind: str) -> None:
        with self._fault_lock:
            if self._faulted:
                return
            self._faulted = True
        self.on_fault(reason, kind)

    # -- coordinator half ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except (OSError, socket.timeout, TypeError, AttributeError):
                if self._stop.is_set():
                    return
                continue
            conn.settimeout(self.timeout)
            self._spawn(lambda c=conn: self._serve_peer(c), "health-peer")

    def _serve_peer(self, conn: socket.socket) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = conn.recv(4096)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    try:
                        msg = json.loads(line)
                        rank = int(msg["rank"])
                    except (ValueError, KeyError, TypeError):
                        continue  # a garbled line is not a liveness signal
                    if not self._beat.is_set():  # wedged: receive, never ack
                        continue
                    self._conn_by_rank[rank] = conn
                    self.last_seen[rank] = self._clock()
                    snap = msg.get("metrics")
                    if isinstance(snap, dict):
                        # per-epoch metric snapshot riding the beat: file
                        # it for the learner's rank_* aggregates
                        self.note_peer_metrics(rank, snap)
                    ack = json.dumps({"ok": 1, "lost": sorted(self.lost)})
                    conn.sendall(ack.encode() + b"\n")
        except OSError:
            return  # a dropped connection surfaces as heartbeat silence
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _peer_has_pending_data(self, rank: int) -> bool:
        """True when rank's connection holds UNPROCESSED bytes: its beats
        arrived but the serve thread hasn't run yet (LOCAL scheduling
        starvation — GIL convoy under CPU oversubscription — not a dead
        peer).  Declaring a loss on top of that would exit 75 out of a
        healthy run; skip the tick and let the serve thread catch up."""
        conn = self._conn_by_rank.get(rank)
        if conn is None:
            return False
        try:
            readable, _, _ = select.select([conn], [], [], 0)
            return bool(readable)
        except (OSError, ValueError):
            return False

    def check_peers(self, now: Optional[float] = None) -> Optional[int]:
        """One monitor tick (public for socket-free unit tests): returns
        the first newly-LOST rank, or None.  A peer is lost once silent
        past ``timeout`` — including one that never sent a first beat
        within the join grace (it died between the group's init and plane start)."""
        now = self._clock() if now is None else now
        grace_origin = self._started_at if self._started_at is not None else now
        for rank in range(1, self.num_processes):
            if rank in self.lost:
                continue
            last = self.last_seen.get(rank, grace_origin)
            age = now - last
            if age > 1.5 * self.interval and (
                now - self._last_miss_bump.get(rank, 0.0) > self.interval
            ):
                # one miss per silent interval, not per monitor tick
                self._last_miss_bump[rank] = now
                self.events["heartbeat_misses"] += 1
            if age > self.timeout:
                if self._peer_has_pending_data(rank):
                    continue  # beats are HERE, just not processed yet
                self.lost.add(rank)
                self.events["peer_losses"] += 1
                return rank
        return None

    def _rebase_after_stall(self, gap: float) -> None:
        """The monitor thread itself just lost ``gap`` seconds to
        scheduling starvation: that window observed nothing, so shifting
        every liveness origin forward by it keeps the staleness that was
        measured BEFORE the stall without counting the blackout as peer
        silence (a starved process must not declare its healthy peers
        dead the instant it wakes up)."""
        for rank in list(self.last_seen):
            self.last_seen[rank] += gap
        if self._started_at is not None:
            self._started_at += gap

    def _monitor_loop(self) -> None:
        tick = max(0.05, self.interval / 2.0)
        prev = self._clock()
        while not self._stop.is_set():
            time.sleep(tick)
            now = self._clock()
            if now - prev > 3.0 * tick + 1.0:
                self._rebase_after_stall(now - prev)
            prev = now
            if not self._beat.is_set():  # wedged: a frozen host declares nothing
                continue
            rank = self.check_peers()
            if rank is not None:
                self._fault(
                    f"peer process {rank} lost: no heartbeat for "
                    f"{self.timeout:.0f}s (heartbeat_timeout)",
                    "peer_loss",
                )
                return

    # -- follower half -------------------------------------------------------

    def _client_loop(self) -> None:
        # lazy: the utils package init imports torch; the module itself
        # stays stdlib-only for socket-free units
        from ..utils.trace import trace_span

        last_ok = self._clock()
        conn: Optional[socket.socket] = None
        buf = b""
        seq = 0
        attempts_since_ok = 0
        # one recv cycle waits at most ~2 beat intervals, not the whole
        # timeout: a single delayed ack must not silently swallow the
        # entire budget with zero further probes in flight
        ack_wait = min(self.timeout, max(2.0 * self.interval, 1.0))
        while not self._stop.is_set():
            if not self._beat.is_set():   # wedged: go silent, stay up
                time.sleep(self.interval)
                continue
            pending = None
            try:
                if conn is None:
                    conn = socket.create_connection(
                        (self._host, self._port), timeout=ack_wait
                    )
                    conn.settimeout(ack_wait)
                    buf = b""
                seq += 1
                attempts_since_ok += 1
                msg: Dict[str, Any] = {"rank": self.process_id, "seq": seq}
                pending = self._take_pending_metrics()
                if pending is not None:
                    # the per-epoch metric snapshot piggybacks on the beat
                    # (one send covers liveness AND observability)
                    msg["metrics"] = pending
                with trace_span("health.heartbeat", plane="health", seq=seq):
                    conn.sendall(json.dumps(msg).encode() + b"\n")
                    while b"\n" not in buf:
                        chunk = conn.recv(4096)
                        if not chunk:
                            raise OSError("health connection closed")
                        buf += chunk
                line, buf = buf.split(b"\n", 1)
                ack = json.loads(line)
                pending = None  # acked: the snapshot reached the books
                last_ok = self._clock()
                attempts_since_ok = 0
                lost = [r for r in ack.get("lost", []) if r != self.process_id]
                if lost:
                    self._fault(
                        f"coordinator reports peer process(es) {lost} lost; "
                        "the run cannot keep its collectives coherent",
                        "peer_loss",
                    )
                    return
            except (OSError, ValueError, socket.timeout):
                self.events["heartbeat_misses"] += 1
                self._restore_pending_metrics(pending)
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    conn = None
            if (
                self._clock() - last_ok > self.timeout
                and attempts_since_ok >= 3
            ):
                # the probe-count floor keeps a locally-STARVED client
                # honest: a thread that just lost the whole window to a
                # GIL convoy has sent nothing, so it earns no verdict
                # until a few real probes go unanswered too
                self.events["coordinator_losses"] += 1
                self._fault(
                    f"coordinator at {self._host}:{self._port} unreachable "
                    f"for {self.timeout:.0f}s (heartbeat_timeout, "
                    f"{attempts_since_ok} unanswered probes) — it likely "
                    "died; exiting instead of hanging in its collectives",
                    "coordinator_loss",
                )
                return
            self._stop.wait(self.interval)


def announce_fault(reason: str, kind: str, exit_code: int) -> None:
    """One loud, grep-stable stderr line for every host-fault exit."""
    print(
        f"[handyrl_tpu_torch] host fault ({kind}): {reason} — exiting "
        f"{exit_code} (EX_TEMPFAIL; relaunch with restart_epoch: -1)",
        file=sys.stderr,
        flush=True,
    )
