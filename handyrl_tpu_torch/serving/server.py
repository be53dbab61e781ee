"""Serving-plane network front: framed-socket request/reply.

Counterpart of ``handyrl_tpu/serving/server.py``, frame for frame.  It
reuses ``runtime/connection.py``'s hub: length-prefixed codec frames and a
bounded send queue with a sender thread per peer, so one stalled client
never wedges the replies to the rest.  One dispatch thread takes request
frames off the hub and hands them to the router; inference is
asynchronous (the reply goes out from a future callback on the engine's
thread), so a slow batch never blocks frame intake.

Wire protocol (codec frames; each request/reply pair carries ``rid``):

    -> ("infer", {"rid", "model", "obs", "hidden"?, "slo_ms"?, "sid"?})
    <- ("result", {"rid", "model": served_id, "out": numpy tree, "sid"?})
    <- ("error",  {"rid", "kind": shed|deadline|stopped|bad_request|..., "msg"})
    -> ("stats", {"rid"})               <- ("stats", {"rid", "stats": {...}})
    -> ("swap",  {"rid", "id", "params"?})  <- ("swapped", {"rid", "id", "warm_ms"})
    -> ("open_session",  {"rid", "model"?})  <- ("session", {"rid", "sid"})
    -> ("close_session", {"rid", "sid"})     <- ("session_closed", {"rid", "sid", "existed"})
    -> ("export_sessions", {"rid"})     <- ("sessions_export", {"rid", "sessions", "fresh", "count"})
    -> ("import_sessions", {"rid", "sessions", "fresh"?})
                                        <- ("sessions_imported", {"rid", "count"})
    -> ("harvest_open", {"rid", "players", "sids"})  <- ("harvest_opened", {"rid", "hid"})
    -> ("harvest_step", {"rid", "hid", "actions", "legal", "rewards", "turn"})
                                        <- ("harvest_stepped", {"rid", "hid", "steps"})
    -> ("harvest_close", {"rid", "hid", "outcome"})
                                        <- ("harvest_closed", {"rid", "hid", "kept"})
    -> ("harvest_pull", {"rid", "max"}) <- ("harvest", {"rid", "episodes", "counts"})
    -> ("report_outcome", {"rid", "model", "outcome"}) <- ("outcome_recorded", {"rid"})
    -> ("heartbeat", None)              (liveness only, never replied)
    <- ("draining", {"deadline_s"})     (rid-less notice, pushed to every peer)

The data flywheel (flywheel/, ``flywheel.enabled``) attaches a
``FlywheelPlane``: the harvest frames bind sessions into episodes, captured
at the infer and reply seams; a share of latest-addressed requests shadows
to a staged candidate; the watch loop (on at 1 s when the flywheel is on
and ``watch_interval`` is 0) runs the promotion gate and the sentinel in
place of the plain refresh.  Without it the harvest frames get "flywheel
disabled", as from the JAX server.  A ``swap`` frame's
``params`` is a state dict of numpy arrays (the codec carries no tensor);
without it the server loads ``{id}.ckpt`` from its model dir,
digest-verified.  ``watch_interval`` > 0 arms a manifest watcher that hot
swaps when training publishes a newer verified snapshot.  An ``infer``
with a ``sid`` reads and writes the session's hidden state here
(fleet/sessions.py); its reply carries no hidden state.

On SIGTERM ``serve_main`` pushes ``draining`` to every peer, waits for an
``export_sessions`` (or the deadline), and exits 75.
``HANDYRL_FAULT_SIGTERM_REPLICA=N`` (runtime/faults.py) makes the server
SIGTERM its own process after its N-th reply.  Each request's lifecycle,
admission to reply, is a ``serve.request`` span (utils/trace.py), armed by
``serve_main`` from ``trace.enabled``.
"""

from __future__ import annotations

import os
import queue as _queue
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ..fleet.sessions import SessionCache
from ..runtime import faults
from ..runtime.checkpoint import latest_verified_epoch, load_verified_params
from ..runtime.connection import (
    FramedConnection,
    QueueCommunicator,
    accept_socket_connections,
    open_socket_connection,
)
from ..runtime.inference_engine import EngineStopped
from ..utils.metrics import append_metrics_record
from ..utils.trace import trace_event
from .router import ColdRoute, ModelRouter

__all__ = ["ServingServer", "serve_main"]

# the longest an export waits for its reply to reach the socket
EXPORT_FLUSH_S = 300.0

FLYWHEEL_FRAMES = ("harvest_open", "harvest_step", "harvest_close", "harvest_pull",
                   "report_outcome")


class ServingServer(QueueCommunicator):
    """Continuous-batching inference server over the framed transport."""

    def __init__(self, router: ModelRouter, serving_cfg: Dict[str, Any],
                 metrics_path: Optional[str] = None, flywheel=None):
        cfg = dict(serving_cfg or {})
        recv_timeout = float(cfg.get("recv_timeout", 0.0)) or None
        # a pipelining client draining a batch's replies outruns its socket
        # for a moment: size each peer's send queue to the engine queue
        # bound, not the hub's default
        super().__init__(
            recv_timeout=recv_timeout,
            send_queue_size=max(256, int(cfg.get("queue_bound", 1024))),
        )
        self.router = router
        # the data flywheel (flywheel/FlywheelPlane), or None
        self.flywheel = flywheel
        self.port = int(cfg.get("port", 9997))
        self.bound_port: Optional[int] = None
        self.watch_interval = float(cfg.get("watch_interval", 0.0))
        if flywheel is not None and self.watch_interval <= 0:
            # the gate and the sentinel run in the watch loop: a flywheel
            # server without one would stage and judge nothing
            self.watch_interval = 1.0
        self.stats_interval = float(cfg.get("stats_interval", 30.0))
        self._default_slo_s = float(cfg.get("slo_ms", 200.0)) / 1000.0
        self._sheds = cfg.get("shed_policy", "deadline") != "none"
        self._metrics_path = metrics_path
        self._sock = None
        self._threads: List[threading.Thread] = []
        # cold work (disk loads, warm-ups, stats, exports) runs here, on
        # bounded workers, off the dispatch thread
        self._cold_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="serve-cold")
        # server-resident sessions; session_capacity 0 turns them off (the
        # stateless ship-the-state path works either way).  The cache
        # adopts the serving engine's device on first use
        session_capacity = int(cfg.get("session_capacity", 1024))
        self.sessions: Optional[SessionCache] = (
            SessionCache(session_capacity, int(cfg.get("session_spill", 4096)))
            if session_capacity > 0
            else None
        )
        self._stats_lock = threading.Lock()
        self.requests_in = 0
        self.replies = 0
        self.errors: Dict[str, int] = {}
        self._stats_t0 = time.monotonic()
        self._stats_served0 = 0
        # set when a caller has pulled the session cache (export_sessions):
        # the SIGTERM drain waits for it or for its deadline
        self._sessions_exported = threading.Event()
        # parsed here, so a replica process inherits it from its environment
        self._fault_sigterm_after = faults.sigterm_replica()

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> "ServingServer":
        # bind and listen before returning: port 0 resolves here, and a
        # client connecting at once is never refused
        self._sock = open_socket_connection(self.port)
        self._sock.listen(1024)
        self.bound_port = self._sock.getsockname()[1]
        targets = [self._accept_loop, self._dispatch]
        if self.watch_interval > 0:
            targets.append(self._watch_loop)
        if self._metrics_path and self.stats_interval > 0:
            targets.append(self._metrics_loop)
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        super().shutdown()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._cold_pool.shutdown(wait=False)
        self.router.stop()

    def _accept_loop(self) -> None:
        for conn in accept_socket_connections(timeout=0.5, sock=self._sock):
            if conn is None:
                if self.shutdown_flag:
                    break
                continue
            self.add_connection(conn)

    # -- request dispatch ----------------------------------------------------

    def _dispatch(self) -> None:
        while not self.shutdown_flag:
            try:
                conn, frame = self.recv(timeout=0.3)
            except _queue.Empty:
                continue
            try:
                req, data = frame
            except (TypeError, ValueError):
                continue  # malformed frame
            if req == "heartbeat" or req == "__hb__":
                continue
            if not isinstance(data, dict):
                data = {}
            rid = data.get("rid")
            try:
                if req == "infer":
                    self._handle_infer(conn, data)
                elif req == "stats":
                    # sorts every engine's latency reservoir: off this thread
                    self._cold_pool.submit(self._handle_stats, conn, rid)
                elif req == "swap":
                    # warm-ups take time: on the bounded pool, never here
                    self._cold_pool.submit(self._handle_swap, conn, data)
                elif req == "open_session":
                    self._handle_open_session(conn, rid)
                elif req == "close_session":
                    self._handle_close_session(conn, rid, data.get("sid"))
                elif req == "export_sessions":
                    # copies every resident state to the host: off this thread
                    self._cold_pool.submit(self._handle_export_sessions, conn, rid)
                elif req == "import_sessions":
                    self._cold_pool.submit(self._handle_import_sessions, conn, rid, data)
                elif req in FLYWHEEL_FRAMES:
                    if self.flywheel is None:
                        self._error(conn, rid, "bad_request",
                                    "flywheel disabled (flywheel.enabled: false)")
                    elif req in ("harvest_close", "harvest_pull"):
                        # a close finalizes and compresses a whole game, a
                        # pull encodes a batch of them: off this thread
                        self._cold_pool.submit(self._handle_harvest, conn, rid, req, data)
                    else:
                        self._handle_harvest(conn, rid, req, data)
                else:
                    self._error(conn, rid, "bad_request", f"unknown request {req!r}")
            except Exception as exc:
                # no frame may kill the dispatch thread, or every client
                # hangs while the accept loop keeps admitting new ones
                self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_infer(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        with self._stats_lock:
            self.requests_in += 1
        # the SLO clock starts at frame arrival, set here whatever the
        # frame says, so a client cannot mint its own deadline
        data["_arrival"] = time.monotonic()
        try:
            # resident routes resolve and submit inline; a cold one goes to
            # the pool (the resolve itself decides, so no race)
            self._do_infer(conn, data, allow_cold=False)
        except ColdRoute:
            self._cold_pool.submit(self._infer_cold, conn, data)

    def _handle_stats(self, conn: FramedConnection, rid) -> None:
        try:
            self.send(conn, ("stats", {"rid": rid, "stats": self.stats_record()}))
        except Exception as exc:  # a pool task must never die silently
            self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _infer_cold(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        try:
            self._do_infer(conn, data)
        except Exception as exc:
            self._error(conn, data.get("rid"), "error", f"{type(exc).__name__}: {exc}")

    def _handle_open_session(self, conn: FramedConnection, rid) -> None:
        if self.sessions is None:
            self._error(conn, rid, "bad_request",
                        "session cache disabled (serving.session_capacity: 0)")
            return
        self.send(conn, ("session", {"rid": rid, "sid": self.sessions.open()}))

    def _handle_close_session(self, conn: FramedConnection, rid, sid) -> None:
        if self.sessions is None or not isinstance(sid, str):
            self._error(conn, rid, "bad_request", f"bad session id {sid!r}")
            return
        existed = self.sessions.close(sid)
        self.send(conn, ("session_closed", {"rid": rid, "sid": sid, "existed": existed}))

    def _handle_export_sessions(self, conn: FramedConnection, rid) -> None:
        """Hand the whole session cache to the caller and clear it.  A
        server without sessions exports nothing."""
        try:
            if self.sessions is None:
                exported: Dict[str, Any] = {"sessions": {}, "fresh": []}
            else:
                exported = self.sessions.export_all()
            self.send(conn, ("sessions_export", {
                "rid": rid,
                "sessions": exported["sessions"],
                "fresh": exported["fresh"],
                "count": len(exported["sessions"]),
            }))
            # only once the reply is on the socket: the drain shuts the
            # socket down as soon as this is set, and a transformer's
            # sessions are hundreds of MB (the drain's deadline bounds it)
            self.flush(conn, timeout=EXPORT_FLUSH_S)
            self._sessions_exported.set()
        except Exception as exc:
            self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_import_sessions(self, conn: FramedConnection, rid,
                                data: Dict[str, Any]) -> None:
        """Adopt another server's exported sessions into the spill tier."""
        try:
            if self.sessions is None:
                self._error(conn, rid, "bad_request",
                            "session cache disabled (serving.session_capacity: 0)")
                return
            n = self.sessions.adopt(data.get("sessions") or {}, data.get("fresh") or ())
            self.send(conn, ("sessions_imported", {"rid": rid, "count": n}))
        except Exception as exc:
            self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def _handle_harvest(self, conn: FramedConnection, rid, req: str,
                        data: Dict[str, Any]) -> None:
        """The flywheel's frames: the client reports the half of each step
        only it knows; the recorder captured the server's half already."""
        from ..flywheel import HarvestError

        recorder = self.flywheel.recorder
        try:
            if req == "harvest_open":
                hid = recorder.open_episode(data.get("players") or (), data.get("sids") or ())
                self.send(conn, ("harvest_opened", {"rid": rid, "hid": hid}))
            elif req == "harvest_step":
                steps = recorder.step(data.get("hid"), data.get("actions") or (),
                                      data.get("legal") or (), data.get("rewards") or (),
                                      data.get("turn"))
                self.send(conn, ("harvest_stepped",
                                 {"rid": rid, "hid": data.get("hid"), "steps": steps}))
            elif req == "harvest_close":
                episode = recorder.close(data.get("hid"), data.get("outcome"))
                self.send(conn, ("harvest_closed",
                                 {"rid": rid, "hid": data.get("hid"), "kept": episode is not None}))
            elif req == "harvest_pull":
                episodes, counts = recorder.pull(int(data.get("max", 64)))
                self.send(conn, ("harvest", {"rid": rid, "episodes": episodes, "counts": counts}))
            else:  # report_outcome
                self.flywheel.quality.record_outcome(data.get("model"), data.get("outcome"))
                self.send(conn, ("outcome_recorded", {"rid": rid}))
        except (HarvestError, ValueError) as exc:
            self._error(conn, rid, "bad_request", str(exc))
        except Exception as exc:  # a pool task must never die silently
            self._error(conn, rid, "error", f"{type(exc).__name__}: {exc}")

    def begin_drain(self, deadline_s: float = 60.0) -> bool:
        """The SIGTERM path: push a ``draining`` notice to every peer, then
        wait for a caller to pull the session cache (``export_sessions``)
        or for the deadline.  True if the sessions were handed off.  With
        no peer or no session it returns at once."""
        for conn in self.connections():
            self.send(conn, ("draining", {"deadline_s": float(deadline_s)}))
        if self.sessions is None or self.connection_count() == 0:
            return False
        stats = self.sessions.stats()
        if stats["session_resident"] + stats["session_spilled"] == 0:
            return False
        deadline = time.monotonic() + max(0.0, float(deadline_s))
        while time.monotonic() < deadline:
            if self._sessions_exported.wait(timeout=0.1):
                return True
        return self._sessions_exported.is_set()

    def _do_infer(self, conn: FramedConnection, data: Dict[str, Any],
                  allow_cold: bool = True) -> None:
        rid = data.get("rid")
        model_id = data.get("model", -1)
        if self.flywheel is not None:
            # the shadow slice: a latest-addressed request may go to the
            # staged candidate (pinned ids pass; the reply names the epoch)
            model_id = self.flywheel.shadow_model(model_id)
        # the default budget also starts at arrival, so a cold request's
        # wait behind a snapshot load counts against it
        arrival = data.get("_arrival", time.monotonic())
        deadline = arrival + self._default_slo_s if self._sheds else None
        slo_ms = data.get("slo_ms")
        if slo_ms is not None:
            try:
                deadline = arrival + float(slo_ms) / 1000.0
            except (TypeError, ValueError):
                self._error(conn, rid, "bad_request", f"slo_ms={slo_ms!r} is not a number")
                return
        sid = data.get("sid")
        hidden = data.get("hidden")
        if sid is not None and self.sessions is None:
            self._error(conn, rid, "bad_request",
                        "session cache disabled (serving.session_capacity: 0)")
            return
        if sid is not None and hidden is None:
            # the session's state lives here (a hidden on the wire still
            # wins); a lost one restarts from the initial state, counted
            hidden, _status = self.sessions.lookup(sid)
        if self.flywheel is not None and sid is not None:
            # harvest capture, the request's half: this session's observation
            self.flywheel.capture_request(sid, data.get("obs"))
        for attempt in (0, 1):
            try:
                served, route = self.router.resolve(model_id, allow_cold=allow_cold)
            except ColdRoute:
                raise
            except Exception as exc:
                self._error(conn, rid, getattr(exc, "kind", "bad_request"), str(exc))
                return
            fut = route.submit(data.get("obs"), hidden, deadline)
            if attempt == 0 and fut.done() and isinstance(fut.exception(), EngineStopped):
                # raced an eviction's drain between resolve and submit:
                # resolve once more rather than drop the request
                continue
            break
        if sid is not None and self.sessions.device is None:
            # pin resident states on the engine's device from now on
            self.sessions.device = getattr(route, "device", None)
        fut.add_done_callback(
            lambda f, c=conn, r=rid, s=served, a=arrival, i=sid: self._reply(c, r, s, f, a, i)
        )

    def _reply(self, conn: FramedConnection, rid, served, fut,
               arrival: Optional[float] = None, sid=None) -> None:
        exc = fut.exception()
        if arrival is not None:
            trace_event("serve.request", time.monotonic() - arrival, t0=arrival,
                        plane="serving", ok=exc is None)
        if exc is None:
            with self._stats_lock:
                self.replies += 1
                replies = self.replies
            if self._fault_sigterm_after is not None and replies == self._fault_sigterm_after:
                # a spot preemption in mid-load: serve_main's handler runs
                # the draining notice -> session handoff -> exit 75
                print(f"serving: FAULT sigterm_replica after {replies} replies — raising SIGTERM",
                      flush=True)
                os.kill(os.getpid(), signal.SIGTERM)
            out = fut.result()
            if self.flywheel is not None and sid is not None:
                # harvest capture, the reply's half, before the reply leaves:
                # a client that has its reply knows the step is captured
                self.flywheel.capture_reply(sid, served, out)
            if sid is not None and isinstance(out, dict) and "hidden" in out:
                # the next state stays here (store() copies it back to the
                # device) and the reply sheds its largest part; out is this
                # request's own row, so popping touches nothing shared
                self.sessions.store(sid, out.pop("hidden"))
            reply = {"rid": rid, "model": served, "out": out}
            if sid is not None:
                reply["sid"] = sid
            self.send(conn, ("result", reply))
        else:
            kind = getattr(exc, "kind", None) or (
                "stopped" if isinstance(exc, EngineStopped) else "error"
            )
            self._error(conn, rid, kind, str(exc))

    def _error(self, conn: FramedConnection, rid, kind: str, msg: str) -> None:
        with self._stats_lock:
            self.errors[kind] = self.errors.get(kind, 0) + 1
        self.send(conn, ("error", {"rid": rid, "kind": kind, "msg": msg}))

    def _handle_swap(self, conn: FramedConnection, data: Dict[str, Any]) -> None:
        rid = (data or {}).get("rid")
        try:
            model_id = int(data["id"])
            params = data.get("params")
            if params is None:
                params = load_verified_params(self.router.model_dir, model_id)
            warm_ms = self.router.publish(model_id, params)
            self.send(conn, ("swapped", {"rid": rid, "id": model_id, "warm_ms": warm_ms}))
        except Exception as exc:
            self._error(conn, rid, "swap_failed", f"{type(exc).__name__}: {exc}")

    # -- checkpoint watcher --------------------------------------------------

    def _watch_loop(self) -> None:
        while not self.shutdown_flag:
            time.sleep(self.watch_interval)
            if self.shutdown_flag:
                return
            try:
                if self.flywheel is not None:
                    # the flywheel's beat replaces the plain refresh: with the
                    # gate off it is maybe_refresh, with it on it stages and
                    # judges candidates and runs the sentinel
                    event = self.flywheel.tick()
                    if event is not None:
                        print(f"serving: flywheel: {event}", flush=True)
                    continue
                published = self.router.maybe_refresh()
                if published is not None:
                    print(f"serving: hot-swapped to verified snapshot {published}", flush=True)
            except Exception as exc:
                # a manifest caught mid-write must not kill the watcher
                print(f"serving: refresh failed: {type(exc).__name__}: {exc}", flush=True)

    # -- stats / metrics -----------------------------------------------------

    def stats_record(self, advance_window: bool = False) -> Dict[str, Any]:
        """One metrics.jsonl record of the serving plane's health; every key
        is in ``utils.metrics.METRIC_KEYS``.  qps is over the window since
        the metrics loop last advanced it (a stats poll never does)."""
        rstats = self.router.stats()
        now = time.monotonic()
        with self._stats_lock:
            requests_in = self.requests_in
            # the wire's count: instant (model 0) and ensemble replies too
            replies = self.replies
            errors = dict(self.errors)
            dt = max(now - self._stats_t0, 1e-6)
            served_delta = replies - self._stats_served0
            if advance_window:
                self._stats_t0 = now
                self._stats_served0 = replies
        record: Dict[str, Any] = {
            "serve_requests": requests_in,
            "serve_replies": replies,
            "serve_shed": rstats["requests_shed"],
            "serve_deadline_miss": rstats["deadline_misses"],
            "serve_batches": rstats["batches_served"],
            "serve_depth": rstats["depth"],
            "serve_qps": round(served_delta / dt, 2),
            "serve_p50_ms": rstats["p50_ms"],
            "serve_p99_ms": rstats["p99_ms"],
            "serve_hot_swaps": rstats["hot_swaps"],
            "serve_models": rstats["models"],
            "serve_snapshot_substituted": rstats["substituted"],
            "serve_connections": self.connection_count(),
            "serve_errors": sum(errors.values()),
        }
        if self.sessions is not None:
            record.update(self.sessions.stats())
        if self.flywheel is not None:
            record.update(self.flywheel.stats_record())
        if getattr(self.router, "weight_dtype", "float32") != "float32":
            # the int8 rung: its dtype and the last publish's measured
            # calibration (none until a calibration source is wired)
            record["lowprec_weight_dtype"] = self.router.weight_dtype
            calib = getattr(self.router, "last_calibration", None)
            if calib:
                record["lowprec_calib_batches"] = calib["calib_batches"]
                record["lowprec_calib_max_dev"] = calib["calib_max_dev"]
                record["lowprec_calib_mean_dev"] = calib["calib_mean_dev"]
        return record

    def _metrics_loop(self) -> None:
        while not self.shutdown_flag:
            time.sleep(self.stats_interval)
            if self.shutdown_flag:
                return
            try:
                append_metrics_record(self._metrics_path, self.stats_record(advance_window=True))
            except Exception as exc:
                print(f"serving: metrics write failed: {type(exc).__name__}: {exc}", flush=True)


def serve_main(args: Dict[str, Any], device=None) -> int:
    """``--serve``: the serving plane for the configured env, on the card
    unless ``device`` says otherwise.

    Publishes the newest manifest-verified snapshot of ``model_dir``
    (fresh weights from ``seed`` as id 0 when there is none), then serves
    until SIGTERM (drain, exit 75) or Ctrl-C (exit 0).  With
    ``serving.watch_interval`` > 0 every newer verified snapshot is hot
    swapped in."""
    import torch

    from ..envs import make_env, prepare_env
    from ..models.inference import init_variables
    from ..utils import trace

    train = args["train_args"]
    env_args = args["env_args"]
    if trace.configure(train.get("trace")):
        print(f"serving: trace spans -> {trace.current_path()}")
    prepare_env(env_args)
    env = make_env(env_args)
    env.reset()
    template_obs = env.observation(env.players()[0])
    model_dir = train.get("model_dir", "models")
    serving_cfg = train.get("serving", {})
    newest = 0
    try:
        newest = latest_verified_epoch(model_dir)
    except Exception as exc:
        print(f"serving: checkpoint scan failed ({exc}); starting fresh")
    if newest > 0:
        # the router reads only the structure: no host copy of the weights
        with torch.device("meta"):
            module = env.net()
    else:
        module = env.net()
    router = ModelRouter(module, template_obs, serving_cfg, model_dir=model_dir,
                         devices=None if device is None else [device])
    if newest > 0:
        router.publish(newest, load_verified_params(model_dir, newest, pre_verified=True))
    else:
        # fresh weights under id 0, which keeps the watcher's newer-than
        # check able to pick up training's first epoch
        router.publish(0, init_variables(module, int(train.get("seed", 0))).state_dict())
    del module  # the engine holds its own weights

    flywheel = None
    fly_cfg = train.get("flywheel", {}) or {}
    if fly_cfg.get("enabled"):
        from ..flywheel import FlywheelPlane

        obs_spec_fn = None
        if train.get("obs_int8"):
            # harvested episodes quantize under the Generator's env spec
            from ..models.quantize import obs_quant_spec

            obs_spec_fn = lambda obs: obs_quant_spec(env, obs=obs)  # noqa: E731
        gen_args = {
            "gamma": train.get("gamma", 0.8),
            "compress_steps": train.get("compress_steps", 8),
            "observation": train.get("observation", True),
            "obs_int8": bool(train.get("obs_int8", False)),
        }
        flywheel = FlywheelPlane(router, model_dir, fly_cfg, gen_args, obs_spec_fn=obs_spec_fn)
        print(f"serving: data flywheel on (gate_promotions="
              f"{bool(fly_cfg.get('gate_promotions', True))})", flush=True)

    server = ServingServer(router, serving_cfg, metrics_path=train.get("metrics_path"),
                           flywheel=flywheel).run()
    print(f"serving: listening on port {server.bound_port} "
          f"(model {router.latest_id()}, dir {model_dir!r}, device {router._devices[0]})",
          flush=True)

    # SIGTERM (a preemption) drains: broadcast the notice, wait inside
    # drain_deadline_seconds for the sessions to be pulled, exit 75
    # (EX_TEMPFAIL) for a relaunch.  Ctrl-C shuts down at once.
    preempted = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: preempted.set())
    except ValueError:
        pass  # not the main thread (embedded use): no preemption handler
    try:
        while not preempted.wait(timeout=1.0):
            pass
        deadline_s = float(train.get("drain_deadline_seconds", 60.0))
        print(f"serving: SIGTERM — draining sessions (deadline {deadline_s:.0f}s)", flush=True)
        handed_off = server.begin_drain(deadline_s)
        if handed_off:
            # the export reply is queued, but the peer still has to read
            # it: closing at once could cut it off
            time.sleep(0.25)
        device = router._devices[0]
        if device.type == "cuda":
            print(f"serving: peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
                  f" GB allocated, {torch.cuda.max_memory_reserved(device) / 1e9:.2f} GB reserved",
                  flush=True)
        print(f"serving: drain complete (sessions handed off: {handed_off}); "
              "exiting 75 for relaunch", flush=True)
        server.shutdown()
        return 75
    except KeyboardInterrupt:
        print("serving: shutting down")
        server.shutdown()
        return 0
    finally:
        trace.shutdown()
