"""Remote worker machines over TCP: the train server's side and the worker's.

Counterpart of ``handyrl_tpu/runtime/server.py``.  An entry listener hands
each joining machine the training config and a ``base_worker_id``; the
machine then opens data connections ("gathers", one per ~16 actors) that
carry job args, episodes, evaluation results and parameter blobs, so the
server's connection count grows with gathers, not actors.  A machine's
actors are threads sharing one ``BatchedInferenceEngine`` on its card.

Parameters travel as ``checkpoint.to_bytes(state_dict)``, a ``torch.save``
archive of CPU tensors, and load with ``checkpoint.from_bytes``
(``weights_only=True``): never a pickled module.  This blob format is the
port's own, so a worker machine of the JAX package (which sends flax
msgpack) cannot join a train server of the port, nor the reverse.  The
frames around the blob are the JAX package's.

Fault tolerance, as in the JAX package:

* the entry handshake runs under an absolute deadline, so a client that
  connects and stalls cannot hold up later joins;
* liveness is heartbeat-based both ways: the server pings every gather
  from a thread of its own (pings flow while the learner sits minutes in
  an epoch boundary, or the dispatch thread serialises a large blob), and
  drops a peer silent for ~3 intervals; gathers ping the server alike;
* a severed gather ends the machine's session (no actor thread survives
  it) and the machine rejoins through the entry port with exponential
  backoff; the server hands the vanished connection's in-flight jobs back
  to the learner as ``jobs_lost``, so its generation/evaluation balance
  re-dispatches them.
"""

from __future__ import annotations

import copy
import queue
import socket
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from ..envs import make_env, prepare_env
from ..models import InferenceModel, RandomModel
from ..utils import resolve_device
from .checkpoint import from_bytes, load_verified_params, to_bytes
from .connection import (
    FramedConnection,
    QueueCommunicator,
    accept_socket_connections,
    connect_socket_connection,
    open_socket_connection,
    send_recv,
)
from .inference_engine import BatchedInferenceEngine
from .worker import Worker

ENTRY_PORT = 9999
DATA_PORT = 9998

_HB = ("__hb__",)  # the server's liveness ping; never a reply


def _is_hb(frame: Any) -> bool:
    return isinstance(frame, tuple) and len(frame) == 1 and frame[0] == "__hb__"


# ---------------------------------------------------------------------------
# learner side
# ---------------------------------------------------------------------------


class WorkerServer(QueueCommunicator):
    """Serves remote worker machines, with ``LocalWorkerPool``'s ``run()``
    surface: requests go to the learner's ``handler``; ``model`` requests
    are answered here, from the model server's latest snapshot or a
    verified snapshot on disk, as ``(model_id, blob)``.

    Port 0 in ``args['worker']`` takes a free port: ``entry_port`` and
    ``data_port`` hold the ports bound, and the entry handshake tells
    joining machines the data port."""

    def __init__(self, args: Dict[str, Any], handler: Callable, model_server):
        worker_cfg = args["worker"]
        self.heartbeat_interval = float(worker_cfg.get("heartbeat_interval", 10.0))
        super().__init__(recv_timeout=(
            3.0 * self.heartbeat_interval if self.heartbeat_interval > 0 else None))
        self.args = args
        self.handler = handler
        self.model_server = model_server
        # bound here, so the ports are known (and taken) once the server exists
        self._listeners = [open_socket_connection(int(worker_cfg.get("entry_port", ENTRY_PORT))),
                           open_socket_connection(int(worker_cfg.get("data_port", DATA_PORT)))]
        for sock in self._listeners:
            sock.listen(1024)
        self.entry_port, self.data_port = (s.getsockname()[1] for s in self._listeners)
        self.entry_timeout = float(worker_cfg.get("entry_timeout", 10.0))
        self.total_worker_count = 0
        self._blob_cache: Dict[int, bytes] = {}
        # (model id, bytes, seconds to serialise) of each blob made
        self.blob_log: List[tuple] = []
        # in-flight jobs per connection: assignments sent minus uploads
        # received; a vanished peer's balance goes back to the learner
        self._inflight: Dict[FramedConnection, Dict[str, int]] = {}
        self._inflight_lock = threading.Lock()

    def run(self) -> None:
        entry_sock, data_sock = self._listeners
        targets = [(self._entry_server, entry_sock), (self._data_server, data_sock),
                   (self._dispatch, None)]
        if self.heartbeat_interval > 0:
            targets.append((self._heartbeat_loop, None))
        for target, sock in targets:
            threading.Thread(target=target, args=() if sock is None else (sock,),
                             daemon=True).start()

    def shutdown(self) -> None:
        """Drop every peer and stop listening."""
        super().shutdown()
        for sock in self._listeners:
            sock.close()

    def _entry_server(self, sock: socket.socket) -> None:
        print("started entry server %d" % self.entry_port)
        for conn in accept_socket_connections(timeout=0.5, sock=sock):
            if conn is None:
                if self.shutdown_flag:
                    break
                continue
            try:
                # an absolute deadline on the single entry thread: a client
                # that stalls, or drips a byte per gap, is dropped
                worker_args = conn.recv(timeout=self.entry_timeout, hard=True)
                n = int(worker_args.get("num_parallel", 8))
                train_args = {k: v for k, v in self.args.items() if k != "env"}
                train_args["worker"] = dict(train_args["worker"], data_port=self.data_port)
                reply = {
                    "env_args": self.args["env"],
                    "train_args": train_args,
                    "worker_args": dict(worker_args, base_worker_id=self.total_worker_count),
                }
                self.total_worker_count += n
                conn.send(reply, timeout=self.entry_timeout, hard=True)
            except socket.timeout:
                print("entry handshake timed out; dropping slow client")
            except Exception as exc:
                print("entry handshake failed:", exc)
            finally:
                conn.close()
        print("finished entry server")

    def _data_server(self, sock: socket.socket) -> None:
        print("started worker server %d" % self.data_port)
        for conn in accept_socket_connections(timeout=0.5, sock=sock):
            if conn is None:
                if self.shutdown_flag:
                    break
                continue
            self.add_connection(conn)
        print("finished worker server")

    def _heartbeat_loop(self) -> None:
        """Ping every peer each interval, off the dispatch path."""
        while not self.shutdown_flag:
            time.sleep(self.heartbeat_interval)
            for conn in self.connections():
                self.send(conn, _HB, droppable=True)

    def add_connection(self, conn: FramedConnection) -> None:
        # the ledger lives as long as the connection: made here, removed
        # once by on_disconnect; _count_jobs never makes one, so a frame
        # read after its peer was reaped cannot resurrect it
        with self._inflight_lock:
            self._inflight[conn] = {"g": 0, "e": 0}
        super().add_connection(conn)

    def _count_jobs(self, conn: FramedConnection, role_counts: Dict[str, int]) -> None:
        with self._inflight_lock:
            ledger = self._inflight.get(conn)
            if ledger is not None:
                for role, n in role_counts.items():
                    ledger[role] = max(0, ledger[role] + n)
                return
        # the peer was already reaped: assignments are lost, and uploads
        # that arrived after the loss report pass through as negative
        # counts, which the learner adds back
        self._report_lost({k: v for k, v in role_counts.items() if v})

    def _report_lost(self, counts: Dict[str, int]) -> None:
        if not (counts.get("g") or counts.get("e")) or self.shutdown_flag:
            return

        def report():
            try:
                self.handler("jobs_lost", counts, timeout=30.0)
            except Exception:
                pass  # the learner is draining; the balance no longer matters

        # a thread of its own: the learner may be busy for minutes at an
        # epoch boundary, and this runs on a receiver or heartbeat thread
        threading.Thread(target=report, daemon=True).start()

    def on_disconnect(self, conn: FramedConnection) -> None:
        with self._inflight_lock:
            ledger = self._inflight.pop(conn, None)
        if ledger:
            self._report_lost(ledger)

    def _dispatch(self) -> None:
        while not self.shutdown_flag:
            try:
                conn, (req, data) = self.recv(timeout=0.3)
            except queue.Empty:
                continue
            except (TypeError, ValueError):
                continue  # not a (request, data) pair
            if req == "heartbeat":
                continue  # liveness traffic only; no reply
            if req == "model":
                self.send(conn, self._model_bytes(int(data)))
                continue
            reply = self.handler(req, data)
            if req == "args" and isinstance(reply, list):
                roles = {"g": 0, "e": 0}
                for a in reply:
                    if a is not None:
                        roles[a["role"]] += 1
                self._count_jobs(conn, roles)
            elif req in ("episode", "result"):
                n = len(data) if isinstance(data, list) else 1
                self._count_jobs(conn, {"g" if req == "episode" else "e": -n})
            self.send(conn, reply)

    def _blob(self, model_id: int, state_dict) -> bytes:
        t0 = time.perf_counter()
        blob = to_bytes(state_dict)
        self.blob_log.append((model_id, len(blob), time.perf_counter() - t0))
        self._trim_blob_cache()
        self._blob_cache[model_id] = blob
        return blob

    def _model_bytes(self, requested_id: int):
        """(model_id, blob) for a snapshot id.  Blobs are cached per id:
        every machine asks for the same latest params each epoch."""
        latest_id, latest = self.model_server.latest_snapshot()
        if 0 < requested_id < latest_id:
            cached = self._blob_cache.get(requested_id)
            if cached is not None:
                return requested_id, cached
            try:
                # digest-verified: a corrupt snapshot would poison every
                # episode a whole machine generates
                params = load_verified_params(self.model_server.model_dir, requested_id)
                return requested_id, self._blob(requested_id, params)
            except Exception:
                pass  # missing or corrupt: serve the latest instead
        cached = self._blob_cache.get(latest_id)
        if cached is None:
            # id and params were read together, so the cache key is honest
            cached = self._blob(latest_id, latest)
        return latest_id, cached

    def _trim_blob_cache(self, keep: int = 4) -> None:
        while len(self._blob_cache) >= keep:
            self._blob_cache.pop(next(iter(self._blob_cache)))


# ---------------------------------------------------------------------------
# worker machine side
# ---------------------------------------------------------------------------


class RemoteModelServer:
    """A worker machine's model cache, fed by ``('model', id)`` requests.

    The newest params are served by the machine's one batched engine and
    replace its weights through ``load_state_dict``, as ``publish`` does on
    the learner; id 0 is the zero-output random model; older ids become
    standalone ``InferenceModel``s, fetched once and cached.  Runs on the
    card unless ``device`` says otherwise.  ``fetch_log`` holds (model id,
    blob bytes, seconds, CRC32 of the blob) per fetch."""

    def __init__(self, module, env, args: Dict[str, Any], fetch: Callable[[int], tuple],
                 device=None):
        self.device = resolve_device(device)
        self._fetch_rpc = fetch
        self._model = InferenceModel(module, self.device)
        env.reset()
        self._random = RandomModel.from_model(self._model, env.observation(env.players()[0]))
        self.engine = BatchedInferenceEngine(
            self._model, max_batch=args.get("inference_batch_size", 64)).start()
        self.model_id = -1
        self._cache: Dict[int, InferenceModel] = {}
        self._lock = threading.Lock()
        self._fetch_lock = threading.Lock()
        self.fetch_log: List[tuple] = []
        # the learner's latest params from the start: jobs with id -1 must
        # not run on this machine's own random init
        got_id, params = self._fetch(-1)
        self.engine.load_state_dict(params)
        self.model_id = got_id

    def _fetch(self, model_id: int):
        t0 = time.perf_counter()
        got_id, blob = self._fetch_rpc(model_id)
        params = from_bytes(blob)
        seconds = time.perf_counter() - t0
        crc = zlib.crc32(blob)
        self.fetch_log.append((got_id, len(blob), seconds, crc))
        print(f"[remote] model {got_id}: {len(blob)} bytes in {seconds:.3f} s, "
              f"crc32 {crc:08x}", flush=True)
        return got_id, params

    def get(self, model_id: int):
        if model_id == 0:
            return self._random
        served = self._served(model_id)
        if served is not None:
            return served
        # one fetch at a time: the actors that asked for the same new id
        # meanwhile find it served instead of fetching the blob again
        with self._fetch_lock:
            served = self._served(model_id)
            if served is not None:
                return served
            got_id, params = self._fetch(model_id)
            return self._install(model_id, got_id, params)

    def _served(self, model_id: int):
        with self._lock:
            if model_id < 0 or model_id == self.model_id:
                return self.engine.client()
            return self._cache.get(model_id)

    def _install(self, model_id: int, got_id: int, params):
        with self._lock:
            if got_id > self.model_id:
                self.engine.load_state_dict(params)
                self.model_id = got_id
                # drop stale models; only explicitly requested old ids recur
                self._cache = {k: v for k, v in self._cache.items() if k == model_id}
            if got_id == self.model_id:
                return self.engine.client()
        # an older id than the engine's: a standalone model of its own
        module = copy.deepcopy(self._model.module)
        module.load_state_dict(params)
        model = InferenceModel(module, self.device)
        if got_id == model_id:
            with self._lock:
                self._cache[model_id] = model
        return model

    def stop(self) -> None:
        self.engine.stop()


class RemoteGather:
    """One data connection multiplexing ~16 actor threads.

    Job args are prefetched in blocks and uploads flushed in blocks; every
    request runs under a deadline.  The wait for a reply skips the
    server's heartbeats (each restarts the silence deadline), and ~3
    silent intervals raise, mark the gather ``failed`` and make the
    machine rejoin."""

    def __init__(self, conn: FramedConnection, n_workers: int,
                 heartbeat_interval: float = 10.0, io_timeout: float = 60.0):
        self.conn = conn
        self.buffer_length = 1 + n_workers // 4
        self.io_timeout = io_timeout
        self.hb_timeout = (
            max(3.0 * heartbeat_interval, io_timeout) if heartbeat_interval > 0 else None)
        self._lock = threading.Lock()
        self._args_queue: List[Any] = []
        self._uploads: Dict[str, List[Any]] = {"episode": [], "result": []}
        self.closed = False
        self.failed = False

    def _rpc(self, payload: Any) -> Any:
        if self.failed:
            # a deadline fired, possibly mid-frame: a late reply to that
            # request would be read as this one's
            raise ConnectionResetError("gather link failed; stream not reusable")
        try:
            self.conn.send(payload, timeout=self.io_timeout)
            while True:
                frame = self.conn.recv(timeout=self.hb_timeout)
                if not _is_hb(frame):
                    return frame
        except OSError:
            self.failed = True
            raise

    def ping(self) -> None:
        """One-way liveness frame, outside the request lock (it must flow
        while a request waits minutes for its reply) and never queued
        behind a frame in flight."""
        if self.closed or self.failed:
            return
        try:
            self.conn.try_send(("heartbeat", None), timeout=self.io_timeout)
        except OSError:
            self.failed = True

    def __call__(self, req: str, data: Any) -> Any:
        with self._lock:
            if self.failed:
                return None  # actors drain; the machine is tearing down
            if req == "args":
                return self._next_args()
            if req in self._uploads:
                self._uploads[req].append(data)
                if len(self._uploads[req]) >= self.buffer_length:
                    self._flush(req)
                return None
            if self.closed:
                return None
            return self._rpc((req, data))

    def _next_args(self) -> Optional[Dict[str, Any]]:
        if self.closed:
            return None
        if not self._args_queue:
            for req in ("episode", "result"):
                self._flush(req)  # uploads must not wait behind the prefetch
            batch = self._rpc(("args", self.buffer_length))
            self._args_queue = [a for a in batch or [] if a is not None]
            if not self._args_queue:
                self.close()  # the learner is draining
                return None
        return self._args_queue.pop(0)

    def _flush(self, req: str) -> None:
        if self._uploads[req] and not self.closed:
            self._rpc((req, self._uploads[req]))
            self._uploads[req] = []

    def fetch_model(self, model_id: int) -> tuple:
        with self._lock:
            if self.closed:
                raise ConnectionResetError("gather connection closed")
            return self._rpc(("model", model_id))

    def close(self, abort: bool = False) -> None:
        """``abort`` skips the last upload flush: the link, or a sibling's,
        already failed, and a flush into a dead socket would stall the
        teardown."""
        if not self.closed:
            if not abort and not self.failed:
                for req in ("episode", "result"):
                    try:
                        self._flush(req)
                    except OSError:
                        break
            self.closed = True
            self.conn.close()


class RemoteWorkerCluster:
    """A worker machine's main loop.

    ``run()`` supervises sessions: one session (entry handshake, data
    connections, actor threads) runs until the learner drains it (job
    assignment answers None: the run is over) or a connection fails; then
    every gather is torn down, every actor thread exits, and the machine
    re-enters with exponential backoff, at most ``max_rejoins`` times in a
    row.  Inference runs on the card unless ``device`` says otherwise."""

    def __init__(self, worker_args: Dict[str, Any], device=None):
        self.worker_args = dict(worker_args)
        self.device = resolve_device(device)
        self.server_address = worker_args["server_address"]
        self.entry_port = int(worker_args.get("entry_port", ENTRY_PORT))
        self.num_parallel = int(worker_args.get("num_parallel", 8))
        self.rejoin = bool(worker_args.get("rejoin", True))
        self.rejoin_backoff = float(worker_args.get("rejoin_backoff", 1.0))
        self.rejoin_backoff_max = float(worker_args.get("rejoin_backoff_max", 60.0))
        self.max_rejoins = int(worker_args.get("max_rejoins", -1))
        self.entry_retry_seconds = float(worker_args.get("entry_retry_seconds", 60.0))
        self.sessions = 0
        self.model_server: Optional[RemoteModelServer] = None  # the live session's

    def _entry(self) -> Dict[str, Any]:
        conn = connect_socket_connection(self.server_address, self.entry_port,
                                         retry_seconds=self.entry_retry_seconds)
        try:
            return send_recv(conn, dict(self.worker_args, num_parallel=self.num_parallel),
                             timeout=30.0)
        finally:
            conn.close()

    def run(self) -> None:
        backoff = self.rejoin_backoff
        rejoins = 0
        while True:
            t0 = time.monotonic()
            try:
                clean = self._run_session()
            except OSError as exc:
                print(f"worker session failed: {type(exc).__name__}: {exc}")
                clean = False
            if clean or time.monotonic() - t0 > self.rejoin_backoff_max:
                # a clean end, or a session that worked for a while, resets
                # the count: max_rejoins bounds consecutive failures
                backoff = self.rejoin_backoff
                rejoins = 0
            if clean or not self.rejoin:
                return
            rejoins += 1
            if 0 <= self.max_rejoins < rejoins:
                print(f"giving up after {self.max_rejoins} rejoins")
                return
            print(f"rejoining server in {backoff:.1f}s")
            time.sleep(backoff)
            backoff = min(backoff * 2.0, self.rejoin_backoff_max)

    def _run_session(self) -> bool:
        """One join, work, drain cycle: True when the learner drained this
        machine, False when a connection failed."""
        cfg = self._entry()
        self.sessions += 1
        args = dict(cfg["train_args"])
        args["env"] = cfg["env_args"]
        base_worker_id = cfg["worker_args"].get("base_worker_id", 0)
        worker_cfg = args["worker"]
        data_port = int(worker_cfg.get("data_port", DATA_PORT))
        heartbeat_interval = float(worker_cfg.get("heartbeat_interval", 10.0))
        io_timeout = float(worker_cfg.get("socket_timeout", 60.0))
        prepare_env(args["env"])

        num_gathers = 1 + (self.num_parallel - 1) // 16
        gathers: List[RemoteGather] = []
        shares: List[int] = []
        try:
            for g in range(num_gathers):
                share = self.num_parallel // num_gathers + int(g < self.num_parallel % num_gathers)
                conn = connect_socket_connection(self.server_address, data_port)
                gathers.append(RemoteGather(conn, share, heartbeat_interval, io_timeout))
                shares.append(share)
        except OSError:
            for gather in gathers:
                gather.close(abort=True)
            raise

        # pings start before the first blocking params fetch: the other
        # gathers would sit silent through it and be reaped as dead
        ping_stop = threading.Event()
        if heartbeat_interval > 0:
            def _ping_loop():
                while not ping_stop.is_set():
                    for g in gathers:
                        g.ping()
                    ping_stop.wait(heartbeat_interval)

            threading.Thread(target=_ping_loop, daemon=True).start()

        model_server = None
        t_play = time.perf_counter()
        try:
            env = make_env(args["env"])
            model_server = RemoteModelServer(env.net(), env, args, gathers[0].fetch_model,
                                             self.device)
            self.model_server = model_server
            t_play = time.perf_counter()
            threads: List[threading.Thread] = []
            wid = base_worker_id
            for gather, share in zip(gathers, shares):
                for _ in range(share):
                    worker = Worker(make_env(args["env"]), args, gather, model_server, wid)
                    t = threading.Thread(target=worker.run, daemon=True,
                                         name=f"remote-actor-{wid}")
                    t.start()
                    threads.append(t)
                    wid += 1
            while any(t.is_alive() for t in threads):
                if any(g.failed for g in gathers):
                    # one dead link ends the session: abort every gather so
                    # each blocked request raises and its actors exit
                    for g in gathers:
                        g.close(abort=True)
                time.sleep(0.2)
            for t in threads:
                t.join()
        finally:
            ping_stop.set()
            failed = any(g.failed for g in gathers)
            for gather in gathers:
                gather.close(abort=failed)
            if model_server is not None:
                model_server.stop()
                engine = model_server.engine
                print(f"[remote] session {self.sessions}: {engine.requests_served} inference "
                      f"requests in {engine.batches_served} batches over "
                      f"{time.perf_counter() - t_play:.3f} s of play", flush=True)
        return not failed


def worker_main(args: Dict[str, Any], argv: Optional[List[str]] = None, device=None) -> None:
    """``--worker [NUM_PARALLEL]``: ``argv`` is the command line as
    ``sys.argv`` holds it (program, mode, then NUM_PARALLEL).  The actors'
    model runs on the card unless ``device`` says otherwise."""
    worker_args = dict(args["worker_args"])
    if argv and len(argv) >= 3:
        worker_args["num_parallel"] = int(argv[2])
    RemoteWorkerCluster(worker_args, device=device).run()
