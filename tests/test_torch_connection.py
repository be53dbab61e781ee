"""The port's transport (handyrl_tpu_torch/runtime/connection.py) against the
JAX package's, on the CPU.

* One frame of the port puts on a socket exactly the bytes the JAX
  package's ``FramedConnection.send`` puts there, for the messages the
  remote actor plane carries (job args, a generated episode, a result,
  heartbeats, a 16 MB params blob), and each package reads the other's.
* A real generated episode and evaluation result of every env, made with
  the env's own net on the CPU, crosses a connection intact: no tensor
  reaches the wire.
* Deadlines: a silent peer's ``recv`` times out; a peer that stops reading
  is dropped while the others are served; a stalled entry handshake does
  not hold up later joins (tests/test_faults.py's cases, on the port).

Exact comparisons throughout: frames are bytes.  Every socket binds port 0
or is a socketpair, and every wait has a deadline of a few seconds.
"""

import copy
import functools
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from handyrl_tpu.runtime.connection import FramedConnection as JaxFramedConnection
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, init_variables
from handyrl_tpu_torch.runtime import codec
from handyrl_tpu_torch.runtime.connection import (
    MAX_PAYLOAD,
    FramedConnection,
    QueueCommunicator,
    accept_socket_connections,
    connect_socket_connection,
    frame_header,
    open_socket_connection,
    send_recv,
)
from handyrl_tpu_torch.runtime.evaluation import Evaluator
from handyrl_tpu_torch.runtime.generation import Generator
from handyrl_tpu_torch.runtime.replay import decompress_block

ENVS = ["TicTacToe", "Geister", "ParallelTicTacToe", "HungryGeese", "ConnectFour"]


def _train_args(name):
    simultaneous = name in ("HungryGeese", "ParallelTicTacToe")
    cfg = normalize_args({"env_args": {"env": name}, "train_args": {
        "turn_based_training": not simultaneous, "observation": name == "Geister"}})
    return dict(cfg["train_args"], env=cfg["env_args"])


def _generated(name, seed=0):
    """An episode and an evaluation result of ``name`` played by its own
    net on the CPU (the DRC's hidden state stays in torch tensors).  Each
    (name, seed) is played once per module; every caller gets a copy."""
    return copy.deepcopy(_played(name, seed))


@functools.lru_cache(maxsize=None)
def _played(name, seed):
    # two intra-op threads: a worker of a parallel run shares the cores with
    # the others, and oversubscribed threads slowed one Geister game tens of
    # times over
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _play(name, seed)
    finally:
        torch.set_num_threads(threads)


def _play(name, seed):
    args = _train_args(name)
    env = make_env(args["env"])
    model = InferenceModel(init_variables(env.net(), seed), "cpu")
    models = {p: model for p in env.players()}
    job = {"player": env.players(), "model_id": {p: 1 for p in env.players()}}
    random.seed(seed)
    episode = Generator(env, args).generate(models, dict(job, role="g"))
    result = Evaluator(env, args).execute(models, dict(job, role="e", player=[0]))
    assert episode is not None and result is not None
    return episode, result


def _wire_bytes(conn_cls, obj):
    """The bytes one ``send`` of ``obj`` puts on a socket."""
    a, b = socket.socketpair()
    out = bytearray()

    def read():
        while chunk := b.recv(1 << 20):
            out.extend(chunk)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        conn_cls(a).send(obj)
        a.shutdown(socket.SHUT_WR)
        reader.join(10)
        assert not reader.is_alive()
    finally:
        a.close()
        b.close()
    return bytes(out)


def _payload(kind):
    if kind == "job_args":
        return [{"role": "g", "player": [0, 1], "model_id": {0: 3, 1: 3}},
                {"role": "e", "player": [1], "model_id": {0: -1, 1: 3}}]
    if kind == "episode":
        return ("episode", [_generated("TicTacToe")[0]])
    if kind == "result":
        return ("result", [_generated("HungryGeese")[1]])
    if kind == "heartbeat":
        return ("heartbeat", None)
    if kind == "server_heartbeat":
        return ("__hb__",)
    if kind == "blob_16mb":
        return (2, np.random.default_rng(0).bytes(16 << 20))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["job_args", "episode", "result", "heartbeat",
                                  "server_heartbeat", "blob_16mb"])
def test_frames_are_byte_equal_with_the_jax_package(kind):
    obj = _payload(kind)
    ours, theirs = _wire_bytes(FramedConnection, obj), _wire_bytes(JaxFramedConnection, obj)
    assert ours == theirs
    assert ours[:4] == frame_header(len(ours) - 4)


@pytest.mark.parametrize("sender,receiver", [(FramedConnection, JaxFramedConnection),
                                             (JaxFramedConnection, FramedConnection)])
def test_each_package_reads_the_others_frames(sender, receiver):
    episode, result = _generated("Geister")
    a, b = socket.socketpair()
    try:
        tx, rx = sender(a, timeout=5.0), receiver(b, timeout=5.0)
        for obj in (("episode", [episode]), ("result", [result]), (7, b"\x00blob")):
            threading.Thread(target=tx.send, args=(obj,), daemon=True).start()
            got = rx.recv()
            assert codec.py_dumps(got) == codec.py_dumps(obj)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("env", ENVS)
def test_generated_episode_of_each_env_round_trips(env):
    episode, result = _generated(env)
    a, b = socket.socketpair()
    try:
        tx, rx = FramedConnection(a, timeout=5.0), FramedConnection(b, timeout=5.0)
        threading.Thread(target=tx.send, args=(("episode", [episode], "result", [result]),),
                         daemon=True).start()
        _, (got,), _, (got_result,) = rx.recv()
    finally:
        a.close()
        b.close()
    assert got.keys() == episode.keys() and got["blocks"] == episode["blocks"]
    assert got["outcome"] == episode["outcome"] and got["args"] == episode["args"]
    assert got_result == result
    for block in got["blocks"]:  # the columns decode as numpy, never tensors
        for leaf in decompress_block(block).values():
            assert not isinstance(leaf, torch.Tensor)


def test_payload_over_4_gib_is_refused_not_wrapped():
    assert frame_header(MAX_PAYLOAD) == b"\xff\xff\xff\xff"
    with pytest.raises(codec.CodecError, match="does not fit the u32 length header"):
        frame_header(MAX_PAYLOAD + 1)
    with pytest.raises(codec.CodecError):
        frame_header(1 << 33)


def test_unencodable_tensor_never_reaches_the_wire():
    a, b = socket.socketpair()
    try:
        with pytest.raises(codec.CodecError, match="Tensor"):
            FramedConnection(a).send(("episode", torch.zeros(2)))
        b.setblocking(False)
        with pytest.raises(BlockingIOError):  # not a byte was sent
            b.recv(1)
    finally:
        a.close()
        b.close()


def test_framed_recv_deadline_fires():
    sock = open_socket_connection(0)
    port = sock.getsockname()[1]

    def silent_server():
        for conn in accept_socket_connections(maxsize=1, sock=sock):
            time.sleep(2.0)  # accept, then say nothing
            conn.close()

    t = threading.Thread(target=silent_server, daemon=True)
    t.start()
    conn = connect_socket_connection("localhost", port, retry_seconds=5.0)
    t0 = time.monotonic()
    with pytest.raises(socket.timeout):
        conn.recv(timeout=0.3)
    assert time.monotonic() - t0 < 1.5
    conn.close()
    t.join(5)
    assert not t.is_alive()
    sock.close()


def test_hard_deadline_is_absolute_against_a_trickle():
    """A stall bound is kept alive by one byte per gap; ``hard=True`` is not."""
    a, b = socket.socketpair()
    stop = threading.Event()

    def trickle():
        try:
            a.sendall(b"\x00\x00\x00\x10")
            while not stop.wait(0.1):
                a.sendall(b"x")
        except OSError:
            pass

    threading.Thread(target=trickle, daemon=True).start()
    try:
        t0 = time.monotonic()
        with pytest.raises(socket.timeout):
            FramedConnection(b).recv(timeout=0.5, hard=True)
        assert time.monotonic() - t0 < 1.0
    finally:
        stop.set()
        a.close()
        b.close()


def test_stalled_peer_does_not_wedge_other_peers():
    """A peer that stops reading is dropped once its TCP window and send
    queue fill; the hub keeps serving the other one."""
    listener = open_socket_connection(0)
    port = listener.getsockname()[1]
    hub = QueueCommunicator(send_queue_size=2)
    ready = threading.Event()
    ids = {}

    def server():
        for conn in accept_socket_connections(maxsize=2, sock=listener):
            hub.add_connection(conn)
        for _ in range(2):
            conn, data = hub.recv(timeout=10)
            ids[data] = conn
        ready.set()

    threading.Thread(target=server, daemon=True).start()
    stalled = connect_socket_connection("localhost", port, retry_seconds=5.0)
    healthy = connect_socket_connection("localhost", port, retry_seconds=5.0)
    try:
        stalled.send("stalled")
        healthy.send("healthy")
        assert ready.wait(timeout=10)
        big = np.zeros((1 << 18,), np.uint8)  # 256 KiB frames
        for _ in range(200):
            hub.send(ids["stalled"], big)
            if hub.connection_count() <= 1:
                break
        deadline = time.monotonic() + 10.0
        while hub.connection_count() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert hub.connection_count() == 1, "stalled peer was never torn down"
        hub.send(ids["healthy"], ("pong", 42))
        assert healthy.recv(timeout=5.0) == ("pong", 42)
    finally:
        healthy.close()
        stalled.close()
        hub.shutdown()
        listener.close()


def test_stalled_entry_handshake_does_not_block_joins():
    """The entry thread reads under an absolute deadline: a client that
    sends a huge length and then one byte per 0.4 s is dropped, and a
    well-behaved join behind it completes."""
    from handyrl_tpu_torch.runtime.server import WorkerServer

    args = {"env": {"env": "TicTacToe"},
            "worker": {"num_parallel": 2, "entry_port": 0, "data_port": 0,
                       "entry_timeout": 1.0, "heartbeat_interval": 0}}
    server = WorkerServer(args, lambda req, data, timeout=None: None, None)
    server.run()
    trickler = socket.create_connection(("localhost", server.entry_port), timeout=5)
    stop_trickle = threading.Event()

    def trickle():
        try:
            trickler.sendall(b"\x00\xff\xff\xff")
            while not stop_trickle.is_set():
                trickler.sendall(b"x")
                stop_trickle.wait(0.4)
        except OSError:
            pass  # the server dropped us

    try:
        threading.Thread(target=trickle, daemon=True).start()
        time.sleep(0.2)  # the trickler is accepted first
        conn = connect_socket_connection("localhost", server.entry_port, retry_seconds=5.0)
        t0 = time.monotonic()
        reply = send_recv(conn, {"num_parallel": 2}, timeout=10.0)
        elapsed = time.monotonic() - t0
        conn.close()
        assert reply["worker_args"]["base_worker_id"] == 0
        assert reply["env_args"] == {"env": "TicTacToe"}
        # the handshake names the data port actually bound (port 0 asked)
        assert reply["train_args"]["worker"]["data_port"] == server.data_port != 0
        assert elapsed < 8.0, f"join waited {elapsed:.1f}s behind a trickled handshake"
    finally:
        stop_trickle.set()
        trickler.close()
        server.shutdown()
