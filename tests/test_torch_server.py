"""The port's train server and remote worker machines over loopback, on the
CPU (``device="cpu"``): tests/test_faults.py's and test_distributed.py's
remote cases, on the port.

* A TicTacToe ``Learner(remote=True)`` trains 2 epochs fed by a
  ``RemoteWorkerCluster``; its snapshots verify, and the machine's served
  state_dict is the learner's snapshot bit for bit (and the blob's CRC32
  the manifest's).
* Every gather connection severed mid-run: the machine rejoins and the
  training finishes, with no actor thread left behind.
* A vanished connection's in-flight jobs come back as ``jobs_lost``, and
  the learner's generation/evaluation balance is restored.
* The blob server: old ids digest-verified from disk, a corrupt one
  replaced by the latest, blobs cached per id; the machine's model cache:
  stale ids as standalone models, one fetch for many actors.
* ``--train-server`` and ``--worker`` through ``main`` in one process.

Every socket binds port 0 (the CLI case takes a port that was free), the
heartbeat interval is 0.2 s, and every join has a deadline well under a
minute, so a hang fails fast.
"""

import json
import os
import socket
import threading
import time
import zlib

import pytest
import torch
import yaml

from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, RandomModel, init_variables
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.connection import connect_socket_connection, send_recv
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.runtime.server import RemoteModelServer, RemoteWorkerCluster, WorkerServer

TIMEOUT = 45.0  # seconds any one run may take before the test fails


@pytest.fixture(autouse=True)
def _few_threads():
    # the learner, its actors' engine and the trainer share the box with other tests
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config(epochs=2, entry_port=0, data_port=0, heartbeat_interval=0.5):
    return {
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10, "update_episodes": 12,
            "maximum_episodes": 100, "epochs": epochs, "num_batchers": 1, "eval_rate": 0.2,
            "worker": {"num_parallel": 2, "entry_port": entry_port, "data_port": data_port,
                       "heartbeat_interval": heartbeat_interval, "socket_timeout": 5.0,
                       "entry_timeout": 2.0},
        },
        "worker_args": {"server_address": "127.0.0.1", "num_parallel": 3, "entry_port": entry_port,
                        "rejoin_backoff": 0.1, "rejoin_backoff_max": 1.0, "max_rejoins": 5,
                        "entry_retry_seconds": 5.0},
    }


def _remote_learner(epochs=2, heartbeat_interval=0.5):
    """A remote learner on free ports, and the worker args that join it."""
    args = normalize_args(_config(epochs, heartbeat_interval=heartbeat_interval))
    learner = Learner(args, device="cpu", remote=True)
    return learner, dict(args["worker_args"], entry_port=learner.worker.entry_port)


def _start(learner, worker_args):
    """The learner's run and one worker machine joining it, on threads."""
    cluster = RemoteWorkerCluster(worker_args, device="cpu")
    threads = [threading.Thread(target=learner.run, daemon=True),
               threading.Thread(target=cluster.run, daemon=True)]
    for t in threads:
        t.start()
    return cluster, threads


def _join(threads, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "the run did not finish in time"


def _actors_alive():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("remote-actor-") and t.is_alive()]


def test_remote_learner_trains_and_serves_its_snapshot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    learner, worker_args = _remote_learner()
    cluster, threads = _start(learner, worker_args)
    _join(threads)
    assert ckpt.verify_snapshot("models", 1) and ckpt.verify_snapshot("models", 2)
    assert ckpt.verify_state("models", 2)
    records = [json.loads(line) for line in open("metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1] and records[-1]["steps"] > 0
    assert learner.num_returned_episodes >= 22 and cluster.sessions == 1
    assert not _actors_alive()
    # what the machine serves is an epoch's snapshot, bit for bit
    served_id = cluster.model_server.model_id
    assert served_id >= 1
    served = cluster.model_server.engine.model.module.state_dict()
    snapshot = ckpt.load_params(f"models/{served_id}.ckpt")
    assert served.keys() == snapshot.keys()
    assert all(torch.equal(served[k], v) for k, v in snapshot.items())
    # the blob that crossed is the file the manifest records
    manifest = ckpt.load_manifest("models")["epochs"]
    fetched = {model_id: crc for model_id, _, _, crc in cluster.model_server.fetch_log}
    assert fetched[served_id] == manifest[str(served_id)]["files"][f"{served_id}.ckpt"]["crc32"]
    assert [b[0] for b in learner.worker.blob_log] == sorted(fetched)
    assert learner.trainer.sentinel_skipped_steps == 0


def test_severed_gather_rejoins_and_training_finishes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    learner, worker_args = _remote_learner(epochs=3)
    cluster, threads = _start(learner, worker_args)
    deadline = time.monotonic() + TIMEOUT
    while learner.num_returned_episodes < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert learner.num_returned_episodes >= 4, "the worker machine never delivered"
    episodes_before = learner.num_returned_episodes
    severed = learner.worker.connections()
    assert severed, "no gather connection to sever"
    for conn in severed:
        learner.worker.disconnect(conn)
    _join(threads)
    assert cluster.sessions >= 2, "the machine never rejoined"
    assert learner.num_returned_episodes > episodes_before
    assert ckpt.verify_snapshot("models", 3)
    assert not _actors_alive(), "an actor thread outlived its session"


def test_jobs_lost_restores_the_balance(tmp_path, monkeypatch):
    """A gather takes 4 assignments, returns one episode and vanishes: the
    other 3 come back as jobs_lost, and the learner's counts are those of
    the one episode returned."""
    monkeypatch.chdir(tmp_path)
    # this client sends no heartbeats: the server's silence bound is 3 x 5 s
    learner, _ = _remote_learner(heartbeat_interval=5.0)
    learner.worker.run()
    server = threading.Thread(target=learner.server, daemon=True)
    server.start()
    try:
        conn = connect_socket_connection("127.0.0.1", learner.worker.data_port)
        jobs = send_recv(conn, ("args", 4), timeout=10.0)
        roles = [job["role"] for job in jobs]
        assert len(jobs) == 4 and learner.num_episodes + learner.num_results == 4
        assert roles.count("g") == learner.num_episodes >= 1
        assert send_recv(conn, ("episode", [None]), timeout=10.0) is None
        conn.close()
        deadline = time.monotonic() + 10.0
        while (learner.num_episodes, learner.num_results) != (1, 0):
            assert time.monotonic() < deadline, (learner.num_episodes, learner.num_results)
            time.sleep(0.05)
        assert learner.worker.connection_count() == 0
        # the local pool's one-job request and single uploads keep working
        assert learner._serve_request("args", None)["role"] in ("g", "e")
        assert learner._serve_request("result", None) is None
    finally:
        learner.shutdown_flag = True
        _join([server])


def test_inflight_ledger_under_many_concurrent_gathers():
    """16 gathers at once (more than the cores), a tiny switch interval:
    each takes 3 jobs, returns one and vanishes; the jobs lost reported
    add up to exactly the jobs never returned."""
    import sys

    lock = threading.Lock()
    lost = {"g": 0, "e": 0}

    def handler(req, data, timeout=None):
        if req == "args":
            return [{"role": "g" if i % 3 else "e"} for i in range(int(data))]
        if req == "jobs_lost":
            with lock:
                for role, n in data.items():
                    lost[role] += n
        return None

    args = {"env": {"env": "TicTacToe"},
            "worker": {"entry_port": 0, "data_port": 0, "heartbeat_interval": 0}}
    server = WorkerServer(args, handler, None)
    server.run()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def gather():
        try:
            conn = connect_socket_connection("127.0.0.1", server.data_port)
            assert len(send_recv(conn, ("args", 3), timeout=10.0)) == 3
            assert send_recv(conn, ("episode", [None]), timeout=10.0) is None
            conn.close()
        except Exception as exc:  # reported below, on the test's thread
            errors.append(exc)

    try:
        pool = [threading.Thread(target=gather) for _ in range(16)]
        for t in pool:
            t.start()
        _join(pool, 20.0)
        deadline = time.monotonic() + 10.0
        while (lost["g"], lost["e"]) != (16, 16) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
    assert not errors, errors
    # per gather: roles e, g, g assigned; one g returned; e and g lost
    assert lost == {"g": 16, "e": 16}
    assert server.connection_count() == 0


class _ModelServer:
    def __init__(self, model_dir, latest_id, latest):
        self.model_dir, self.latest = model_dir, (latest_id, latest)

    def latest_snapshot(self):
        return self.latest


def _state(value):
    return {"w": torch.full((3, 3), float(value))}


def test_model_bytes_verifies_old_snapshots_and_caches_blobs(tmp_path):
    model_dir = str(tmp_path / "models")
    for epoch in (1, 2):
        ckpt.save_epoch_snapshot(model_dir, epoch, _state(epoch), {"steps": epoch}, epoch)
    args = {"env": {"env": "TicTacToe"},
            "worker": {"entry_port": 0, "data_port": 0, "heartbeat_interval": 0}}
    server = WorkerServer(args, None, _ModelServer(model_dir, 3, _state(3)))
    try:
        got_id, blob = server._model_bytes(1)
        assert got_id == 1 and torch.equal(ckpt.from_bytes(blob)["w"], _state(1)["w"])
        assert server._model_bytes(1)[1] is blob  # cached per id
        latest = server._model_bytes(-1)
        assert latest[0] == 3 and torch.equal(ckpt.from_bytes(latest[1])["w"], _state(3)["w"])
        assert server._model_bytes(7)[1] is latest[1]
        with open(os.path.join(model_dir, "2.ckpt"), "r+b") as f:  # rot one byte
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        assert server._model_bytes(2) == latest  # refused; the latest instead
        assert [entry[0] for entry in server.blob_log] == [1, 3]
    finally:
        server.shutdown()


def test_remote_model_server_caches_old_ids_and_fetches_once():
    """Id -1 and the latest id are the engine; an older id is a model of its
    own, fetched once; eight actors asking for a new id cause one fetch,
    and its weights go into the engine's module."""
    env = make_env({"env": "TicTacToe"})
    snapshots = {i: init_variables(env.net(), i).state_dict() for i in (1, 2, 3)}
    served = {"latest": 2}
    fetches = []

    def fetch(model_id):
        fetches.append(model_id)
        time.sleep(0.05)
        got = model_id if model_id in snapshots and model_id <= served["latest"] \
            else served["latest"]
        return got, ckpt.to_bytes(snapshots[got])

    models = RemoteModelServer(env.net(), env, {}, fetch, device="cpu")
    try:
        assert models.model_id == 2 and fetches == [-1]
        assert isinstance(models.get(0), RandomModel)
        assert models.get(-1).__class__.__name__ == "BatchedInferenceClient"
        old = models.get(1)
        assert isinstance(old, InferenceModel) and models.get(1) is old
        assert all(torch.equal(old.module.state_dict()[k], v) for k, v in snapshots[1].items())
        assert fetches == [-1, 1]
        served["latest"] = 3
        pool = [threading.Thread(target=models.get, args=(3,)) for _ in range(8)]
        for t in pool:
            t.start()
        _join(pool, 10.0)
        assert fetches == [-1, 1, 3] and models.model_id == 3
        engine = models.engine.model.module.state_dict()
        assert all(torch.equal(engine[k], v) for k, v in snapshots[3].items())
    finally:
        models.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_train_server_and_worker_through_main(tmp_path, monkeypatch):
    from handyrl_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    cfg = _config(epochs=1, entry_port=_free_port())
    cfg["train_args"]["worker"]["data_port"] = 0
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    codes = {}
    threads = [threading.Thread(target=lambda m=m: codes.setdefault(m[0], main(m, device="cpu")),
                                daemon=True)
               for m in (["--train-server"], ["--worker", "2"])]
    for t in threads:
        t.start()
    _join(threads)
    assert codes == {"--train-server": 0, "--worker": 0}
    assert ckpt.verify_snapshot("models", 1)
    assert zlib.crc32(open("models/latest.ckpt", "rb").read()) == \
        ckpt.load_manifest("models")["epochs"]["1"]["files"]["latest.ckpt"]["crc32"]
