"""The pieces of a learner of several processes, socket-free where they can
be, against the JAX package's:

* ``make_mesh`` and ``split_mesh`` partitions and their errors over device
  lists (the JAX package's over its 8 virtual CPU devices, the port's over
  the same ids);
* ``local_batch_size`` and the backend rule, a pure function of where the
  ranks placed themselves, and each rank's placement;
* ``DistributedCadence``'s command bits over a fake broadcast;
* the health plane's monitor logic, the scenarios of tests/test_health.py,
  run on the JAX package's module and on the port's copy alike;
* the plane wire: a JAX ``_pack_tree`` payload unpacks in the port and the
  port's in JAX, with equal arrays; one gateway round trip over localhost,
  a JAX client against the port's gateway.
"""

import io
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.parallel import distributed as jax_dist
from handyrl_tpu.parallel import health as jax_health
from handyrl_tpu.parallel import mesh as jax_mesh
from handyrl_tpu.runtime import plane as jax_plane
from handyrl_tpu_torch.parallel import distributed, health, mesh
from handyrl_tpu_torch.runtime import plane

# -- the mesh ------------------------------------------------------------------


def _jax_ids(m):
    return [d.id for d in m.devices.flat], dict(m.shape)


@pytest.mark.parametrize("spec", [None, {"dp": -1}, {"dp": 8}, {"dp": 4, "mp": 2},
                                  {"dp": -1, "mp": 2}])
def test_make_mesh_lays_out_devices_as_jax(spec):
    devices = jax.devices()
    assert len(devices) == 8
    got = mesh.make_mesh(spec, [d.id for d in devices])
    ids, shape = _jax_ids(jax_mesh.make_mesh(spec, devices))
    assert got.devices == ids and got.shape == shape


@pytest.mark.parametrize("spec,words", [({"dp": -1, "mp": 3}, "not divisible by fixed mesh axes"),
                                        ({"dp": 16}, "needs more than 8 devices")])
def test_make_mesh_refuses_what_jax_refuses(spec, words):
    with pytest.raises(ValueError, match=words):
        jax_mesh.make_mesh(spec, jax.devices())
    with pytest.raises(ValueError, match=words):
        mesh.make_mesh(spec, list(range(8)))


def test_make_mesh_refuses_a_sub_mesh_jax_would_take():
    """All-positive sizes over a prefix of the devices: a JAX sub-mesh, a
    rank left out of the collective step here."""
    assert jax_mesh.make_mesh({"dp": 3}, jax.devices()).size == 3
    with pytest.raises(ValueError, match="sub-mesh"):
        mesh.make_mesh({"dp": 3}, list(range(8)))


def test_make_mesh_defaults_to_one_device_per_rank():
    m = mesh.make_mesh()
    assert m.shape == {"dp": 1} and m.devices == [mesh.RankDevice(0, "cpu")]


@pytest.mark.parametrize("spec,actor_chips", [(None, 1), ({"dp": -1}, 3), ({"dp": 2}, 2),
                                              ({"dp": 3, "mp": 2}, 1)])
def test_split_mesh_partitions_as_jax(spec, actor_chips):
    devices = jax.devices()
    learner, actor = mesh.split_mesh(spec, actor_chips, [d.id for d in devices])
    jlearner, jactor = jax_mesh.split_mesh(spec, actor_chips, devices)
    assert (learner.devices, learner.shape) == _jax_ids(jlearner)
    assert (actor.devices, actor.shape) == _jax_ids(jactor)


@pytest.mark.parametrize("actor_chips,words", [(0, "actor_chips must be >= 1"),
                                               (8, "at least one learner device")])
def test_split_mesh_refuses_what_jax_refuses(actor_chips, words):
    with pytest.raises(ValueError, match=words):
        jax_mesh.split_mesh(None, actor_chips, jax.devices())
    with pytest.raises(ValueError, match=words):
        mesh.split_mesh(None, actor_chips, list(range(8)))


def test_dispatch_serialized_takes_the_devices_lock():
    from handyrl_tpu_torch.parallel import dispatch

    lock = dispatch.locks_for(["cpu"])[0]
    seen = []
    assert mesh.dispatch_serialized(lambda: seen.append(lock.locked()) or 7) == 7
    assert seen == [True] and not lock.locked()


# -- batch shares, placement, backend ---------------------------------------------


def test_local_batch_size_splits_the_global_batch(monkeypatch):
    assert distributed.local_batch_size(16) == 16   # no group: one process
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert distributed.local_batch_size(16) == jax_dist.local_batch_size(16) == 8
    for fn in (distributed.local_batch_size, jax_dist.local_batch_size):
        with pytest.raises(ValueError, match="batch_size 9 not divisible by 2 processes"):
            fn(9)


@pytest.mark.parametrize("placements,backend", [
    ([("h", "cuda:0"), ("h", "cuda:1")], "nccl"),
    ([("h", "cuda:0"), ("h", "cuda:0")], "gloo"),   # two ranks on one card
    ([("a", "cuda:0"), ("b", "cuda:0")], "nccl"),   # one card on each of two hosts
    ([("h", "cpu"), ("h", "cpu")], "gloo"),
    ([("h", "cuda:0"), ("h", "cpu")], "gloo"),
])
def test_backend_follows_from_the_placement(placements, backend):
    assert distributed.choose_backend(placements) == backend


def test_rank_placement(monkeypatch):
    assert distributed.rank_placement({}, 1, device="cpu") == torch.device("cpu")
    assert distributed.rank_placement({}, 1, device="cuda:3") == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_placement({}, 0)   # never the CPU behind the caller's back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.rank_placement({}, 1) == torch.device("cuda", 0)   # both on the one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_placement({}, 1) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.rank_placement({}, 1) == torch.device("cuda", 2)
    assert distributed.rank_placement({"local_device_ids": [3]}, 1) == torch.device("cuda", 3)


def test_no_coordinator_means_one_process():
    assert distributed.init_distributed(None, device="cpu") == (0, torch.device("cpu"))
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    assert distributed.backend() is None and distributed.broadcast_resume_epoch(5) == 5


def test_dead_coordinator_is_a_loud_bounded_error():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="initialization_timeout=1s"):
        distributed.init_distributed({"coordinator_address": f"127.0.0.1:{port}",
                                      "num_processes": 2, "process_id": 1,
                                      "initialization_timeout": 1.0}, device="cpu")
    assert time.monotonic() - t0 < 10.0


def test_params_crc32_tells_bits_apart():
    a = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.zeros(2)}
    b = {k: v.clone() for k, v in a.items()}
    assert distributed.params_crc32(a) == distributed.params_crc32(b)
    b["w"][1, 2] = torch.nextafter(b["w"][1, 2], torch.tensor(100.0))
    assert distributed.params_crc32(a) != distributed.params_crc32(b)


# -- the cadence ------------------------------------------------------------------


@pytest.fixture(params=["jax", "port"])
def cadence_of(request, monkeypatch):
    """A DistributedCadence factory over a fake broadcast that records
    what each rank passes and returns the coordinator's value."""
    module = jax_dist if request.param == "jax" else distributed
    sent = []

    def fake_broadcast(value):
        sent.append(int(value))
        return fake_broadcast.coordinator_value

    fake_broadcast.coordinator_value = 0
    monkeypatch.setattr(module, "broadcast_from_coordinator", fake_broadcast)

    def make(coordinator):
        monkeypatch.setattr(module, "is_coordinator", lambda: coordinator)
        monkeypatch.setattr(module, "process_count", lambda: 2)
        return module.DistributedCadence(None)

    return module, make, sent, fake_broadcast


def test_cadence_command_bits(cadence_of):
    module, make, sent, broadcast = cadence_of
    assert (module.CMD_CONTINUE, module.CMD_END, module.CMD_DRAIN) == (0, 1, 2)
    coord = make(True)
    coord.agree_step(end=False, drain=False)
    coord.agree_step(end=True, drain=False)
    coord.agree_step(end=False, drain=True)
    coord.agree_stop(True)
    coord.agree_rollback_epoch(4)
    assert sent == [0, 1, 3, 1, 4]
    follower = make(False)
    sent.clear()
    broadcast.coordinator_value = 3
    assert follower.agree_step(end=True, drain=True) == 3   # the coordinator's word
    assert follower.agree_stop(True) is True
    assert follower.agree_rollback_epoch(9) == 3
    assert sent == [0, 0, 0]   # a follower passes nothing of its own


# -- the health plane: tests/test_health.py's scenarios on both copies -------------


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(params=["jax", "port"])
def hp(request):
    return jax_health if request.param == "jax" else health


def _plane(hp, on_fault, clock, interval=1.0, timeout=5.0, rank=0, nprocs=3):
    return hp.HostHealthPlane({"coordinator_address": "127.0.0.1:6000",
                               "heartbeat_interval": interval, "heartbeat_timeout": timeout},
                              rank, nprocs, on_fault, clock=clock)


def test_health_port_defaults_to_coordinator_port_plus_one(hp):
    assert hp.resolve_health_port({"coordinator_address": "10.0.0.1:1234"}) == 1235
    assert hp.resolve_health_port({"coordinator_address": "10.0.0.1:1234",
                                   "health_port": 7777}) == 7777
    assert plane.resolve_plane_port({"coordinator_address": "10.0.0.1:1234"}) == 1236


def test_peer_silence_counts_misses_then_declares_loss(hp):
    clock = _Clock()
    p = _plane(hp, lambda r, k: None, clock)
    p._started_at = clock()
    p.last_seen[1] = p.last_seen[2] = clock()
    assert p.check_peers() is None
    clock.t += 2.0
    p.last_seen[2] = clock()
    assert p.check_peers() is None and p.events["heartbeat_misses"] >= 1
    clock.t += 3.5   # rank 1 silent 5.5 s > 5 s
    p.last_seen[2] = clock()
    assert p.check_peers() == 1 and p.events["peer_losses"] == 1 and 1 in p.lost
    clock.t += 0.1
    p.last_seen[2] = clock()
    assert p.check_peers() is None


def test_peer_that_never_joined_is_lost_after_grace(hp):
    clock = _Clock()
    p = _plane(hp, lambda r, k: None, clock, nprocs=2)
    p._started_at = clock()
    assert p.check_peers() is None
    clock.t += 5.5
    assert p.check_peers() == 1


def test_fault_callback_fires_at_most_once_and_disarm_silences(hp):
    calls = []
    p = _plane(hp, lambda r, k: calls.append(k), _Clock())
    p._fault("a", "peer_loss")
    p._fault("b", "coordinator_loss")
    assert calls == ["peer_loss"]
    calls.clear()
    q = _plane(hp, lambda r, k: calls.append(k), _Clock())
    q.disarm()
    q._fault("silent", "peer_loss")
    assert calls == []


def test_collective_watchdog_fires_once_past_its_timeout(hp):
    clock = _Clock()
    fired = []
    wd = hp.CollectiveWatchdog(10.0, fired.append, clock=clock)
    assert not wd.check()
    wd.arm("train_step @ step 7")
    clock.t += 9.0
    assert not wd.check()
    clock.t += 2.0
    assert wd.check() and len(fired) == 1 and "train_step @ step 7" in fired[0]
    clock.t += 100.0
    assert wd.check() and len(fired) == 1
    wd2 = hp.CollectiveWatchdog(10.0, fired.append, clock=clock)
    wd2.arm("x")
    wd2.disarm()
    clock.t += 100.0
    assert not wd2.check()
    wd0 = hp.CollectiveWatchdog(0.0, fired.append, clock=clock)
    wd0.arm("y")
    clock.t += 1e6
    assert not wd0.check() and len(fired) == 1


def test_heartbeat_roundtrip_echoes_the_lost_set(hp):
    p = _plane(hp, lambda r, k: None, time.monotonic, interval=0.2, timeout=2.0)
    p.lost.add(2)
    a, b = socket.socketpair()
    threading.Thread(target=p._serve_peer, args=(b,), daemon=True).start()
    try:
        a.settimeout(2.0)
        snap = {"epoch": 4, "steps": 120}
        a.sendall(json.dumps({"rank": 1, "seq": 1, "metrics": snap}).encode() + b"\n")
        ack = json.loads(a.makefile().readline())
        assert ack == {"ok": 1, "lost": [2]} and 1 in p.last_seen
        deadline = time.monotonic() + 2.0
        while 1 not in p.peer_metrics and time.monotonic() < deadline:
            time.sleep(0.01)
        assert p.peer_metrics[1][0] == snap
        p.stop_heartbeats()   # a wedged coordinator receives and never acks
        a.sendall(json.dumps({"rank": 1, "seq": 2}).encode() + b"\n")
        a.settimeout(0.5)
        with pytest.raises(socket.timeout):
            a.recv(4096)
    finally:
        p._stop.set()
        a.close()


def test_follower_offer_rides_next_beat_and_survives_a_failed_send(hp):
    p = _plane(hp, lambda r, k: None, _Clock(), rank=1)
    p.offer_metrics({"epoch": 1})
    p.offer_metrics({"epoch": 2})
    taken = p._take_pending_metrics()
    assert taken == {"epoch": 2} and p._take_pending_metrics() is None
    p._restore_pending_metrics(taken)
    assert p._take_pending_metrics() == {"epoch": 2}
    p.offer_metrics({"epoch": 3})
    p._restore_pending_metrics({"epoch": 2})
    assert p._take_pending_metrics() == {"epoch": 3}


def test_rank_aggregates_and_the_stale_wedged_follower(hp):
    clock = _Clock()
    p = _plane(hp, lambda r, k: None, clock, interval=1.0, timeout=30.0, nprocs=2)
    p._started_at = clock()
    for epoch in (1, 2, 3):
        p.last_seen[1] = clock()
        p.note_peer_metrics(1, {"epoch": epoch, "steps": 30 * epoch,
                                "train_steps_per_sec": 9.0}, now=clock())
        agg = p.rank_aggregates({"epoch": epoch, "steps": 30 * epoch,
                                 "train_steps_per_sec": 9.1})
        assert agg["rank_stale_reports"] == 0 and agg["rank_reports"] == 2
        clock.t += 1.0
    for _ in range(10):   # rank 1's trainer wedges; its beats go on
        clock.t += 1.0
        p.last_seen[1] = clock()
    assert p.check_peers() is None
    agg = p.rank_aggregates({"epoch": 4, "steps": 120, "train_steps_per_sec": 9.1})
    assert agg["rank_report_age_s_max"] == 11.0 and agg["rank_stale_reports"] == 1
    assert agg["rank_epoch_min"] == 3 and agg["rank_epoch_max"] == 4
    assert agg["rank_train_steps_per_sec_min"] == 9.0


def test_stall_rebase_keeps_peers_alive_through_a_local_blackout(hp):
    clock = _Clock()
    p = _plane(hp, lambda r, k: None, clock, nprocs=2)
    p._started_at = clock()
    p.last_seen[1] = clock()
    clock.t += 60.0     # this process starved for a minute
    p._rebase_after_stall(60.0)
    assert p.check_peers() is None


def test_kill_and_wedge_faults_are_parsed_alike(monkeypatch):
    from handyrl_tpu.runtime import faults as jax_faults
    from handyrl_tpu_torch.runtime import faults

    for raw, want in (("2:1", (2, 1)), ("3", (3, 0))):
        monkeypatch.setenv("HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH", raw)
        monkeypatch.setenv("HANDYRL_FAULT_WEDGE_PROCESS", raw)
        for mod in (faults, jax_faults):
            assert mod.kill_process_at_epoch() == want == mod.wedge_process_at_epoch()
    monkeypatch.setenv("HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH", "x:1")
    with pytest.raises(ValueError, match="HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH"):
        faults.kill_process_at_epoch()


# -- the plane wire -----------------------------------------------------------------

TREE = {"obs": {"board": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                "mask": np.array([[True, False]])},
        "action": np.arange(6, dtype=np.int64).reshape(3, 2), "done": np.zeros((3, 2), np.int8)}


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_the_wire_round_trips_between_the_packages():
    _equal_trees(plane._unpack_tree(jax_plane._pack_tree(TREE)), TREE)
    torch_tree = {"obs": {k: torch.from_numpy(v) for k, v in TREE["obs"].items()},
                  "action": torch.from_numpy(TREE["action"]), "done": TREE["done"]}
    _equal_trees(jax_plane._unpack_tree(plane._pack_tree(torch_tree)), TREE)
    assert plane._pack_tree(TREE) == jax_plane._pack_tree(TREE)
    # one framed message each way
    buf = io.BytesIO()
    n = plane._send_msg(buf, {"kind": "records"}, b"xyz")
    buf.seek(0)
    assert jax_plane._recv_msg(buf) == ({"kind": "records", "nbytes": 3}, b"xyz", n)
    buf = io.BytesIO()
    jax_plane._send_msg(buf, {"kind": "params", "version": 4}, b"")
    buf.seek(0)
    assert plane._recv_msg(buf)[0] == {"kind": "params", "version": 4, "nbytes": 0}
    with pytest.raises(ValueError, match="nested dicts"):
        plane._pack_tree({"a": [np.zeros(1)]})
    with pytest.raises(ValueError, match="bfloat16"):
        plane._pack_tree({"a": torch.zeros(1, dtype=torch.bfloat16)})


def test_param_cache_and_record_transfer():
    cache = plane.PlaneParamCache("cpu")
    assert cache.lag(10) == 0
    cache.publish({"w": torch.ones(3)}, 4)
    with pytest.raises(ValueError, match="monotonically"):
        cache.publish({"w": torch.ones(3)}, 4)
    version, params = cache.latest()
    assert version == 4 and torch.equal(params["w"], torch.ones(3)) and cache.lag(10) == 6
    assert cache.bytes_transferred == 12
    xfer = plane.RecordTransfer("cpu")
    moved = xfer({"a": np.zeros((2, 3), np.float32)})
    assert torch.is_tensor(moved["a"]) and xfer.bytes_transferred == 24


def test_a_jax_client_against_the_ports_gateway():
    """Hello, records in (handed to on_records), params out only when
    newer, a clean stop; the client is the JAX package's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = []
    dist_args = {"coordinator_address": "127.0.0.1:1", "plane_port": port}
    gateway = plane.PlaneGateway(dist_args, on_records=got.append)
    gateway.publish({"w": torch.arange(4, dtype=torch.float32)}, 3)
    gateway.start()
    client = jax_plane.PlaneClient(dist_args, timeout=10.0)
    try:
        assert client.connect(retry_for=10.0) == 3
        assert client.ship_records(TREE) == 3
        _equal_trees(got[0], TREE)
        assert client.poll_params() == (3, None)   # the hello's version: nothing newer
        version, params = client.poll_params(have=-1)
        assert version == 3 and np.array_equal(params["w"], np.arange(4, dtype=np.float32))
        gateway.publish({"w": torch.zeros(4)}, 9)
        assert client.poll_params()[0] == 9
        assert gateway.actor_hosts == 1 and gateway.record_batches == 1
        gateway.begin_stop()
        assert client.ship_records(TREE) is None   # a clean stop
    finally:
        client.close()
        gateway.stop(goodbye_s=2.0)
    assert gateway.actor_host_losses == 0 and gateway.actor_hosts == 0


@pytest.mark.parametrize("entry", ["train_main", "main_train", "actor_host_main", "main_actor"])
def test_rank_and_actor_host_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path,
                                                                   entry):
    """A rank of the learner and an actor host run on the card; without one
    they raise before they touch the network (the coordinator's port is
    closed here: a rendezvous would time out, not raise this)."""
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.main import main
    from handyrl_tpu_torch.runtime.actor_host import actor_host_main
    from handyrl_tpu_torch.runtime.learner import train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    dist = {"coordinator_address": "127.0.0.1:1", "num_processes": 2, "process_id": 1,
            "initialization_timeout": 60.0}
    config = {"env_args": {"env": "Geister"},
              "train_args": {"observation": True, "batch_size": 4, "device_rollout_games": 4,
                             "device_replay": True,
                             "distributed": dict(dist, role="actor" if "actor" in entry
                                                 else "learner")}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    args = normalize_args(config)
    call = {"train_main": lambda: train_main(args), "main_train": lambda: main(["--train"]),
            "actor_host_main": lambda: actor_host_main(args),
            "main_actor": lambda: main(["--train"])}[entry]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert time.monotonic() - t0 < 30.0 and not (tmp_path / "models").exists()


def test_cadence_and_gateway_spans_reach_the_trace(tmp_path, monkeypatch):
    from handyrl_tpu_torch.utils import trace

    monkeypatch.setattr(distributed, "broadcast_from_coordinator", lambda value: 1)
    monkeypatch.setattr(distributed, "is_coordinator", lambda: True)
    path = tmp_path / "trace.jsonl"
    assert trace.configure({"enabled": True, "path": str(path), "annotate_device": False})
    try:
        cadence = distributed.DistributedCadence(None)
        assert cadence.agree_step(end=True, drain=False) == 1
        cadence.agree_stop(True)
        cadence.agree_rollback_epoch(2)
        cache = plane.PlaneGateway({"coordinator_address": "127.0.0.1:1", "plane_port": 1},
                                   on_records=lambda r: None)
        cache.publish({"w": torch.ones(2)}, 1)
        cache._packed_params()
    finally:
        trace.shutdown()
    names = {r["name"] for r in trace.read_trace(str(path))}
    assert {"cadence.agree_step", "cadence.agree_stop", "cadence.agree_rollback",
            "dispatch.wait", "dispatch.run", "plane.param_publish"} <= names


def _geese_replay():
    """A small HungryGeese rollout and its rings on the CPU, filled until 8
    windows are sampleable."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.models.nets import GeeseNet
    from handyrl_tpu_torch.runtime.device_replay import DeviceReplay
    from handyrl_tpu_torch.runtime.device_rollout import StreamingDeviceRollout

    cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": {
        "turn_based_training": False, "observation": False, "batch_size": 8,
        "forward_steps": 8}})
    args = dict(cfg["train_args"], env=cfg["env_args"])
    venv = make_env(cfg["env_args"]).vector_env()
    module = init_variables(GeeseNet(filters=8, blocks=2), 0)
    roll = StreamingDeviceRollout(venv, module, args, n_lanes=8, k_steps=32, device="cpu")
    replay = DeviceReplay(venv, module, args, 8, slots=192, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        while replay.eligible_count() < 8:
            replay.ingest_counted(roll.launch(None, gen))
    return roll, replay, gen


def test_sample_host_is_the_sample_on_the_host():
    """``DeviceReplay.sample_host``: the batch ``sample`` draws, as numpy."""
    from handyrl_tpu_torch.utils import tree_leaves

    _, replay, gen = _geese_replay()
    state = gen.get_state()
    want = replay.sample(gen, 8)
    gen.set_state(state)
    got = replay.sample_host(gen, 8)
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    assert pairs and all(isinstance(g, np.ndarray) and np.array_equal(g, w.numpy())
                         for g, w in pairs)


@pytest.mark.parametrize("source,restarted", [("local", False), ("gateway", True)])
def test_a_block_from_another_source_restarts_the_lanes(source, restarted):
    """An actor host's block after the learner's own rollout: every lane's
    episode in progress is cut (never sampled), and the new block's steps
    open a new one at the block's first step."""
    roll, replay, gen = _geese_replay()
    with torch.inference_mode():
        launched = roll.launch(None, gen)
    block = {k: v.clone() for k, v in launched.items()}
    block["done"].zero_()                 # no episode ends in this block
    before = replay.rings["cur_start_g"].clone()
    g0 = replay.rings["g"]
    eligible = replay.eligible_count()
    replay.ingest(block, source=source)
    after = replay.rings["cur_start_g"]
    if restarted:
        assert bool((after == g0).all())
        assert replay.eligible_count() <= eligible
    else:
        assert torch.equal(after, before)
