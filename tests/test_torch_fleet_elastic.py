"""The port's elastic fleet on the CPU: the port's versions of
tests/test_fleet_elastic.py.

* ``AutoscaleDecider`` against the JAX package's over sequences of
  signals made by hypothesis: the same decisions, tick for tick.
* Warm-then-admit: a connected replica with nothing published takes no
  traffic until it publishes; a fleet with no warm replica refuses to serve.
* The planned retire moves a replica's whole session cache (resident and
  spilled) to the successor: the migrated sessions' next replies equal
  those of unmigrated controls bit for bit, with no affinity miss; a retire
  with no successor returns at once, loudly.
* A load storm scales the fleet up through a replica factory (the new
  replica admitted warm, nothing shed) and calm scales it down through the
  migration; ``ProcessReplicaFactory`` starts a replica process (spawn) that
  the router admits and a retire stops.
* A ``--serve`` replica process preempted by ``HANDYRL_FAULT_SIGTERM_REPLICA``
  drains its sessions to the survivor through the router and exits 75.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from handyrl_tpu.fleet.autoscale import AutoscaleDecider as JaxAutoscaleDecider
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.fleet import FleetRouter, ProcessReplicaFactory, ReplicaSpec
from handyrl_tpu_torch.fleet.autoscale import AutoscaleDecider
from handyrl_tpu_torch.models import init_variables
from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingServer

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60

SERVING_CFG = {
    "port": 0, "max_models": 3, "slo_ms": 2000.0, "shed_policy": "none", "max_batch": 8,
    "max_wait_ms": 1.0, "warm_buckets": [1, 4, 8], "queue_bound": 256, "recv_timeout": 0.0,
    "watch_interval": 0.0, "stats_interval": 0.0, "session_capacity": 64, "session_spill": 256,
}
FLEET_CFG = {"port": 0, "stats_poll_s": 0.2, "replica_stall_s": 5.0, "rejoin_backoff_s": 0.2,
             "rejoin_backoff_max_s": 1.0, "stats_interval": 0.0}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _env_model(name, seed=1):
    env = make_env({"env": name})
    module = init_variables(env.net(), seed)
    env.reset()
    return module, env.observation(env.players()[0]), module.state_dict()


def _start_server(module, obs, params, tmp_path, **overrides):
    cfg = dict(SERVING_CFG, **overrides)
    router = ModelRouter(module, obs, cfg, model_dir=str(tmp_path), devices=["cpu"])
    if params is not None:
        router.publish(1, params)
    return ServingServer(router, cfg).run()


def _fleet(ports, connect_timeout=10.0, **overrides):
    cfg = dict(FLEET_CFG, **overrides)
    cfg["replicas"] = [f"127.0.0.1:{p}" for p in ports]
    return FleetRouter(cfg).run(connect_timeout=connect_timeout)


def _wait_for(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _misses(stats):
    return sum(r["session_affinity_miss"] for r in stats["replicas"].values())


# -- the decider --------------------------------------------------------------

DECIDER_CFG = st.fixed_dictionaries({
    "min_replicas": st.integers(1, 3), "max_replicas": st.integers(3, 6),
    "shed_slo": st.sampled_from([0.0, 0.01, 0.1]), "depth_high": st.sampled_from([2.0, 8.0]),
    "depth_low": st.sampled_from([0.5, 1.0]), "scale_down_after_s": st.sampled_from([0.0, 2.0, 5.0]),
    "cooldown_s": st.sampled_from([0.0, 1.0, 2.0]),
})
TICK = st.tuples(st.floats(0.0, 3.0), st.integers(0, 7), st.integers(0, 2),
                 st.sampled_from([0.0, 0.005, 0.05, 0.5]), st.sampled_from([0.0, 0.7, 4.0, 20.0]))


@settings(max_examples=200, deadline=None)
@given(cfg=DECIDER_CFG, ticks=st.lists(TICK, min_size=1, max_size=30))
def test_decider_matches_the_jax_package(cfg, ticks):
    port, jax_decider = AutoscaleDecider(cfg), JaxAutoscaleDecider(cfg)
    now = 10.0
    for dt, replicas, warming, shed, depth in ticks:
        now += dt
        assert (port.decide(now, replicas, warming, shed, depth)
                == jax_decider.decide(now, replicas, warming, shed, depth))
        assert (port._calm_since, port._last_action_t) == (jax_decider._calm_since,
                                                          jax_decider._last_action_t)


def test_decider_hysteresis():
    d = AutoscaleDecider({"min_replicas": 1, "max_replicas": 3, "shed_slo": 0.01,
                          "depth_high": 8.0, "depth_low": 1.0, "scale_down_after_s": 5.0,
                          "cooldown_s": 2.0})
    assert d.decide(10.0, 1, 0, shed_rate=0.05, depth_mean=0.0) == "up"
    assert d.decide(11.0, 2, 0, shed_rate=0.05, depth_mean=0.0) is None     # cooldown
    assert d.decide(13.0, 2, 1, shed_rate=0.05, depth_mean=0.0) is None     # warming
    assert d.decide(14.0, 2, 0, shed_rate=0.05, depth_mean=0.0) == "up"
    assert d.decide(17.0, 3, 0, shed_rate=0.9, depth_mean=99.0) is None     # at max
    assert d.decide(17.5, 0, 0, shed_rate=0.0, depth_mean=0.0) == "up"      # the floor
    assert d.decide(30.0, 2, 0, shed_rate=0.0, depth_mean=0.0) is None
    assert d.decide(35.1, 2, 0, shed_rate=0.0, depth_mean=0.0) == "down"
    assert d.decide(50.0, 1, 0, shed_rate=0.0, depth_mean=0.0) is None      # never below


# -- warm-then-admit ------------------------------------------------------------


def test_cold_replica_is_warming_not_live_until_published(tmp_path):
    module, obs, params = _env_model("TicTacToe")
    warm = _start_server(module, obs, params, tmp_path / "warm")
    cold = _start_server(module, obs, None, tmp_path / "cold")
    fleet = _fleet([warm.bound_port, cold.bound_port], stats_poll_s=0.05)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        stats = client.stats()
        assert stats["fleet_replicas_live"] == 2 and stats["fleet_replicas_warming"] == 1
        for _ in range(6):
            assert client.infer(obs, timeout=TIMEOUT) is not None
        cold_rep = next(r for r in fleet._reps() if r.spec.port == cold.bound_port)
        assert not cold_rep.admitted and cold_rep.picked == 0
        cold.router.publish(1, params)
        _wait_for(lambda: cold_rep.admitted, 10.0, "the cold replica's admission")
        assert client.stats()["fleet_replicas_warming"] == 0
    finally:
        client.close()
        fleet.shutdown()
        warm.shutdown()
        cold.shutdown()


def test_fleet_refuses_to_serve_with_no_warm_replica(tmp_path):
    module, obs, _ = _env_model("TicTacToe")
    cold = _start_server(module, obs, None, tmp_path)
    try:
        with pytest.raises(ConnectionError, match="warm"):
            _fleet([cold.bound_port], connect_timeout=1.5, stats_poll_s=0.05)
    finally:
        cold.shutdown()


# -- the planned retire -----------------------------------------------------------


def test_planned_retire_migrates_sessions_bit_identical(tmp_path):
    module, obs, params = _env_model("Geister")
    # capacity 1: of a replica's two sessions one is resident, one spilled
    s1 = _start_server(module, obs, params, tmp_path / "a", session_capacity=1, session_spill=8)
    s2 = _start_server(module, obs, params, tmp_path / "b", session_capacity=1, session_spill=8)
    fleet = _fleet([s1.bound_port, s2.bound_port], stats_poll_s=5.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        sids = [client.open_session() for _ in range(4)]
        by_port = {}
        for sid in sids:
            by_port.setdefault(fleet._affinity[sid].spec.port, []).append(sid)
        assert sorted(len(v) for v in by_port.values()) == [2, 2], by_port
        migr_sids, ctrl_sids = by_port[s1.bound_port], by_port[s2.bound_port]
        for _ in range(3):
            for sid in sids:
                assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        miss0 = _misses(client.stats())
        victim = next(r for r in fleet._reps() if r.spec.port == s1.bound_port)
        assert fleet.retire(victim) == 2, "both tiers must travel"
        for sid in migr_sids:
            assert fleet._affinity[sid].spec.port == s2.bound_port
        migr_out = [client.infer(obs, sid=sid, timeout=TIMEOUT)["out"] for sid in migr_sids]
        ctrl_out = [client.infer(obs, sid=sid, timeout=TIMEOUT)["out"] for sid in ctrl_sids]
        for a, b in zip(migr_out, ctrl_out):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        stats = client.stats()
        survivor = stats["replicas"][f"127.0.0.1:{s2.bound_port}"]
        assert survivor["session_migrated_in"] == 2 and survivor["session_restored"] >= 2
        assert _misses(stats) - miss0 == 0, "a planned retire loses no session"
        assert stats["fleet_migrations"] == 1 and stats["fleet_sessions_migrated"] == 2
        assert stats["fleet_migration_ms"] > 0.0 and stats["fleet_replicas"] == 1
        assert fleet.retire(victim) == 0   # idempotent
    finally:
        client.close()
        fleet.shutdown()
        s1.shutdown()
        s2.shutdown()


def test_retire_without_successor_is_loud_not_wedged(tmp_path, capsys):
    module, obs, params = _env_model("Geister")
    s1 = _start_server(module, obs, params, tmp_path / "a")
    fleet = _fleet([s1.bound_port], stats_poll_s=5.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        sid = client.open_session()
        assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        t0 = time.monotonic()
        assert fleet.retire(fleet._reps()[0]) == 0
        assert time.monotonic() - t0 < 10.0, "retire must be bounded"
        assert sid not in fleet._affinity
        assert "no live successor" in capsys.readouterr().out
    finally:
        client.close()
        fleet.shutdown()
        s1.shutdown()


# -- scaling -------------------------------------------------------------------------


class _InProcFactory:
    """A replica factory of in-process servers."""

    def __init__(self, make_server):
        self._make = make_server
        self._servers = {}
        self.spawned = 0

    def spawn(self):
        server = self._make(self.spawned)
        self.spawned += 1
        spec = ReplicaSpec("127.0.0.1", server.bound_port)
        self._servers[spec.name] = server
        return spec

    def stop(self, spec):
        server = self._servers.pop(spec.name, None)
        if server is not None:
            server.shutdown()

    def close(self):
        servers, self._servers = dict(self._servers), {}
        for server in servers.values():
            server.shutdown()


def test_load_storm_scales_up_shed_free_and_back_down(tmp_path):
    # a recurrent net: the session scale-down migrates carries a state
    module, obs, params = _env_model("Geister")

    def make_server(n):
        # max_batch 1 keeps the queue depth visible under the storm
        return _start_server(module, obs, params, tmp_path / f"r{n}", max_batch=1,
                             max_wait_ms=0.0, warm_buckets=[1])

    factory = _InProcFactory(make_server)
    fleet = FleetRouter({
        "port": 0, "replicas": [], "stats_poll_s": 0.1, "replica_stall_s": 10.0,
        "rejoin_backoff_s": 0.2, "rejoin_backoff_max_s": 1.0, "stats_interval": 0.0,
        "autoscale": {"enabled": True, "min_replicas": 1, "max_replicas": 2, "interval_s": 0.1,
                      "shed_slo": 0.01, "depth_high": 2.0, "depth_low": 1.0,
                      "scale_down_after_s": 0.6, "cooldown_s": 0.2, "warm_timeout_s": 60.0},
    }, replica_factory=factory).run(connect_timeout=60.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    stop = threading.Event()
    errors, served = [], [0]

    def storm():
        c = ServingClient("127.0.0.1", fleet.bound_port)
        try:
            while not stop.is_set():
                futs = [c.submit(obs) for _ in range(4)]
                for f in futs:
                    try:
                        f.result(timeout=30)
                        served[0] += 1
                    except Exception as exc:
                        errors.append(repr(exc))
        finally:
            c.close()

    threads = [threading.Thread(target=storm, daemon=True) for _ in range(6)]
    try:
        assert client.stats()["fleet_replicas_live"] == 1
        for t in threads:
            t.start()
        _wait_for(lambda: fleet.scale_ups >= 1 and sum(
            1 for r in fleet._reps() if r.alive and r.admitted) >= 2,
            60.0, "storm scale-up to a second warm replica")
        stop.set()
        for t in threads:
            t.join(30)
        assert not errors, errors[:3]
        assert served[0] > 0
        stats = client.stats()
        assert sum(r.get("serve_shed") or 0 for r in stats["replicas"].values()) == 0
        victim = [r for r in fleet._reps() if r.spawned][-1]
        sid = None
        for _ in range(8):
            s = client.open_session()
            if fleet._affinity[s] is victim:
                sid = s
                break
        assert sid is not None, "no session landed on the newest replica"
        assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        miss0 = _misses(client.stats())
        _wait_for(lambda: fleet.scale_downs >= 1, 30.0, "calm scale-down")
        _wait_for(lambda: client.stats()["fleet_replicas_live"] == 1, 15.0, "the floor")
        assert fleet.sessions_migrated >= 1
        assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        assert _misses(client.stats()) - miss0 == 0, "scale-down loses no session"
    finally:
        stop.set()
        client.close()
        fleet.shutdown()
        factory.close()


def test_process_replica_factory_spawns_a_replica_the_router_admits(tmp_path):
    """A spawn-context serving process on the CPU: it reports its port,
    warms, is admitted, serves, and a scale-down's retire stops it."""
    args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
        "model_dir": str(tmp_path / "models"), "seed": 1,
        "serving": {"max_batch": 4, "warm_buckets": [1, 4], "stats_interval": 0}}})
    factory = ProcessReplicaFactory(args, device="cpu")
    fleet = FleetRouter(dict(FLEET_CFG, autoscale={"enabled": True, "min_replicas": 1,
                                                   "max_replicas": 2, "interval_s": 60.0}),
                        replica_factory=factory).run(connect_timeout=TIMEOUT)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    module, obs, _ = _env_model("TicTacToe")
    try:
        reply = client.infer(obs, timeout=TIMEOUT)
        assert reply["model"] == 0   # fresh weights from the seed, as id 0
        want = init_variables(make_env({"env": "TicTacToe"}).net(), 1)
        from handyrl_tpu_torch.models import InferenceModel

        np.testing.assert_allclose(reply["out"]["policy"],
                                   InferenceModel(want, device="cpu").inference(obs)["policy"],
                                   rtol=1e-5, atol=1e-5)
        (proc, _pipe), = factory._procs.values()
        assert proc.is_alive()
        assert fleet.scale_up()
        _wait_for(lambda: sum(1 for r in fleet._reps() if r.admitted) == 2, TIMEOUT,
                  "the second replica's admission")
        assert fleet.scale_down()
        _wait_for(lambda: len(factory._procs) == 1, TIMEOUT, "the retired replica's stop")
    finally:
        client.close()
        fleet.shutdown()
        factory.close()
    assert not factory._procs and not proc.is_alive()


# -- preemption -------------------------------------------------------------------------


REPLICA_CONFIG = """\
env_args: {env: Geister}
train_args:
  seed: 1
  model_dir: models
  drain_deadline_seconds: 20
  serving: {port: 0, max_models: 3, shed_policy: none, max_batch: 8, max_wait_ms: 1.0,
            warm_buckets: [1], stats_interval: 0, session_capacity: 64, session_spill: 256}
"""


def _spawn_replica_proc(cwd, fault_after=None):
    cwd.mkdir()
    (cwd / "config.yaml").write_text(REPLICA_CONFIG)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    env.pop("HANDYRL_FAULT_SIGTERM_REPLICA", None)
    if fault_after is not None:
        env["HANDYRL_FAULT_SIGTERM_REPLICA"] = str(fault_after)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, torch; torch.set_num_threads(2); "
                               "from handyrl_tpu_torch.main import main; "
                               "sys.exit(main(['--serve'], device='cpu'))"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port = [], [None]

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "listening on port" in line and port[0] is None:
                port[0] = int(line.split("listening on port")[1].split()[0])

    threading.Thread(target=reader, daemon=True).start()
    _wait_for(lambda: port[0] is not None or proc.poll() is not None, 120.0, "a replica's port")
    assert port[0] is not None, "\n".join(lines)
    return proc, port[0], lines


def test_preempted_replica_drains_sessions_and_exits_75(tmp_path):
    _, obs, _ = _env_model("Geister")
    steps_before_fault = 3
    victim, victim_port, victim_lines = _spawn_replica_proc(tmp_path / "victim",
                                                            fault_after=steps_before_fault)
    surv, surv_port, _ = _spawn_replica_proc(tmp_path / "survivor")
    fleet = client = None
    try:
        fleet = _fleet([victim_port, surv_port], connect_timeout=TIMEOUT, stats_poll_s=0.3)
        client = ServingClient("127.0.0.1", fleet.bound_port)
        sids = [client.open_session() for _ in range(2)]
        owners = {fleet._affinity[s].spec.port: s for s in sids}
        assert set(owners) == {victim_port, surv_port}
        migr_sid, ctrl_sid = owners[victim_port], owners[surv_port]
        for _ in range(steps_before_fault):
            assert client.infer(obs, sid=migr_sid, timeout=TIMEOUT)["sid"] == migr_sid
            assert client.infer(obs, sid=ctrl_sid, timeout=TIMEOUT)["sid"] == ctrl_sid
        t0 = time.monotonic()
        assert victim.wait(timeout=40.0) == 75, "\n".join(victim_lines)
        assert time.monotonic() - t0 < 25.0, "the drain must keep its deadline"
        _wait_for(lambda: fleet.preempt_drains >= 1, 10.0, "the router's preemption drain")
        _wait_for(lambda: fleet._affinity.get(migr_sid) is not None
                  and fleet._affinity[migr_sid].spec.port == surv_port, 20.0,
                  "affinity re-pinned to the survivor")
        a = client.infer(obs, sid=migr_sid, timeout=TIMEOUT)["out"]
        b = client.infer(obs, sid=ctrl_sid, timeout=TIMEOUT)["out"]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        stats = client.stats()
        assert stats["fleet_preempt_drains"] == 1 and stats["fleet_sessions_migrated"] >= 1
        survivor = stats["replicas"][f"127.0.0.1:{surv_port}"]
        assert survivor["session_migrated_in"] >= 1 and survivor["session_affinity_miss"] == 0
        assert any("FAULT sigterm_replica after 3 replies" in line for line in victim_lines)
        assert any("exiting 75 for relaunch" in line for line in victim_lines)
    finally:
        if client is not None:
            client.close()
        if fleet is not None:
            fleet.shutdown()
        for proc in (victim, surv):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def test_a_flushed_frame_survives_the_drain_closing_its_socket():
    """The drain closes a replica's sockets once its sessions are exported:
    ``QueueCommunicator.flush`` returns only when the export's frame is on
    the socket, so a transformer's hundreds of MB reach the router whole."""
    import socket

    from handyrl_tpu_torch.runtime.connection import FramedConnection, QueueCommunicator

    a, b = socket.socketpair()
    hub, peer = QueueCommunicator(), FramedConnection(b)
    conn = FramedConnection(a)
    hub.add_connection(conn)
    payload = {"sessions": {f"s{i}": np.full((1 << 20,), i, np.float32) for i in range(24)}}
    got = {}
    reader = threading.Thread(target=lambda: got.update(peer.recv()), daemon=True)
    reader.start()
    hub.send(conn, payload)
    assert hub.flush(conn, timeout=60.0)
    hub.disconnect(conn)   # what the drain's shutdown does next
    reader.join(60)
    assert sorted(got["sessions"]) == sorted(payload["sessions"])
    assert all(np.array_equal(got["sessions"][k], v) for k, v in payload["sessions"].items())
    assert not hub.flush(conn, timeout=1.0)   # gone: nothing to wait for
    peer.close()
