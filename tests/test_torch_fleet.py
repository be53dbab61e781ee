"""The port's fleet router (``fleet/router_tier.py``) over port replicas
(``ServingServer`` on the CPU): the port's versions of tests/test_fleet.py's
router tests, and the fleet against the JAX package.

* proxy and balance; bounded failover (a session request on a lost
  replica fails loudly, stateless traffic goes on, the session re-routes
  with a counted miss); the stateless retry, once; the fleet-wide swap;
  sessions and shipped hidden state kept off an ``edge``-tagged replica;
  the fleet keys validated as the JAX package validates them;
* parity: the same requests through the port's fleet and through a JAX
  ``ServingServer`` with the same converted weights give the same policy
  and value within 1e-5 (fp32: the serving parity tolerance of
  tests/test_torch_serving.py);
* a session through the fleet equals serving it directly, bit for bit;
* ``main(["--fleet"], device="cpu")`` fronts configured replicas and exits
  0 on SIGTERM.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.serving import ModelRouter as JaxModelRouter
from handyrl_tpu.serving import ServingServer as JaxServingServer
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.fleet import FleetRouter
from handyrl_tpu_torch.models import InferenceModel, flax_to_state_dict, init_variables
from handyrl_tpu_torch.models.inference import as_host_array
from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingError, ServingServer
from handyrl_tpu_torch.utils import tree_map

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
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
    cfg["replicas"] = [e if isinstance(e, dict) else f"127.0.0.1:{e}" for e in ports]
    return FleetRouter(cfg).run(connect_timeout=connect_timeout)


def _stop(*things):
    for thing in things:
        if thing is not None:
            (thing.close if isinstance(thing, ServingClient) else thing.shutdown)()


def test_router_proxies_and_balances(tmp_path):
    module, obs, params = _env_model("TicTacToe")
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    fleet = _fleet([s1.bound_port, s2.bound_port])
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        direct = InferenceModel(module, device="cpu").inference(obs)
        futs = [client.submit(obs) for _ in range(32)]
        for fut in futs:
            out = fut.result(timeout=TIMEOUT)
            assert out["model"] == 1
            np.testing.assert_allclose(out["out"]["policy"], direct["policy"], **TOL)
        stats = client.stats()
        assert stats["fleet_replies"] == 32 and stats["fleet_replicas_live"] == 2
        assert len(stats["replicas"]) == 2
        assert all(r["serve_replies"] >= 1 for r in stats["replicas"].values())
    finally:
        _stop(client, fleet, s1, s2)


def test_router_failover_is_bounded_and_survivors_serve(tmp_path):
    module, obs, params = _env_model("Geister")
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    # a 5 s poll cannot race the kill: the first request after it finds it
    fleet = _fleet([s1.bound_port, s2.bound_port], replica_stall_s=2.0, stats_poll_s=5.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        # the router serves once one replica is warm; the spread below is
        # decided by the polled load scores, so wait until both replicas are
        # admitted with equal scores (the pick then takes them in turn)
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            live = fleet._live(stateful=True)
            if len(live) == 2 and live[0].load == live[1].load:
                break
            time.sleep(0.05)
        sids = [client.open_session() for _ in range(2)]
        for sid in sids:
            assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        owners = {fleet._affinity[s].spec.port: s for s in sids}
        assert len(owners) == 2, "sessions should spread over both replicas"
        s1.shutdown()
        lost_sid = owners[s1.bound_port]
        t0 = time.monotonic()
        with pytest.raises(ServingError) as err:
            client.infer(obs, sid=lost_sid, timeout=15)
        assert err.value.kind == "replica_lost"
        assert time.monotonic() - t0 < 10.0, "failover must be bounded"
        for _ in range(4):
            assert client.infer(obs, timeout=15) is not None
        reply = client.infer(obs, sid=lost_sid, timeout=TIMEOUT)
        assert reply["sid"] == lost_sid
        stats = client.stats()
        assert stats["fleet_replicas_live"] == 1 and stats["fleet_replica_lost"] >= 1
        assert stats["replicas"][f"127.0.0.1:{s2.bound_port}"]["session_affinity_miss"] >= 1
    finally:
        _stop(client, fleet, s1, s2)


def test_router_retries_stateless_requests_once_on_replica_loss(tmp_path):
    module, obs, params = _env_model("TicTacToe")
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    fleet = _fleet([s1.bound_port, s2.bound_port], replica_stall_s=2.0, stats_poll_s=5.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        assert client.infer(obs, timeout=TIMEOUT) is not None
        victim = next(r for r in fleet._reps() if r.spec.port == s1.bound_port)
        for rep in fleet._reps():   # the next pick lands on the victim
            rep.load = 0.0 if rep is victim else 999.0
            rep.picked = 0
        s1.shutdown()
        assert client.infer(obs, timeout=15) is not None
        stats = client.stats()
        assert stats["fleet_failover_retries"] == 1 and stats["fleet_replicas_live"] == 1
        assert stats["fleet_errors"] == 0
    finally:
        _stop(client, fleet, s1, s2)


def test_fleet_wide_swap_flips_every_replica(tmp_path):
    module, obs, params = _env_model("TicTacToe")
    params2 = init_variables(make_env({"env": "TicTacToe"}).net(), 2).state_dict()
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    fleet = _fleet([s1.bound_port, s2.bound_port])
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        reply = client.swap(2, params=params2)
        assert reply["replicas"] == 2 and reply["warm_ms"] >= 0
        for _ in range(8):
            assert client.infer(obs, timeout=TIMEOUT)["model"] == 2
        assert client.stats()["fleet_hot_swaps"] == 1
    finally:
        _stop(client, fleet, s1, s2)


def test_router_keeps_stateful_routes_off_edge(tmp_path):
    """An ordinary port replica registered with the ``edge`` tag takes only
    feed-forward traffic: sessions and shipped hidden state land on the
    full replica, swaps skip it."""
    module, obs, params = _env_model("Geister")
    full = _start_server(module, obs, params, tmp_path / "full")
    edge = _start_server(module, obs, params, tmp_path / "edge")
    fleet = _fleet([full.bound_port,
                    {"host": "127.0.0.1", "port": edge.bound_port, "tags": ["edge"]}])
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        sids = [client.open_session() for _ in range(4)]
        assert all(not fleet._affinity[s].is_edge for s in sids)
        for sid in sids:
            assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        hidden = tree_map(as_host_array, InferenceModel(module, device="cpu").init_hidden())
        for _ in range(4):
            assert "hidden" in client.infer(obs, hidden=hidden, timeout=TIMEOUT)["out"]
        edge_stats = client.stats()["replicas"][f"127.0.0.1:{edge.bound_port}"]
        assert edge_stats["session_opened"] == 0 and edge_stats["session_resident"] == 0
        assert client.swap(2, params=params)["replicas"] == 1
        assert edge.router.latest_id() == 1 and full.router.latest_id() == 2
    finally:
        _stop(client, fleet, full, edge)


def _cfg(**fleet):
    return {"env_args": {"env": "TicTacToe"}, "train_args": {"fleet": fleet}}


@pytest.mark.parametrize("bad,match", [
    ({"replicas": ["nocolon"]}, "host:port"),
    ({"replicas": [{"port": 1}]}, "host.*port"),
    ({"replicas": [7]}, "must be a"),
    ({"stats_poll_s": 0}, "stats_poll_s"),
    ({"port": 70000}, "fleet.port"),
    ({"poll_retry_attempts": -1}, "poll_retry_attempts"),
    ({"rejoin_backoff_max_s": 0.5}, "rejoin_backoff_max_s"),
    ({"migrate_timeout_s": 0}, "migrate_timeout_s"),
    ({"autoscale": {"min_replicas": 0}}, "min_replicas"),
    ({"autoscale": {"max_replicas": 0}}, "max_replicas"),
    ({"autoscale": {"shed_slo": 2.0}}, "shed_slo"),
    ({"autoscale": {"depth_high": 0.5}}, "depth_high"),
    ({"autoscale": {"enabled": "yes"}}, "enabled"),
], ids=lambda v: str(v) if isinstance(v, str) else None)
def test_fleet_config_validation_matches_the_jax_package(bad, match):
    port, jax_args = normalize_args(_cfg())["train_args"], jax_normalize_args(_cfg())["train_args"]
    assert port["fleet"] == jax_args["fleet"] and port["trace"] == jax_args["trace"]
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
            normalize(_cfg(**bad))


def test_fleet_matches_a_jax_server_on_converted_weights(tmp_path):
    """The same seeded TicTacToe observations through the port's fleet (two
    port replicas) and through a JAX server, one weight set."""
    jenv = jax_make_env({"env": "TicTacToe"})
    jmodule = jenv.net()
    params = jax_init_variables(jmodule, jenv, seed=2)["params"]
    jenv.reset()
    obs = jenv.observation(0)
    jrouter = JaxModelRouter(jmodule, obs, SERVING_CFG, model_dir=str(tmp_path / "jax"),
                             devices=[jax.devices()[0]])
    jrouter.publish(1, params)
    jserver = JaxServingServer(jrouter, SERVING_CFG).run()
    module = make_env({"env": "TicTacToe"}).net()
    state = flax_to_state_dict(jax.tree.map(np.asarray, params))
    module.load_state_dict(state)
    s1 = _start_server(module, obs, state, tmp_path / "a")
    s2 = _start_server(module, obs, state, tmp_path / "b")
    fleet = _fleet([s1.bound_port, s2.bound_port])
    rng = np.random.default_rng(4)
    batch = [(rng.random((3, 3, 3)) < 0.4).astype(np.float32) for _ in range(24)]
    outs = {}
    try:
        for tag, port in (("jax", jserver.bound_port), ("fleet", fleet.bound_port)):
            client = ServingClient("127.0.0.1", port)
            try:
                futs = [client.submit(o) for o in batch]
                outs[tag] = [f.result(timeout=TIMEOUT) for f in futs]
            finally:
                client.close()
    finally:
        _stop(fleet, s1, s2, jserver)
    for want, got in zip(outs["jax"], outs["fleet"]):
        assert got["model"] == want["model"] == 1
        for k in ("policy", "value"):
            np.testing.assert_allclose(got["out"][k], np.asarray(want["out"][k]), **TOL)


def test_session_through_the_fleet_equals_direct_serving(tmp_path):
    """A Geister session served through the fleet and the same session
    served by a replica directly: the same outputs, bit for bit (serial,
    batch 1, one weight set)."""
    module, obs, params = _env_model("Geister")
    rng = np.random.default_rng(7)
    seq = [{"board": (rng.random((7, 6, 6)) < 0.3).astype(np.float32),
            "scalar": (rng.random(18) < 0.5).astype(np.float32)} for _ in range(5)]
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    direct = _start_server(module, obs, params, tmp_path / "direct")
    fleet = _fleet([s1.bound_port, s2.bound_port])
    try:
        outs = []
        for port in (fleet.bound_port, direct.bound_port):
            client = ServingClient("127.0.0.1", port)
            try:
                sid = client.open_session()
                outs.append([client.infer(o, sid=sid, timeout=TIMEOUT)["out"] for o in seq])
            finally:
                client.close()
        for got, want in zip(*outs):
            assert set(got) == set(want) and "hidden" not in got
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    finally:
        _stop(fleet, s1, s2, direct)


def test_cli_fleet_fronts_replicas_and_exits_on_sigterm(tmp_path):
    module, obs, params = _env_model("TicTacToe")
    s1 = _start_server(module, obs, params, tmp_path / "a")
    s2 = _start_server(module, obs, params, tmp_path / "b")
    (tmp_path / "config.yaml").write_text(
        "env_args: {env: TicTacToe}\n"
        "train_args:\n"
        "  metrics_path: fleet.jsonl\n"
        "  fleet:\n"
        "    port: 0\n"
        "    stats_poll_s: 0.2\n"
        "    stats_interval: 0.2\n"
        f"    replicas: ['127.0.0.1:{s1.bound_port}', '127.0.0.1:{s2.bound_port}']\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from handyrl_tpu_torch.main import main; "
                               "sys.exit(main(['--fleet'], device='cpu'))"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        deadline = time.monotonic() + TIMEOUT
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("fleet: entry port"):
                port = int(line.split()[3])
        assert port is not None, "".join(lines)
        client = ServingClient("127.0.0.1", port)
        assert client.infer(obs, timeout=TIMEOUT)["model"] == 1
        assert client.stats()["fleet_replicas_live"] == 2
        client.close()
        time.sleep(0.5)   # a metrics record or two
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        _stop(s1, s2)
    assert proc.returncode == 0, "".join(lines) + out
    assert "fleet: SIGTERM — shutting down" in out
    from handyrl_tpu_torch.utils.metrics import METRIC_KEYS, read_metrics

    records = read_metrics(str(tmp_path / "fleet.jsonl"))
    assert records and all(set(r) <= METRIC_KEYS for r in records)
    assert records[-1]["fleet_replies"] == 1
