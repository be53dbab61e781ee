"""The port's server-resident session cache and sessions over the wire, on
the CPU (the port's versions of tests/test_fleet.py's session tests).

* ``SessionCache`` alone: open, store, LRU eviction to the host spill ring,
  restore bit for bit, affinity misses, close, export and adopt.  Each
  test runs with host-side states (``device=None``) and with states pinned
  as tensors on a device (``device="cpu"``, the path a card takes).
* Over the wire: a session replays the ship-the-state loop bit for bit and
  the wire carries no hidden state; sessions off is a loud bad_request.
* Against the JAX package: the JAX ``ModelRouter`` and ``ServingServer``
  and the port's, on the same weights (``convert.py``), answer the same
  session steps alike: the DRC ``GeisterNet`` and the transformer (d_model
  64, 2 heads, 2 layers, memory 16), 4 steps of 3 sessions each.
  Tolerance 1e-5 (fp32: the nets' parity tolerance, tests/test_torch_rnn.py
  and test_torch_transformer.py; batches of other sizes sum in other
  orders).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.serving import ModelRouter as JaxModelRouter
from handyrl_tpu.serving import ServingClient as JaxServingClient
from handyrl_tpu.serving import ServingServer as JaxServingServer
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.fleet import SessionCache
from handyrl_tpu_torch.models import InferenceModel, flax_to_state_dict, init_variables
from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingError, ServingServer

TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 60

SERVING_CFG = {
    "port": 0,
    "max_models": 3,
    "slo_ms": 2000.0,
    "shed_policy": "none",
    "max_batch": 4,
    "max_wait_ms": 1.0,
    "warm_buckets": [1, 4],
    "queue_bound": 256,
    "recv_timeout": 0.0,
    "watch_interval": 0.0,
    "stats_interval": 0.0,
    "session_capacity": 64,
    "session_spill": 256,
}
DEVICES = [None, "cpu"]


def _hidden(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 4).astype(np.float32), rng.randn(2).astype(np.float32))


def _equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# SessionCache (socket-free)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_roundtrip_and_lru_restore(device):
    cache = SessionCache(capacity=2, spill_capacity=8, device=device)
    sids = [cache.open() for _ in range(3)]
    assert len(set(sids)) == 3
    states = {sid: _hidden(i) for i, sid in enumerate(sids)}
    for sid, h in states.items():
        cache.store(sid, h)
    stats = cache.stats()
    assert stats["session_resident"] == 2
    assert stats["session_spilled"] == 1
    assert stats["session_evictions"] == 1
    h, status = cache.lookup(sids[0])
    assert status == "restored"
    if device is not None:
        assert all(torch.is_tensor(x) and x.device == torch.device(device) for x in h)
    _equal(h, states[sids[0]])
    stats = cache.stats()
    assert stats["session_restored"] == 1
    assert stats["session_resident"] == 2
    h2, status2 = cache.lookup(sids[0])
    assert status2 == "resident"
    _equal(h2, states[sids[0]])


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_close_releases_capacity(device):
    cache = SessionCache(capacity=1, spill_capacity=4, device=device)
    a, b = cache.open(), cache.open()
    cache.store(a, _hidden(1))
    cache.store(b, _hidden(2))  # evicts a to the spill ring
    assert cache.close(a) is True
    assert cache.close(a) is False
    assert cache.close(b) is True
    stats = cache.stats()
    assert stats["session_resident"] == 0
    assert stats["session_spilled"] == 0
    assert stats["session_closed"] == 2
    h, status = cache.lookup(a)
    assert h is None and status == "miss"
    assert cache.stats()["session_affinity_miss"] == 1


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_spill_overflow_drops_oldest(device):
    cache = SessionCache(capacity=1, spill_capacity=1, device=device)
    sids = [cache.open() for _ in range(3)]
    for i, sid in enumerate(sids):
        cache.store(sid, _hidden(i))
    stats = cache.stats()
    assert stats["session_resident"] == 1
    assert stats["session_spilled"] == 1
    assert stats["session_spill_drops"] == 1
    h, status = cache.lookup(sids[0])
    assert h is None and status == "miss"
    cache.store(sids[0], _hidden(9))
    h, status = cache.lookup(sids[0])
    assert status in ("resident", "restored")
    assert np.array_equal(np.asarray(h[0]), _hidden(9)[0])


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_overflow_miss_reopens_fresh_not_restore(device):
    """One loss event, one counted miss; the re-adopted sid is fresh, and
    its close counts as a real close."""
    cache = SessionCache(capacity=1, spill_capacity=1, device=device)
    sids = [cache.open() for _ in range(3)]
    for i, sid in enumerate(sids):
        cache.store(sid, _hidden(i))
    h, status = cache.lookup(sids[0])
    assert h is None and status == "miss"
    assert cache.stats()["session_affinity_miss"] == 1
    h, status = cache.lookup(sids[0])
    assert h is None and status == "fresh"
    stats = cache.stats()
    assert stats["session_affinity_miss"] == 1
    assert stats["session_restored"] == 0
    cache.store(sids[0], _hidden(9))
    closed_before = cache.stats()["session_closed"]
    assert cache.close(sids[0])
    assert cache.stats()["session_closed"] == closed_before + 1


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_store_drops_stale_spill_copy(device):
    cache = SessionCache(capacity=1, spill_capacity=4, device=device)
    a, b = cache.open(), cache.open()
    cache.store(a, _hidden(1))
    cache.store(b, _hidden(2))       # a evicted to the spill ring
    assert cache.stats()["session_spilled"] == 1
    cache.store(a, _hidden(3))       # a's stale spill copy dropped
    assert cache.stats()["session_spilled"] == 1
    h, status = cache.lookup(a)
    assert status == "resident"
    assert np.array_equal(np.asarray(h[0]), _hidden(3)[0])


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_export_adopt_is_zero_loss_and_bit_identical(device):
    src = SessionCache(capacity=1, spill_capacity=8, device=device)
    dst = SessionCache(capacity=4, spill_capacity=8, device=device)
    sids = [src.open() for _ in range(3)]
    states = {sid: _hidden(i) for i, sid in enumerate(sids)}
    for sid, h in states.items():
        src.store(sid, h)
    fresh_sid = src.open()
    shipped = src.export_all()
    assert set(shipped["sessions"]) == set(sids)
    assert shipped["fresh"] == [fresh_sid]
    # what leaves the cache is numpy: the codec carries no tensor
    assert all(isinstance(x, np.ndarray) for h in shipped["sessions"].values() for x in h)
    assert src.stats()["session_migrated_out"] == 3
    assert src.stats()["session_resident"] == 0
    assert src.stats()["session_spilled"] == 0
    _, status = src.lookup(sids[0])
    assert status == "miss"
    assert dst.adopt(shipped["sessions"], fresh=shipped["fresh"]) == 3
    assert dst.stats()["session_migrated_in"] == 3
    for sid in sids:
        h, status = dst.lookup(sid)
        assert status == "restored", f"{sid}: {status}"
        _equal(h, states[sid])
    assert dst.stats()["session_affinity_miss"] == 0
    h, status = dst.lookup(fresh_sid)
    assert h is None and status == "fresh"
    assert dst.stats()["session_affinity_miss"] == 0


@pytest.mark.parametrize("device", DEVICES)
def test_session_cache_adopt_overflow_is_counted_not_wedged(device):
    src = SessionCache(capacity=8, spill_capacity=8, device=device)
    sids = [src.open() for _ in range(4)]
    for i, sid in enumerate(sids):
        src.store(sid, _hidden(i))
    shipped = src.export_all()
    dst = SessionCache(capacity=8, spill_capacity=2, device=device)
    dst.adopt(shipped["sessions"], fresh=shipped["fresh"])
    stats = dst.stats()
    assert stats["session_spilled"] == 2
    assert stats["session_spill_drops"] == 2
    assert stats["session_migrated_in"] == 4


# ---------------------------------------------------------------------------
# sessions over the wire
# ---------------------------------------------------------------------------


def _port_model(env_args, seed=1):
    env = make_env(env_args)
    module = init_variables(env.net(), seed)
    env.reset()
    return module, env.observation(env.players()[0])


def _port_server(module, obs, tmp_path, **overrides):
    cfg = dict(SERVING_CFG, **overrides)
    router = ModelRouter(module, obs, cfg, model_dir=str(tmp_path), devices=["cpu"])
    router.publish(1, module.state_dict())
    return ServingServer(router, cfg).run()


def test_sessions_bit_identical_with_ship_state_and_lighter(tmp_path):
    """A server-resident session replays the ship-the-state loop bit for
    bit (serial, batch 1), while the wire carries no hidden state either
    way: the session leg is >= 5x lighter per request both ways."""
    module, obs = _port_model({"env": "Geister"})
    server = _port_server(module, obs, tmp_path)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        steps = 4
        hidden = InferenceModel(module, device="cpu").init_hidden()
        hidden = tuple(h.numpy() for h in hidden)
        shipped = []
        for _ in range(steps):
            out = client.infer(obs, hidden=hidden, timeout=TIMEOUT)["out"]
            hidden = out.pop("hidden")
            shipped.append(out)
        ship_sent, ship_recv = client.wire_bytes()

        sid = client.open_session()
        b0_sent, b0_recv = client.wire_bytes()
        sessioned = []
        for _ in range(steps):
            reply = client.infer(obs, sid=sid, timeout=TIMEOUT)
            assert reply["sid"] == sid
            assert "hidden" not in reply["out"]
            sessioned.append(reply["out"])
        s_sent = client.wire_bytes()[0] - b0_sent
        s_recv = client.wire_bytes()[1] - b0_recv

        for a, b in zip(shipped, sessioned):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert ship_sent / max(s_sent, 1) >= 5.0
        assert ship_recv / max(s_recv, 1) >= 5.0

        stats = client.stats()
        assert stats["session_opened"] == 1
        assert stats["session_resident"] == 1
        assert client.close_session(sid)["existed"] is True
        assert client.stats()["session_resident"] == 0
    finally:
        client.close()
        server.shutdown()


def test_session_disabled_is_a_loud_bad_request(tmp_path):
    module, obs = _port_model({"env": "TicTacToe"})
    server = _port_server(module, obs, tmp_path, session_capacity=0)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        with pytest.raises(ServingError) as err:
            client.open_session()
        assert err.value.kind == "bad_request"
        with pytest.raises(ServingError) as err:
            client.infer(obs, sid="s-nope", timeout=TIMEOUT)
        assert err.value.kind == "bad_request"
        assert client.infer(obs, timeout=TIMEOUT)["model"] == 1
    finally:
        client.close()
        server.shutdown()


def test_session_states_stay_on_the_engine_device_until_evicted(tmp_path):
    """Resident states are tensors on the engine's device; evicted ones are
    numpy on the host, and restore onto the device."""
    module, obs = _port_model({"env": "Geister"})
    server = _port_server(module, obs, tmp_path, session_capacity=2, session_spill=8)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        sids = [client.open_session() for _ in range(3)]
        for sid in sids:
            client.infer(obs, sid=sid, timeout=TIMEOUT)
        cache = server.sessions
        assert cache.device == torch.device("cpu")
        assert all(torch.is_tensor(x) for h in cache._resident.values() for x in h)
        assert all(isinstance(x, np.ndarray) for h in cache._spill.values() for x in h)
        client.infer(obs, sid=sids[0], timeout=TIMEOUT)
        stats = client.stats()
        assert stats["session_restored"] == 1 and stats["session_evictions"] == 2
    finally:
        client.close()
        server.shutdown()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _geister_obs(rng):
    return {"board": (rng.random((7, 6, 6)) < 0.3).astype(np.float32),
            "scalar": (rng.random(18) < 0.5).astype(np.float32)}


SESSION_NETS = {
    "drc": {"env": "Geister"},
    "transformer": {"env": "Geister", "net": "transformer",
                    "net_args": {"d_model": 64, "n_heads": 2, "n_layers": 2, "memory_len": 16}},
}


def _both_servers(env_args, tmp_path, seed=3):
    """The JAX package's router and server and the port's, one weight set."""
    jenv = jax_make_env(env_args)
    jmodule = jenv.net()
    params = jax_init_variables(jmodule, jenv, seed=seed)["params"]
    jenv.reset()
    obs = jenv.observation(0)
    jrouter = JaxModelRouter(jmodule, obs, SERVING_CFG, model_dir=str(tmp_path / "jax"),
                             devices=[jax.devices()[0]])
    jrouter.publish(1, params)
    jserver = JaxServingServer(jrouter, SERVING_CFG).run()
    module = make_env(env_args).net()
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    router = ModelRouter(module, obs, SERVING_CFG, model_dir=str(tmp_path / "port"),
                         devices=["cpu"])
    router.publish(1, module.state_dict())
    return jserver, ServingServer(router, SERVING_CFG).run()


def _session_trajectories(client, steps, n_sessions, seed):
    """``n_sessions`` sessions, ``steps`` pipelined steps each, the same
    seeded observations for every server."""
    rng = np.random.default_rng(seed)
    sids = [client.open_session() for _ in range(n_sessions)]
    outs = []
    for _ in range(steps):
        futs = [client.submit(_geister_obs(rng), sid=sid) for sid in sids]
        outs.append([f.result(timeout=TIMEOUT)["out"] for f in futs])
    return outs


@pytest.mark.parametrize("net", sorted(SESSION_NETS))
def test_session_steps_match_the_jax_server(net, tmp_path):
    jserver, server = _both_servers(SESSION_NETS[net], tmp_path)
    jclient = JaxServingClient("127.0.0.1", jserver.bound_port)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        want = _session_trajectories(jclient, 4, 3, seed=11)
        got = _session_trajectories(client, 4, 3, seed=11)
        for step_want, step_got in zip(want, got):
            for w, g in zip(step_want, step_got):
                assert set(w) == set(g) and "hidden" not in g
                for k in w:
                    np.testing.assert_allclose(g[k], np.asarray(w[k]), **TOL, err_msg=k)
        for c in (jclient, client):
            stats = c.stats()
            assert stats["session_opened"] == 3 and stats["session_resident"] == 3
            assert stats["serve_replies"] == 12 and stats["serve_errors"] == 0
    finally:
        jclient.close()
        client.close()
        jserver.shutdown()
        server.shutdown()


def test_clients_of_either_package_drive_either_server(tmp_path):
    """Wire compatibility: the JAX client drives the port's server and the
    port's client the JAX server, through infer, open_session and stats;
    the answers agree with the same package's client."""
    jserver, server = _both_servers(SESSION_NETS["drc"], tmp_path)
    rng = np.random.default_rng(5)
    obs = [_geister_obs(rng) for _ in range(3)]
    results = {}
    clients = []
    try:
        for tag, client_cls, port in (
            ("jax->jax", JaxServingClient, jserver.bound_port),
            ("port->jax", ServingClient, jserver.bound_port),
            ("port->port", ServingClient, server.bound_port),
            ("jax->port", JaxServingClient, server.bound_port),
        ):
            client = client_cls("127.0.0.1", port)
            clients.append(client)
            stateless = client.infer(obs[0], timeout=TIMEOUT)
            assert stateless["model"] == 1 and "hidden" in stateless["out"]
            sid = client.open_session()
            steps = [client.infer(o, sid=sid, timeout=TIMEOUT)["out"] for o in obs]
            stats = client.stats()
            assert stats["session_opened"] >= 1 and stats["serve_errors"] == 0
            results[tag] = [stateless["out"]] + steps
        for server_side in ("jax", "port"):
            a, b = results[f"jax->{server_side}"], results[f"port->{server_side}"]
            for x, y in zip(a, b):
                for k in ("policy", "value", "return"):
                    np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for x, y in zip(results["jax->jax"][1:], results["port->port"][1:]):
            for k in ("policy", "value", "return"):
                np.testing.assert_allclose(np.asarray(y[k]), np.asarray(x[k]), **TOL)
    finally:
        for client in clients:
            client.close()
        jserver.shutdown()
        server.shutdown()


def test_concurrent_sessions_keep_their_own_states(tmp_path):
    """Sessions interleaved from several connections at once (batches mix
    them in every order) each follow their own trajectory: each matches
    direct inference from its own hidden state."""
    module, _ = _port_model(SESSION_NETS["transformer"])
    rng = np.random.default_rng(9)
    obs = [[_geister_obs(rng) for _ in range(4)] for _ in range(6)]
    server = _port_server(module, obs[0][0], tmp_path, session_capacity=3)
    direct = InferenceModel(module, device="cpu")
    got = [None] * 6

    def play(i):
        client = ServingClient("127.0.0.1", server.bound_port)
        try:
            sid = client.open_session()
            got[i] = [client.infer(o, sid=sid, timeout=TIMEOUT)["out"] for o in obs[i]]
        finally:
            client.close()

    threads = [threading.Thread(target=play, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    server.shutdown()
    for i in range(6):
        hidden = direct.init_hidden()
        for o, g in zip(obs[i], got[i]):
            want = direct.inference(o, hidden)
            hidden = want["hidden"]
            np.testing.assert_allclose(g["policy"], want["policy"], **TOL)
            np.testing.assert_allclose(g["value"], want["value"], **TOL)
