"""The port's serving plane on the CPU: the continuous batcher, the model
router, the network server and client, ``--serve``, and the ``serving``
config block (the port's versions of tests/test_serving.py; the int8
engines and the flywheel's serving seams are held against JAX in
tests/test_torch_quantize.py and tests/test_torch_flywheel.py).

* The batcher against direct inference; expiry freeing its slot; shed-fast
  admission, the idle engine that admits, a bucket's first run kept out of
  the EMA; ``queue_bound``; malformed observations; ``shed_policy: none``;
  drain and stop; warm-up.
* The router: cold resolves at capacity one and under a burst (one load),
  ColdRoute, the stopped router, routing by id, ensembles, substitution,
  eviction that drains.
* The server: round trip and stats, shed over the wire, hot swap under load
  with nothing dropped, the cold pool, malformed frames, swap from disk,
  swap with inline params, the watcher, the metrics loop.
* Against the JAX package: its router and server and the port's on the
  same ``SimpleConvNet`` weights (``convert.py``) answer 16 seeded
  TicTacToe observations alike; tolerance 1e-5 (fp32, the net's parity
  tolerance in tests/test_torch_nets.py).  ``next_bucket`` and
  ``stack_padded`` against the JAX helpers.
* ``main(["--serve"], device="cpu")`` in a subprocess: it answers, and on
  SIGTERM drains its sessions to an ``export_sessions`` and exits 75.

Direct-inference tolerance: rtol 2e-4, atol 2e-5, as the JAX tests use.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, build_inference_model, init_variables
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.inference_engine import EngineStopped, next_bucket, stack_padded
from handyrl_tpu_torch.serving import (
    BadRequest,
    ContinuousBatcher,
    DeadlineExceeded,
    ModelRouter,
    RequestShed,
    RouteError,
    ServingClient,
    ServingError,
    ServingServer,
)
from handyrl_tpu_torch.serving.router import ColdRoute
from handyrl_tpu_torch.utils.metrics import METRIC_KEYS, read_metrics

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-5)
TIMEOUT = 60

SERVING_CFG = {
    "port": 0,
    "max_models": 3,
    "slo_ms": 2000.0,
    "shed_policy": "none",
    "max_batch": 8,
    "max_wait_ms": 1.0,
    "warm_buckets": [1, 4, 8],
    "queue_bound": 256,
    "recv_timeout": 0.0,
    "watch_interval": 0.0,
    "stats_interval": 0.0,
}


def _tictactoe():
    env = make_env({"env": "TicTacToe"})
    module = env.net()
    env.reset()
    return env, module, env.observation(0)


def _params(module, seed):
    """A state dict from ``seed`` (the module is re-initialised in place)."""
    return {k: v.clone() for k, v in init_variables(module, seed).state_dict().items()}


def _direct(module, params, obs):
    return build_inference_model(module, params, device="cpu").inference(obs)


def _batcher(module, params, **overrides):
    kwargs = dict(max_batch=8, max_wait_ms=1.0, slo_ms=2000.0, shed_policy="none",
                  queue_bound=256)
    kwargs.update(overrides)
    return ContinuousBatcher(build_inference_model(module, params, device="cpu"), ["cpu"],
                             **kwargs)


def _save(model_dir, epoch, params):
    ckpt.save_epoch_snapshot(str(model_dir), epoch, params, {"steps": 0}, 0)


def _router(module, obs, tmp_path, **overrides):
    return ModelRouter(module, obs, dict(SERVING_CFG, **overrides), model_dir=str(tmp_path),
                       devices=["cpu"])


# ---------------------------------------------------------------------------
# continuous batcher
# ---------------------------------------------------------------------------


def test_batcher_matches_direct():
    env, module, obs = _tictactoe()
    params = _params(module, 1)
    direct = _direct(module, params, obs)
    engine = _batcher(module, params).start()
    futs = [engine.submit(obs) for _ in range(16)]
    for fut in futs:
        np.testing.assert_allclose(fut.result(timeout=TIMEOUT)["policy"], direct["policy"], **TOL)
    assert engine.requests_served == 16
    assert engine.batches_served >= 1
    engine.stop()


def test_expired_request_frees_its_slot():
    """8 expired + 8 live admitted, max_batch 8: the expiries free their
    slots in one gather pass, so the live batch goes out whole."""
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), max_batch=8)
    now = time.monotonic()
    dead = [engine.submit(obs, deadline=now + 0.01) for _ in range(8)]
    live = [engine.submit(obs, deadline=now + 60.0) for _ in range(8)]
    time.sleep(0.05)
    engine.start()
    for fut in dead:
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=TIMEOUT)
    for fut in live:
        assert "policy" in fut.result(timeout=TIMEOUT)
    assert engine.deadline_misses == 8
    assert engine.requests_served == 8
    assert engine.batches_served == 1
    engine.stop()


def test_admission_controller_sheds_fast():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), shed_policy="deadline", slo_ms=10.0)
    engine._ema_batch_s = 0.05  # 50 ms a batch, one in flight: 10 ms is unservable
    engine._inflight = 1
    with pytest.raises(RequestShed):
        engine.submit(obs).result(timeout=5)
    assert engine.requests_shed == 1
    assert engine.requests_admitted == 0
    engine.stop()


def test_idle_engine_admits_despite_poisoned_ema():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), shed_policy="deadline", slo_ms=50.0).start()
    engine.warm((1,), obs)
    engine._ema_batch_s = 10.0  # 200x the budget: would shed forever
    for _ in range(20):
        assert "policy" in engine.submit(obs).result(timeout=TIMEOUT)
    assert engine.requests_shed == 0
    assert engine._ema_batch_s < 1.0  # healed (0.8 decay per batch)
    engine.stop()


def test_first_run_at_a_bucket_never_feeds_the_ema():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1)).start()
    assert engine.submit(obs).result(timeout=TIMEOUT)  # the first bucket-1 batch
    assert engine._ema_batch_s is None
    assert engine.submit(obs).result(timeout=TIMEOUT)
    assert engine._ema_batch_s is not None and engine._ema_batch_s < 1.0
    engine.stop()


def test_warm_runs_each_bucket_once_and_marks_it_timed():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 4)).start()
    ms = engine.warm((1, 2, 4, 8, 16), obs)  # 16 caps at max_batch 8
    assert ms > 0 and engine.buckets_warmed == [1, 2, 4, 8]
    assert engine._timed_buckets == {1, 2, 4, 8} and engine.batches_served == 0
    assert engine.submit(obs).result(timeout=TIMEOUT)
    assert engine._ema_batch_s is not None  # a warmed bucket samples at once
    engine.stop()


def test_queue_bound_sheds():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), shed_policy="queue", queue_bound=4)
    futs = [engine.submit(obs) for _ in range(5)]  # not started: the queue fills
    with pytest.raises(RequestShed):
        futs[-1].result(timeout=5)
    assert engine.requests_shed == 1
    engine.stop()
    for fut in futs[:-1]:
        with pytest.raises(EngineStopped):
            fut.result(timeout=5)


def test_malformed_obs_fails_only_its_own_request():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), template_obs=obs).start()
    bad = engine.submit(np.zeros((2, 2), np.float32))
    wrong_dtype = engine.submit(obs.astype(np.float64))
    good = [engine.submit(obs) for _ in range(4)]
    for fut in (bad, wrong_dtype):
        with pytest.raises(BadRequest):
            fut.result(timeout=10)
    for fut in good:
        assert "policy" in fut.result(timeout=TIMEOUT)
    engine.stop()


def test_malformed_hidden_fails_only_its_own_request():
    env = make_env({"env": "Geister"})
    module = init_variables(env.net(), 1)
    env.reset()
    obs = env.observation(0)
    engine = _batcher(module, module.state_dict(), template_obs=obs).start()
    good_hidden = tuple(h.numpy() for h in engine.model.init_hidden())
    bad = engine.submit(obs, hidden=(np.zeros(3, np.float32),))
    good = engine.submit(obs, hidden=good_hidden)
    with pytest.raises(BadRequest, match="recurrent"):
        bad.result(timeout=10)
    assert "hidden" in good.result(timeout=TIMEOUT)
    engine.stop()


def test_shed_policy_none_imposes_no_default_deadline():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1), shed_policy="none", slo_ms=10.0)
    fut = engine.submit(obs)
    time.sleep(0.1)  # 10x the slo in the queue
    engine.start()
    assert "policy" in fut.result(timeout=TIMEOUT)
    assert engine.deadline_misses == 0
    engine.stop()


def test_drain_and_stop_completes_admitted_work():
    env, module, obs = _tictactoe()
    engine = _batcher(module, _params(module, 1)).start()
    futs = [engine.submit(obs) for _ in range(24)]
    assert engine.drain_and_stop(timeout=60.0)
    for fut in futs:
        assert "policy" in fut.result(timeout=5)
    with pytest.raises(EngineStopped):
        engine.submit(obs).result(timeout=5)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def test_cold_resolve_survives_capacity_one(tmp_path):
    env, module, obs = _tictactoe()
    p1, p5 = _params(module, 1), _params(module, 5)
    _save(tmp_path, 1, p1)
    router = _router(module, obs, tmp_path, max_models=1)
    router.publish(5, p5)
    served, route = router.resolve(1)  # cold: disk load + warm + spawn
    assert served == 1
    out = route.submit(obs).result(timeout=TIMEOUT)  # not EngineStopped
    np.testing.assert_allclose(out["policy"], _direct(module, p1, obs)["policy"], **TOL)
    assert router.substituted == 0
    router.stop()


def test_concurrent_cold_resolves_pay_one_load(tmp_path):
    env, module, obs = _tictactoe()
    p1, p5 = _params(module, 1), _params(module, 5)
    _save(tmp_path, 1, p1)
    router = _router(module, obs, tmp_path)
    router.publish(5, p5)
    results = [None] * 8

    def resolve(i):
        served, route = router.resolve(1)
        results[i] = (served, route.submit(obs).result(timeout=TIMEOUT))

    threads = [threading.Thread(target=resolve, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    d1 = _direct(module, p1, obs)
    for served, out in results:
        assert served == 1
        np.testing.assert_allclose(out["policy"], d1["policy"], **TOL)
    assert router._spawned == 2  # latest + exactly one cold loader
    assert router.substituted == 0
    router.stop()


def test_stopped_router_refuses_cleanly(tmp_path):
    env, module, obs = _tictactoe()
    router = _router(module, obs, tmp_path)
    p1 = _params(module, 1)
    router.publish(1, p1)
    router.stop()
    with pytest.raises(RouteError, match="stopped"):
        router.resolve(-1)
    with pytest.raises(RouteError, match="stopped"):
        router.publish(2, p1)
    assert router.routes() == []


def test_cold_routes_raise_coldroute_when_disallowed(tmp_path):
    env, module, obs = _tictactoe()
    router = _router(module, obs, tmp_path)
    router.publish(5, _params(module, 1))
    for resident in (-1, 5, 99):
        assert router.resolve(resident, allow_cold=False)[0] == 5
    with pytest.raises(ColdRoute):
        router.resolve(0, allow_cold=False)
    with pytest.raises(ColdRoute):
        router.resolve(3, allow_cold=False)
    with pytest.raises(ColdRoute):
        router.resolve([5, 3], allow_cold=False)
    router.resolve(0)
    assert router.resolve(0, allow_cold=False)[0] == 0
    router.stop()


def test_fresh_start_watcher_picks_up_first_epoch(tmp_path):
    env, module, obs = _tictactoe()
    p0, p1 = _params(module, 1), _params(module, 2)
    router = _router(module, obs, tmp_path)
    router.publish(0, p0)
    assert router.maybe_refresh() is None
    _save(tmp_path, 1, p1)
    assert router.maybe_refresh() == 1
    assert router.latest_id() == 1
    router.stop()


def test_router_routes_by_model_id(tmp_path):
    env, module, obs = _tictactoe()
    p1, p2 = _params(module, 1), _params(module, 2)
    router = _router(module, obs, tmp_path)
    router.publish(1, p1)
    router.publish(2, p2)
    assert router.latest_id() == 2 and router.routes() == [1, 2]
    d1, d2 = _direct(module, p1, obs), _direct(module, p2, obs)
    for mid, want in ((-1, d2), (2, d2), (1, d1), (99, d2)):
        served, route = router.resolve(mid)
        out = route.submit(obs).result(timeout=TIMEOUT)
        np.testing.assert_allclose(out["policy"], want["policy"], **TOL)
        assert served == (2 if mid != 1 else 1)
    router.stop()


def test_router_engines_own_their_modules(tmp_path):
    """Each engine holds a module of its own built from the state dict: the
    router's template has no storage, and re-initialising the caller's
    module changes nothing that serves."""
    env, module, obs = _tictactoe()
    p1 = _params(module, 1)
    router = _router(module, obs, tmp_path)
    router.publish(1, p1)
    assert all(p.device.type == "meta" for p in router.module.parameters())
    engine = router._engines[1]
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(engine.model.module.parameters(), module.parameters()))
    before = engine.submit(obs).result(timeout=TIMEOUT)["policy"]
    init_variables(module, 7)
    np.testing.assert_array_equal(engine.submit(obs).result(timeout=TIMEOUT)["policy"], before)
    router.stop()


def test_router_ensemble_mean_pools(tmp_path):
    env, module, obs = _tictactoe()
    p1, p2 = _params(module, 1), _params(module, 2)
    router = _router(module, obs, tmp_path)
    router.publish(1, p1)
    router.publish(2, p2)
    d1, d2 = _direct(module, p1, obs), _direct(module, p2, obs)
    served, route = router.resolve([1, 2])
    out = route.submit(obs).result(timeout=TIMEOUT)
    assert served == (1, 2)
    np.testing.assert_allclose(out["policy"], (d1["policy"] + d2["policy"]) / 2.0, **TOL)
    router.stop()


def test_ensemble_refuses_hidden_state(tmp_path):
    env, module, obs = _tictactoe()
    router = _router(module, obs, tmp_path)
    router.publish(1, _params(module, 1))
    router.publish(2, _params(module, 2))
    _served, route = router.resolve([1, 2])
    with pytest.raises(BadRequest, match="recurrent"):
        route.submit(obs, hidden={"h": np.zeros(4)}).result(timeout=10)
    router.stop()


def test_router_substitution_is_counted(tmp_path):
    env, module, obs = _tictactoe()
    router = _router(module, obs, tmp_path)
    router.publish(5, _params(module, 1))
    served, _route = router.resolve(3)  # 3.ckpt does not exist
    assert served == 5
    assert router.substituted == 1
    assert router.stats()["substituted"] == 1
    router.stop()


def test_router_stage_promote_and_demote(tmp_path):
    """The promotion gate's moves: a staged candidate is addressable but
    latest does not flip; promotion flips it and keeps the incumbent; a
    demotion flips back and retires the regressed engine; a demoted
    candidate is retired without a flip."""
    env, module, obs = _tictactoe()
    p1, p2, p3 = _params(module, 1), _params(module, 2), _params(module, 3)
    router = _router(module, obs, tmp_path)
    router.publish(1, p1)
    assert router.stage(2, p2) > 0
    assert router.latest_id() == 1 and router.candidate_id() == 2
    assert router.resolve(-1)[0] == 1 and router.resolve(2)[0] == 2
    np.testing.assert_allclose(router.resolve(2)[1].submit(obs).result(timeout=TIMEOUT)["policy"],
                               _direct(module, p2, obs)["policy"], **TOL)
    assert router.promote_candidate() == 2
    assert router.latest_id() == 2 and router.incumbent_id() == 1
    assert router.demote_latest() == 1
    assert router.latest_id() == 1 and router.routes() == [1]
    router.stage(3, p3)
    assert router.demote_candidate() == 3 and router.routes() == [1]
    assert router.candidate_id() is None and router.promote_candidate() is None
    assert router.stats()["hot_swaps"] == 2
    router.stop()


def test_dispatch_locks_are_per_device_and_held_over_the_call():
    from handyrl_tpu_torch.parallel.dispatch import dispatch_serialized, locks_for

    (lock,) = locks_for(["cpu", torch.device("cpu")])
    assert locks_for(["cpu"]) == [lock] and len(locks_for(["cpu", "meta"])) == 2
    assert dispatch_serialized(lambda: lock.locked(), ["cpu"]) is True
    assert not lock.locked()
    with pytest.raises(ZeroDivisionError):
        dispatch_serialized(lambda: 1 / 0, ["cpu"])
    assert not lock.locked()  # released on the error path too


def test_router_eviction_drains_not_drops(tmp_path):
    env, module, obs = _tictactoe()
    router = _router(module, obs, tmp_path, max_models=2)
    engines = {}
    for mid in (1, 2, 3):
        router.publish(mid, _params(module, mid))
        if mid == 1:
            assert "policy" in router.resolve(1)[1].submit(obs).result(timeout=TIMEOUT)
        engines[mid] = router._engines.get(mid)
    assert router.latest_id() == 3
    assert 3 in router.routes() and len(router.routes()) == 2
    for t in list(router._retiring):
        t.join(30)
    evicted = engines[1]
    assert evicted is not None and evicted._stop.is_set()
    assert router.stats()["requests_served"] >= 1
    router.stop()


# ---------------------------------------------------------------------------
# the network server, and the hot-swap pin
# ---------------------------------------------------------------------------


def _start_server(module, obs, tmp_path, metrics_path=None, **overrides):
    cfg = dict(SERVING_CFG, **overrides)
    router = ModelRouter(module, obs, cfg, model_dir=str(tmp_path), devices=["cpu"])
    return router, ServingServer(router, cfg, metrics_path=metrics_path).run()


def test_server_roundtrip_and_stats(tmp_path):
    env, module, obs = _tictactoe()
    p1 = _params(module, 1)
    router, server = _start_server(module, obs, tmp_path)
    router.publish(1, p1)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        reply = client.infer(obs, timeout=TIMEOUT)
        assert reply["model"] == 1
        np.testing.assert_allclose(reply["out"]["policy"], _direct(module, p1, obs)["policy"],
                                   **TOL)
        ens = client.infer(obs, model=[1, 1], timeout=TIMEOUT)
        assert tuple(ens["model"]) == (1, 1)
        rnd = client.infer(obs, model=0, timeout=TIMEOUT)
        assert rnd["model"] == 0
        assert float(np.abs(np.asarray(rnd["out"]["policy"])).sum()) == 0.0
        stats = client.stats()
        assert stats["serve_replies"] >= 3
        assert stats["serve_models"] == 1
        assert stats["serve_p50_ms"] is not None
        assert stats["serve_snapshot_substituted"] == 0
        assert set(stats) <= METRIC_KEYS
    finally:
        client.close()
        server.shutdown()


def test_server_reports_shed_over_the_wire(tmp_path):
    env, module, obs = _tictactoe()
    router, server = _start_server(module, obs, tmp_path, shed_policy="deadline", slo_ms=50.0)
    router.publish(1, _params(module, 1))
    engine = router._engines[1]
    engine._ema_batch_s = 10.0
    engine._inflight = 1
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        with pytest.raises(ServingError) as err:
            client.infer(obs, slo_ms=5.0, timeout=TIMEOUT)
        assert err.value.kind in ("shed", "deadline")
        assert client.stats()["serve_shed"] >= 1
    finally:
        client.close()
        server.shutdown()


def test_hot_swap_under_load_drops_nothing(tmp_path):
    """Clients hammer the server across a hot swap: every request is
    answered, the flip is seen mid-run, nothing drops."""
    env, module, obs = _tictactoe()
    p1, p2 = _params(module, 1), _params(module, 2)
    router, server = _start_server(module, obs, tmp_path, shed_policy="none")
    router.publish(1, p1)
    stop = threading.Event()
    lock = threading.Lock()
    served_ids, submitted, failures = [], [0], []

    def hammer():
        client = ServingClient("127.0.0.1", server.bound_port)
        try:
            while not stop.is_set():
                with lock:
                    submitted[0] += 1
                try:
                    reply = client.infer(obs, timeout=TIMEOUT)
                    with lock:
                        served_ids.append(reply["model"])
                except Exception as exc:  # any failure is a dropped request
                    with lock:
                        failures.append(repr(exc))
                    return
        finally:
            client.close()

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    admin = ServingClient("127.0.0.1", server.bound_port)
    swap = admin.swap(2, params=p2)  # tensors, sent as numpy
    assert swap["id"] == 2 and swap["warm_ms"] > 0
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(30)
    admin.close()
    server.shutdown()
    assert not failures, failures[:5]
    assert len(served_ids) == submitted[0]
    assert set(served_ids) == {1, 2}
    assert served_ids[0] == 1 and served_ids[-1] == 2


def test_cold_model_served_over_the_wire(tmp_path):
    env, module, obs = _tictactoe()
    p1, p5 = _params(module, 1), _params(module, 5)
    _save(tmp_path, 1, p1)
    router, server = _start_server(module, obs, tmp_path)
    router.publish(5, p5)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        reply = client.infer(obs, model=1, timeout=120)
        assert reply["model"] == 1
        np.testing.assert_allclose(reply["out"]["policy"], _direct(module, p1, obs)["policy"],
                                   **TOL)
    finally:
        client.close()
        server.shutdown()


def test_malformed_frames_do_not_kill_the_dispatch_thread(tmp_path):
    from handyrl_tpu_torch.runtime.connection import connect_socket_connection

    env, module, obs = _tictactoe()
    router, server = _start_server(module, obs, tmp_path)
    router.publish(1, _params(module, 1))
    raw = connect_socket_connection("127.0.0.1", server.bound_port)
    try:
        raw.send(("infer", None))                      # payload not a dict
        raw.send(("infer", {"rid": 2, "obs": obs, "slo_ms": "soon"}))
        raw.send(("infer", {"rid": 3, "obs": None}))   # spec-violating obs
        raw.send(("no_such_request", {"rid": 4}))
        raw.send(("harvest_open", {"rid": 5}))         # the flywheel is not ported
        kinds = {}
        for _ in range(5):
            kind, data = raw.recv(timeout=30)
            assert kind == "error"
            kinds[data.get("rid")] = data["kind"]
        assert kinds[2] == kinds[3] == kinds[4] == kinds[5] == "bad_request"
    finally:
        raw.close()
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        assert client.infer(obs, timeout=TIMEOUT)["model"] == 1
    finally:
        client.close()
        server.shutdown()


def test_flywheel_frames_get_the_flywheel_off_answer(tmp_path):
    """The flywheel is not ported: the client sends its frames as the JAX
    client does, and the server answers each as the JAX server does with
    its flywheel off."""
    env, module, obs = _tictactoe()
    router, server = _start_server(module, obs, tmp_path)
    router.publish(1, _params(module, 1))
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        for call in (lambda: client.harvest_open([0, 1], ["a", "b"]),
                     lambda: client.harvest_step("h", [1, None], [[1], []], [0, 0], 0),
                     lambda: client.harvest_close("h", [1, -1]),
                     lambda: client.harvest_pull(),
                     lambda: client.report_outcome(1, 1.0)):
            with pytest.raises(ServingError, match="flywheel disabled") as err:
                call()
            assert err.value.kind == "bad_request"
        assert client.infer(obs, timeout=TIMEOUT)["model"] == 1
    finally:
        client.close()
        server.shutdown()


def test_swap_from_disk_verified(tmp_path):
    env, module, obs = _tictactoe()
    p1, p2 = _params(module, 1), _params(module, 2)
    _save(tmp_path, 7, p2)
    router, server = _start_server(module, obs, tmp_path)
    router.publish(1, p1)
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        assert client.swap(7)["id"] == 7
        reply = client.infer(obs, timeout=TIMEOUT)
        assert reply["model"] == 7
        np.testing.assert_allclose(reply["out"]["policy"], _direct(module, p2, obs)["policy"],
                                   **TOL)
        with pytest.raises(ServingError) as err:
            client.swap(8)  # no such snapshot
        assert err.value.kind == "swap_failed"
    finally:
        client.close()
        server.shutdown()


def test_watcher_hot_swaps_and_metrics_loop_writes_records(tmp_path):
    env, module, obs = _tictactoe()
    p1, p2 = _params(module, 1), _params(module, 2)
    metrics = tmp_path / "serve.jsonl"
    router, server = _start_server(module, obs, tmp_path / "models", metrics_path=str(metrics),
                                   watch_interval=0.1, stats_interval=0.2)
    router.publish(1, p1)
    _save(tmp_path / "models", 9, p2)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and router.latest_id() != 9:
        time.sleep(0.05)
    assert router.latest_id() == 9

    def records():
        return read_metrics(str(metrics)) if metrics.exists() else []

    # the loop's records, until one written after the swap
    while time.monotonic() < deadline and not any(r["serve_hot_swaps"] for r in records()):
        time.sleep(0.05)
    server.shutdown()
    written = records()
    assert written and all(set(r) <= METRIC_KEYS for r in written)
    assert written[-1]["serve_hot_swaps"] == 1 and "t_mono" in written[-1]


def test_read_metrics_tolerates_only_a_truncated_tail(tmp_path):
    path = tmp_path / "m.jsonl"
    path.write_text('{"serve_qps": 1.0}\n{"serve_qps": 2')
    assert read_metrics(str(path)) == [{"serve_qps": 1.0}]
    with pytest.raises(ValueError):
        read_metrics(str(path), strict=True)
    path.write_text('{"serve_qps": 1\n{"serve_qps": 2.0}\n')
    with pytest.raises(ValueError):
        read_metrics(str(path))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_router_and_server_match_the_jax_package():
    """The JAX router and server and the port's, on the same SimpleConvNet
    weights, answer 16 pipelined seeded observations alike (stateless)."""
    from handyrl_tpu.envs import make_env as jax_make_env
    from handyrl_tpu.models import init_variables as jax_init_variables
    from handyrl_tpu.serving import ModelRouter as JaxModelRouter
    from handyrl_tpu.serving import ServingServer as JaxServingServer
    from handyrl_tpu_torch.models import flax_to_state_dict

    jenv = jax_make_env({"env": "TicTacToe"})
    jmodule = jenv.net()
    params = jax_init_variables(jmodule, jenv, seed=2)["params"]
    jenv.reset()
    obs = jenv.observation(0)
    cfg = dict(SERVING_CFG, warm_buckets=[1, 8])
    jrouter = JaxModelRouter(jmodule, obs, cfg, model_dir=".", devices=[jax.devices()[0]])
    jrouter.publish(1, params)
    jserver = JaxServingServer(jrouter, cfg).run()
    env, module, _ = _tictactoe()
    router = ModelRouter(module, obs, cfg, model_dir=".", devices=["cpu"])
    router.publish(1, flax_to_state_dict(jax.tree.map(np.asarray, params)))
    server = ServingServer(router, cfg).run()
    rng = np.random.default_rng(4)
    batch = [(rng.random((3, 3, 3)) < 0.4).astype(np.float32) for _ in range(16)]
    outs = {}
    try:
        for tag, port in (("jax", jserver.bound_port), ("port", server.bound_port)):
            client = ServingClient("127.0.0.1", port)
            try:
                futs = [client.submit(o) for o in batch]
                outs[tag] = [f.result(timeout=TIMEOUT) for f in futs]
            finally:
                client.close()
    finally:
        jserver.shutdown()
        server.shutdown()
    for want, got in zip(outs["jax"], outs["port"]):
        assert got["model"] == want["model"] == 1
        assert set(got["out"]) == {"policy", "value"}
        for k in ("policy", "value"):
            np.testing.assert_allclose(got["out"][k], np.asarray(want["out"][k]),
                                       rtol=1e-5, atol=1e-5)


def test_bucket_and_padding_helpers_match_the_jax_package():
    from handyrl_tpu.runtime.inference_engine import next_bucket as jax_next_bucket
    from handyrl_tpu.runtime.inference_engine import stack_padded as jax_stack_padded

    for n in range(1, 70):
        assert next_bucket(n, 64) == jax_next_bucket(n, 64)
    rng = np.random.default_rng(0)
    obs = [{"board": rng.random((2, 3)).astype(np.float32), "scalar": rng.random(4)}
           for _ in range(3)]
    template = (np.zeros((2, 2), np.float32), np.zeros(5, np.float32))
    hidden = [None, tuple(rng.random(s).astype(np.float32) for s in ((2, 2), (5,))), None]
    want_obs, want_hidden = jax_stack_padded(obs, hidden, 4, template)
    torch_template = tuple(torch.as_tensor(t) for t in template)
    got_obs, got_hidden = stack_padded(obs, hidden, 4, torch_template)
    for k in want_obs:
        np.testing.assert_array_equal(got_obs[k], want_obs[k])
    for g, w in zip(got_hidden, want_hidden):
        assert torch.is_tensor(g)
        np.testing.assert_array_equal(g.numpy(), w)
    assert stack_padded(obs, [None] * 3, 4, None)[1] is None


# ---------------------------------------------------------------------------
# the CLI, the config block, the device
# ---------------------------------------------------------------------------

CLI_CONFIG = """
env_args:
  env: Geister
train_args:
  seed: 1
  model_dir: models
  metrics_path: metrics.jsonl
  drain_deadline_seconds: 20
  serving:
    port: 0
    max_batch: 4
    warm_buckets: [1, 4]
    stats_interval: 0
"""


@pytest.mark.parametrize("start", ["fresh", "snapshot"])
def test_cli_serves_and_drains_on_sigterm(tmp_path, start):
    """``main(["--serve"], device="cpu")`` from a config.yaml: it answers a
    request (fresh weights as model 0 with no snapshot, else the newest
    verified snapshot's), keeps a session, and on SIGTERM pushes the
    draining notice, hands its sessions to an ``export_sessions`` and exits
    75."""
    (tmp_path / "config.yaml").write_text(CLI_CONFIG)
    env_ = make_env({"env": "Geister"})
    env_.reset()
    obs = env_.observation(0)
    served = 0
    if start == "snapshot":
        module = init_variables(env_.net(), 4)
        _save(tmp_path / "models", 3, module.state_dict())
        want = InferenceModel(module, device="cpu").inference(obs)
        served = 3
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from handyrl_tpu_torch.main import main; "
                               "sys.exit(main(['--serve'], device='cpu'))"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.monotonic() + TIMEOUT
        port = None
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving: listening on port"):
                port = int(line.split()[4])
        assert port is not None, "".join(lines)
        assert f"(model {served}," in lines[-1] and "device cpu" in lines[-1]
        draining = threading.Event()
        client = ServingClient("127.0.0.1", port, on_notice=lambda kind, data: draining.set())
        reply = client.infer(obs, timeout=TIMEOUT)
        assert reply["model"] == served
        if start == "snapshot":
            np.testing.assert_allclose(reply["out"]["policy"], want["policy"], **TOL)
        sid = client.open_session()
        client.infer(obs, sid=sid, timeout=TIMEOUT)
        proc.send_signal(signal.SIGTERM)
        assert draining.wait(TIMEOUT)
        exported = client.export_sessions(timeout=TIMEOUT)
        assert exported["count"] == 1 and sid in exported["sessions"]
        out, _ = proc.communicate(timeout=TIMEOUT)
        client.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + out
    assert proc.returncode == 75, text
    assert "serving: SIGTERM — draining sessions (deadline 20s)" in text
    assert "sessions handed off: True" in text


@pytest.mark.parametrize("mode", ["--fleet", "--edge", "--league"])
def test_modes_still_refused_name_a10(mode, capsys, tmp_path, monkeypatch):
    """``--league`` exits 1 naming its ROADMAP A10 item.  ``--fleet`` and
    ``--edge`` are ported: neither is refused, and with no replica or no
    artifact configured each says so (tests/test_torch_fleet.py and
    tests/test_torch_export_edge.py run them)."""
    from handyrl_tpu_torch.main import main

    if mode == "--edge":
        monkeypatch.chdir(tmp_path)
        (tmp_path / "config.yaml").write_text("env_args: {env: TicTacToe}\n")
        with pytest.raises(ValueError, match="no edge artifact"):
            main([mode], device="cpu")
        assert "not ported" not in capsys.readouterr().out
        return
    if mode == "--fleet":
        monkeypatch.chdir(tmp_path)
        (tmp_path / "config.yaml").write_text("env_args: {env: TicTacToe}\n")
        with pytest.raises(ValueError, match="fleet.replicas is empty"):
            main([mode], device="cpu")
        assert "not ported" not in capsys.readouterr().out
        return
    assert main([mode], device="cpu") == 1
    assert "ROADMAP A10" in capsys.readouterr().out


def _cfg(**serving):
    return {"env_args": {"env": "TicTacToe"}, "train_args": {"serving": serving}}


def test_serving_config_validation():
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    port, jax_defaults = normalize_args(_cfg()), jax_normalize_args(_cfg())
    jax_serving = dict(jax_defaults["train_args"]["serving"])
    assert port["train_args"]["serving"] == jax_serving
    assert (port["train_args"]["drain_deadline_seconds"]
            == jax_defaults["train_args"]["drain_deadline_seconds"])
    for bad, match in ((dict(shed_policy="panic"), "shed_policy"),
                       (dict(warm_buckets=[3]), "warm_buckets"),
                       (dict(warm_buckets=[128], max_batch=64), "exceeds"),
                       (dict(slo_ms=0), "slo_ms"),
                       (dict(max_models=0), "max_models"),
                       (dict(port=70000), "port"),
                       (dict(watch_interval=-1), "watch_interval"),
                       (dict(session_spill=-1), "session_spill"),
                       (dict(weight_dtype="float16"), "weight_dtype")):
        for normalize in (normalize_args, jax_normalize_args):
            with pytest.raises(ValueError, match=match):
                normalize(_cfg(**bad))
    # int8 engines are ported: the value passes both packages
    for normalize in (normalize_args, jax_normalize_args):
        assert normalize(_cfg(weight_dtype="int8"))["train_args"]["serving"]["weight_dtype"] == "int8"
    with pytest.raises(ValueError, match="drain_deadline_seconds"):
        normalize_args({"env_args": {"env": "TicTacToe"},
                        "train_args": {"drain_deadline_seconds": 0}})


def test_int8_engines_are_refused_naming_a10():
    """int8 engines are ported (models/quantize.py, held against JAX in
    tests/test_torch_quantize.py): "int8" builds an int8-resident engine
    whose outputs equal an fp32 engine of the dequantized weights (1e-6);
    a dtype neither package knows is still refused."""
    from handyrl_tpu_torch.models.quantize import dequantize_params, quantize_params

    env, module, obs = _tictactoe()
    q = build_inference_model(module, module.state_dict(), "int8", device="cpu")
    assert all(t.dtype == torch.int8 for k, t in q.module.state_dict().items()
               if k.endswith("int8_q"))
    f = build_inference_model(module, dequantize_params(quantize_params(module.state_dict())),
                              device="cpu")
    got, want = q.inference(obs), f.inference(obs)
    for key in ("policy", "value"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="weight_dtype"):
        build_inference_model(module, module.state_dict(), "float16", device="cpu")


@pytest.mark.parametrize("entry", ["router", "serve_main"])
def test_serving_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path, entry):
    """The router and ``--serve`` run on the card; without one they raise,
    saying so, and run on the CPU only when asked."""
    from handyrl_tpu_torch.serving import serve_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, module, obs = _tictactoe()
    if entry == "router":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelRouter(module, obs, SERVING_CFG, model_dir=str(tmp_path))
        ModelRouter(module, obs, SERVING_CFG, model_dir=str(tmp_path), devices=["cpu"])
    else:
        args = normalize_args({"env_args": {"env": "TicTacToe"},
                               "train_args": {"model_dir": str(tmp_path)}})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_main(args)
