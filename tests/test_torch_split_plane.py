"""The split device plane (``plane: split``) of the port against the JAX
package's, on the CPU.

* ``split_mesh`` over a device list carves as the JAX one (the learner keeps
  the prefix laid out by its spec, the actors the trailing ``actor_chips``)
  and refuses what it refuses, in its words; per rank the learner member
  keeps the rank's device and the actor members are local to the process,
  each with a dispatch lock of its own; a member that cannot make its CUDA
  stream raises.
* Dispatch locks (tests/test_plane.py's pair, on both packages): two
  members of one device (the learner's and an actor's) are inside their
  dispatches at once, as two JAX devices are; one member serializes;
  opposite-order sets never deadlock.
* ``PlaneParamCache`` versions only rise, with the JAX cache's refusal and
  byte count; ``RecordTransfer`` counts the bytes the JAX one counts;
  ``PlaneStats`` accumulates as the JAX one does; the gateway keeps a copy
  of a publish, never a reference to params that change in place.
* The split smoke (tests/test_plane.py's): two actor members fill the
  learner member's rings while it trains, the loss stays finite and the
  versions the actors see never fall; the rings then equal those of a JAX
  ``DeviceReplay`` fed the same records, leaf for leaf.
* The trainer publishes at the JAX trainer's cadence: a gateway-fed learner
  at ``param_refresh_updates: 2`` publishes exactly the versions JAX's
  ``_maybe_publish_params`` picks over the same steps.
* ``Learner`` under ``plane: split`` for two epochs writes the ``plane_*``
  keys the JAX learner writes, with both planes at work; one actor member
  plays the fused plane's games bit for bit.
* The watchdog's ladder, held against the JAX learner's own loop: restarts,
  then split -> fused, then out; a param lag past ``plane_param_lag_bound``
  is unhealthy in both; a rollout wedged after two blocks degrades a real
  split run to fused, which ends 0.
* The league's frozen opponents' engines go on the actor member (JAX:
  the actor mesh), on its stream and lock, and serve what the latest
  engine serves.
* Two processes under gloo, each carving its own actor member: both end
  0 with bit-equal params, and the coordinator's records carry the plane
  keys with both planes at work.
"""

import functools
import inspect
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs.vector_hungry_geese import VectorHungryGeese as JaxGeese
from handyrl_tpu.parallel import make_mesh as jax_make_mesh
from handyrl_tpu.parallel import split_mesh as jax_split_mesh
from handyrl_tpu.parallel.mesh import dispatch_serialized as jax_dispatch
from handyrl_tpu.runtime import device_replay as jax_replay_mod
from handyrl_tpu.runtime import plane as jax_plane
from handyrl_tpu.runtime.learner import Learner as JaxLearner
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import GeeseNet, init_variables
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.parallel.dispatch import dispatch_serialized
from handyrl_tpu_torch.parallel.mesh import PlaneMember, plane_members, split_mesh
from handyrl_tpu_torch.runtime import plane
from handyrl_tpu_torch.runtime.device_replay import DeviceReplay
from handyrl_tpu_torch.runtime.device_rollout import HostRecord, StreamingDeviceRollout
from handyrl_tpu_torch.runtime.learner import Learner

ROOT = Path(__file__).resolve().parent.parent
CHILD = str(Path(__file__).resolve().parent / "torch_mp_child.py")


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- the carve ------------------------------------------------------------------


def test_split_mesh_carves_a_device_list_as_jax():
    jdevs = jax.devices()[:4]
    names = [f"cpu:{i}" for i in range(4)]
    for spec, chips in (({"dp": 2}, 2), ({"dp": -1}, 1), ({"dp": 1}, 3)):
        jl, ja = jax_split_mesh(spec, chips, devices=jdevs)
        learner, actor = split_mesh(spec, chips, devices=names)
        assert [names[d.id - jdevs[0].id] for d in jl.devices.flat] == learner.devices
        assert [names[d.id - jdevs[0].id] for d in ja.devices.flat] == actor.devices
        assert dict(jl.shape) == learner.shape and dict(ja.shape) == actor.shape
    for chips, words in ((4, "at least one learner device"), (0, ">= 1")):
        for split in (functools.partial(jax_split_mesh, devices=jdevs),
                      functools.partial(split_mesh, devices=names)):
            with pytest.raises(ValueError, match=words):
                split(None, chips)


def test_split_mesh_per_rank_members():
    learner, actor = split_mesh({"dp": -1}, 2, device="cpu")
    (me,) = learner.local_members()
    actors = actor.local_members()
    assert me.role == "learner" and me.device == torch.device("cpu") and me.stream is None
    assert [(m.role, m.index, str(m.device)) for m in actors] == [("actor", 0, "cpu"),
                                                                   ("actor", 1, "cpu")]
    assert actor.shape == {"dp": 2}
    # one lock each: the learner's is its device's, the actors' their own
    assert len({m.lock_key for m in [me] + actors}) == 3 and me.lock_key == "cpu"
    # the JAX per-host carve's words when local_device_ids leaves no learner card
    words = "at least one learner device PER HOST"
    assert words in inspect.getsource(jax_split_mesh)
    with pytest.raises(ValueError, match=words):
        plane_members("cpu", 2, local_device_ids=[0, 1])
    # no card here: a member that cannot make its stream raises
    with pytest.raises(Exception):
        PlaneMember("cuda:0", "actor")


# -- dispatch locks (tests/test_plane.py:50-134) ----------------------------------


def _overlap(dispatch, targets, enqueue):
    """Two threads each inside a dispatch of its target at once (a barrier
    they can only pass together), or the errors of those that could not."""
    barrier = threading.Barrier(2, timeout=10.0)
    out, errs = {}, []

    def run(name, target):
        def call():
            barrier.wait()
            return enqueue(target)

        try:
            out[name] = dispatch(call, [target])
        except Exception as exc:
            errs.append(f"{name}: {exc!r}")

    threads = [threading.Thread(target=run, args=(n, t)) for n, t in zip("ab", targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    return out, errs


def _spans(dispatch, target, enqueue):
    spans = []

    def run():
        def call():
            t0 = time.perf_counter()
            time.sleep(0.05)
            r = enqueue(target)
            spans.append((t0, time.perf_counter()))
            return r

        dispatch(call, [target])

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    return sorted(spans)


def _jax_enqueue(device):
    return jax.device_put(np.float32(1.0), device) + 1


def _torch_enqueue(member):
    return torch.ones((), device=member.device) + 1


def test_disjoint_members_overlap_and_a_shared_member_serializes_as_jax_devices():
    learner, (actor,) = plane_members("cpu", 1)
    d0, d1 = jax.devices()[:2]
    for dispatch, targets, enqueue in ((jax_dispatch, (d0, d1), _jax_enqueue),
                                       (dispatch_serialized, (learner, actor), _torch_enqueue)):
        out, errs = _overlap(dispatch, targets, enqueue)
        assert not errs, errs
        assert float(out["a"]) == float(out["b"]) == 2.0
    for dispatch, target, enqueue in ((jax_dispatch, d0, _jax_enqueue),
                                      (dispatch_serialized, actor, _torch_enqueue)):
        (a0, a1), (b0, b1) = _spans(dispatch, target, enqueue)
        assert a1 <= b0, "dispatches of one member overlapped"
    # opposite-order member sets take the locks in one order: no deadlock
    done = []

    def run(members):
        dispatch_serialized(lambda: _torch_enqueue(members[0]), members)
        done.append(members)

    threads = [threading.Thread(target=run, args=(m,))
               for m in ([learner, actor], [actor, learner])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert len(done) == 2


# -- the flows --------------------------------------------------------------------


def test_param_cache_record_transfer_and_stats_count_as_jax():
    params = {"w": np.ones((4, 4), np.float32)}
    jcache = jax_plane.PlaneParamCache(jax_make_mesh({"dp": 1}, jax.devices()[-1:]))
    _, (actor,) = plane_members("cpu", 1)
    cache = plane.PlaneParamCache([actor])
    for c in (jcache, cache):
        with pytest.raises(RuntimeError, match="before first publish"):
            c.latest()
        c.publish(params, 0)
        c.publish(params, 8)
        for stale in (8, 3):
            with pytest.raises(ValueError, match="monotonically"):
                c.publish(params, stale)
    version, got = cache.latest(actor)
    assert version == jcache.latest()[0] == 8
    np.testing.assert_array_equal(got["w"].numpy(), params["w"])
    assert cache.refreshes == jcache.refreshes == 2
    assert cache.bytes_transferred == jcache.bytes_transferred == 2 * 4 * 4 * 4
    assert cache.lag(12) == jcache.lag(12) == 4 and cache.lag(8) == jcache.lag(8) == 0
    # the versions an actor reads never fall as publishes land
    seen = []
    for v in range(9, 15):
        cache.publish({"w": np.full((4, 4), v, np.float32)}, v)
        seen.append(cache.latest(actor)[0])
    assert seen == sorted(seen) and seen[-1] == 14

    rec = {"obs": np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3),
           "done": np.zeros((4, 8), np.bool_)}
    jl, _ = jax_split_mesh({"dp": 2}, 2, devices=jax.devices()[:4])
    learner, _ = plane_members("cpu", 1)
    jx, xfer = jax_plane.RecordTransfer(jl), plane.RecordTransfer(learner)
    jmoved, moved = jx(rec), xfer(rec)
    assert xfer.bytes_transferred == jx.bytes_transferred == 4 * 8 * 3 * 4 + 4 * 8
    for k in rec:
        np.testing.assert_array_equal(moved[k].numpy(), np.asarray(jmoved[k]))

    stats, jstats = plane.PlaneStats(), jax_plane.PlaneStats()
    for s in (stats, jstats):
        s.bump(actor_dispatches=1, param_lag_sum=3.0)
        s.bump(actor_dispatches=1, actor_busy_s=0.5, actor_idle_s=0.25)
    assert stats.snapshot() == jstats.snapshot()


def test_the_gateway_keeps_a_copy_of_params_that_change_in_place():
    gateway = plane.PlaneGateway({"plane_port": 1}, on_records=lambda r: None)
    w = torch.ones(3)
    gateway.publish({"w": w}, 2)
    w += 1   # the trainer's next step writes its params in place
    version, packed = gateway._packed_params()
    assert version == 2
    np.testing.assert_array_equal(plane._unpack_tree(packed)["w"], np.ones(3, np.float32))
    # with the split plane's cache as its inner, it serves the cache's copy
    _, (actor,) = plane_members("cpu", 1)
    inner = plane.PlaneParamCache([actor])
    gateway = plane.PlaneGateway({"plane_port": 1}, on_records=lambda r: None, inner=inner)
    gateway.publish({"w": w}, 4)
    w += 1
    assert inner.version == gateway.version == 4
    np.testing.assert_array_equal(plane._unpack_tree(gateway._packed_params()[1])["w"],
                                  np.full(3, 2.0, np.float32))
    assert gateway.bytes_transferred == inner.bytes_transferred == 12


# -- the split smoke (tests/test_plane.py:262-368) ----------------------------------


GEESE = {"turn_based_training": False, "observation": False, "batch_size": 4,
         "forward_steps": 4, "burn_in_steps": 0}


def _geese_args(normalize=normalize_args):
    cfg = normalize({"env_args": {"env": "HungryGeese"}, "train_args": GEESE})
    return dict(cfg["train_args"], env=cfg["env_args"])


def _assert_rings_equal(rings, jrings):
    jrings = jax.tree.map(np.asarray, jrings)
    assert rings["g"] == int(jrings["g"])
    for key in ("ep_start_g", "ep_end_g", "valid", "cur_start_g"):
        np.testing.assert_array_equal(rings[key].numpy(), jrings[key], err_msg=key)
    assert sorted(rings["rec"]) == sorted(jrings["rec"])
    for key, ring in rings["rec"].items():
        np.testing.assert_array_equal(ring.numpy(), jrings["rec"][key], err_msg=key)


def test_split_plane_smoke():
    """Two actor members fill the learner member's rings while it trains:
    both planes progress in one window, the loss stays finite, the versions
    the actors see never fall and advance; the rings equal JAX's fed the
    same records."""
    args = _geese_args()
    venv = make_env({"env": "HungryGeese"}).vector_env()
    module = init_variables(GeeseNet(filters=8, blocks=2), 0)
    learner, actors = plane_members("cpu", 2)
    lanes, k_steps, slots = 4, 8, 64
    rolls = [StreamingDeviceRollout(venv, module, args, n_lanes=lanes, k_steps=k_steps,
                                    device=m.device) for m in actors]
    gens = [torch.Generator().manual_seed(1 + i) for i in range(len(actors))]
    replay = DeviceReplay(venv, module, args, lanes * len(actors), slots=slots, device="cpu")
    xfer = plane.RecordTransfer(learner)
    cache = plane.PlaneParamCache(actors)
    cache.publish(module.state_dict(), 0)
    seen, fed = [], []

    def rollout():
        parts, blocks = [], []
        with torch.inference_mode():
            for member, roll, gen in zip(actors, rolls, gens):
                version, params = cache.latest(member)
                seen.append(version)
                with member.stream_context():
                    records = dispatch_serialized(lambda: roll.launch(params, gen), [member])
                    block = HostRecord(DeviceReplay._stats(records))
                parts.append(xfer(records, block.event))
                blocks.append(block)
            records = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
            fed.append({k: v.numpy().copy() for k, v in records.items()})
            with learner.stream_context():
                return dispatch_serialized(lambda: replay.ingest(records), [learner])

    deadline = time.monotonic() + 120.0
    while replay.eligible_count() < args["batch_size"]:
        rollout()
        assert time.monotonic() < deadline, "rings never became sampleable"
    ctx = TrainContext(module, args, "cpu")
    train = replay.train_fn(ctx, 1)
    gen = torch.Generator().manual_seed(2)
    metrics = train(gen, 1e-5)
    stop = threading.Event()
    prod = {"dispatches": 0, "error": None}

    def producer():
        try:
            while not stop.is_set():
                rollout()
                prod["dispatches"] += 1
        except Exception as exc:
            prod["error"] = repr(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    steps = 0
    try:
        while prod["dispatches"] < 2 or steps < 3:
            metrics = train(gen, 1e-5)
            steps += 1
            cache.publish(ctx.module.state_dict(), steps)
            assert time.monotonic() < deadline, f"planes never both progressed: {steps} {prod}"
            time.sleep(0.01)
    finally:
        stop.set()
        thread.join(timeout=60.0)
    assert prod["error"] is None, prod["error"]
    assert prod["dispatches"] >= 2 and steps >= 3
    assert np.isfinite(float(metrics["total"]))
    assert seen == sorted(seen) and seen[-1] > seen[0]
    # the learner's rings hold what JAX's rings hold after the same records
    jreplay = jax_replay_mod.DeviceReplay(
        JaxGeese, make_env({"env": "HungryGeese"}).net(), _geese_args(jax_normalize_args),
        jax_make_mesh({"dp": 1}), lanes * len(actors), slots=slots)
    for records in fed:
        jreplay.ingest(records)
    _assert_rings_equal(replay.rings, jreplay.rings)


# -- the learner --------------------------------------------------------------------


def _ptt(tmp_path, **train):
    """tests/test_plane.py:371-440's learner (ParallelTicTacToe, device
    replay), on one process."""
    return {"env_args": {"env": "ParallelTicTacToe"}, "train_args": dict({
        "plane": "split", "actor_chips": 1, "param_refresh_updates": 2,
        "turn_based_training": False, "observation": False, "batch_size": 8,
        "forward_steps": 4, "burn_in_steps": 0, "device_rollout_games": 8,
        "device_replay": True, "device_replay_slots": 64, "device_replay_k_steps": 16,
        "minimum_episodes": 20, "update_episodes": 30, "maximum_episodes": 400, "epochs": 2,
        "eval_rate": 0.0, "worker": {"num_parallel": 1},
        "model_dir": str(tmp_path / "models"), "metrics_path": str(tmp_path / "metrics.jsonl"),
    }, **train)}


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


PLANE_KEYS = ("plane_actor_busy_frac", "plane_actor_idle_frac", "plane_xfer_bytes_per_sec",
              "plane_param_lag_mean")


def test_learner_split_plane_two_epochs_writes_the_jax_plane_keys(tmp_path, capsys):
    cfg = _ptt(tmp_path)
    jax_normalize_args(cfg)   # the JAX package takes the same config
    learner = Learner(normalize_args(cfg), device="cpu")
    assert learner.run() == 0
    assert "device planes: split" in capsys.readouterr().out
    records = _records(tmp_path / "metrics.jsonl")
    assert [r["epoch"] for r in records] == [0, 1] and records[-1]["steps"] > 0
    assert all(r["plane"] == "split" and r["plane_watchdog_degraded"] == 0 for r in records)
    source = inspect.getsource(JaxLearner)
    for key in PLANE_KEYS + ("plane_watchdog_degraded",):
        assert key in source   # the JAX learner's own keys
    rows = [r for r in records if "plane_actor_busy_frac" in r]
    assert rows and all(k in r for k in PLANE_KEYS for r in rows)
    assert max(r["plane_actor_busy_frac"] for r in rows) > 0
    assert max(r["plane_xfer_bytes_per_sec"] for r in rows) > 0
    assert learner.trainer.stats["plane_param_refreshes"] > 1
    assert learner.trainer.param_cache.version > 0
    assert os.path.exists(tmp_path / "models" / "latest.ckpt")


def test_one_actor_member_plays_the_fused_planes_games():
    """One actor member's block is the fused plane's block from the same
    params and draws, bit for bit: the split moves the work, not the
    games."""
    args = dict(normalize_args({"env_args": {"env": "ParallelTicTacToe"},
                                "train_args": {"turn_based_training": False,
                                               "observation": False}})["train_args"])
    venv = make_env({"env": "ParallelTicTacToe"}).vector_env()
    module = init_variables(make_env({"env": "ParallelTicTacToe"}).net(), 0)
    _, (actor,) = plane_members("cpu", 1)
    cache = plane.PlaneParamCache([actor])
    cache.publish(module.state_dict(), 0)
    blocks = []
    for params in (module.state_dict(), cache.latest(actor)[1]):
        roll = StreamingDeviceRollout(venv, module, args, n_lanes=8, k_steps=16, device="cpu")
        gen = torch.Generator().manual_seed(7)
        with torch.inference_mode(), actor.stream_context():
            blocks.append([roll.launch(params, gen) for _ in range(3)])
    for fused, split in zip(*blocks):
        for k in fused:
            assert torch.equal(fused[k], split[k]), k


def _cadence_config(tmp_path, port):
    cfg = _ptt(tmp_path, plane="fused", minimum_episodes=8, update_episodes=48, epochs=3)
    cfg["train_args"]["distributed"] = {"coordinator_address": f"127.0.0.1:{port}",
                                        "num_processes": 1, "actor_hosts": 1,
                                        "plane_port": port}
    return cfg


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gateway_fed_learner_publishes_at_the_jax_trainers_cadence(tmp_path):
    """``param_refresh_updates: 2``: the trainer publishes to the gateway
    at exactly the versions the JAX trainer's ``_maybe_publish_params``
    picks over the same steps (not only at the epoch boundaries)."""
    from handyrl_tpu.runtime.trainer import Trainer as JaxTrainer

    cfg = _cadence_config(tmp_path, _free_port())
    jax_normalize_args(cfg)
    learner = Learner(normalize_args(cfg), device="cpu")
    gateway = learner._plane_gateway
    published = [gateway.version]
    publish = gateway.publish

    def recording(params, version):
        publish(params, version)
        published.append(int(version))

    gateway.publish = recording
    assert learner.run() == 0
    steps = learner.trainer.steps
    assert steps >= 4, steps

    class _Cache:   # the JAX rule over the same steps, one update per pull
        version = published[0]

        def publish(self, params, version):
            self.version = version
            jax_versions.append(version)

    jax_versions = [published[0]]
    jt = type("T", (), {"param_cache": _Cache(), "param_refresh": 2, "state": {"params": None},
                        "steps": 0})()
    for step in range(1, steps + 1):
        jt.steps = step
        JaxTrainer._maybe_publish_params(jt)
    assert published == jax_versions
    assert published[:3] == [0, 2, 4]
    # each boundary's record holds a version the cadence published
    records = _records(tmp_path / "metrics.jsonl")
    assert all(r["plane_param_version"] in published for r in records)
    assert published[-1] >= steps - 1


# -- the watchdog ---------------------------------------------------------------------


class _Lagging:
    def lag(self, steps):
        return 10


def _watchdog(cls, thread, lag_bound=0, cache=None):
    """A learner of ``cls`` holding only what the watchdog reads, a split
    plane of one restart, its restart and degrade faked; the watchdog's
    events once its loop returns."""
    lrn = object.__new__(cls)
    lrn.args = {"plane_stall_timeout": 0.2, "plane_max_restarts": 1,
                "plane_param_lag_bound": lag_bound}
    lrn.shutdown_flag = False
    lrn._drain_requested = False
    lrn._plane = "split"
    lrn._param_cache = cache
    lrn.trainer = type("T", (), {"steps": 20})()
    lrn._watchdog_events = {"plane_watchdog_stalls": 0, "plane_watchdog_restarts": 0,
                            "plane_watchdog_degraded": 0}
    lrn._rollout_progress_t = time.monotonic()
    lrn._rollout_dispatched = False
    lrn._rollout_thread = thread
    calls = {"restarts": 0, "degrades": 0}

    def restart():
        calls["restarts"] += 1
        lrn._watchdog_events["plane_watchdog_restarts"] += 1
        lrn._rollout_progress_t = time.monotonic()
        return thread

    def degrade():
        calls["degrades"] += 1
        lrn._watchdog_events["plane_watchdog_degraded"] = 1
        lrn._plane = "fused"

    lrn._start_rollout_thread = restart
    lrn._degrade_to_fused = degrade
    t = threading.Thread(target=lrn._watchdog_loop, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive(), "the watchdog never went through its ladder"
    lrn.shutdown_flag = True
    return calls, lrn._watchdog_events


@pytest.mark.parametrize("why", ["dead", "lagged"])
def test_watchdog_restarts_then_degrades_as_the_jax_learners(why):
    """A dead rollout thread, or an alive one whose params lag past
    plane_param_lag_bound: one restart, then split -> fused, then the
    watchdog gives up, in both packages alike."""
    if why == "dead":
        thread = threading.Thread(target=lambda: None)
        thread.start()
        thread.join()
        kwargs = {}
    else:
        stop = threading.Event()
        thread = threading.Thread(target=stop.wait, daemon=True)
        thread.start()
        kwargs = {"lag_bound": 5, "cache": _Lagging()}
    try:
        got = [_watchdog(cls, thread, **kwargs) for cls in (Learner, JaxLearner)]
    finally:
        if why == "lagged":
            stop.set()
    assert got[0] == got[1]
    calls, events = got[0]
    assert calls == {"restarts": 1, "degrades": 1}
    assert events["plane_watchdog_stalls"] >= 2 and events["plane_watchdog_degraded"] == 1


def test_wedged_split_plane_degrades_to_fused_and_finishes(tmp_path, monkeypatch):
    """tests/test_sentinel.py:525-560 on the port: a rollout wedged after two
    blocks trips the watchdog; with no restart budget the split degrades to
    fused, generates on the learner's device and completes its epochs."""
    monkeypatch.setenv("HANDYRL_FAULT_WEDGE_ROLLOUT", "2")
    # 3 epochs (110 episodes) need more than the 2 blocks before the wedge;
    # a 5 s bound keeps a loaded host's healthy fused plane from tripping it
    cfg = _ptt(tmp_path, plane_stall_timeout=5.0, plane_max_restarts=0, epochs=3)
    learner = Learner(normalize_args(cfg), device="cpu")
    assert learner.run() == 0
    last = _records(tmp_path / "metrics.jsonl")[-1]
    assert last["steps"] > 0 and last["plane"] == "fused"
    assert last["plane_watchdog_stalls"] >= 1 and last["plane_watchdog_degraded"] == 1
    assert learner._plane == "fused" and learner.trainer.param_cache is None
    assert all(np.isfinite(v) for v in last["loss"].values())


# -- the league's opponents -------------------------------------------------------------


def test_league_opponents_live_on_the_actor_member(tmp_path):
    from handyrl_tpu.envs import make_env as jax_make_env
    from handyrl_tpu.league.learner import LeagueLearner as JaxLeagueLearner
    from handyrl_tpu_torch.league.learner import LeagueLearner
    from handyrl_tpu_torch.runtime.checkpoint import save_epoch_snapshot

    # the JAX league: the router's devices are the actor mesh's
    jlrn = object.__new__(JaxLeagueLearner)
    _, jactor = jax_split_mesh(None, 1, devices=jax.devices()[:2])
    jcfg = jax_normalize_args(_ptt(tmp_path / "jax"))
    jlrn._actor_mesh, jlrn.args = jactor, dict(jcfg["train_args"], env=jcfg["env_args"])
    jlrn.module = jax_make_env({"env": "ParallelTicTacToe"}).net()
    jserver = jlrn._make_model_server(jcfg)
    try:
        assert jserver._router._devices == list(jactor.devices.flat)
    finally:
        jserver.stop()

    learner = LeagueLearner(normalize_args(_ptt(tmp_path / "port")), device="cpu")
    server = learner.model_server
    try:
        (actor,) = learner._actor_members
        assert server._router._devices == [actor]
        params = {k: v.detach().clone() for k, v in learner.module.state_dict().items()}
        save_epoch_snapshot(learner.args["model_dir"], 1, params, {"note": 1}, 1)
        server.publish(1, params)
        server.publish(2, params)
        env = make_env({"env": "ParallelTicTacToe"})
        env.reset()
        obs = env.observation(0)
        frozen = server.get(1).inference(obs)
        engine = server._router._engines[1]
        assert engine._member is actor and engine.device == actor.device
        latest = server.get(2).inference(obs)
        np.testing.assert_array_equal(frozen["policy"], latest["policy"])
    finally:
        server.stop()


# -- two processes (tests/test_multihost.py:1059) ------------------------------------------


def test_two_process_split_plane(tmp_path):
    port = _free_port()
    while port > 65000:
        port = _free_port()
    cfg = _ptt(tmp_path, mesh={"dp": -1}, plane_stall_timeout=600.0,
               model_dir="models", metrics_path="metrics.jsonl")
    cfg["train_args"]["distributed"] = {
        "coordinator_address": f"127.0.0.1:{port}", "num_processes": 2,
        "heartbeat_interval": 1.0, "heartbeat_timeout": 30.0, "initialization_timeout": 60.0,
        "health_port": _free_port()}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, CHILD, "cli"], cwd=str(tmp_path),
                              env=dict(env, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=150))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    codes = [p.returncode for p in procs]
    assert codes == [0, 0], "\n".join(f"--- rc {c}\n{o[-2000:]}\n{e[-3000:]}"
                                      for c, (o, e) in zip(codes, outs))
    for out, _ in outs:
        assert "device planes: split" in out
    crcs = [[line.split("crc32 ")[1] for line in out.splitlines() if "params crc32" in line]
            for out, _ in outs]
    assert len(crcs[0]) == len(crcs[1]) == 1 and crcs[0] == crcs[1]
    records = _records(tmp_path / "metrics.jsonl")
    assert records[-1]["dist_processes"] == 2
    rows = [r for r in records if "plane_actor_busy_frac" in r]
    assert rows and max(r["plane_actor_busy_frac"] for r in rows) > 0
    assert max(r["plane_xfer_bytes_per_sec"] for r in rows) > 0
