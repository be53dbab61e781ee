"""The port's shared-memory batcher processes and C fill, on the CPU: the
counterparts of tests/test_shm_pipeline.py and of tests/test_faults.py's
batcher supervision tests.

Batches from the C fill, from a reused (dirty) ring slot and from a batcher
process are bit-identical to the numpy fill and to the JAX package's
``make_batch`` on the same windows; the plane reaps its children and
unlinks its segment on every exit path, a SIGTERM'd learner's included; a
SIGKILL'd child is respawned, and past the restart budget the pipeline
degrades loudly to threads.
"""

import gc
import json
import os
import random
import signal
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from handyrl_tpu.runtime.batch import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, RandomModel
from handyrl_tpu_torch.runtime import batch as batch_mod
from handyrl_tpu_torch.runtime.batch import fill_batch, make_batch
from handyrl_tpu_torch.runtime.generation import Generator
from handyrl_tpu_torch.runtime.replay import EpisodeStore
from handyrl_tpu_torch.runtime.shm_batch import ShmBatchPipeline, slot_spec, slot_views
from handyrl_tpu_torch.runtime.trainer import BatchPipeline, make_pipeline
from handyrl_tpu_torch.utils import tree_leaves


def _targs(env="TicTacToe", **over):
    return normalize_args({"env_args": {"env": env}, "train_args": over})["train_args"]


def _gen_store(env_name, n, targs, seed=0):
    env = make_env({"env": env_name})
    env.reset()
    model = RandomModel.from_model(InferenceModel(env.net(), device="cpu"),
                                   env.observation(env.players()[0]))
    gen = Generator(env, targs)
    random.seed(seed)
    eps = []
    while len(eps) < n:
        ep = gen.generate({p: model for p in env.players()}, {"player": env.players()})
        if ep is not None:
            eps.append(ep)
    store = EpisodeStore(1000)
    store.extend(eps)
    return store, eps


def _assert_batches_identical(ref, got):
    assert set(ref) == set(got)
    for key in ref:
        ref_leaves, got_leaves = tree_leaves(ref[key]), tree_leaves(got[key])
        assert len(ref_leaves) == len(got_leaves), key
        for rl, gl in zip(ref_leaves, got_leaves):
            gl = np.asarray(gl)
            assert rl.dtype == gl.dtype and rl.shape == gl.shape, key
            assert rl.tobytes() == gl.tobytes(), f"{key}: bytes differ"


class _HostCtx:
    """put_batch stub on the CPU: deep copies, as a real copy to the card
    would, so a recycled slot never aliases a handed-out batch."""

    device = torch.device("cpu")

    def put_batch(self, batch, non_blocking=False, pinned=False):
        return {k: (v.copy() if isinstance(v, np.ndarray) else {kk: vv.copy() for kk, vv in v.items()})
                for k, v in batch.items()}

    def put_batches(self, batches, non_blocking=False, pinned=False):
        return [self.put_batch(b) for b in batches]


def _segment_linked(name):
    try:
        probe = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    probe.close()
    return True


def _wait_unlinked(name, seconds=15.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not _segment_linked(name):
            return True
        time.sleep(0.2)
    return False


# -- the C fill against numpy and the JAX package ------------------------------


@pytest.mark.parametrize("env,over,n", [
    ("TicTacToe", {"batch_size": 8, "forward_steps": 8, "burn_in_steps": 2}, 10),  # turn player
    ("TicTacToe", {"batch_size": 6, "forward_steps": 4, "observation": True}, 8),   # all players
    ("HungryGeese", {"batch_size": 4, "forward_steps": 8, "turn_based_training": False}, 4),
])
def test_c_fill_bit_identical_to_numpy_and_jax(monkeypatch, env, over, n):
    """Same windows through the C fill, the numpy fill and JAX make_batch:
    byte for byte the same batch (the simultaneous env draws its target
    player from ``random``, reseeded before each fill)."""
    targs = _targs(env, **over)
    store, _ = _gen_store(env, n, targs)
    fs, bs = targs["forward_steps"], targs["burn_in_steps"]
    windows = [store.sample_window(fs, bs, 4) for _ in range(targs["batch_size"])]
    assert batch_mod._fill_accel() is not None, "the C fill did not load"

    def fill(fn):
        random.seed(7)
        return fn(windows, targs)

    got = fill(make_batch)
    monkeypatch.setenv("HANDYRL_NO_FILL_ACCEL", "1")
    assert batch_mod._fill_accel() is None
    ref = fill(make_batch)
    _assert_batches_identical(ref, got)
    _assert_batches_identical(fill(jax_make_batch), got)


def test_fill_kernels_validate_bounds():
    acc = batch_mod._fill_accel()
    assert acc is not None
    dst = np.zeros((2, 4, 3), np.float32)
    src = np.ones((3, 3), np.float32)
    with pytest.raises(ValueError):
        acc.fill_column(dst, [0, 0, 0], [src, src, src])  # more windows than B
    with pytest.raises(ValueError):
        acc.fill_column(dst, [0, 2], [src, src])  # the second window overruns T
    with pytest.raises(ValueError):
        acc.fill_column(dst, [0], [np.ones((3, 4), np.float32)])  # row shape
    with pytest.raises(ValueError):
        acc.fill_column(dst, [0], [np.ones((3, 3), np.int32)])  # same width, other dtype
    with pytest.raises(ValueError):
        acc.fill_rows(dst, 0, 0, 5, np.ones((3,), np.float32))  # hi > T
    with pytest.raises(ValueError):
        acc.fill_rows(dst, 2, 0, 4, np.ones((3,), np.float32))  # b out of range
    acc.fill_column(dst, [1, 0], [src[:2], src])
    assert np.array_equal(dst[0, 1:3], src[:2]) and np.array_equal(dst[1, 0:3], src)
    row = np.full((3,), 7.0, np.float32)
    acc.fill_rows(dst, 0, 3, 4, row)
    assert np.array_equal(dst[0, 3], row)


def test_fill_batch_into_dirty_shm_slot_bit_identical():
    """A fill into a reused, garbage-filled slot equals a fresh make_batch:
    the per-slot reset restores every padding value."""
    targs = _targs(batch_size=6, forward_steps=8)
    store, _ = _gen_store("TicTacToe", 8, targs)
    windows = [store.sample_window(8, 0, 4) for _ in range(6)]
    ref = make_batch(windows, targs)
    spec, slot_bytes = slot_spec(ref)
    shm = shared_memory.SharedMemory(create=True, size=slot_bytes)
    try:
        views = slot_views(spec, shm.buf, 0)
        shm.buf[:slot_bytes] = bytes([0xAB]) * slot_bytes
        fill_batch(windows, targs, views)
        _assert_batches_identical(ref, views)
        fill_batch(windows, targs, views)  # over its own last batch
        _assert_batches_identical(ref, views)
        for leaf in tree_leaves(views):
            assert leaf.ctypes.data % 64 == 0  # every leaf on a cache line
    finally:
        views = None
        gc.collect()
        shm.close()
        shm.unlink()


# -- the process pipeline -------------------------------------------------------


def test_process_batcher_bit_identical_to_make_batch():
    """One short episode and forward_steps past its end make the window
    deterministic (train_start 0, the whole episode), so a batcher process's
    batch in shared memory equals make_batch here and the JAX package's."""
    targs = _targs(batch_size=2, forward_steps=16, num_batchers=1)
    store, eps = _gen_store("TicTacToe", 1, targs)
    assert eps[0]["steps"] <= 16
    windows = [store.sample_window(16, 0, 4) for _ in range(2)]
    ref = make_batch(windows, targs)
    _assert_batches_identical(jax_make_batch(windows, targs), ref)
    stop = threading.Event()
    pipe = ShmBatchPipeline(targs, store, _HostCtx(), stop)
    pipe.start()
    try:
        assert pipe._fallback is None, "the shm plane fell back to threads"
        got = pipe.batch()
        assert got is not None
        _assert_batches_identical(ref, got)
    finally:
        pipe.stop()


def test_process_pipeline_produces_and_cleans_up():
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=2)
    store, eps = _gen_store("TicTacToe", 8, targs)
    pipe = ShmBatchPipeline(targs, store, _HostCtx())
    pipe.start()
    assert pipe._fallback is None and not pipe.registered  # no card here
    shm_name = pipe._shm.name
    for _ in range(3):
        got = pipe.batch()
        assert got is not None and got["action"].dtype == np.int32
        assert got["observation"].shape[:2] == (4, 8) and float(got["episode_mask"].sum()) > 0
    store.extend(eps[:2])  # a live feed does not disturb the stream
    assert pipe.batch() is not None
    stats = pipe.stats()
    assert stats["mode"] == "shm" and stats["batches"] >= 4 and stats["assemble_s"] > 0
    assert stats["batcher_deaths"] == stats["batcher_fallback"] == 0
    pipe.stop()
    for proc in pipe._procs:
        assert not proc.is_alive(), "orphaned batcher process"
    assert not _segment_linked(shm_name)


def test_stop_event_alone_reaps_processes_and_shm():
    """Only the shared stop event is set, as the trainer does: the
    pipeline's own threads join the children and unlink the segment."""
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=2)
    store, _ = _gen_store("TicTacToe", 6, targs)
    stop = threading.Event()
    pipe = ShmBatchPipeline(targs, store, _HostCtx(), stop)
    pipe.start()
    assert pipe._fallback is None
    shm_name = pipe._shm.name
    assert pipe.batch() is not None
    stop.set()
    assert _wait_unlinked(shm_name), "shm segment still linked 15 s after the stop event"
    for proc in pipe._procs:
        proc.join(timeout=5)
        assert not proc.is_alive()


def test_fused_grouping_through_shm_pipeline():
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=1, fused_steps=2)
    store, _ = _gen_store("TicTacToe", 6, targs)
    pipe = ShmBatchPipeline(targs, store, _HostCtx())
    assert pipe._n_slots == max(6, 2 * 2 + 2)
    pipe.start()
    try:
        assert pipe._fallback is None
        group = pipe.batch()
        assert isinstance(group, list) and len(group) == 2
        assert pipe.stats()["batches"] >= 2
    finally:
        pipe.stop()


@pytest.mark.parametrize("nb", [2, 4])
def test_multi_batcher_slot_accounting(nb):
    """At 2 and 4 children every ring slot is dealt and consumed, recycled
    through its generation, and no (slot, generation) pair circulates
    twice."""
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=nb, shm_slots=5)
    store, _ = _gen_store("TicTacToe", 8, targs)
    pipe = ShmBatchPipeline(targs, store, _HostCtx())
    seen = []
    orig = pipe._ready_get

    def spy():
        item = orig()
        if item is not None:
            seen.append((item[0], int(pipe._slot_gen[item[0]])))
        return item

    pipe._ready_get = spy
    pipe.start()
    try:
        assert pipe._fallback is None
        n_slots = pipe._n_slots
        for _ in range(3 * n_slots):
            assert pipe.batch() is not None
        assert len(seen) >= 3 * n_slots
        assert len(set(seen)) == len(seen), "a slot generation was consumed twice"
        assert {s for s, _ in seen} == set(range(n_slots))
        assert pipe.stats()["batcher_deaths"] == 0
    finally:
        pipe.stop()


def test_sigkilled_batcher_child_is_respawned_and_batches_flow():
    """SIGKILL one child mid-run: batches keep flowing within 10 s, the
    death and the respawn show in the stats, and both children live."""
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=2,
                   batcher_max_restarts=3, batcher_stall_timeout=30.0)
    store, _ = _gen_store("TicTacToe", 8, targs)
    pipe = ShmBatchPipeline(targs, store, _HostCtx())
    pipe.start()
    try:
        assert pipe._fallback is None
        assert pipe.batch() is not None
        os.kill(pipe._procs[0].pid, signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        drained = 0
        while drained < 10 and time.monotonic() < deadline:
            assert pipe.batch() is not None, "the pipeline died after the SIGKILL"
            drained += 1
        assert drained >= 10
        while time.monotonic() < deadline and pipe.stats()["batcher_deaths"] < 1:
            pipe.batch()
            time.sleep(0.05)
        stats = pipe.stats()
        assert stats["batcher_deaths"] == 1 and stats["batcher_restarts"] == 1
        assert stats["mode"] == "shm" and stats["batcher_fallback"] == 0
        assert sum(p is not None and p.is_alive() for p in pipe._procs) == 2
    finally:
        pipe.stop()
    for proc in pipe._procs:
        assert proc is None or not proc.is_alive(), "orphaned batcher process"


def test_batcher_restart_budget_degrades_to_thread_pipeline():
    """Past ``batcher_max_restarts`` the plane hands over to the threaded
    pipeline, loudly: batches keep flowing, the mode flips, the counters
    say so, and the segment is unlinked."""
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=1,
                   batcher_max_restarts=0, batcher_stall_timeout=30.0)
    store, _ = _gen_store("TicTacToe", 8, targs)
    pipe = ShmBatchPipeline(targs, store, _HostCtx())
    pipe.start()
    shm_name = pipe._shm.name
    try:
        assert pipe.batch() is not None
        os.kill(pipe._procs[0].pid, signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and pipe.stats()["mode"] != "thread":
            assert pipe.batch() is not None
            time.sleep(0.05)
        stats = pipe.stats()
        assert stats["mode"] == "thread" and stats["batcher_fallback"] == 1.0
        assert stats["batcher_deaths"] >= 1
        for _ in range(3):
            assert pipe.batch() is not None, "the fallback pipeline does not produce"
        assert _wait_unlinked(shm_name, 10.0), "shm segment still linked after the degrade"
    finally:
        pipe.stop()


# -- factory and config ---------------------------------------------------------


def test_make_pipeline_mode_selection():
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=1)
    store, ctx = EpisodeStore(10), _HostCtx()
    assert isinstance(make_pipeline(targs, store, ctx), ShmBatchPipeline)
    assert isinstance(make_pipeline(dict(targs, batch_pipeline="thread"), store, ctx), BatchPipeline)
    assert isinstance(make_pipeline(dict(targs, num_batchers=0), store, ctx), BatchPipeline)


def test_config_validates_pipeline_knobs():
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    for bad in ({"batch_pipeline": "fiber"}, {"shm_slots": 1}, {"num_batchers": -1},
                {"num_batchers": 9, "shm_slots": 6}, {"fused_steps": 0},
                {"batcher_max_restarts": -1}, {"batcher_stall_timeout": 0}):
        with pytest.raises(ValueError):
            _targs(**bad)
        with pytest.raises(ValueError):  # the JAX package refuses the same
            jax_normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": bad})
    assert _targs(num_batchers=0)["num_batchers"] == 0
    assert _targs(num_batchers=9, shm_slots=9)["num_batchers"] == 9
    assert _targs()["batch_pipeline"] == "shm"
    from handyrl_tpu.config import effective_shm_slots as jax_slots
    from handyrl_tpu_torch.config import effective_shm_slots

    for train in ({}, {"shm_slots": 2}, {"fused_steps": 4}, {"shm_slots": 12, "fused_steps": 3}):
        assert effective_shm_slots(train) == jax_slots(train)


def test_thread_pipeline_reports_stage_stats():
    targs = _targs(batch_size=4, forward_steps=8, num_batchers=1, batch_pipeline="thread",
                   fused_steps=2)
    store, _ = _gen_store("TicTacToe", 6, targs)

    class Ctx(_HostCtx):
        def put_batches(self, batches, non_blocking=False, pinned=False):
            return ("group", len(batches))

    pipe = BatchPipeline(targs, store, Ctx())
    pipe.start()
    try:
        assert pipe.batch() == ("group", 2)  # fused groups on the thread plane too
        stats = pipe.stats()
        assert stats["mode"] == "thread" and stats["batches"] >= 2
        for key in ("sample_s", "assemble_s", "free_wait_s", "ready_wait_s", "put_s",
                    "batcher_deaths", "batcher_restarts", "batcher_fallback"):
            assert key in stats
    finally:
        pipe.stop()


# -- a learner on the shm plane -----------------------------------------------


def test_learner_on_shm_leaves_no_child_and_no_segment(tmp_path, monkeypatch):
    """A small CPU learner on the default pipeline: every record says 'shm'
    with no fault counted, and when it returns, no batcher child is alive
    and its segment is unlinked."""
    import multiprocessing as mp

    from handyrl_tpu_torch.runtime.learner import Learner

    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
            "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10, "update_episodes": 15,
            "maximum_episodes": 100, "epochs": 2, "num_batchers": 2, "eval_rate": 0.2,
            "worker": {"num_parallel": 2}}})
        learner = Learner(args, device="cpu")
        pipe = learner.trainer.batcher
        assert isinstance(pipe, ShmBatchPipeline)
        assert learner.run() == 0
    finally:
        torch.set_num_threads(threads)
    with open("metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[-1]["steps"] > 0
    trained = [r for r in records if "loss" in r]
    assert trained and all(r["pipeline"] == "shm" for r in records)
    for r in trained:
        assert r["pipe_batcher_deaths"] == r["pipe_batcher_fallback"] == 0
    assert pipe._shm is not None and not _segment_linked(pipe._shm.name)
    assert all(not p.is_alive() for p in pipe._procs)
    assert not [c for c in mp.active_children() if c.name.startswith("shm-batcher")]


_SIGTERM_LEARNER = """
import json, threading, time
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.runtime.learner import Learner
args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
    "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10, "update_episodes": 1000,
    "maximum_episodes": 100, "epochs": 5, "num_batchers": 2, "worker": {"num_parallel": 2}}})
learner = Learner(args, device="cpu")
threading.Thread(target=learner.run, daemon=True).start()
pipe = learner.trainer.batcher
while pipe.stats()["batches"] < 2:
    time.sleep(0.1)
print()  # a line of its own: the learner's episode counter may have left one open
print(json.dumps({"pids": [p.pid for p in pipe._procs], "shm": pipe._shm.name}), flush=True)
time.sleep(300)
"""


def test_sigterm_to_the_learner_leaves_no_child_and_no_segment():
    """The port has no SIGTERM drain: a SIGTERM ends the learner's process
    at once.  Its batchers see their parent gone and exit, and the resource
    tracker unlinks the segment once they have."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_LEARNER], cwd=root,
                            env={**os.environ, "PYTHONPATH": str(root)},
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        info = next(json.loads(line) for line in proc.stdout if line.startswith("{"))
        assert len(info["pids"]) == 2 and _segment_linked(info["shm"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    def gone(pid):  # exited: reaped, or a zombie of the new parent
        try:
            with open(f"/proc/{pid}/status") as f:
                return f.read().split("State:")[1].split()[0] == "Z"
        except FileNotFoundError:
            return True

    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        if all(gone(pid) for pid in info["pids"]) and not _segment_linked(info["shm"]):
            break
        time.sleep(0.2)
    assert all(gone(pid) for pid in info["pids"]), "a batcher outlived the SIGTERM'd learner"
    assert not _segment_linked(info["shm"]), "the segment outlived the SIGTERM'd learner"
