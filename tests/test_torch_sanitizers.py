"""The port's runtime sanitizers (``handyrl_tpu_torch/utils/sanitizers.py``)
on the CPU, one counterpart for each non-slow test of
``tests/test_sanitizers.py``.

Units pin the instrumentation (counting, the named site, the allowlist,
the restore, even when the body raises); the window test arms both
sanitizers around the port's ``batch_pipeline: device`` window: 4
``batch()`` calls and 4 train steps, with no blocking host sync and no
build, and a deliberate leak in the same window named by this file and
its line.  On the CPU every call of an instrumented entry point counts:
it is where the card would wait.
"""

import inspect
import random
import threading

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.ops import cuda_build
from handyrl_tpu_torch.parallel.dispatch import dispatch_serialized
from handyrl_tpu_torch.utils.sanitizers import (
    DEFAULT_ALLOWED_SITES, HostSyncSanitizer, RecompileSentinel,
)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- RecompileSentinel --------------------------------------------------------------


@pytest.fixture
def fake_kernel(tmp_path, monkeypatch):
    """A CudaKernel over a source in tmp_path, built by a stand-in for nvcc
    into a build dir in tmp_path (no toolkit here)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "k.cu"
    source.write_text("// v1\n")
    return cuda_build.CudaKernel(str(source), "k_entry", [])


def test_recompile_sentinel_quiet_on_warm_path(fake_kernel):
    fake_kernel.build()  # warm: the library of this source exists
    with RecompileSentinel() as sentinel:
        for _ in range(3):
            fake_kernel.build()
    sentinel.assert_no_recompiles("warm build")
    assert sentinel.count == 0


def test_recompile_sentinel_counts_and_names_the_site(fake_kernel):
    fake_kernel.build()
    orig = cuda_build.CudaKernel.build
    with RecompileSentinel() as sentinel:
        fake_kernel.source.write_text("// v2\n")   # an edited source: a new build
        fake_kernel.build()
    assert sentinel.count == 1 and sentinel.events[0].source == "k.cu"
    report = sentinel.report()
    assert "test_torch_sanitizers.py" in report, report
    with pytest.raises(AssertionError, match="compilation"):
        sentinel.assert_no_recompiles("source drift")
    # disarmed and restored outside the window
    assert cuda_build.CudaKernel.build is orig
    fake_kernel.source.write_text("// v3\n")
    fake_kernel.build()
    assert sentinel.count == 1


# -- HostSyncSanitizer --------------------------------------------------------------


def test_host_sync_sanitizer_clean_on_async_dispatch():
    x = torch.ones(3)
    with HostSyncSanitizer() as sync:
        y = x + 1
        y = torch.where(y > 1, y * 2, y)
    sync.assert_clean("pure dispatch")
    assert y.sum().item() == 12.0  # outside the window: not recorded
    assert sync.count == 0


def test_host_sync_sanitizer_names_every_entry_point():
    originals = {name: vars(torch.Tensor).get(name) for name in ("item", "__array__", "cpu")}
    x = torch.arange(3.0)
    with HostSyncSanitizer() as sync:
        x[0].item()
        x.tolist()
        x.cpu()
        x.numpy()
        np.asarray(x)        # __array__, and inside it numpy(): counted once
        float(x[1]), int(x[1]), bool(x[1])
        for call in (torch.cuda.synchronize, lambda: torch.cuda.Event().synchronize(),
                     lambda: torch.cuda.Stream().synchronize()):
            try:
                call()
            except (RuntimeError, AssertionError, AttributeError):
                pass         # no card here: the call is counted before it fails
    kinds = {e.kind: e.count for e in sync.events}
    for kind in ("item", "tolist", "cpu", "numpy", "__array__", "__float__", "__int__",
                 "__bool__", "cuda.synchronize"):
        assert kind in kinds, sync.report()
    assert kinds["numpy"] == 1 and kinds["__array__"] == 1
    report = sync.report()
    assert "test_torch_sanitizers.py" in report and "MainThread" in report, report
    with pytest.raises(AssertionError, match="blocking host sync"):
        sync.assert_clean()
    # every patch restored: the class's own attributes back, the inherited ones gone
    assert {name: vars(torch.Tensor).get(name) for name in originals} == originals
    assert torch.cuda.synchronize.__module__ == "torch.cuda"


def test_host_sync_sanitizer_attributes_threads_and_restores_on_raise():
    x = torch.ones(2)
    item = torch.Tensor.item
    with pytest.raises(ZeroDivisionError):
        with HostSyncSanitizer() as sync:
            t = threading.Thread(target=lambda: x.sum().item(), name="rollout-7")
            t.start()
            t.join()
            1 / 0
    assert [e.thread for e in sync.events] == ["rollout-7"]
    assert torch.Tensor.item is item and "item" not in vars(torch.Tensor)


def test_host_sync_sanitizer_allows_dispatch_lock_block():
    """A sync whose immediate caller is the dispatch lock's holder is
    allowlisted by default (the JAX package's site, kept alike), and still
    visible in the report; the port's lock itself never syncs."""
    assert DEFAULT_ALLOWED_SITES == (("parallel/dispatch.py", "dispatch_serialized"),)
    x = torch.ones(3)
    with HostSyncSanitizer() as sync:
        dispatch_serialized(lambda: x + 5, ["cpu"])
    assert not sync.events and not sync.allowed_events
    with HostSyncSanitizer() as sync:
        dispatch_serialized(x.sum().item, ["cpu"])
    sync.assert_clean("locked dispatch")
    assert sync.allowed_events and "allowed" in sync.report()


# -- the batch_pipeline: device window ----------------------------------------------


def _device_pipeline():
    """A live DeviceBatchPipeline and TrainContext over host-born HungryGeese
    episodes, on the CPU."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import RandomModel
    from handyrl_tpu_torch.models.nets import GeeseNet
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime.device_batch import DeviceBatchPipeline
    from handyrl_tpu_torch.runtime.generation import Generator
    from handyrl_tpu_torch.runtime.replay import EpisodeStore

    random.seed(11)
    cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": {
        "turn_based_training": False, "observation": False, "batch_size": 4,
        "forward_steps": 8, "batch_pipeline": "device", "device_stage_lanes": 2,
        "device_stage_chunk": 4, "device_stage_slots": 256}})
    args = dict(cfg["train_args"], env=cfg["env_args"])
    env = make_env({"env": "HungryGeese"})
    model = RandomModel({"policy": ((4,), np.float32), "value": ((1,), np.float32)})
    gen = Generator(env, args)
    players = env.players()
    episodes = []
    while len(episodes) < 8:
        ep = gen.generate({p: model for p in players},
                          {"player": players, "model_id": {p: 1 for p in players}})
        if ep is not None:
            episodes.append(ep)
    store = EpisodeStore(100)
    ctx = TrainContext(GeeseNet(filters=8, blocks=2), args, device="cpu")
    stop = threading.Event()
    pipe = DeviceBatchPipeline(args, store, ctx, stop)
    store.extend(episodes)
    pipe.start()
    return pipe, ctx, stop


def test_device_pipeline_window_is_host_sync_free():
    """Across the batch_pipeline: device window (batch() sampling and
    assembly, train steps) no blocking host transfer and no build; a stray
    host conversion in the same window is caught and named by file and
    line."""
    pipe, ctx, stop = _device_pipeline()
    try:
        batch = pipe.batch()    # warm-up outside the window
        assert batch is not None
        ctx.train_step(batch, 1e-5)
        # the feeder's flushes read the rings' counters on its thread: let
        # it stage everything first, or a loaded machine puts a flush in the
        # window
        assert pipe.wait_idle()
        with HostSyncSanitizer() as sync, RecompileSentinel() as sentinel:
            history = []
            for _ in range(4):
                batch = pipe.batch()
                assert batch is not None
                history.append(ctx.train_step(batch, 1e-5))
        sync.assert_clean("batch_pipeline: device window")
        sentinel.assert_no_recompiles("batch_pipeline: device window")
        assert all(np.isfinite(m["total"]) and m["sentinel_bad"] == 0 for m in history)

        with HostSyncSanitizer() as sync:
            batch = pipe.batch()
            leak_line = inspect.currentframe().f_lineno + 1
            batch["action"].cpu().numpy()   # deliberate leak
        assert sync.events, sync.report()
        report = sync.report()
        assert f"test_torch_sanitizers.py:{leak_line}" in report, report
        with pytest.raises(AssertionError, match="test_torch_sanitizers.py"):
            sync.assert_clean("deliberate violation")
    finally:
        stop.set()
        pipe.stop()
