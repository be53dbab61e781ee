"""The port's span tracer (``utils/trace.py``) on the CPU: the port's
versions of tests/test_trace.py's recording tests, the file schema against
the JAX package's (its ``read_trace`` and ``scripts/trace_export.py`` read
the port's file into the same Chrome trace as a JAX file of the same
spans), the learner's spans with ``trace.enabled``, nothing recorded with
it off, and ``profile_dir``'s profiler trace.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from handyrl_tpu.utils import trace as jax_trace
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.utils import trace as trace_mod
from handyrl_tpu_torch.utils.trace import META_NAME, read_trace, trace_event, trace_span, trace_stats

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True)
def _tracer_reset():
    """Every test leaves both process tracers disarmed."""
    trace_mod.shutdown()
    jax_trace.shutdown()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    trace_mod.shutdown()
    jax_trace.shutdown()
    torch.set_num_threads(threads)


def _configure(tmp_path, rank=0, **over):
    cfg = {"enabled": True, "path": str(tmp_path / "trace.jsonl"), "ring_size": 4096,
           "flush_interval": 0.05}
    cfg.update(over)
    assert trace_mod.configure(cfg, rank=rank)
    return trace_mod.current_path()


def test_disabled_span_is_one_shared_noop_object():
    a = trace_span("x", plane="learner")
    b = trace_span("y")
    assert a is b
    with a:
        pass
    trace_event("z", 0.5)
    assert trace_stats() == {"trace_spans": 0, "trace_dropped": 0}


def test_unwritable_sink_fails_at_configure_naming_the_knob(tmp_path):
    with pytest.raises(ValueError, match="trace.path"):
        trace_mod.configure({"enabled": True,
                             "path": str(tmp_path / "no" / "such" / "dir" / "t.jsonl")})
    assert not trace_mod.enabled()


@pytest.mark.parametrize("annotate", [True, False])
def test_span_nesting_and_attribution(tmp_path, annotate):
    path = _configure(tmp_path, annotate_device=annotate)
    with trace_span("outer", plane="learner"):
        with trace_span("inner", step=3):
            time.sleep(0.01)
    done = threading.Event()

    def worker():
        with trace_span("threaded"):
            pass
        done.set()

    threading.Thread(target=worker, name="obs-worker", daemon=True).start()
    assert done.wait(5.0)
    trace_mod.shutdown()
    recs = {r["name"]: r for r in read_trace(path) if r["name"] != META_NAME}
    assert set(recs) == {"outer", "inner", "threaded"}
    outer, inner = recs["outer"], recs["inner"]
    assert outer["t_mono"] <= inner["t_mono"]
    assert inner["t_mono"] + inner["dur_s"] <= outer["t_mono"] + outer["dur_s"] + 1e-6
    assert inner["dur_s"] >= 0.01
    assert inner["attrs"] == {"step": 3} and outer["attrs"] == {"plane": "learner"}
    assert recs["threaded"]["thread"] == "obs-worker"
    assert all(r["rank"] == 0 for r in recs.values())
    first = read_trace(path)[0]
    assert first["name"] == META_NAME and first["version"] >= 1


def test_spans_annotate_the_torch_profiler(tmp_path):
    """With annotate_device each span is a record_function range, so it
    shows in a profiler capture (on the card, around the span's kernels)."""
    _configure(tmp_path)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_span("annotated_span"):
            torch.ones(4).sum()
    assert any(e.key == "annotated_span" for e in prof.key_averages())


def test_ring_overflow_drops_counted_never_blocking(tmp_path):
    _configure(tmp_path, ring_size=8, flush_interval=999.0)
    t0 = time.perf_counter()
    for _ in range(100):
        trace_event("spam", 0.001)
    elapsed = time.perf_counter() - t0
    assert trace_stats() == {"trace_spans": 8, "trace_dropped": 92}
    assert elapsed < 1.0


def test_rank_suffix_path_derivation(tmp_path):
    path = _configure(tmp_path, rank=2)
    assert path.endswith("trace.rank2.jsonl")
    with trace_span("s"):
        pass
    trace_mod.shutdown()
    assert all(r["rank"] == 2 for r in read_trace(path))


def test_truncated_tail_tolerated_mid_file_raises(tmp_path):
    path = _configure(tmp_path)
    for i in range(3):
        trace_event(f"s{i}", 0.001)
    trace_mod.shutdown()
    with open(path, "a") as f:
        f.write('{"name": "torn", "ts": 1.0, "dur_')
    recs = read_trace(path)
    assert [r["name"] for r in recs if r["name"] != META_NAME] == ["s0", "s1", "s2"]
    with pytest.raises(ValueError):
        read_trace(path, strict=True)
    lines = Path(path).read_text().splitlines()
    lines.insert(2, "{not json")
    Path(path).write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError):
        read_trace(path)


class _Clock:
    """A fake clock for both tracers: the same spans, the same times."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t + 1.7e9

    def monotonic(self):
        return self.t


def _write_spans(module, path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    assert module.configure({"enabled": True, "path": str(path), "flush_interval": 999.0,
                             "annotate_device": False})
    for i, (name, dur) in enumerate((("train_step", 0.25), ("batch.wait", 0.125),
                                     ("checkpoint.save", 0.5))):
        clock.t += 1.0
        module.trace_event(name, dur, t0=clock.t - dur, plane="learner", i=i)
    with module.trace_span("epoch.snapshot_wait", plane="learner"):
        clock.t += 0.375
    module.shutdown()


def test_port_file_reads_and_exports_as_a_jax_file(tmp_path, monkeypatch):
    """The schema is the JAX package's: its ``read_trace`` reads the port's
    file record for record as a file the JAX tracer wrote of the same
    spans, and ``scripts/trace_export.py`` makes the same Chrome trace of
    both."""
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    _write_spans(trace_mod, port_path, monkeypatch)
    _write_spans(jax_trace, jax_path, monkeypatch)
    port_recs = jax_trace.read_trace(str(port_path))
    jax_recs = jax_trace.read_trace(str(jax_path))
    assert port_recs == read_trace(str(port_path))
    assert port_recs == jax_recs and len(port_recs) == 5
    sys.path.insert(0, str(SCRIPTS))
    try:
        import trace_export
    finally:
        sys.path.remove(str(SCRIPTS))
    chrome = trace_export.export_chrome([port_recs])
    assert chrome == trace_export.export_chrome([jax_recs])
    spans = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in spans] == ["train_step", "batch.wait", "checkpoint.save",
                                          "epoch.snapshot_wait"]
    assert spans[0]["cat"] == "learner"


def _learner_args(extra=None):
    return normalize_args({
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10,
            "update_episodes": 15, "maximum_episodes": 100, "epochs": 2,
            "num_batchers": 1, "eval_rate": 0.2, "worker": {"num_parallel": 2},
            **(extra or {}),
        },
    })


def test_learner_records_its_spans(tmp_path, monkeypatch):
    """A CPU learner with trace.enabled records the trainer's and the
    boundary's spans, and its metrics records carry the tracer's counters."""
    monkeypatch.chdir(tmp_path)
    learner = Learner(_learner_args({"trace": {"enabled": True, "flush_interval": 0.05}}),
                      device="cpu")
    assert learner.run() == 0
    assert not trace_mod.enabled()   # run() shut it down, the tail written
    names = {r["name"] for r in read_trace("trace.jsonl")}
    for name in ("train_step", "batch.wait", "checkpoint.save", "epoch.snapshot_wait",
                 "epoch.metrics_fetch", "pipe.ready_wait"):
        assert name in names, name
    records = [json.loads(line) for line in open("metrics.jsonl")]
    assert records[-1]["trace_spans"] > 0 and records[-1]["trace_dropped"] == 0


def test_learner_with_tracing_off_records_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = trace_stats()   # the counters of the last armed tracer stay
    learner = Learner(_learner_args(), device="cpu")
    assert learner.run() == 0
    assert not os.path.exists("trace.jsonl")
    assert trace_stats() == before
    records = [json.loads(line) for line in open("metrics.jsonl")]
    assert all("trace_spans" not in r for r in records)


def test_profile_dir_writes_a_profiler_trace_of_the_first_epoch(tmp_path, monkeypatch):
    """``profile_dir``: the first trained epoch under torch.profiler, a
    Chrome trace written under the directory, holding the train step's ops."""
    monkeypatch.chdir(tmp_path)
    learner = Learner(_learner_args({"profile_dir": "profiles", "epochs": 1}), device="cpu")
    assert learner.run() == 0
    files = list(Path("profiles").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("Optimizer.step" in n for n in names), sorted(names)[:20]
