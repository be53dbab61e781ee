"""The port's ``utils/retry.py`` and ``runtime/faults.py`` against the JAX
package's, on the CPU.

* ``retry_call``: failure schedules made by hypothesis, a fake ``sleep``;
  both packages make the same calls, sleep the same backoffs, call
  ``on_retry`` with the same indices and return or raise the same thing.
* Every ``HANDYRL_FAULT_*`` parser on one table of valid and malformed
  values: the same value, or ``ValueError`` from both.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from handyrl_tpu.runtime import faults as jax_faults
from handyrl_tpu.utils.retry import retry_call as jax_retry_call
from handyrl_tpu_torch.runtime import faults
from handyrl_tpu_torch.utils.retry import retry_call

OUTCOMES = st.sampled_from(["ok", "conn", "os", "timeout", "value"])
ERRORS = {"conn": ConnectionResetError, "os": OSError, "timeout": TimeoutError,
          "value": ValueError}


def _run(retry, schedule, attempts, base, factor, cap):
    """One retry_call over a schedule of outcomes; returns what it did."""
    calls, sleeps, retries = [], [], []

    def fn():
        i = len(calls)
        calls.append(i)
        kind = schedule[i] if i < len(schedule) else "ok"
        if kind == "ok":
            return f"value-{i}"
        raise ERRORS[kind](f"fail-{i}")

    try:
        out = retry(fn, attempts=attempts, base_delay=base, factor=factor, max_delay=cap,
                    on_retry=lambda i, exc: retries.append((i, type(exc).__name__, str(exc))),
                    sleep=sleeps.append)
    except Exception as exc:
        out = ("raised", type(exc).__name__, str(exc))
    return out, calls, sleeps, retries


@settings(max_examples=150, deadline=None)
@given(schedule=st.lists(OUTCOMES, max_size=8), attempts=st.integers(-1, 6),
       base=st.floats(0.0, 1.0), factor=st.floats(1.0, 3.0), cap=st.floats(0.0, 2.0))
def test_retry_call_matches_the_jax_package(schedule, attempts, base, factor, cap):
    assert (_run(retry_call, schedule, attempts, base, factor, cap)
            == _run(jax_retry_call, schedule, attempts, base, factor, cap))


def test_retry_call_failed_reconnect_propagates():
    """An ``on_retry`` that raises ends the retries with its exception."""
    for retry in (retry_call, jax_retry_call):
        def fn():
            raise ConnectionResetError("reset")

        def reconnect(i, exc):
            raise OSError("peer gone")

        with pytest.raises(OSError, match="peer gone"):
            retry(fn, attempts=3, on_retry=reconnect, sleep=lambda s: None)


PARSERS = [
    ("HANDYRL_FAULT_NAN_AT_STEP", "nan_window",
     ["7", "7:3", "7:0", " 12 ", "", "x", "3:y", "-1"]),
    ("HANDYRL_FAULT_WEDGE_ROLLOUT", "wedge_rollout", ["2", "2:all", "2:first", "", "z", "0"]),
    ("HANDYRL_FAULT_SIGTERM_AT_STEP", "sigterm_at_step", ["11", "", "eleven", "0"]),
    ("HANDYRL_FAULT_SIGTERM_REPLICA", "sigterm_replica", ["3", "1", "0", "-2", "", "three"]),
    ("HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH", "poison_snapshot_epoch",
     ["2", "1", "0", "", "two"]),
    ("HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH", "kill_process_at_epoch",
     ["3", "3:1", "3:", "", "a:1", "3:b"]),
    ("HANDYRL_FAULT_WEDGE_PROCESS", "wedge_process_at_epoch", ["4", "4:2", "", "x:y"]),
]
CASES = [(var, fn, value) for var, fn, values in PARSERS for value in values]


def _parse(module, fn, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    try:
        return ("ok", getattr(module, fn)())
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("var,fn,value", CASES, ids=[f"{f}-{v!r}" for _, f, v in CASES])
def test_fault_parsers_match_the_jax_package(var, fn, value, monkeypatch):
    assert (_parse(faults, fn, monkeypatch, var, value)
            == _parse(jax_faults, fn, monkeypatch, var, value))


@pytest.mark.parametrize("fn", sorted({fn for _, fn, _ in PARSERS}))
def test_unset_fault_variables_inject_nothing(fn, monkeypatch):
    for var, _, _ in PARSERS:
        monkeypatch.delenv(var, raising=False)
    assert getattr(faults, fn)() is None is getattr(jax_faults, fn)()
