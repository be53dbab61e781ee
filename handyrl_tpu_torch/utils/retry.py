"""Bounded retry with exponential backoff for transient transport faults.

Counterpart of ``handyrl_tpu/utils/retry.py``.  One EINTR or ECONNRESET on
a control-plane call (the fleet router's stats poll) must not cost a
``replica_lost``: that is the answer to a peer being gone, not to one
flaky syscall.  ``retry_call`` bounds the attempts, backs off
exponentially, and calls ``on_retry`` between attempts for callers that
must re-establish state; ``sleep`` is injectable so the schedule can be
held without sockets.  Only the ``retry_on`` types are retried; the last
failure propagates unchanged.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

__all__ = ["retry_call"]

T = TypeVar("T")


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    factor: float = 2.0,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, OSError, TimeoutError),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` with up to ``attempts`` retries after the first try
    (``attempts=0``: one try).  The backoff before retry ``i`` (from 0) is
    ``min(base_delay * factor**i, max_delay)``; ``on_retry(i, exc)`` runs
    after it and before the next attempt, and what it raises propagates."""
    attempts = max(0, int(attempts))
    for i in range(attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            if i >= attempts:
                raise
            sleep(min(max_delay, base_delay * (factor ** i)))
            if on_retry is not None:
                on_retry(i, exc)
    raise AssertionError("unreachable")  # pragma: no cover
