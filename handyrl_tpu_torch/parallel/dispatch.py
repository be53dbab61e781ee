"""Per-member dispatch locks: the serving plane's and the device planes'.

Counterpart of ``dispatch_serialized`` in ``handyrl_tpu/parallel/mesh.py``,
for one process and its devices.  One lock per plane member: a
``torch.device`` is its own member, and a ``PlaneMember``
(parallel/mesh.py) names its own key, so two members sharing one card (the
learner on the rank's stream, an actor on a stream of its own) enqueue at
the same time, as disjoint JAX meshes do, while engines sharing a member
take turns.  The lock covers the enqueue of a batch, which returns as soon
as the work is queued on the device; the copy of the outputs to the host
happens after it is released.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, TypeVar

import torch

T = TypeVar("T")

_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_REGISTRY_LOCK = threading.Lock()


def _key(device) -> str:
    key = getattr(device, "lock_key", None)
    if key is not None:
        return key
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def locks_for(devices: Iterable) -> List[threading.Lock]:
    """The locks of ``devices`` (devices or plane members), in one order
    for every caller (sorted by key), so a call that takes several never
    deadlocks with another."""
    keys = sorted({_key(d) for d in devices})
    with _REGISTRY_LOCK:
        return [_DEVICE_LOCKS.setdefault(k, threading.Lock()) for k in keys]


def dispatch_serialized(call: Callable[[], T], devices: Iterable) -> T:
    """Run ``call`` (which enqueues work on ``devices`` and returns without
    waiting for it) holding the dispatch lock of each of those devices or
    plane members."""
    locks = locks_for(devices)
    held = []
    try:
        for lock in locks:
            lock.acquire()
            held.append(lock)
        return call()
    finally:
        for lock in reversed(held):
            lock.release()
