"""Episode store: compressed columnar trajectories + recency-biased sampling.

Counterpart of ``handyrl_tpu/runtime/replay.py``.  Episodes are columnar
numpy blocks of ``compress_steps`` timesteps, each zlib-compressed, so
sampling a window decompresses only the blocks it touches.  Index i of an
N-episode buffer is accepted with probability 1 - (N-1-i)/N, and windows of
``forward_steps`` start uniformly, extended backwards by ``burn_in_steps``
where possible — all drawn from Python's ``random``, in the JAX package's
order, so one seed samples the same windows in both packages.  Above 95%
host memory the buffer shrinks to fit (psutil, when installed), as the JAX
store does.
"""

from __future__ import annotations

import random
import threading
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np

from . import codec
from ..utils import tree_leaves

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def compress_block(columns: Dict[str, Any]) -> bytes:
    # codec, not pickle: blocks may come from other hosts and must never
    # carry executable payloads
    return zlib.compress(codec.dumps(columns), level=1)


class _BlockCache:
    """LRU of decoded blocks keyed by their compressed bytes.

    Recency-biased sampling decodes the same blocks over and over.  Decoded
    leaves are frozen read-only: every consumer slices or copies, and an
    in-place write must fail loudly rather than corrupt later batches."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._cols: "OrderedDict[bytes, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(cols) -> int:
        return sum(leaf.nbytes for leaf in tree_leaves(cols) if isinstance(leaf, np.ndarray))

    def get(self, blob: bytes) -> Dict[str, Any]:
        with self._lock:
            cols = self._cols.get(blob)
            if cols is not None:
                self._cols.move_to_end(blob)
                return cols
        cols = codec.loads(zlib.decompress(blob))
        for leaf in tree_leaves(cols):
            if isinstance(leaf, np.ndarray):
                leaf.flags.writeable = False
        with self._lock:
            self._cols[blob] = cols
            self._bytes += self._nbytes(cols)
            while self._bytes > self.max_bytes and len(self._cols) > 1:
                _, evicted = self._cols.popitem(last=False)
                self._bytes -= self._nbytes(evicted)
        return cols


_BLOCK_CACHE = _BlockCache()


def reset_block_cache() -> None:
    """Re-create the decoded-block cache and its lock.

    A forked batcher process (runtime/shm_batch.py) inherits this module's
    state as of the fork, including a lock some thread of the parent may
    have held at that instant; it calls this first, so its cache is its own
    and its lock is fresh."""
    global _BLOCK_CACHE
    _BLOCK_CACHE = _BlockCache()


def decompress_block(blob: bytes) -> Dict[str, Any]:
    return _BLOCK_CACHE.get(blob)


class EpisodeStore:
    """Thread-safe bounded episode buffer with recency-biased sampling."""

    def __init__(self, maximum_episodes: int):
        self.maximum_episodes = maximum_episodes
        self._episodes: deque = deque()
        self._lock = threading.Lock()
        self._listeners: List[Any] = []

    def __len__(self) -> int:
        return len(self._episodes)

    def subscribe(self, listener) -> None:
        """Call ``listener(episodes)`` with every batch of episodes added from
        now on (outside the store's lock): the shared-memory pipeline mirrors
        the stream into its batcher processes' replica stores this way."""
        with self._lock:
            self._listeners.append(listener)

    def unsubscribe(self, listener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def snapshot(self) -> List[Dict[str, Any]]:
        """A consistent copy of the episode list (the episodes themselves,
        compressed block bytes, never change once stored)."""
        with self._lock:
            return list(self._episodes)

    def extend(self, episodes: List[Dict[str, Any]]) -> None:
        episodes = [e for e in episodes if e is not None]
        with self._lock:
            self._episodes.extend(episodes)
            limit = self._memory_limited_max()
            while len(self._episodes) > limit:
                self._episodes.popleft()
            listeners = list(self._listeners)
        if episodes:
            for listener in listeners:
                listener(episodes)

    def _memory_limited_max(self) -> int:
        """Shrink the buffer under memory pressure: above 95% host memory
        it keeps that share of what it holds."""
        if psutil is not None:
            mem_percent = psutil.virtual_memory().percent
            if mem_percent > 95:
                return max(1, int(len(self._episodes) * 95 / mem_percent))
        return self.maximum_episodes

    def sample_window(self, forward_steps: int, burn_in_steps: int, compress_steps: int) -> Optional[Dict[str, Any]]:
        """Pick one episode (recency-biased) and one training window in it."""
        with self._lock:
            n = len(self._episodes)
            if n == 0:
                return None
            while True:
                idx = random.randrange(n)
                accept = 1 - (n - 1 - idx) / n
                if random.random() < accept:
                    break
            ep = self._episodes[idx]

        steps = ep["steps"]
        train_start = random.randrange(1 + max(0, steps - forward_steps))
        start = max(0, train_start - burn_in_steps)
        end = min(train_start + forward_steps, steps)
        first_block = start // compress_steps
        last_block = (end - 1) // compress_steps + 1
        return {
            "args": ep["args"],
            # outcome as an array ordered like ep['players'] for batching
            "outcome": np.asarray([ep["outcome"][p] for p in ep["players"]], np.float32),
            "players": ep["players"],
            "blocks": ep["blocks"][first_block:last_block],
            "base": first_block * compress_steps,
            "start": start,
            "end": end,
            "train_start": train_start,
            "total": steps,
        }
