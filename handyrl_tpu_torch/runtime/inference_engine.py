"""Cross-environment batched inference: many actor threads, one forward.

Counterpart of ``handyrl_tpu/runtime/inference_engine.py``.  Each actor
thread submits its (observation, hidden) and blocks on a future; one
dispatcher thread drains the queue, stacks the pending requests' numpy
observations and device hidden trees on a new leading dimension, runs the
model once and hands every request its row.  A request with no hidden
state takes the module's initial state, so one batch mixes fresh and
mid-episode games; the transformer's per-row step counters let its rows be
at different steps.

The engine, the trainer and the batch pipeline share the card's default
stream, so device work is ordered across the threads as it is enqueued.

The JAX engine pads batches to power-of-two buckets so XLA compiles a few
shapes; torch does not recompile, so the port runs the batch as it is.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import torch

from ..models.inference import split_outputs
from ..utils import tree_map, tree_stack


class EngineStopped(RuntimeError):
    """Raised to waiters when the engine is stopped with requests pending."""


class BatchedInferenceClient:
    """Per-actor facade with the model API (``inference`` / ``init_hidden``)."""

    def __init__(self, engine: "BatchedInferenceEngine"):
        self._engine = engine

    def init_hidden(self, batch_dims=()):
        return self._engine.model.init_hidden(batch_dims)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        return self._engine.submit(obs, hidden).result()

    def submit(self, obs, hidden=None) -> Future:
        """Queue a request without waiting, so a caller can put several
        players' observations into one batch."""
        return self._engine.submit(obs, hidden)


class BatchedInferenceEngine:
    """One model on its device serving many actor threads in batches.

    ``model`` is an ``InferenceModel``.  ``load_state_dict`` swaps its
    weights between two batches, never during one."""

    def __init__(self, model, max_batch: int = 64, max_wait_ms: float = 2.0):
        self.model = model
        self.max_batch = max(1, max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # orders submit against stop: a request is enqueued only while the
        # stop flag is provably unset, so exactly one party owns the final
        # drain (the serve thread when it exists, stop() otherwise)
        self._lifecycle = threading.Lock()
        # held around each forward and each weight swap
        self._model_lock = threading.Lock()
        self.batches_served = 0
        self.requests_served = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "BatchedInferenceEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                            name="inference-engine")
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        with self._lifecycle:
            if self._stop.is_set():
                return
            self._stop.set()
            self._queue.put(None)  # wake the dispatcher
            thread = self._thread
        if thread is None:
            self._fail_pending()
        elif thread is not threading.current_thread():
            thread.join(timeout)

    def _fail_pending(self) -> None:
        """Fail every queued request; called once, by the drain's owner."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(EngineStopped("inference engine stopped"))

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """New weights for the served module, copied in between batches."""
        with self._model_lock:
            self.model.module.load_state_dict(state_dict)

    # -- client API ---------------------------------------------------------

    def client(self) -> BatchedInferenceClient:
        return BatchedInferenceClient(self)

    def submit(self, obs, hidden=None) -> Future:
        fut: Future = Future()
        with self._lifecycle:
            if self._stop.is_set():
                fut.set_exception(EngineStopped("inference engine stopped"))
                return fut
            self._queue.put((obs, hidden, fut))
        return fut

    # -- dispatcher ---------------------------------------------------------

    def _drain(self) -> List:
        """Block for the first request, then gather more up to max_batch."""
        first = self._queue.get()
        if first is None:
            return []
        requests = [first]
        deadline = time.monotonic() + self.max_wait
        while len(requests) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                item = self._queue.get_nowait() if timeout <= 0 else self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                break
            requests.append(item)
        return requests

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            requests = self._drain()
            if not requests:
                continue
            try:
                self._serve(requests)
            except Exception as exc:  # every waiter hears of it
                for _, _, fut in requests:
                    if not fut.done():
                        fut.set_exception(exc)
        self._fail_pending()

    def _serve(self, requests: List) -> None:
        obs_batch = tree_stack([r[0] for r in requests])
        with self._model_lock:
            template = self.model.init_hidden()
            hidden_batch = None
            if template is not None:
                hidden_batch = tree_map(lambda *hs: torch.stack(hs),
                                        *[r[1] if r[1] is not None else template for r in requests])
            outputs = self.model.inference_batch(obs_batch, hidden_batch)
            rows = split_outputs(outputs, len(requests))
        for (_, _, fut), row in zip(requests, rows):
            fut.set_result(row)
        self.batches_served += 1
        self.requests_served += len(requests)
