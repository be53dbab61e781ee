"""Continuous batcher: iteration-level scheduling for the serving plane.

Counterpart of ``handyrl_tpu/serving/batcher.py``.  The dispatcher forms
the next device batch from whatever is queued the moment the previous one
is enqueued; a request that expires on the way to the device frees its
slot to the next queued request in the same gather pass.

Latency discipline:

* every request carries a deadline (the caller's, else now + ``slo_ms``);
* admission fast-fails (``RequestShed``) when the predicted completion
  (the batch waves ahead of the request times the EMA batch time) already
  passes the deadline: under overload the queue stays shallow and rejects
  quickly instead of serving everyone late;
* a request whose deadline passes while queued fails with
  ``DeadlineExceeded`` at gather time, without taking a device slot.

Device discipline: batches pad to the power-of-two buckets of
``next_bucket``.  Eager PyTorch compiles nothing, but a bucket's first run
still pays the allocator's growth and cuBLAS/cuDNN's first choices, so
``warm()`` runs each bucket once off the hot path and a bucket's first run
never feeds the EMA.  Every batch is enqueued under the engine's device
dispatch lock (``parallel/dispatch.py``) and fetched to the host outside
it.  The serve thread enters ``torch.inference_mode`` itself (the mode is
per thread), and every tensor names its device.

Lifecycle: submit and stop order through one lifecycle gate, and exactly
one party (the serve thread, or ``stop()`` when none exists) fails the
stragglers.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.inference import fetch_outputs
from ..parallel.dispatch import dispatch_serialized
from ..parallel.mesh import PlaneMember
from ..runtime.inference_engine import EngineStopped, next_bucket, stack_padded
from ..utils import tree_map
from ..utils.trace import trace_event

__all__ = [
    "ContinuousBatcher", "ServeError", "RequestShed", "DeadlineExceeded",
    "BadRequest", "obs_spec", "percentiles_ms",
]


class ServeError(RuntimeError):
    """Base class for request-level serving failures (wire kind tag)."""

    kind = "error"


class RequestShed(ServeError):
    """Admission fast-fail: the SLO budget is already spent."""

    kind = "shed"


class DeadlineExceeded(ServeError):
    """The request's deadline passed while it sat in the queue."""

    kind = "deadline"


class BadRequest(ServeError):
    """The request's observation does not match the model's input spec."""

    kind = "bad_request"


def _dtype_str(x) -> Optional[str]:
    """numpy's name of a leaf's dtype, so numpy and tensor leaves compare."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            return "bfloat16"
        return torch.empty(0, dtype=x.dtype).numpy().dtype.str
    dtype = getattr(x, "dtype", None)
    return None if dtype is None else np.dtype(dtype).str


def obs_spec(tree):
    """Nested shape and dtype of an observation (or hidden) tree: the
    admission gate's input contract.  A malformed observation fails its own
    future and never reaches the stacking, where it would fail every
    request of its batch."""
    if isinstance(tree, dict):
        return {k: obs_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(obs_spec(v) for v in tree)
    shape = tuple(tree.shape) if torch.is_tensor(tree) else np.shape(tree)
    return (shape, _dtype_str(tree))


class _Request:
    __slots__ = ("obs", "hidden", "fut", "deadline", "t0")

    def __init__(self, obs, hidden, fut, deadline, t0):
        self.obs = obs
        self.hidden = hidden
        self.fut = fut
        self.deadline = deadline
        self.t0 = t0


class _LatencyRing:
    """Fixed-size reservoir of recent request latencies (ms): the
    percentiles follow the current operating point."""

    def __init__(self, size: int = 4096):
        self._buf = [0.0] * size
        self._n = 0
        self._lock = threading.Lock()

    def add(self, ms: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = ms
            self._n += 1

    def snapshot(self) -> List[float]:
        with self._lock:
            if self._n >= len(self._buf):
                return list(self._buf)
            return self._buf[: self._n]


def percentiles_ms(samples: Sequence[float], qs=(50, 99)) -> Dict[int, Optional[float]]:
    """Nearest-rank percentiles of a latency sample (None when empty)."""
    if not samples:
        return {q: None for q in qs}
    ordered = sorted(samples)
    out = {}
    for q in qs:
        idx = min(len(ordered) - 1, max(0, int(round(q / 100.0 * len(ordered))) - 1))
        out[q] = ordered[idx]
    return out


class ContinuousBatcher:
    """One model's serving engine: iteration-level batched inference with
    per-request deadlines and load shedding.  ``model`` is an
    ``InferenceModel``; it runs on ``devices[0]``."""

    def __init__(
        self,
        model,
        devices,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        slo_ms: float = 200.0,
        shed_policy: str = "deadline",
        queue_bound: int = 1024,
        template_obs=None,
    ):
        self.model = model
        # a plane member (parallel/mesh.py, the league's opponents on the
        # split plane's actor members): its device, its stream, its lock
        self._member = devices[0] if isinstance(devices[0], PlaneMember) else None
        self._devices = [d.device if isinstance(d, PlaneMember) else torch.device(d)
                         for d in devices]
        if self.model.device != self._devices[0]:
            self.model.module.to(self._devices[0])
            self.model.device = self._devices[0]
        if self._member is not None and self._member.stream is not None:
            # the member's stream reads the module after its copy landed
            self._member.stream.wait_stream(torch.cuda.current_stream(self._devices[0]))
        self.max_batch = max(1, int(max_batch))
        self.max_wait = float(max_wait_ms) / 1000.0
        self.slo_s = float(slo_ms) / 1000.0
        self.shed_policy = shed_policy
        self.queue_bound = max(1, int(queue_bound))
        self._obs_spec = None if template_obs is None else obs_spec(template_obs)
        # the initial state, made once on the device: every batch's fresh
        # and pad rows stack from it (nothing writes it in place)
        self._hidden_template = self.model.init_hidden()
        self._hidden_spec = (
            None if self._hidden_template is None else obs_spec(self._hidden_template)
        )
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._gate = threading.Lock()  # lifecycle + admission state
        self._sealed = False           # drain mode: no new admissions
        self._depth = 0                # admitted, not yet gathered
        self._inflight = 0             # gathered, not yet scattered
        self._ema_batch_s: Optional[float] = None
        # admitted/shed move under the gate; the rest only on the
        # dispatcher thread
        self.requests_admitted = 0
        self.requests_served = 0
        self.requests_shed = 0
        self.deadline_misses = 0
        self.batches_served = 0
        self.buckets_warmed: List[int] = []
        # buckets that have run once (warm() seeds them): a bucket's first
        # run is not a service-time sample, or one slow first run would
        # shed every later request and, with nothing admitted, never heal
        self._timed_buckets: set = set()
        self._latency = _LatencyRing()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True, name="serve-batcher"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._gate:
            if self._stop.is_set():
                return
            self._stop.set()
            self._queue.put(None)  # wake the dispatcher
            thread = self._thread
        if thread is None:
            self._fail_pending()

    def join(self, timeout: float = 5.0) -> None:
        """Wait for the serve thread to exit (after stop): its last counter
        increments come after a drain can see an empty queue, so readers
        of final counters join first."""
        if self._thread is not None:
            self._thread.join(timeout)

    def seal(self) -> None:
        """Refuse new admissions; everything already admitted completes."""
        with self._gate:
            self._sealed = True

    def drain_and_stop(self, timeout: float = 30.0) -> bool:
        """Zero-drop retirement: seal, wait for the queue and the batch in
        flight to finish, then stop.  False when the timeout fired with
        work still pending (stop() then fails it)."""
        self.seal()
        deadline = time.monotonic() + timeout
        drained = False
        while time.monotonic() < deadline:
            with self._gate:
                if self._depth == 0 and self._inflight == 0:
                    drained = True
                    break
            time.sleep(0.002)
        self.stop()
        return drained

    def _fail_pending(self) -> None:
        """Fail every queued request; run once, by the drain's owner."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            with self._gate:
                self._depth -= 1
            if not item.fut.done():
                item.fut.set_exception(EngineStopped("serving engine stopped"))

    # -- client API ---------------------------------------------------------

    def submit(self, obs, hidden=None, deadline: Optional[float] = None) -> Future:
        """Queue one request; the future resolves to the numpy output tree
        or raises RequestShed / DeadlineExceeded / BadRequest /
        EngineStopped.  A shed is decided here, at once."""
        fut: Future = Future()
        now = time.monotonic()
        if deadline is None and self.shed_policy != "none":
            # 'none' imposes no default budget (every admitted request
            # completes); a caller's deadline still holds
            deadline = now + self.slo_s
        if self._obs_spec is not None and obs_spec(obs) != self._obs_spec:
            fut.set_exception(BadRequest("observation does not match the model's input spec"))
            return fut
        if hidden is not None:
            if self._hidden_spec is None or obs_spec(hidden) != self._hidden_spec:
                fut.set_exception(BadRequest(
                    "hidden state does not match the model's recurrent spec"
                ))
                return fut
        with self._gate:
            if self._sealed or self._stop.is_set():
                fut.set_exception(EngineStopped("serving engine stopped"))
                return fut
            why = self._admission_check(now, deadline)
            if why is not None:
                self.requests_shed += 1
                fut.set_exception(RequestShed(why))
                return fut
            self.requests_admitted += 1
            self._depth += 1
            self._queue.put(_Request(obs, hidden, fut, deadline, now))
        return fut

    def _admission_check(self, now: float, deadline: float) -> Optional[str]:
        """None = admit; else the shed reason.  Caller holds the gate."""
        if self.shed_policy == "none":
            return None
        if self._depth == 0 and not self._inflight:
            # an idle engine serves: the only wait is the request's own
            # batch, and the batch re-samples an EMA a stall inflated
            return None
        if self._depth >= self.queue_bound:
            return f"queue depth {self._depth} at bound {self.queue_bound}"
        if self.shed_policy == "deadline" and self._ema_batch_s is not None:
            # batch waves ahead: the queue in front, this request, and the
            # batch on the device
            waves = self._depth // self.max_batch + 1 + (1 if self._inflight else 0)
            predicted = now + waves * self._ema_batch_s
            if predicted > deadline:
                budget_ms = (deadline - now) * 1000.0
                return (
                    f"predicted completion {waves} batch wave(s) x "
                    f"{self._ema_batch_s * 1000.0:.1f}ms exceeds the "
                    f"{budget_ms:.1f}ms SLO budget"
                )
        return None

    # -- dispatcher ---------------------------------------------------------

    def _serve_loop(self) -> None:
        with torch.inference_mode():
            while not self._stop.is_set():
                requests = self._gather()
                if not requests:
                    continue
                try:
                    self._execute(requests)
                except Exception as exc:  # every waiter hears of it
                    for r in requests:
                        if not r.fut.done():
                            r.fut.set_exception(exc)
                finally:
                    with self._gate:
                        self._inflight = 0
        self._fail_pending()

    def _take(self, req: _Request, live: List[_Request], now: float) -> None:
        """Admit one popped request into the forming batch, or expire it,
        freeing its slot to whatever the gather pulls next."""
        expired = req.deadline is not None and now > req.deadline
        with self._gate:
            # depth -> inflight per live request, atomically, so a drain
            # never sees zero/zero while the forming batch holds work
            self._depth -= 1
            if not expired:
                self._inflight += 1
        if expired:
            self.deadline_misses += 1
            if not req.fut.done():
                req.fut.set_exception(DeadlineExceeded(
                    f"deadline passed {(now - req.deadline) * 1000.0:.1f}ms before dispatch"
                ))
            return
        live.append(req)

    def _gather(self) -> List[_Request]:
        """Block for the first live request, then sweep everything queued,
        waiting at most ``max_wait`` for stragglers once the queue runs
        dry."""
        item = self._queue.get()
        live: List[_Request] = []
        first_t = time.monotonic()
        while True:
            if item is None:
                break  # stop token; the loop condition handles the rest
            self._take(item, live, time.monotonic())
            if len(live) >= self.max_batch:
                break
            try:
                item = self._queue.get_nowait()
                continue
            except queue.Empty:
                pass
            if not live:
                if self._stop.is_set():
                    break
                item = self._queue.get()  # everything expired: block again
                first_t = time.monotonic()
                continue
            remaining = (first_t + self.max_wait) - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
        return live

    def _run(self, obs_list, hid_list, bucket: int) -> Dict[str, Any]:
        """Stack, enqueue under the device lock, fetch outside it."""
        model = self.model
        member = self._member
        with member.stream_context() if member is not None else contextlib.nullcontext():
            obs_batch, hidden_batch = stack_padded(obs_list, hid_list, bucket,
                                                   self._hidden_template)
            device_out = dispatch_serialized(
                lambda: model.inference_batch_async(obs_batch, hidden_batch),
                [member] if member is not None else self._devices
            )
            return fetch_outputs(device_out)

    def _execute(self, requests: List[_Request]) -> None:
        n = len(requests)
        bucket = next_bucket(n, self.max_batch)
        t0 = time.monotonic()
        outputs = self._run([r.obs for r in requests], [r.hidden for r in requests], bucket)
        done = time.monotonic()
        # stack -> outputs on the host; each request's "serve.request" span
        # (server.py) brackets admission -> reply around it
        trace_event("serve.batch", done - t0, t0=t0, plane="serving", n=n, bucket=bucket)
        self._note_batch(done - t0, bucket)
        with self._gate:
            # the device work is over: a waiter woken by the scatter below
            # must not see this batch as still in flight
            self._inflight = 0
        for i, r in enumerate(requests):
            if not r.fut.done():
                # x[i, ...] keeps a row of a 1-d leaf (the transformer's
                # step counter) a 0-d array, which the codec sends as one
                r.fut.set_result(tree_map(lambda x: None if x is None else x[i, ...], outputs))
            self._latency.add((done - r.t0) * 1000.0)
        self.batches_served += 1
        self.requests_served += n

    def _note_batch(self, seconds: float, bucket: int) -> None:
        if bucket not in self._timed_buckets:
            self._timed_buckets.add(bucket)  # a first run: not a sample
            return
        if self._ema_batch_s is None:
            self._ema_batch_s = seconds
        else:
            self._ema_batch_s = 0.8 * self._ema_batch_s + 0.2 * seconds

    # -- warm-up ------------------------------------------------------------

    def warm(self, buckets: Sequence[int], template_obs, template_hidden=None) -> float:
        """Run each bucket once off the hot path, on batches of the template
        observation; returns wall ms.  The router warms a standby engine
        before it flips to it."""
        t0 = time.monotonic()
        with torch.inference_mode():
            for b in sorted({max(1, min(int(x), self.max_batch)) for x in buckets}):
                self._run([template_obs] * b, [template_hidden] * b, b)
                self.buckets_warmed.append(b)
                self._timed_buckets.add(b)
        return (time.monotonic() - t0) * 1000.0

    # -- introspection ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The engine's device: where its module lives and where the
        session cache pins resident hidden states."""
        return self._devices[0]

    def latencies_ms(self) -> List[float]:
        return self._latency.snapshot()

    def stats(self) -> Dict[str, Any]:
        with self._gate:
            depth = self._depth
            inflight = self._inflight
            ema = self._ema_batch_s
        pct = percentiles_ms(self.latencies_ms())
        return {
            "requests_admitted": self.requests_admitted,
            "requests_served": self.requests_served,
            "requests_shed": self.requests_shed,
            "deadline_misses": self.deadline_misses,
            "batches_served": self.batches_served,
            "depth": depth,
            "inflight": inflight,
            "ema_batch_ms": None if ema is None else ema * 1000.0,
            "p50_ms": pct[50],
            "p99_ms": pct[99],
        }
