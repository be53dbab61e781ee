"""Batch assembly off the learner's GIL: batcher processes and a
shared-memory ring.

Counterpart of ``handyrl_tpu/runtime/shm_batch.py``, ``batch_pipeline:
shm``.  The threaded pipeline (runtime/trainer.py) assembles every batch on
the learner's GIL, beside the actor threads, the inference engine and the
train step.  Here ``num_batchers`` forked processes do it:

    parent                                children (num_batchers processes)
    ------                                ---------------------------------
    EpisodeStore --codec blobs--> feed_q -> replica EpisodeStore
                                            sample batch_size windows
    free_q[i] ----------- slot indices ---> fill_batch into shm slot views
    ready pipe <-- fixed-size records <----'
    put thread: slot views -> ctx.put_batch -> device queue

Both slot channels survive a SIGKILL'd child, which dies holding whatever
lock it was inside:

* Free slots travel through per-child ``mp.Queue``s (the parent deals
  recycled slots round-robin): ``Queue.get`` holds its reader lock for the
  whole blocking wait, so a kill almost always lands inside it, and a
  per-child queue means a dead child poisons only itself.
* Ready messages travel over a raw ``os.pipe`` as fixed-size records, far
  below PIPE_BUF, so every write is atomic and takes no lock: a killed
  writer leaves a whole record or nothing.

Batches have fixed (B, T, P, ...) shapes (runtime/batch.py), so each ring
slot is a preallocated columnar layout in one
``multiprocessing.shared_memory`` segment.  Children write into numpy views
over their mapping; the parent wraps the same bytes as views and hands them
to ``TrainContext.put_batch``.  On the card the whole segment is registered
with ``cudaHostRegister`` once, so the host-to-device copies read the slots
where they lie, page-locked, without a staging copy and without blocking
the put thread; a CUDA event after each group's copies marks when its slots
may be refilled (the JAX package blocks on the transfer at the same point),
with up to two groups in flight.

Episodes travel to the children once, as wire-codec bytes (never pickle),
and each child keeps its own recency-biased replica store, so sampling
costs the parent nothing.  A child touches no torch tensor and makes no
CUDA call: numpy, zlib and the codec only.

Supervision: the put thread watches the children.  A dead child's ring
slots are reclaimed (the parent stamps an owner array before each deal,
and a per-slot generation makes any ready message still in flight for a
reclaimed slot stale), handed to the survivors, and the child is respawned
up to ``batcher_max_restarts`` times; past that, or if the ring stays
silent ``batcher_stall_timeout`` seconds after a death, the pipeline
degrades loudly to the threaded one.  Deaths, respawns and the degrade are
counted in ``stats()`` and recorded as ``pipe_batcher_*``.
"""

from __future__ import annotations

import atexit
import gc
import multiprocessing as mp
import os
import queue as thqueue
import select
import struct
import sys
import threading
import time
import traceback
import warnings
from collections import deque
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import effective_shm_slots
from ..utils.trace import trace_event
from . import codec
from .batch import _fill_accel, fill_batch, make_batch
from .replay import EpisodeStore
from .trainer import PIPE_EVENT_KEYS, PIPE_STAT_KEYS, BatchPipeline

_ALIGN = 64  # every leaf of a slot starts on a cache line

# one ready message: slot (-1 = "this child hit an exception and is
# exiting"), the slot's generation, and the sample / assemble / free-wait
# seconds.  36 bytes, far under PIPE_BUF: a write of one record is atomic
_READY_REC = struct.Struct("=iQddd")


def slot_spec(template: Dict[str, Any]):
    """(nested spec, slot_bytes) of one batch.  The spec mirrors the batch's
    structure with each array replaced by ``("leaf", shape, dtype_str,
    offset)``; dict keys are laid out sorted, the order of ``tree_leaves``."""
    offset = 0

    def walk(node):
        nonlocal offset
        if isinstance(node, np.ndarray):
            here = offset
            offset += (node.nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
            return ("leaf", tuple(node.shape), node.dtype.str, here)
        if isinstance(node, dict):
            return ("dict", {k: walk(node[k]) for k in sorted(node)})
        if isinstance(node, (list, tuple)):
            return ("seq", isinstance(node, tuple), [walk(x) for x in node])
        raise TypeError(f"batch leaf {type(node).__name__} is not shm-mappable")

    spec = walk(template)
    return spec, max(offset, _ALIGN)


def slot_views(spec, buf, base: int):
    """The batch as numpy views into ``buf`` at ``base``."""
    kind = spec[0]
    if kind == "leaf":
        _, shape, dtype_str, off = spec
        return np.ndarray(shape, dtype=np.dtype(dtype_str), buffer=buf, offset=base + off)
    if kind == "dict":
        return {k: slot_views(v, buf, base) for k, v in spec[1].items()}
    _, is_tuple, items = spec
    seq = [slot_views(s, buf, base) for s in items]
    return tuple(seq) if is_tuple else seq


def _drain_feed(feed_q, store: EpisodeStore) -> None:
    while True:
        try:
            blob = feed_q.get_nowait()
        except thqueue.Empty:
            return
        try:
            store.extend([codec.loads(blob)])
        except Exception:
            traceback.print_exc()


def _batcher_main(shm_name, spec, slot_bytes, args, seed, parent_pid,
                  feed_q, free_q, ready_w, stop, slot_gen) -> None:
    """Child entry point: replica store -> sample -> fill a ring slot.

    It runs in a fork of the learner, which holds a CUDA context and runs
    threads.  So it calls nothing of torch or CUDA, first freezes what it
    inherited out of the garbage collector's reach (collecting an inherited
    cycle that holds a CUDA tensor would call the caching allocator, whose
    lock a parent thread may have held at the fork), re-creates the block
    cache and its lock, and restores the default SIGTERM/SIGINT disposition.
    It exits when the stop flag is raised or its parent is gone.

    Crash safety: ``free_q`` is this child's own queue; the parent stamped
    ``owner[slot]`` before dealing each index into it, so every slot this
    process holds is reclaimable if it dies.  The child reads
    ``slot_gen[slot]`` when it takes a slot and sends it with the ready
    message; a reclaim bumps the generation, so a reclaimed slot never
    circulates twice."""
    import random
    import signal

    from . import replay

    gc.freeze()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
    replay.reset_block_cache()
    random.seed((int(seed) & 0xFFFFFFFF) * 1_000_003 + os.getpid())

    def stopping() -> bool:
        return bool(stop.value) or os.getppid() != parent_pid

    views_by_slot: Dict[int, Dict[str, Any]] = {}
    shm = None
    try:
        # attaching registers the segment with the resource tracker again,
        # but a forked child shares its parent's tracker, where the name is
        # a set entry: the parent's close unlinks and unregisters it once
        shm = shared_memory.SharedMemory(name=shm_name)
        store = EpisodeStore(int(args["maximum_episodes"]))
        fs, bs, cs = args["forward_steps"], args["burn_in_steps"], args["compress_steps"]
        while not stopping():
            _drain_feed(feed_q, store)
            t0 = time.perf_counter()
            windows: List[Dict[str, Any]] = []
            while len(windows) < args["batch_size"]:
                if stopping():
                    return
                w = store.sample_window(fs, bs, cs)
                if w is None:
                    _drain_feed(feed_q, store)
                    time.sleep(0.05)
                    continue
                windows.append(w)
            t_sample = time.perf_counter() - t0

            t0 = time.perf_counter()
            slot = None
            while slot is None:
                try:
                    slot = free_q.get(timeout=0.2)
                except thqueue.Empty:
                    if stopping():
                        return
                    _drain_feed(feed_q, store)
            gen = slot_gen[slot]
            t_free = time.perf_counter() - t0

            out = views_by_slot.get(slot)
            if out is None:
                out = views_by_slot[slot] = slot_views(spec, shm.buf, slot * slot_bytes)
            t0 = time.perf_counter()
            fill_batch(windows, args, out)
            os.write(ready_w, _READY_REC.pack(slot, gen, t_sample, time.perf_counter() - t0, t_free))
    except Exception:
        traceback.print_exc()  # the detail goes to stderr; the record tells the parent
        try:
            os.write(ready_w, _READY_REC.pack(-1, 0, 0.0, 0.0, 0.0))
        except OSError:
            pass
    finally:
        views_by_slot.clear()
        if shm is not None:
            gc.collect()  # numpy views pin shm.buf; drop them first
            try:
                shm.close()
            except BufferError:
                pass  # the process exit unmaps it regardless


def _buffer_address(buf) -> int:
    """The address of a writable buffer's first byte."""
    return np.frombuffer(buf, dtype=np.uint8, count=1).ctypes.data


class ShmBatchPipeline:
    """Batcher processes writing into a shared-memory slot ring.

    The threaded ``BatchPipeline``'s surface (``start()``, ``batch()``,
    ``stop()``, ``stats()``), the same constructor; ``stop()`` also joins
    the children and unlinks the segment."""

    mode = "shm"

    def __init__(self, args: Dict[str, Any], store: EpisodeStore, ctx,
                 stop_event: Optional[threading.Event] = None):
        self.args = args
        self.store = store
        self.ctx = ctx
        self.stop_event = stop_event or threading.Event()
        self.fused = max(1, int(args.get("fused_steps", 1)))
        self._n_slots = effective_shm_slots(dict(args, fused_steps=self.fused))
        self._device_queue: thqueue.Queue = thqueue.Queue(
            maxsize=max(1, int(args.get("prefetch_batches", 2))))
        if "fork" not in mp.get_all_start_methods():
            # the ready pipe's fds reach the children by fork inheritance
            raise RuntimeError("the shm batch pipeline needs the fork start method")
        self._mp = mp.get_context("fork")
        self._procs: List[Any] = []
        self._feed_qs: List[Any] = []
        self._free_qs: List[Any] = []
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._registered = 0      # address of the segment registered with CUDA, or 0
        self._slot_views = None
        self._mp_stop = None
        self._ready_r = self._ready_w = None
        self._consumer_thread: Optional[threading.Thread] = None
        self._started = False
        self._closed = False
        self._fallback: Optional[BatchPipeline] = None
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = {k: 0.0 for k in PIPE_STAT_KEYS}
        self._stats.update({k: 0.0 for k in PIPE_EVENT_KEYS})
        self._stats.update(batches=0.0, device_queue_depth_sum=0.0, gets=0.0)
        self._pending: deque = deque()
        self._pending_cv = threading.Condition()
        # supervision state (put thread only, except the counters)
        self._max_restarts = int(args.get("batcher_max_restarts", 3))
        self._stall_timeout = float(args.get("batcher_stall_timeout", 60.0))
        self._restarts = 0
        self._had_death = False
        self._last_child_check = 0.0
        self._last_death = 0.0

    @property
    def registered(self) -> bool:
        """Whether the ring is page-locked for the card (cudaHostRegister)."""
        return bool(self._registered)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        try:
            self._start_impl()
        except Exception:
            traceback.print_exc()
            print("[handyrl_tpu_torch] shared-memory batch pipeline failed to start (above); "
                  "falling back to threaded batchers (batch_pipeline: thread)", file=sys.stderr)
            self.close()
            fallback = BatchPipeline(self.args, self.store, self.ctx, self.stop_event)
            fallback._stats["batcher_fallback"] = 1.0
            fallback.start()
            self._fallback = fallback

    def _sample_template_windows(self):
        a = self.args
        windows = []
        while len(windows) < a["batch_size"]:
            if self.stop_event.is_set():
                return None
            w = self.store.sample_window(a["forward_steps"], a["burn_in_steps"], a["compress_steps"])
            if w is None:
                time.sleep(0.2)
                continue
            windows.append(w)
        return windows

    def _start_impl(self) -> None:
        # the accelerator is built and loaded here, before any fork: the
        # children inherit it and never compile
        _fill_accel()
        windows = self._sample_template_windows()
        if windows is None:
            return  # stopping before any episode arrived
        # one reference batch fixes the slot layout; children produce the
        # same bytes for the same windows (tests/test_torch_shm_pipeline.py)
        template = make_batch(windows, self.args)
        self._spec, self._slot_bytes = slot_spec(template)
        size = self._slot_bytes * self._n_slots
        self._shm = shared_memory.SharedMemory(create=True, size=size)
        atexit.register(self._unlink_quiet)
        # reserve the pages now: a tmpfs too small for the ring fails here,
        # not as a SIGBUS in a child's fill or in the registration below
        os.posix_fallocate(self._shm._fd, 0, size)
        self._slot_views = [slot_views(self._spec, self._shm.buf, i * self._slot_bytes)
                            for i in range(self._n_slots)]
        if self.ctx.device.type == "cuda":
            self._register(size)
        self._ready_r, self._ready_w = os.pipe()
        self._ready_buf = b""
        # a lock-free stop flag, not an mp.Event, whose is_set() takes a
        # shared lock that a SIGKILL'd child could die holding
        self._mp_stop = self._mp.Value("i", 0, lock=False)
        # slot ownership and generations; lock-free because the parent is
        # the only writer: owner[slot] is stamped before each deal and
        # cleared on receipt, slot_gen[slot] bumps only in the parent's hands
        self._owner = self._mp.Array("i", self._n_slots, lock=False)
        self._slot_gen = self._mp.Array("L", self._n_slots, lock=False)
        for i in range(self._n_slots):
            self._owner[i] = -1
        self._deal_rr = 0
        self._orphan_slots: List[int] = []
        self._spawn_children()

    def _register(self, size: int) -> None:
        """Page-lock the ring for the card, so copies out of a slot are
        asynchronous and need no staging copy."""
        import torch

        addr = _buffer_address(self._shm.buf)
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(addr, size, 0))
        self._registered = addr

    def _unregister(self) -> None:
        if self._registered:
            import torch

            torch.cuda.synchronize(self.ctx.device)  # no copy may still read the ring
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(self._registered))
            self._registered = 0

    def _spawn_children(self) -> None:
        # subscribe before snapshotting: an episode landing in between is
        # delivered twice (which only nudges a replica's sampling weights),
        # never lost
        self.store.subscribe(self._on_episodes)
        snapshot = [codec.dumps(ep) for ep in self.store.snapshot()]
        n = max(1, int(self.args["num_batchers"]))
        self._procs = [None] * n
        self._feed_qs = [None] * n
        self._free_qs = [None] * n
        for i in range(n):
            self._spawn_child(i, snapshot)
        for slot in range(self._n_slots):
            self._deal_slot(slot)
        threading.Thread(target=self._feeder_loop, daemon=True, name="shm-feeder").start()
        self._consumer_thread = threading.Thread(target=self._put_loop, daemon=True,
                                                 name="shm-put")
        self._consumer_thread.start()

    def _spawn_child(self, i: int, snapshot: Optional[List[bytes]] = None) -> None:
        """(Re)start batcher child ``i``, its replica seeded from the
        parent's store."""
        feed_q = self._mp.Queue()
        # publish before snapshotting: on a respawn the feeder is live, and
        # an episode arriving between the two would otherwise be lost
        self._feed_qs[i] = feed_q
        if snapshot is None:
            snapshot = [codec.dumps(ep) for ep in self.store.snapshot()]
        for blob in snapshot:
            feed_q.put(blob)
        free_q = self._mp.Queue()
        self._free_qs[i] = free_q
        proc = self._mp.Process(
            target=_batcher_main,
            args=(self._shm.name, self._spec, self._slot_bytes, self.args,
                  int(self.args.get("seed", 0)) + i + 7919 * self._restarts, os.getpid(),
                  feed_q, free_q, self._ready_w, self._mp_stop, self._slot_gen),
            daemon=True, name=f"shm-batcher-{i}",
        )
        with warnings.catch_warnings():
            # Python warns that fork from a multi-threaded process may
            # deadlock the child.  This child takes none of the locks the
            # learner's threads hold: it calls no torch or CUDA, re-creates
            # the block cache's lock, and keeps the collector off inherited
            # objects (_batcher_main); the warning is silenced for this fork
            # only
            warnings.filterwarnings("ignore", message=r".*multi-threaded.*fork",
                                    category=DeprecationWarning)
            proc.start()
        self._procs[i] = proc

    def _on_episodes(self, episodes: List[Dict[str, Any]]) -> None:
        # store.extend runs on the learner's server thread: only queue a
        # reference here; the feeder thread pays for the encoding
        with self._pending_cv:
            self._pending.extend(episodes)
            self._pending_cv.notify()

    def _feeder_loop(self) -> None:
        try:
            while not self.stop_event.is_set() and not self._closed:
                with self._pending_cv:
                    if not self._pending:
                        self._pending_cv.wait(timeout=0.3)
                    batch = list(self._pending)
                    self._pending.clear()
                for episode in batch:
                    blob = codec.dumps(episode)
                    for feed_q in tuple(self._feed_qs):
                        if feed_q is None:
                            continue
                        try:
                            feed_q.put(blob)
                        except (ValueError, OSError):
                            pass  # the queue of a child being replaced; its
                            # successor is seeded from the store's snapshot
        except Exception:
            traceback.print_exc()

    # -- slot dealing --------------------------------------------------------

    def _deal_slot(self, slot: int) -> None:
        """Hand a free slot to a live child's queue (round-robin), stamping
        its owner first, so the slot is attributed at every instant it is
        out of the parent's hands."""
        if self._closed or self.stop_event.is_set():
            self._orphan_slots.append(slot)  # teardown: nothing takes it again
            return
        n = len(self._procs)
        for off in range(n):
            i = (self._deal_rr + off) % n
            if self._procs[i] is not None:
                self._deal_rr = (i + 1) % n
                self._owner[slot] = i
                try:
                    self._free_qs[i].put(slot)
                except (ValueError, OSError):  # closed under our feet
                    self._orphan_slots.append(slot)
                return
        # every child is dead (between a death and its respawn): park the
        # slot; the respawn deals it again
        self._orphan_slots.append(slot)

    # -- supervision ---------------------------------------------------------

    def _check_children(self) -> None:
        """Reap dead children: reclaim their slots, respawn within the
        budget, degrade to threads past it.  Put thread only, throttled."""
        # never respawn during teardown: a child forked here would race
        # close()'s snapshot of the children and be neither joined nor killed
        if self.stop_event.is_set() or self._closed:
            return
        now = time.monotonic()
        if now - self._last_child_check < 0.25 or self._fallback is not None:
            return
        self._last_child_check = now
        for i, proc in enumerate(self._procs):
            if proc is None or proc.is_alive():
                continue
            exitcode = proc.exitcode
            proc.join(timeout=0)  # reap it: no zombie outlives the supervision
            self._procs[i] = None
            self._had_death = True
            self._last_death = now
            with self._lock:
                self._stats["batcher_deaths"] += 1
            # reclaim every slot dealt to the dead child; the generation
            # bumps first, so any ready message it sent is stale
            reclaimed = []
            for slot in range(self._n_slots):
                if self._owner[slot] == i:
                    self._owner[slot] = -1
                    self._slot_gen[slot] += 1
                    reclaimed.append(slot)
            # retire both of its queues unread (their reader lock may have
            # died with it); cancel_join_thread keeps a feeder thread blocked
            # on a full pipe from hanging the exit
            for old_q in (self._free_qs[i], self._feed_qs[i]):
                if old_q is not None:
                    old_q.cancel_join_thread()
                    old_q.close()
            self._free_qs[i] = None
            self._feed_qs[i] = None
            print(f"[handyrl_tpu_torch] batcher process {i} died (exitcode {exitcode}); "
                  f"reclaimed ring slots {reclaimed}", file=sys.stderr)
            for slot in reclaimed:
                self._deal_slot(slot)  # the survivors keep the ring flowing
            if self._restarts >= self._max_restarts:
                self._degrade(f"restart budget exhausted ({self._max_restarts})")
                return
            self._restarts += 1
            with self._lock:
                self._stats["batcher_restarts"] += 1
            try:
                self._spawn_child(i)
            except Exception:
                traceback.print_exc()
                self._degrade("batcher respawn failed")
                return
            print(f"[handyrl_tpu_torch] batcher process {i} respawned "
                  f"(restart {self._restarts}/{self._max_restarts})", file=sys.stderr)
            orphans, self._orphan_slots = self._orphan_slots, []
            for slot in orphans:
                self._deal_slot(slot)

    def _degrade(self, reason: str) -> None:
        """Swap in the threaded pipeline, loudly: ``pipe_batcher_fallback``
        becomes 1 and ``stats()['mode']`` 'thread'."""
        print(f"[handyrl_tpu_torch] shm batch pipeline degrading to threaded batchers: {reason}",
              file=sys.stderr)
        fallback = BatchPipeline(self.args, self.store, self.ctx, self.stop_event)
        with self._lock:
            # carry every cumulative counter over, or the degrading epoch's
            # per-epoch diffs would go negative
            fallback._stats.update(self._stats)
            fallback._stats["batcher_fallback"] = 1.0
        fallback.start()
        self._fallback = fallback

    # -- consumer side -------------------------------------------------------

    def _ready_next_record(self):
        """The next whole record from the ready pipe, or None after ~0.3 s
        of nothing.  Writes are atomic, so only a read can split a record."""
        if len(self._ready_buf) < _READY_REC.size:
            poller = select.poll()
            poller.register(self._ready_r, select.POLLIN)
            if not poller.poll(300):
                return None
            chunk = os.read(self._ready_r, 4096)
            if not chunk:
                return None
            self._ready_buf += chunk
        if len(self._ready_buf) < _READY_REC.size:
            return None
        record = _READY_REC.unpack(self._ready_buf[:_READY_REC.size])
        self._ready_buf = self._ready_buf[_READY_REC.size:]
        return record

    def _ready_get(self):
        t0 = time.perf_counter()
        t_enter = time.monotonic()
        while not self.stop_event.is_set():
            self._check_children()
            if self._fallback is not None:
                return None
            item = self._ready_next_record()
            if item is None:
                # after a death, a ring silent this long is given up on; the
                # clock starts at this call (time spent elsewhere, e.g. a full
                # device queue, is no stall) or at the death, if later
                if (self._had_death and time.monotonic() - max(t_enter, self._last_death)
                        > self._stall_timeout):
                    self._degrade(f"ring stalled > {self._stall_timeout:.0f}s after a batcher death")
                    return None
                continue
            slot, gen, t_sample, t_assemble, t_free = item
            if slot < 0:
                # the child printed its traceback and exits; the supervision
                # reaps it (respawn or degrade)
                print("[handyrl_tpu_torch] a batcher process failed (traceback on its stderr) "
                      "and will be reaped", file=sys.stderr)
                continue
            if gen != self._slot_gen[slot]:
                continue  # stale: from a child that died; the slot was reclaimed
            self._owner[slot] = -1
            self._had_death = False  # the ring proved itself after a death
            wait = time.perf_counter() - t0
            with self._lock:
                self._stats["ready_wait_s"] += wait
            trace_event("pipe.ready_wait", wait, plane="pipeline", mode="shm")
            return slot, t_sample, t_assemble, t_free
        return None

    def _put_loop(self) -> None:
        # groups in flight: a group's slots recycle only once its copies are
        # done, with up to two groups in flight (one copying while the next
        # is drained from the ring); effective_shm_slots leaves a dealable
        # slot with two groups pinned
        inflight: deque = deque()

        def retire_oldest() -> None:
            done, slots = inflight.popleft()
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            with self._lock:
                self._stats["put_s"] += time.perf_counter() - t0
            for slot in slots:
                self._slot_gen[slot] += 1
                self._deal_slot(slot)

        try:
            while not self.stop_event.is_set():
                group, slots = [], []
                while len(group) < self.fused:
                    item = self._ready_get()
                    if item is None:
                        # stopping or degraded: recycle the partial group so
                        # close() finds a consistent ring
                        for slot in slots:
                            self._slot_gen[slot] += 1
                            self._deal_slot(slot)
                        return
                    slot, t_sample, t_assemble, t_free = item
                    with self._lock:
                        self._stats["sample_s"] += t_sample
                        self._stats["assemble_s"] += t_assemble
                        self._stats["free_wait_s"] += t_free
                    group.append(self._slot_views[slot])
                    slots.append(slot)
                t0 = time.perf_counter()
                pinned = self.registered
                if self.fused > 1:
                    device_batch = self.ctx.put_batches(group, non_blocking=True, pinned=pinned)
                else:
                    device_batch = self.ctx.put_batch(group[0], non_blocking=True, pinned=pinned)
                done = None
                if self.ctx.device.type == "cuda":
                    import torch

                    done = torch.cuda.Event()
                    done.record()
                with self._lock:
                    self._stats["put_s"] += time.perf_counter() - t0
                    self._stats["batches"] += len(group)
                # hand the batch over first: the step waits on the event on
                # the card, and its launches overlap the copies' end
                queued = self._put_device((device_batch, done))
                inflight.append((done, slots))
                while len(inflight) > 1:
                    retire_oldest()
                if not queued:
                    return
        except Exception:
            traceback.print_exc()
            self.stop_event.set()
        finally:
            try:
                while inflight:
                    retire_oldest()
            except Exception:
                traceback.print_exc()
            # a degrade keeps the learner on the threaded pipeline; the shm
            # plane itself still tears down completely
            self.close()

    def _put_device(self, item) -> bool:
        while not self.stop_event.is_set():
            try:
                self._device_queue.put(item, timeout=0.3)
                return True
            except thqueue.Full:
                # a full device queue parks the put thread here: keep
                # supervising, or a death would go unnoticed until the
                # trainer drains a batch
                self._check_children()
                if self._fallback is not None:
                    return False
        return False

    def batch(self):
        """The next device batch, safe to read on the caller's stream; None
        when shutting down."""
        if self._fallback is not None:
            return self._fallback.batch()
        with self._lock:
            self._stats["device_queue_depth_sum"] += self._device_queue.qsize()
            self._stats["gets"] += 1
        while not self.stop_event.is_set():
            if self._fallback is not None:
                return self._fallback.batch()  # degraded mid-wait
            try:
                device_batch, done = self._device_queue.get(timeout=0.3)
            except thqueue.Empty:
                continue
            if done is not None:
                done.wait()
            return device_batch
        return None

    # -- teardown / introspection -------------------------------------------

    def stop(self) -> None:
        self.stop_event.set()  # a fallback pipeline shares the event
        self.close()

    def close(self) -> None:
        """Join every child, close the queues and the pipe, unregister and
        unlink the segment.  Idempotent; runs on every exit path."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.store.unsubscribe(self._on_episodes)
        if self._mp_stop is not None:
            self._mp_stop.value = 1
        procs = [p for p in self._procs if p is not None]
        for proc in procs:
            proc.join(timeout=5.0)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
        for q in [q for q in self._feed_qs + self._free_qs if q is not None]:
            q.cancel_join_thread()
            q.close()
        # the put thread reads the ready fd: join it (unless this is it)
        # before closing the fds, or a reused fd number could be read
        consumer = self._consumer_thread
        if consumer is not None and consumer is not threading.current_thread():
            consumer.join(timeout=5.0)
        for fd in (self._ready_r, self._ready_w):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._ready_r = self._ready_w = None
        self._slot_views = None
        if self._shm is not None:
            try:
                self._unregister()
            except Exception:
                traceback.print_exc()
            gc.collect()  # release the numpy views of shm.buf before unmapping
            try:
                self._shm.close()
            except BufferError:
                pass
            self._unlink_quiet()
        atexit.unregister(self._unlink_quiet)

    def _unlink_quiet(self) -> None:
        if self._shm is None:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def stats(self) -> Dict[str, Any]:
        if self._fallback is not None:
            return self._fallback.stats()
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
        out["mode"] = self.mode
        return out
