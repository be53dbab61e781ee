"""Batch assembly on the card: ``batch_pipeline: device``.

Counterpart of ``handyrl_tpu/runtime/device_batch.py``.  The host
pipelines (threaded, shm) assemble every batch on the host and upload it
whole, observation planes included, once per update.  This one uploads
each host-born episode (worker actors, remote workers, device rollouts
assembled on the host) once, and every batch after that is gathers in
card memory:

    EpisodeStore -- episodes (subscribe, then snapshot: the stream the
      |             shm plane mirrors to its children)
      v
    feeder thread: decode once -> DeviceEpisodeStage lane queues
      -> (chunk, lanes) ring ingest         [one upload per chunk]
    batch(): window sample and assembly from the rings
      -> a (B, T, P, ...) batch on the card  [no upload]

Window assembly is DeviceReplay's, so the parity tests of the streaming
path cover it.  The shm plane stays the default and the fallback: this
pipeline refuses a misconfigured stage at construction, and
``make_pipeline`` then degrades loudly to shm.  One process, one card: the
JAX package's multi-process branch (each process sampling its own rings
and crossing through ``put_batch``) waits for ROADMAP A8.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

import torch

from ..utils import tree_map
from ..utils.trace import trace_event
from .device_replay import DeviceEpisodeStage
from .replay import EpisodeStore
from .trainer import PIPE_EVENT_KEYS, PIPE_STAT_KEYS


class DeviceBatchPipeline:
    """On-card batch assembly for host-born episodes: the
    ``start()``/``batch()``/``stop()``/``stats()`` surface of the host
    pipelines; ``batch()`` returns tensors on the card, a (k, B, ...) stack
    under ``fused_steps`` k > 1."""

    mode = "device"

    def __init__(self, args: Dict[str, Any], store: EpisodeStore, ctx,
                 stop_event: Optional[threading.Event] = None):
        self.args = args
        self.store = store
        self.ctx = ctx
        self.stop_event = stop_event or threading.Event()
        # this process's share of the global batch: the trainer hands its
        # pipeline the local batch (``local_batch_size``), and under several
        # ranks each samples its own rings, staged on its own card
        self._batch = int(args["batch_size"])
        self._fused = max(1, int(args.get("fused_steps", 1)))
        # raises on a misconfigured window mode (a recurrent net without
        # turn windows, observation off, slots too shallow): make_pipeline
        # catches it and degrades loudly
        self.stage = DeviceEpisodeStage(
            ctx.module, args,
            n_lanes=int(args.get("device_stage_lanes", 8)),
            slots=int(args.get("device_stage_slots", 1024)),
            chunk_steps=int(args.get("device_stage_chunk", 64)),
            device=ctx.device,
        )
        from ..parallel.distributed import process_index

        self._gen = torch.Generator(device=ctx.device).manual_seed(
            (int(args.get("seed", 0)) ^ 0xD17A) + 1009 * process_index())
        self._eligible = False
        self._started = False
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = {k: 0.0 for k in PIPE_STAT_KEYS}
        self._stats.update({k: 0.0 for k in PIPE_EVENT_KEYS})
        self._stats.update(batches=0.0, device_queue_depth_sum=0.0, gets=0.0)
        self._pending: deque = deque()
        self._pending_cv = threading.Condition()
        self._feeder_idle = False   # the feeder waits with nothing pending
        self._feeder_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        # subscribe before the snapshot: an episode landing in between is
        # staged twice (a slight lane imbalance), while one missed would be
        # a hole forever
        self.store.subscribe(self._on_episodes)
        snapshot = self.store.snapshot()
        with self._pending_cv:
            self._pending.extend(snapshot)
            self._pending_cv.notify()
        self._feeder_thread = threading.Thread(target=self._feeder_loop, daemon=True,
                                               name="device-stage-feeder")
        self._feeder_thread.start()

    def _on_episodes(self, episodes) -> None:
        with self._pending_cv:
            self._pending.extend(episodes)
            self._pending_cv.notify()

    def _feeder_loop(self) -> None:
        """Decode, stage and flush on a thread of its own: decoding is paid
        once per episode, not per update."""
        try:
            while not self.stop_event.is_set():
                with self._pending_cv:
                    if not self._pending:
                        self._feeder_idle = True
                        self._pending_cv.notify_all()
                        self._pending_cv.wait(timeout=0.3)
                    episodes = list(self._pending)
                    self._pending.clear()
                    self._feeder_idle = not episodes
                if not episodes:
                    continue
                t0 = time.perf_counter()
                for episode in episodes:
                    try:
                        self.stage.add_episode(episode)
                    except Exception:
                        # one malformed episode must not take the plane down
                        # (the shm feeder tolerates the same); a failing
                        # flush below is fatal: that is ring state
                        traceback.print_exc()
                t1 = time.perf_counter()
                self.stage.flush()
                t2 = time.perf_counter()
                with self._lock:
                    # assemble = host decode and staging, put = the ring
                    # ingest (the once-per-chunk upload)
                    self._stats["assemble_s"] += t1 - t0
                    self._stats["put_s"] += t2 - t1
        except Exception:
            traceback.print_exc()   # a silent dead pipeline would starve the trainer
            self.stop_event.set()
        finally:
            try:
                self.stage.drain()
            except Exception:
                pass

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Wait until the feeder has staged and flushed every episode it was
        given and waits for more (its flushes read the rings' counters, a
        host sync on its thread); False on timeout."""
        with self._pending_cv:
            return self._pending_cv.wait_for(
                lambda: self._feeder_idle and not self._pending, timeout)

    # -- consumer side -------------------------------------------------------

    def batch(self):
        """The next batch on the card, or None when shutting down (the
        trainer's epoch loop has no other exit)."""
        if self.stop_event.is_set():
            return None
        with self._lock:
            self._stats["gets"] += 1
        if not self._eligible:
            t0 = time.perf_counter()
            warned_at = t0
            while not self.stop_event.is_set():
                if self.stage.eligible() > 0:
                    self._eligible = True
                    break
                now = time.perf_counter()
                if now - warned_at > 30.0:
                    # a chunk flushes only when every lane has chunk steps
                    # queued: say so rather than wait silently
                    warned_at = now
                    print(f"[handyrl_tpu_torch] device batch pipeline waiting for sampleable "
                          f"windows ({now - t0:.0f}s): {self.stage.steps_staged} steps staged "
                          f"over {self.stage.n_lanes} lanes, first flush needs "
                          f"{self.stage.n_lanes * self.stage.chunk_steps}; lower "
                          "device_stage_lanes/device_stage_chunk if this persists",
                          file=sys.stderr)
                time.sleep(0.05)
            wait = time.perf_counter() - t0
            with self._lock:
                self._stats["ready_wait_s"] += wait
            trace_event("pipe.ready_wait", wait, plane="pipeline", mode="device")
            if not self._eligible:
                return None
        t0 = time.perf_counter()
        k, B = self._fused, self._batch
        out = self.stage.replay.sample(self._gen, k * B)
        if k > 1:
            # rows are i.i.d. draws, so k*B rows reshaped are k batches of B
            out = tree_map(lambda x: x.reshape((k, B) + tuple(x.shape[1:])), out)
        with self._lock:
            self._stats["sample_s"] += time.perf_counter() - t0
            self._stats["batches"] += k
        return out

    # -- teardown and introspection -------------------------------------------

    def stop(self) -> None:
        self.stop_event.set()
        try:
            self.store.unsubscribe(self._on_episodes)
        except Exception:
            pass
        feeder = self._feeder_thread
        if feeder is not None and feeder is not threading.current_thread():
            feeder.join(timeout=30.0)
        try:
            self.stage.drain()
        except Exception:
            pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
        out["mode"] = self.mode
        out["episodes_staged"] = self.stage.episodes_staged
        out["steps_staged"] = self.stage.steps_staged
        out["chunks_flushed"] = self.stage.chunks_flushed
        return out
