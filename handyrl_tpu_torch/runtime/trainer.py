"""Learner-side training: the batch pipelines and the SGD thread.

Counterpart of ``handyrl_tpu/runtime/trainer.py``, single process.  The
default assembly plane is the JAX package's: batcher processes writing
columnar batches into shared-memory ring slots (runtime/shm_batch.py,
``batch_pipeline: shm``).  The threaded pipeline below (``batch_pipeline:
thread``, or ``num_batchers: 0``) is the in-process reference and what the
shm plane degrades to:

    batcher threads (sample windows + make_batch, numpy)
      -> host batch queue
      -> put thread (pinned memory, non-blocking copy, CUDA event)
      -> device batch queue
      -> Trainer.run() on its own thread, fused_steps updates per batch

Both pipelines keep cumulative stage timings and supervision counters
(``stats()``); the trainer diffs the timings per epoch into the ``pipe_*``
keys of metrics.jsonl, so a nonzero ``input_wait_frac`` can be laid at a
stage, and records the counters cumulatively as ``pipe_batcher_*``.

The epoch handshake is the reference's: the learner's ``update()`` raises a
flag and blocks on a one-slot queue; the trainer ends its epoch after the
next pull and hands over a CPU copy of its params (never the live
tensors).  The lr is ``3e-8 * lr_scale * data_cnt_ema / (1 + steps *
1e-5)``, held for an epoch; the data-count EMA moves at the epoch's end
from the updates that were applied.

The divergence sentinel, as the JAX trainer's without a cadence: the
step's in-step skips (``sentinel_bad``) and the loss spikes the epoch's
end finds (a loss above ``sentinel_spike_factor`` x the loss EMA, which bad
steps never feed) extend one streak of bad steps; at
``sentinel_rollback_after`` the train state goes back to the newest
verified snapshot with a fresh optimizer, the step counter kept and the
device replay's sampling generator re-seeded.  The rolled-back params are
the epoch's snapshot, so they reach the actors at that boundary.  The
``HANDYRL_FAULT_NAN_AT_STEP`` and ``HANDYRL_FAULT_SIGTERM_AT_STEP``
injections (runtime/faults.py) and the spans ``train_step``,
``batch.wait`` and ``epoch.metrics_fetch`` (utils/trace.py) sit in the
epoch loop; ``profile_dir`` captures the first trained epoch with
``torch.profiler``.

Under a learner of several processes (parallel/distributed.py) the epoch's
end, the run's stop and a drain are the coordinator's: the learner sets
``cadence`` and the loop asks it once per step (``agree_step``) and once
per boundary (``agree_stop``), so every rank takes the same steps; each
step's gradient bucket is summed over the ranks (parallel/train_step.py),
on this process's share of the batch (``local_batch_size``).  The
collective watchdog (parallel/health.py) is armed around every collective
once the first step is done.  Under ``seq_attention: ring`` the ranks of
one ``sp`` group share a data shard (global batch / dp): the group's leader
assembles it from its own store and pipeline, and every batch is broadcast
to the others, which keep no pipeline of their own
(``SequenceGroupPipeline``); each epoch records the ring's
``dist_ring_ms`` and ``dist_ring_bytes`` per step.
``HANDYRL_FAULT_WEDGE_PROCESS`` freezes the
thread before its next one.  A sentinel rollback is agreed too: the
coordinator's manifest verdict goes out through ``agree_rollback_epoch``
and its params through ``broadcast_params``, so every rank installs the
same bytes.
"""

from __future__ import annotations

import os
import queue
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from ..parallel import TrainContext
from ..parallel.distributed import (
    CMD_DRAIN, CMD_END, CollectiveError, local_batch_size, process_count, process_index,
)
from ..parallel.train_step import LOSS_KEYS, make_optimizer
from ..utils import tree_map
from ..utils.trace import trace_event, trace_span
from . import faults
from .batch import make_batch
from .replay import EpisodeStore

# the pipeline's cumulative stage timings, diffed per epoch into pipe_<key>
PIPE_STAT_KEYS = ("sample_s", "assemble_s", "free_wait_s", "ready_wait_s", "put_s")

# the shm plane's supervision events (batcher deaths, respawns, the degrade
# to threads), recorded cumulatively as pipe_<key>: a nonzero value anywhere
# in a run means the assembly plane took a fault
PIPE_EVENT_KEYS = ("batcher_deaths", "batcher_restarts", "batcher_fallback")

# the divergence sentinel's events, cumulative in metrics.jsonl: in-step
# skips, loss spikes, rollbacks to a verified snapshot
SENTINEL_EVENT_KEYS = ("sentinel_skipped_steps", "sentinel_spike_steps", "sentinel_rollbacks",
                       # asked for by the serving tier's quality sentinel
                       # (flywheel/quality.py -> the learner -> request_rollback)
                       "sentinel_flywheel_rollbacks")


def host_copy(tree):
    """A copy of a (nested) state dict with every tensor detached on the CPU."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)


class SequenceGroupPipeline:
    """The batch plane of a sequence-parallel group: every batch of the
    leader's pipeline (``inner``) is broadcast over the ``sp`` group, and a
    member, which has no pipeline (``inner`` None), takes the leader's.
    Every rank calls ``batch()`` at the same step of the cadence; a leader
    that is stopping sends None, and its members stop with it."""

    def __init__(self, inner, group):
        self.inner, self.group = inner, group
        self.mode = inner.mode if inner is not None else "sp-member"

    def start(self) -> None:
        if self.inner is not None:
            self.inner.start()

    def batch(self):
        return self.group.broadcast_batch(self.inner.batch() if self.inner is not None else None)

    def stop(self) -> None:
        if self.inner is not None:
            self.inner.stop()

    def stats(self) -> Dict[str, Any]:
        if self.inner is not None:
            return self.inner.stats()
        zero = {key: 0.0 for key in PIPE_STAT_KEYS + PIPE_EVENT_KEYS
                + ("batches", "gets", "device_queue_depth_sum")}
        return dict(zero, mode=self.mode)


def make_pipeline(args: Dict[str, Any], store: EpisodeStore, ctx: TrainContext,
                  stop_event: Optional[threading.Event] = None):
    """The configured batch-assembly pipeline: ``batch_pipeline: shm`` with
    ``num_batchers > 0`` forks batcher processes writing into shared memory
    (runtime/shm_batch.py); ``device`` uploads host-born episodes once into
    rings on the card and samples and assembles every batch there
    (runtime/device_batch.py), or, when it cannot be built, says so and
    takes the shm plane; ``thread``, ``num_batchers: 0``, or an shm plane
    that cannot be built, the threaded pipeline.  All expose
    start()/batch()/stop()/stats()."""
    mode = args.get("batch_pipeline", "shm")
    if mode == "device":
        try:
            from .device_batch import DeviceBatchPipeline

            return DeviceBatchPipeline(args, store, ctx, stop_event)
        except Exception:
            traceback.print_exc()
            print("[handyrl_tpu_torch] device batch pipeline unavailable (above); "
                  "falling back to the shm assembly plane", file=sys.stderr)
            mode = "shm"
    if mode == "shm" and int(args.get("num_batchers", 0)) > 0:
        try:
            from .shm_batch import ShmBatchPipeline

            return ShmBatchPipeline(args, store, ctx, stop_event)
        except Exception:
            traceback.print_exc()
            print("[handyrl_tpu_torch] shared-memory batch pipeline unavailable (above); "
                  "using threaded batchers", file=sys.stderr)
    return BatchPipeline(args, store, ctx, stop_event)


class BatchPipeline:
    """Threaded replay -> numpy batch -> device batch pipeline; with
    ``fused_steps`` k > 1 each device item stacks k batches."""

    mode = "thread"

    def __init__(self, args: Dict[str, Any], store: EpisodeStore, ctx: TrainContext,
                 stop_event: Optional[threading.Event] = None):
        self.args = args
        self.store = store
        self.ctx = ctx
        self.stop_event = stop_event or threading.Event()
        self.num_batchers = max(1, int(args.get("num_batchers", 2)))
        self._host_queue: queue.Queue = queue.Queue(maxsize=max(2, self.num_batchers))
        self._device_queue: queue.Queue = queue.Queue(maxsize=max(1, args.get("prefetch_batches", 2)))
        self._started = False
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, float] = {k: 0.0 for k in PIPE_STAT_KEYS}
        self._stats.update({k: 0.0 for k in PIPE_EVENT_KEYS})
        self._stats.update(batches=0.0, device_queue_depth_sum=0.0, gets=0.0)
        self.fused = max(1, int(args.get("fused_steps", 1)))

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.num_batchers):
            threading.Thread(target=self._assemble_loop, daemon=True, name=f"batcher-{i}").start()
        threading.Thread(target=self._put_loop, daemon=True, name="batch-put").start()

    def _sample_windows(self):
        a = self.args
        windows = []
        while len(windows) < a["batch_size"]:
            if self.stop_event.is_set():
                return None
            w = self.store.sample_window(a["forward_steps"], a["burn_in_steps"], a["compress_steps"])
            if w is None:
                time.sleep(0.5)
                continue
            windows.append(w)
        return windows

    def _put(self, q: queue.Queue, item) -> bool:
        while not self.stop_event.is_set():
            try:
                q.put(item, timeout=0.3)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: queue.Queue):
        while not self.stop_event.is_set():
            try:
                return q.get(timeout=0.3)
            except queue.Empty:
                continue
        return None

    def _assemble_loop(self) -> None:
        try:
            while not self.stop_event.is_set():
                t0 = time.perf_counter()
                windows = self._sample_windows()
                if windows is None:
                    return
                t1 = time.perf_counter()
                batch = make_batch(windows, self.args)
                t2 = time.perf_counter()
                self._put(self._host_queue, batch)
                t3 = time.perf_counter()
                with self._stats_lock:
                    self._stats["sample_s"] += t1 - t0
                    self._stats["assemble_s"] += t2 - t1
                    self._stats["free_wait_s"] += t3 - t2  # host queue full: consumer-bound
        except Exception:
            traceback.print_exc()  # a silent dead pipeline would starve the trainer
            self.stop_event.set()

    def _put_loop(self) -> None:
        try:
            while not self.stop_event.is_set():
                t0 = time.perf_counter()
                group = []
                while len(group) < self.fused:
                    batch = self._get(self._host_queue)
                    if batch is None:
                        return
                    group.append(batch)
                t1 = time.perf_counter()
                if self.fused > 1:
                    device_batch = self.ctx.put_batches(group, non_blocking=True)
                else:
                    device_batch = self.ctx.put_batch(group[0], non_blocking=True)
                ready = None
                if self.ctx.device.type == "cuda":
                    # the copies were enqueued, not finished: the step waits
                    # on this event before it reads the batch
                    ready = torch.cuda.Event()
                    ready.record()
                with self._stats_lock:
                    self._stats["ready_wait_s"] += t1 - t0
                    self._stats["put_s"] += time.perf_counter() - t1
                    self._stats["batches"] += len(group)
                trace_event("pipe.ready_wait", t1 - t0, plane="pipeline", mode=self.mode)
                self._put(self._device_queue, (device_batch, ready))
        except Exception:
            traceback.print_exc()
            self.stop_event.set()

    def batch(self):
        """The next device batch, safe to read on the caller's stream; None
        when shutting down."""
        with self._stats_lock:
            self._stats["device_queue_depth_sum"] += self._device_queue.qsize()
            self._stats["gets"] += 1
        item = self._get(self._device_queue)
        if item is None:
            return None
        device_batch, ready = item
        if ready is not None:
            ready.wait()
        return device_batch

    def stop(self) -> None:
        self.stop_event.set()

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            out: Dict[str, Any] = dict(self._stats)
        out["mode"] = self.mode
        return out


class Trainer:
    """The SGD loop, run on a daemon thread by the learner; epoch handoff
    through ``update()``.  Each pull of the pipeline brings ``fused_steps``
    batches, taken as that many updates in a row.  ``train_epoch(n)`` also
    takes ``n`` single steps synchronously, from batches drawn on the
    calling thread."""

    def __init__(self, args: Dict[str, Any], module, device=None, mesh=None):
        self.args = args
        self.ctx = TrainContext(module, args, device, mesh)
        self.store = EpisodeStore(args["maximum_episodes"])
        self.stop_event = threading.Event()
        self.fused = max(1, int(args.get("fused_steps", 1)))
        # this process's share of the global batch: the pipelines assemble
        # it (a forked shm batcher reads it from its args, never from the
        # process group), and the gradients are summed over the ranks; the
        # ranks of an sp group share one share, which its leader assembles
        seq = self.ctx.seq_group
        self.local_batch = local_batch_size(
            int(args["batch_size"]), None if seq is None else process_count() // seq.size)
        if seq is not None and not seq.is_leader:
            self.batcher = SequenceGroupPipeline(None, seq)
        else:
            self.batcher = make_pipeline(dict(args, batch_size=self.local_batch), self.store,
                                         self.ctx, self.stop_event)
            if seq is not None:
                self.batcher = SequenceGroupPipeline(self.batcher, seq)
        self._pipe_stats0: Dict[str, Any] = {}
        self._reduce_stats0 = {"calls": 0, "seconds": 0.0}
        self._ring_stats0 = {"shifts": 0, "bytes": 0, "seconds": 0.0}
        # the run's first batch wait is the pipeline's warm-up, reported
        # apart from the steady-state input_wait_frac
        self._warmup_wait_pending = True
        self.default_lr = 3e-8 * args["lr_scale"]
        self.data_cnt_ema = args["batch_size"] * args["forward_steps"]
        self.steps = 0
        self.sentinel_rollback_after = int(args.get("sentinel_rollback_after", 8))
        self._spike_factor = float(args.get("sentinel_spike_factor", 10.0))
        self._loss_ema_decay = float(args.get("sentinel_loss_ema_decay", 0.9))
        self._loss_ema: Optional[float] = None
        self._sentinel_streak = 0
        self.sentinel_events: Dict[str, int] = {k: 0 for k in SENTINEL_EVENT_KEYS}
        # parsed here, so a test sets the environment before construction
        self._fault_nan = faults.nan_window()
        self._fault_sigterm = faults.sigterm_at_step()
        self._fault_sigterm_fired = False
        # an epoch the quality plane asked to roll back to, taken at the next
        # epoch's start on the trainer's own thread (0 = the newest verified)
        self._requested_rollback: Optional[int] = None
        self.last_loss: Dict[str, float] = {}
        self.stats: Dict[str, float] = {}
        self.update_flag = False
        self.update_queue: queue.Queue = queue.Queue(maxsize=1)
        self.error: Optional[BaseException] = None
        # the on-card replay (runtime/device_replay.py), set by the learner
        # under device_replay: true; the epoch loop then samples, assembles
        # and steps from its rings, and the batch pipeline is never started
        self.device_replay = None
        self._rank = process_index()
        self._replay_gen = torch.Generator(device=self.ctx.device).manual_seed(
            (int(args.get("seed", 0)) ^ 0x7EA1) + 1009 * self._rank)
        # the coordinator's cadence under several ranks, set by the learner:
        # epoch end, stop and drain are then agreed, never decided locally,
        # or the other ranks would wait in a collective forever
        self.cadence = None
        self.collective_watchdog = None
        self.on_agreed_finish = None   # the learner disarms its health plane here
        self.on_collective_fault = None  # a failed collective: the learner's host fault
        self.finished = False          # run() returned through an agreed stop
        self.drain_agreed = False      # the epoch ended with the DRAIN bit
        self._drain_flag = False       # coordinator: send DRAIN next
        self._fault_wedge_process = False  # freeze before the next collective
        self._proceed_queue: queue.Queue = queue.Queue(maxsize=1)
        self._awaiting_proceed = False
        self._collective_dispatched = False  # arms the watchdog after the first step
        # host copy of params + optimizer state, replaced at each epoch end
        # on the trainer's thread: what checkpoints and publishing read
        self.state_host = self._snapshot()

    @property
    def lr(self) -> float:
        return self.default_lr * self.data_cnt_ema / (1 + self.steps * 1e-5)

    @property
    def sentinel_skipped_steps(self) -> int:
        return self.sentinel_events["sentinel_skipped_steps"]

    def _snapshot(self) -> Dict[str, Any]:
        return {
            "params": host_copy(self.ctx.module.state_dict()),
            "opt_state": host_copy(self.ctx.optimizer.state_dict()),
            "steps": self.steps,
        }

    def save_payload(self, epoch: int) -> Dict[str, Any]:
        """Checkpoint payload: train state + epoch tag + lr-schedule EMA."""
        return {**self.state_host, "epoch": int(epoch), "data_cnt_ema": float(self.data_cnt_ema)}

    def drain_payload(self, epoch: int):
        """(params, state payload, steps) of the drain's checkpoint, read
        from one ``state_host`` reference, which the trainer thread swaps
        whole at an epoch's end: the three stay consistent."""
        host = self.state_host
        payload = {**host, "epoch": int(epoch), "data_cnt_ema": float(self.data_cnt_ema)}
        return host["params"], payload, int(host["steps"])

    def load_state(self, path: str, expected_epoch: int) -> bool:
        """Resume params, Adam moments, step count and lr EMA from
        state.ckpt.  False (a fresh optimizer) when the file is unreadable
        or was written at another epoch than ``expected_epoch``: starting
        from an earlier snapshot is a branch, not a resume."""
        from .checkpoint import load_train_state

        try:
            host = load_train_state(path)
            ckpt_epoch = int(host["epoch"])
        except Exception as exc:
            print(f"state.ckpt unreadable ({type(exc).__name__}: {exc}); "
                  "resuming with a fresh optimizer")
            return False
        if ckpt_epoch != expected_epoch:
            print(f"state.ckpt is from epoch {ckpt_epoch}, not {expected_epoch}; "
                  "branching with a fresh optimizer")
            return False
        self.ctx.module.load_state_dict(host["params"])
        self.ctx.load_optimizer_state(host["opt_state"])
        self.data_cnt_ema = float(host["data_cnt_ema"])
        self.steps = int(host["steps"])
        self.state_host = {k: host[k] for k in ("params", "opt_state", "steps")}
        print(f"resumed train state at step {self.steps} from {path}")
        return True

    def sample_batch(self) -> Dict[str, Any]:
        """One numpy batch of ``batch_size`` windows from the store."""
        a = self.args
        if len(self.store) == 0:
            raise RuntimeError("the episode store is empty")
        windows = [
            self.store.sample_window(a["forward_steps"], a["burn_in_steps"], a["compress_steps"])
            for _ in range(self.local_batch)
        ]
        return make_batch(windows, a)

    def train_epoch(self, num_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """One epoch at one lr; returns the metrics of each pull (summed over
        its ``fused_steps`` updates).  With ``num_steps`` None, pulls take
        the pipeline's batches until the learner flags the epoch's end
        (after at least one pull) or the trainer stops; otherwise
        ``num_steps`` single steps take batches drawn here.  Under
        device_replay the pulls sample from the rings instead (see
        ``_replay_epoch``).  Either way the epoch ends with the EMA update
        and the stats."""
        self._consume_requested_rollback()
        lr = self.lr
        history: List[Dict[str, float]] = []
        updates = 0
        wait_s = warmup_wait_s = 0.0
        t_epoch = time.perf_counter()
        if self.device_replay is not None and num_steps is None:
            self._replay_epoch(history, lr)
            updates = self.fused * len(history)
        else:
            while num_steps is None or len(history) < num_steps:
                if num_steps is None:
                    if self.cadence is not None:
                        # the coordinator's epoch end: every rank takes the
                        # same steps, or the next collective waits forever
                        if self._agree_step(bool(history)) & CMD_END:
                            break
                    elif history and self.update_flag:
                        break
                    t0 = time.perf_counter()
                    batch = self.batcher.batch()
                    waited = time.perf_counter() - t0
                    if self._warmup_wait_pending:
                        self._warmup_wait_pending = False
                        warmup_wait_s = waited
                    else:
                        wait_s += waited
                    trace_event("batch.wait", waited, plane="learner")
                    if batch is None:  # stopping
                        if self.cadence is not None and self.cadence.is_coordinator:
                            # end the epoch THROUGH the cadence: a bare break
                            # would strand the followers in the broadcast
                            self._drain_flag = True
                            continue
                        break
                    k = self.fused
                else:
                    batch, k = self.sample_batch(), 1
                step_lr = self._step_lr(lr, k)
                self._arm(f"train_step @ step {self.steps}")
                try:
                    with trace_span("train_step", plane="learner"):
                        if k > 1:
                            history.append(self.ctx.train_steps(batch, step_lr))
                        else:
                            history.append(self.ctx.train_step(batch, step_lr))
                finally:
                    self._disarm()
                self._collective_dispatched = True
                updates += k
                self.steps += k
                self._maybe_fault_sigterm()
        if history:
            self._finish_epoch(history, updates, time.perf_counter() - t_epoch, wait_s,
                               warmup_wait_s)
        return history

    def _step_lr(self, lr: float, k: int) -> float:
        """The lr of the next k updates, NaN inside the
        HANDYRL_FAULT_NAN_AT_STEP window."""
        w = self._fault_nan
        if w is not None:
            start, count = w
            if self.steps < start + count and self.steps + k > start:
                return float("nan")
        return lr

    def _maybe_fault_sigterm(self) -> None:
        """HANDYRL_FAULT_SIGTERM_AT_STEP: a preemption in mid-epoch."""
        if (self._fault_sigterm is not None and not self._fault_sigterm_fired
                and self.steps >= self._fault_sigterm):
            self._fault_sigterm_fired = True
            print(f"[fault] SIGTERM at step {self.steps} (HANDYRL_FAULT_SIGTERM_AT_STEP)",
                  file=sys.stderr)
            os.kill(os.getpid(), signal.SIGTERM)

    def _replay_epoch(self, history: List[Dict[str, float]], lr: float) -> None:
        """The epoch on the card: each pull samples, assembles and steps
        ``fused_steps`` updates from the replay's rings, until the learner
        flags the epoch's end (after at least one pull) or the trainer
        stops; under the cadence, until the coordinator's END.  Reading pull N-1's metrics after pull N is launched keeps
        one pull in flight, so the concurrent rollout thread gets the card
        at every boundary (the JAX loop blocks on update N-1 likewise); on
        the CPU a short sleep per pull hands the replay's lock to the
        rollout thread, which an unfair lock would otherwise starve."""
        train = self.device_replay.train_fn(self.ctx, self.fused)
        on_cpu = self.ctx.device.type == "cpu"
        while True:
            if self.cadence is not None:
                # each rank samples its share from its own rings on its
                # own card and steps; the epoch's end is the coordinator's
                if self._agree_step(bool(history)) & CMD_END:
                    break
                if self.stop_event.is_set():
                    if self.cadence.is_coordinator:
                        self._drain_flag = True
                        continue
                    break
            elif (history and self.update_flag) or self.stop_event.is_set():
                break
            self._arm(f"train_step @ step {self.steps}")
            try:
                with trace_span("train_step", plane="learner"):
                    history.append(train(self._replay_gen, self._step_lr(lr, self.fused)))
                if len(history) > 1:
                    history[-2].fetch()
            finally:
                self._disarm()
            self._collective_dispatched = True
            self.steps += self.fused
            self._maybe_fault_sigterm()
            if on_cpu:
                time.sleep(0.02)

    def _finish_epoch(self, history, updates: int, elapsed: float, wait_s: float,
                      warmup_wait_s: float) -> None:
        # the epoch's metrics reach the host here (a pull's at its first
        # read); the span holds that and the epoch's accounting (and a
        # rollback, when one is due)
        with trace_span("epoch.metrics_fetch", plane="learner"):
            # the wait for the card (and, under NCCL, the epoch's last
            # collectives) is watched like a collective
            self._arm("epoch-end metrics fetch")
            try:
                for m in history:
                    m.fetch()
            finally:
                self._disarm()
            skipped = self._sentinel_account(history) if self.ctx.sentinel else 0
            data_cnt = sum(m["dcnt"] for m in history)
            self.last_loss = {k: sum(m[k] for m in history) / max(data_cnt, 1)
                              for k in LOSS_KEYS}
        print("loss = %s" % " ".join(f"{k}:{v:.3f}" for k, v in self.last_loss.items()))
        elapsed = max(elapsed, 1e-9)
        self.stats = {
            "train_steps_per_sec": updates / elapsed,
            "input_wait_frac": wait_s / elapsed,
        }
        if self.ctx.sentinel:
            self.stats.update(self.sentinel_events)   # cumulative
        if warmup_wait_s:
            self.stats["input_wait_warmup_s"] = round(warmup_wait_s, 4)
        reduce = self.ctx.grad_reduce
        if reduce is not None:   # the gradient bucket's collective, this epoch
            cur = reduce.stats()
            prev, self._reduce_stats0 = self._reduce_stats0, cur
            calls = cur["calls"] - prev["calls"]
            if calls > 0:
                seconds = cur["seconds"] - prev["seconds"]
                self.stats.update(dist_allreduce_ms=round(seconds / calls * 1e3, 4),
                                  dist_allreduce_bytes=cur["bucket_bytes"],
                                  dist_allreduce_calls=calls)
        seq = self.ctx.seq_group
        if seq is not None and updates > 0:   # the ring's shifts, per step this epoch
            cur, prev = seq.stats(), self._ring_stats0
            self._ring_stats0 = cur
            self.stats.update(
                dist_ring_ms=round((cur["seconds"] - prev["seconds"]) / updates * 1e3, 4),
                dist_ring_bytes=int((cur["bytes"] - prev["bytes"]) // updates),
                dist_ring_shifts=int((cur["shifts"] - prev["shifts"]) // updates))
        # skipped steps added nothing to data_cnt, so they leave the divisor
        applied = updates - skipped
        if applied > 0:
            self.data_cnt_ema = self.data_cnt_ema * 0.8 + data_cnt / (1e-2 + applied) * 0.2
        if self.device_replay is not None:  # no host pipeline runs
            return
        cur, prev = self.batcher.stats(), self._pipe_stats0
        for key in PIPE_STAT_KEYS + ("batches",):
            self.stats["pipe_" + key] = round(cur[key] - prev.get(key, 0.0), 4)
        for key in PIPE_EVENT_KEYS:  # cumulative, not diffed
            self.stats["pipe_" + key] = cur.get(key, 0.0)
        gets = cur["gets"] - prev.get("gets", 0.0)
        if gets > 0:
            self.stats["pipe_device_queue_depth"] = round(
                (cur["device_queue_depth_sum"] - prev.get("device_queue_depth_sum", 0.0)) / gets, 3)
        self._pipe_stats0 = cur

    def _sentinel_account(self, fetched: List[Dict[str, Any]]) -> int:
        """The sentinel's books over an epoch's per-pull metrics: in-step
        skips and loss spikes extend one streak of bad steps, a clean pull
        resets it, and neither kind of bad step feeds the loss EMA.  At
        ``sentinel_rollback_after`` the state rolls back.  Returns the
        in-step skipped steps (they applied nothing, so the lr schedule's
        data-count average leaves them out)."""
        skipped = 0
        for m in fetched:
            bad = int(round(float(m.get("sentinel_bad", 0.0))))
            if bad:
                skipped += bad
                self.sentinel_events["sentinel_skipped_steps"] += bad
                self._sentinel_streak += bad
                continue
            dcnt = float(m["dcnt"])
            if dcnt <= 0:
                continue
            loss = abs(float(m["total"])) / dcnt
            if self._loss_ema is not None and loss > self._spike_factor * max(self._loss_ema, 1e-8):
                self.sentinel_events["sentinel_spike_steps"] += self.fused
                self._sentinel_streak += self.fused
                continue
            self._sentinel_streak = 0
            d = self._loss_ema_decay
            self._loss_ema = loss if self._loss_ema is None else d * self._loss_ema + (1 - d) * loss
        if self._sentinel_streak >= self.sentinel_rollback_after:
            self._sentinel_rollback()
        return skipped

    def _sentinel_rollback(self) -> None:
        """Roll the train state back to the newest verified snapshot of
        ``model_dir``.  With none, or with a corrupt manifest, the params
        stay (the in-step skips kept them finite) and the streak starts
        over on fresh evidence."""
        from . import checkpoint as ckpt

        self._sentinel_streak = 0
        self._loss_ema = None
        model_dir = self.args.get("model_dir", "models")
        if self.cadence is not None:
            self._agreed_rollback(ckpt, model_dir)
            return
        try:
            epoch = ckpt.latest_verified_epoch(model_dir)
        except ckpt.CheckpointError as exc:
            print(f"[sentinel] rollback wanted but the manifest is corrupt ({exc}); "
                  "keeping current params", file=sys.stderr)
            return
        if epoch <= 0:
            print("[sentinel] divergence streak hit the rollback threshold but no verified "
                  "snapshot exists yet; keeping current params (in-step skips already "
                  "suppressed the bad updates)", file=sys.stderr)
            return
        params = ckpt.load_verified_params(model_dir, epoch, pre_verified=True)
        self.sentinel_events["sentinel_rollbacks"] += 1
        self._reset_state_from(params)
        print(f"[sentinel] rolled back to verified epoch {epoch} after a divergence streak "
              f"(step counter stays at {self.steps}; fresh optimizer; re-seeded sampling "
              "generator)", file=sys.stderr)

    def _agreed_rollback(self, ckpt, model_dir: str) -> None:
        """The rollback across ranks.  Every rank is here together (the
        streak comes from the summed step metrics, the same everywhere),
        but only the coordinator owns the checkpoint files: its manifest
        verdict and then the snapshot's params ride broadcasts, so every
        rank rolls back to one entry (or none does) and the params stay
        bit for bit the same."""
        from ..parallel.distributed import broadcast_params

        local_epoch = 0
        if self.cadence.is_coordinator:
            try:
                local_epoch = ckpt.latest_verified_epoch(model_dir)
            except ckpt.CheckpointError as exc:
                print(f"[sentinel] rollback wanted but the manifest is corrupt ({exc}); "
                      "keeping current params on every process", file=sys.stderr)
        self._arm("sentinel rollback agreement")
        try:
            epoch = self.cadence.agree_rollback_epoch(local_epoch)
        finally:
            self._disarm()
        if epoch <= 0:
            print("[sentinel] divergence streak hit the rollback threshold but the coordinator "
                  "has no verified snapshot; keeping current params (in-step skips already "
                  "suppressed the bad updates)", file=sys.stderr)
            return
        if self.cadence.is_coordinator:
            params = ckpt.load_verified_params(model_dir, epoch, pre_verified=True)
        else:
            params = self.state_host["params"]   # like-shaped; the broadcast fills it
        self._arm("sentinel rollback params broadcast")
        try:
            params = broadcast_params(params)
        finally:
            self._disarm()
        self.sentinel_events["sentinel_rollbacks"] += 1
        self._reset_state_from(params)
        print(f"[sentinel] rolled back to verified epoch {epoch} on every process after a "
              f"divergence streak (step counter stays at {self.steps}; fresh optimizer; "
              "re-seeded sampling generator)", file=sys.stderr)

    def request_rollback(self, epoch: int) -> None:
        """Ask for a rollback to verified ``epoch`` (<= 0: the newest
        verified), the serving tier's quality signal.  Called from the
        learner's thread; the reset happens at the next epoch's start on the
        trainer's thread, never in the middle of a step."""
        self._requested_rollback = int(epoch)

    def _consume_requested_rollback(self) -> None:
        requested = self._requested_rollback
        if requested is None:
            return
        self._requested_rollback = None
        if self.cadence is not None:
            # one rank's reset would leave the ranks' params apart
            print("[flywheel] quality rollback requested while the cadence of several "
                  "processes is active; skipping the one-sided reset", file=sys.stderr)
            return
        from . import checkpoint as ckpt

        model_dir = self.args.get("model_dir", "models")
        try:
            target = requested if requested > 0 else ckpt.latest_verified_epoch(model_dir)
            if target <= 0:
                print("[flywheel] quality rollback requested but no verified snapshot exists; "
                      "keeping current params", file=sys.stderr)
                return
            # a full digest check: the signal names an epoch the serving tier
            # trusted, not one this process verified
            params = ckpt.load_verified_params(model_dir, target)
        except (ckpt.CheckpointError, OSError) as exc:
            print(f"[flywheel] quality rollback to epoch {requested} refused ({exc}); keeping "
                  "current params", file=sys.stderr)
            return
        self._sentinel_streak = 0
        self._loss_ema = None
        self.sentinel_events["sentinel_flywheel_rollbacks"] += 1
        self._reset_state_from(params)
        print(f"[flywheel] rolled back to verified epoch {target} on the serving tier's quality "
              f"signal (step counter stays at {self.steps}; fresh optimizer; re-seeded sampling "
              "generator)", file=sys.stderr)

    def _reset_state_from(self, params) -> None:
        """The rollback's tail: ``params`` into the module, a fresh Adam
        (the moments fed the divergence), the step counter kept monotone
        (the lr schedule keys off it), and the device replay's sampling
        generator moved far from the stream that fed the poison."""
        ctx = self.ctx
        ctx.module.load_state_dict(params)
        ctx.optimizer = make_optimizer(ctx.module)
        seed = ((int(self.args.get("seed", 0)) ^ 0x7EA1)
                + 0x9E3779B9 * (self.sentinel_events["sentinel_rollbacks"]
                                + self.sentinel_events["sentinel_flywheel_rollbacks"])
                + self.steps)
        seed += 1009 * self._rank
        self._replay_gen = torch.Generator(device=ctx.device).manual_seed(seed % (1 << 63))
        self.state_host = self._snapshot()

    def _warmed_up(self) -> bool:
        """``minimum_episodes`` in the store, or under device_replay (the
        store bypassed) ingested into the rings.  A member of an sp group
        has no store: its leader's warm-up holds the cadence back."""
        seq = self.ctx.seq_group
        if seq is not None and not seq.is_leader:
            return True
        if self.device_replay is not None:
            return self.device_replay.counters["episodes"] >= self.args["minimum_episodes"]
        return len(self.store) >= self.args["minimum_episodes"]

    def update(self):
        """Ask for an epoch boundary; blocks until the epoch's (params,
        steps) are ready.  Before the warm-up threshold nothing has trained:
        (None, steps) at once.  A follower asks for nothing: the
        coordinator's broadcast ends the epoch on every rank, and its
        learner calls this once the snapshot is in the queue."""
        if self.cadence is not None and not self.cadence.is_coordinator:
            while not self.stop_event.is_set():
                try:
                    return self.update_queue.get(timeout=1.0)
                except queue.Empty:
                    continue
            return None, self.steps
        if not self._warmed_up():
            return None, self.steps
        self.update_flag = True
        while not self.stop_event.is_set():
            try:
                return self.update_queue.get(timeout=1.0)
            except queue.Empty:
                continue
        return None, self.steps

    def stop(self) -> None:
        self.stop_event.set()
        self.batcher.stop()

    def request_drain(self) -> None:
        """The preemption drain: stop mid-epoch; the thread's snapshot on
        its way out is what the drain's checkpoint saves.  Under the
        cadence the coordinator sets the DRAIN bit instead, and the next
        broadcast ends the epoch on every rank; a follower's own SIGTERM
        cannot drive the cadence, so it waits for the agreed drain."""
        if self.cadence is None:
            self.stop()
        elif self.cadence.is_coordinator:
            self._drain_flag = True

    def proceed(self, stop: bool) -> None:
        """Coordinator under the cadence: the learner's continue/stop
        decision for the epoch it just consumed, which run() broadcasts so
        that every rank stops (or goes on) together.  A no-op unless run()
        waits for it."""
        if self.cadence is None or not self._awaiting_proceed:
            return
        self._proceed_queue.put(bool(stop))

    def _await_proceed(self):
        """The learner's decision (True = stop), or None when stop() came
        with no decision delivered.  A decision already delivered is still
        returned after a stop: the followers wait in the broadcast for it."""
        while not self.stop_event.is_set():
            try:
                return self._proceed_queue.get(timeout=1.0)
            except queue.Empty:
                continue
        try:
            return self._proceed_queue.get_nowait()
        except queue.Empty:
            return None

    def _agreed_finish(self) -> None:
        """The stop or drain broadcast returned here and, a collective, on
        every rank: the run is over everywhere, and the learner disarms
        its health plane now, before the ranks' teardowns drift apart."""
        if self.on_agreed_finish is not None:
            self.on_agreed_finish()

    # -- cadence and watchdog plumbing -----------------------------------------

    def _wedge_forever(self) -> None:
        """HANDYRL_FAULT_WEDGE_PROCESS landed on this rank: a frozen host,
        this thread never progresses and never exits."""
        print("[fault] trainer wedged: no longer joining collectives "
              "(HANDYRL_FAULT_WEDGE_PROCESS)", file=sys.stderr, flush=True)
        while True:
            time.sleep(60.0)

    def _arm(self, tag: str) -> None:
        wd = self.collective_watchdog
        if wd is not None and self._collective_dispatched:
            # the first step builds kernels and warms the allocator: the
            # heartbeat plane covers a peer lost before it
            wd.arm(tag)

    def _disarm(self) -> None:
        wd = self.collective_watchdog
        if wd is not None:
            wd.disarm()

    def _agree_step(self, stepped: bool) -> int:
        """One cadence broadcast per loop iteration: the coordinator's
        epoch end (the boundary asked for and a step taken) and its DRAIN
        bit, received by every rank."""
        if self._fault_wedge_process:
            self._wedge_forever()
        self._arm("cadence agree_step")
        try:
            cmd = self.cadence.agree_step(end=stepped and self.update_flag,
                                          drain=self._drain_flag)
        finally:
            self._disarm()
        if cmd & CMD_DRAIN:
            self.drain_agreed = True
        return cmd

    def _start_profile(self):
        """``profile_dir``: a torch.profiler capture of the first trained
        epoch, CPU and (on the card) CUDA activities."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.ctx.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        prof.stop()
        profile_dir = self.args["profile_dir"]
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trainer_epoch.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"wrote profiler trace to {path}")

    def _agree_boundary(self) -> bool:
        """After an epoch's snapshot under the cadence: True when the run
        ends here on every rank.  An agreed drain ends it with no further
        collective; otherwise the coordinator waits for its learner's
        decision and broadcasts it (``agree_stop``), followers join the
        broadcast at once."""
        if self.drain_agreed:
            self.finished = True
            self._agreed_finish()
            return True
        if self.cadence.is_coordinator:
            stop_local = self._await_proceed()
            self._awaiting_proceed = False
            if stop_local is None:
                return True
            # only the coordinator arms here: a follower reaches this
            # broadcast at once, the coordinator after its boundary's save,
            # which may outlast the collective bound on a healthy run
            self._arm("cadence agree_stop")
        else:
            stop_local = False
            self._awaiting_proceed = False
            if self.stop_event.is_set():
                # forced down locally: it cannot drive the cadence; the
                # peers leave through the collective watchdog
                return True
        try:
            stop = self.cadence.agree_stop(stop_local)
        finally:
            self._disarm()
        if stop:
            self.finished = True
            self._agreed_finish()
        return stop

    def run(self) -> None:
        """The trainer thread: wait for ``minimum_episodes``, then train
        epoch after epoch until stopped.  An exception stops the trainer and
        stays in ``error`` for the learner to raise."""
        try:
            print("waiting training")
            while not self._warmed_up():
                if self.stop_event.wait(0.5):
                    return
            if self.device_replay is None:
                self.batcher.start()
            print("started training")
            prof = self._start_profile() if self.args.get("profile_dir") else None
            while not self.stop_event.is_set():
                try:
                    self.train_epoch()
                finally:
                    if prof is not None:  # the first epoch, or its interruption
                        self._stop_profile(prof)
                        prof = None
                self.state_host = self._snapshot()
                self.update_flag = False
                if self.cadence is not None:
                    self._awaiting_proceed = True
                item = (self.state_host["params"], self.steps)
                while not self.stop_event.is_set():
                    try:
                        self.update_queue.put(item, timeout=0.3)
                        break
                    except queue.Full:
                        continue
                if self.cadence is not None and self._agree_boundary():
                    return
        except CollectiveError as exc:
            if self.on_collective_fault is None:
                traceback.print_exc()
                self.error = exc
                self.stop()
                return
            # a peer is gone (its connections closed under our collective):
            # the learner's host fault drain-saves and leaves 75
            self.on_collective_fault(f"a collective failed: {exc}")
        except Exception as exc:
            traceback.print_exc()
            self.error = exc
            self.stop()
