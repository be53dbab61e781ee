"""Learner-side training: the threaded batch pipeline and the SGD thread.

Counterpart of ``handyrl_tpu/runtime/trainer.py``, single process, with
the threaded pipeline (the shared-memory and device pipelines wait for
ROADMAP A5/A7):

    batcher threads (sample windows + make_batch, numpy)
      -> host batch queue
      -> put thread (pinned memory, non-blocking copy, CUDA event)
      -> device batch queue
      -> Trainer.run() on its own thread, one train step per batch

The pipeline keeps cumulative stage timings (``stats()``), which the
trainer diffs per epoch into the ``pipe_*`` keys of metrics.jsonl, so a
nonzero ``input_wait_frac`` can be laid at a stage.

The epoch handshake is the reference's: the learner's ``update()`` raises a
flag and blocks on a one-slot queue; the trainer ends its epoch after the
next step and hands over a CPU copy of its params (never the live
tensors).  The lr is ``3e-8 * lr_scale * data_cnt_ema / (1 + steps *
1e-5)``, held for an epoch; the data-count EMA moves at the epoch's end
from the steps that were applied.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from ..parallel import TrainContext
from ..parallel.train_step import LOSS_KEYS
from ..utils import tree_map
from .batch import make_batch
from .replay import EpisodeStore

# the pipeline's cumulative stage timings, diffed per epoch into pipe_<key>
PIPE_STAT_KEYS = ("sample_s", "assemble_s", "free_wait_s", "ready_wait_s", "put_s")


def host_copy(tree):
    """A copy of a (nested) state dict with every tensor detached on the CPU."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)


class BatchPipeline:
    """Threaded replay -> numpy batch -> device batch pipeline."""

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
        self._stats.update(batches=0.0, device_queue_depth_sum=0.0, gets=0.0)

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
                batch = self._get(self._host_queue)
                t1 = time.perf_counter()
                if batch is None:
                    return
                device_batch = self.ctx.put_batch(batch, non_blocking=True)
                ready = None
                if self.ctx.device.type == "cuda":
                    # the copies were enqueued, not finished: the step waits
                    # on this event before it reads the batch
                    ready = torch.cuda.Event()
                    ready.record()
                with self._stats_lock:
                    self._stats["ready_wait_s"] += t1 - t0
                    self._stats["put_s"] += time.perf_counter() - t1
                    self._stats["batches"] += 1
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
    through ``update()``.  ``train_epoch(n)`` also takes ``n`` steps
    synchronously, from batches drawn on the calling thread."""

    def __init__(self, args: Dict[str, Any], module, device=None):
        self.args = args
        self.ctx = TrainContext(module, args, device)
        self.store = EpisodeStore(args["maximum_episodes"])
        self.stop_event = threading.Event()
        self.batcher = BatchPipeline(args, self.store, self.ctx, self.stop_event)
        self._pipe_stats0: Dict[str, Any] = {}
        # the run's first batch wait is the pipeline's warm-up, reported
        # apart from the steady-state input_wait_frac
        self._warmup_wait_pending = True
        self.default_lr = 3e-8 * args["lr_scale"]
        self.data_cnt_ema = args["batch_size"] * args["forward_steps"]
        self.steps = 0
        self.sentinel_skipped_steps = 0
        self.last_loss: Dict[str, float] = {}
        self.stats: Dict[str, float] = {}
        self.update_flag = False
        self.update_queue: queue.Queue = queue.Queue(maxsize=1)
        self.error: Optional[BaseException] = None
        # host copy of params + optimizer state, replaced at each epoch end
        # on the trainer's thread: what checkpoints and publishing read
        self.state_host = self._snapshot()

    @property
    def lr(self) -> float:
        return self.default_lr * self.data_cnt_ema / (1 + self.steps * 1e-5)

    def _snapshot(self) -> Dict[str, Any]:
        return {
            "params": host_copy(self.ctx.module.state_dict()),
            "opt_state": host_copy(self.ctx.optimizer.state_dict()),
            "steps": self.steps,
        }

    def save_payload(self, epoch: int) -> Dict[str, Any]:
        """Checkpoint payload: train state + epoch tag + lr-schedule EMA."""
        return {**self.state_host, "epoch": int(epoch), "data_cnt_ema": float(self.data_cnt_ema)}

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
        self.ctx.optimizer.load_state_dict(host["opt_state"])
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
            for _ in range(a["batch_size"])
        ]
        return make_batch(windows, a)

    def train_epoch(self, num_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """One epoch at one lr; returns the steps' metrics.  With
        ``num_steps`` None, steps take the pipeline's batches until the
        learner flags the epoch's end (after at least one step) or the
        trainer stops; otherwise ``num_steps`` steps take batches drawn
        here.  Either way the epoch ends with the EMA update and the stats."""
        lr = self.lr
        history: List[Dict[str, float]] = []
        wait_s = warmup_wait_s = 0.0
        t_epoch = time.perf_counter()
        while num_steps is None or len(history) < num_steps:
            if num_steps is None:
                if history and self.update_flag:
                    break
                t0 = time.perf_counter()
                batch = self.batcher.batch()
                waited = time.perf_counter() - t0
                if self._warmup_wait_pending:
                    self._warmup_wait_pending = False
                    warmup_wait_s = waited
                else:
                    wait_s += waited
                if batch is None:  # stopping
                    break
            else:
                batch = self.sample_batch()
            history.append(self.ctx.train_step(batch, lr))
            self.steps += 1
        if history:
            self._finish_epoch(history, time.perf_counter() - t_epoch, wait_s, warmup_wait_s)
        return history

    def _finish_epoch(self, history, elapsed: float, wait_s: float, warmup_wait_s: float) -> None:
        skipped = int(sum(m.get("sentinel_bad", 0.0) for m in history))
        self.sentinel_skipped_steps += skipped
        data_cnt = sum(m["dcnt"] for m in history)
        self.last_loss = {k: sum(m[k] for m in history) / max(data_cnt, 1) for k in LOSS_KEYS}
        print("loss = %s" % " ".join(f"{k}:{v:.3f}" for k, v in self.last_loss.items()))
        elapsed = max(elapsed, 1e-9)
        self.stats = {
            "train_steps_per_sec": len(history) / elapsed,
            "input_wait_frac": wait_s / elapsed,
            "sentinel_skipped_steps": self.sentinel_skipped_steps,  # cumulative
        }
        if warmup_wait_s:
            self.stats["input_wait_warmup_s"] = round(warmup_wait_s, 4)
        cur, prev = self.batcher.stats(), self._pipe_stats0
        for key in PIPE_STAT_KEYS:
            self.stats["pipe_" + key] = round(cur[key] - prev.get(key, 0.0), 4)
        gets = cur["gets"] - prev.get("gets", 0.0)
        if gets > 0:
            self.stats["pipe_device_queue_depth"] = round(
                (cur["device_queue_depth_sum"] - prev.get("device_queue_depth_sum", 0.0)) / gets, 3)
        self._pipe_stats0 = cur
        # skipped steps added nothing to data_cnt, so they leave the divisor
        applied = len(history) - skipped
        if applied > 0:
            self.data_cnt_ema = self.data_cnt_ema * 0.8 + data_cnt / (1e-2 + applied) * 0.2

    def _warmed_up(self) -> bool:
        return len(self.store) >= self.args["minimum_episodes"]

    def update(self):
        """Ask for an epoch boundary; blocks until the epoch's (params,
        steps) are ready.  Before the warm-up threshold nothing has trained:
        (None, steps) at once."""
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

    def run(self) -> None:
        """The trainer thread: wait for ``minimum_episodes``, then train
        epoch after epoch until stopped.  An exception stops the trainer and
        stays in ``error`` for the learner to raise."""
        try:
            print("waiting training")
            while not self._warmed_up():
                if self.stop_event.wait(0.5):
                    return
            self.batcher.start()
            print("started training")
            while not self.stop_event.is_set():
                self.train_epoch()
                self.state_host = self._snapshot()
                self.update_flag = False
                item = (self.state_host["params"], self.steps)
                while not self.stop_event.is_set():
                    try:
                        self.update_queue.put(item, timeout=0.3)
                        break
                    except queue.Full:
                        continue
        except Exception as exc:
            traceback.print_exc()
            self.error = exc
            self.stop()
