"""The learner: role assignment, episode books, epoch cadence, checkpoints.

Counterpart of ``handyrl_tpu/runtime/learner.py``, single process:

* jobs handed to workers as 'g' (generate) or 'e' (evaluate), evaluation
  at ``max(eval_rate, update_episodes ** -0.15)`` of the jobs;
* per-model-id generation stats and per-opponent win rates;
* an epoch boundary every ``update_episodes`` returned episodes after a
  ``minimum_episodes`` warm-up: the trainer's snapshot is saved (atomic,
  manifest-verified), published to the actors, and one record appended to
  metrics.jsonl;
* shutdown after ``epochs`` epochs: further job requests are answered
  None, so the workers drain.

Workers are threads sharing the batched inference engine; their requests
arrive on one queue that the server loop consumes.  With ``remote=True``
(``--train-server``) the actors run on worker machines instead, served over
TCP by ``runtime/server.py``'s ``WorkerServer``: a gather asks for ``n``
assignments at once and uploads lists, a vanished connection's jobs come
back as ``jobs_lost``, and the drain waits for the live connections.

With ``device_rollout_games > 0`` a rollout thread plays self-play games of
the env's device twin on the card (runtime/device_rollout.py, the fused
plane of one card): it runs a module of its own, loaded from the model
server's published snapshot when the epoch changes, pauses once the
epoch's episode budget is met, and hands its episodes to the server loop,
which stores them and counts them as generation jobs, so host workers tilt
towards evaluation.  A watchdog restarts the thread when it dies or stalls.
With ``device_eval_games > 0`` each epoch boundary first plays that many
games of the published model against ``rulebase`` or ``random`` on the
card (runtime/device_eval.py), filed as opponent ``device-<name>``.  The
JAX package's distributed learner, fault injection, tracing, data
flywheel, device replay, split plane and preemption drain are not ported
(ROADMAP).
"""

from __future__ import annotations

import json
import os
import queue
import random
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional

import torch

from ..envs import make_env, prepare_env
from ..models import init_variables
from ..utils import resolve_device
from . import batch, codec
from .checkpoint import (
    gc_snapshots,
    latest_verified_epoch,
    load_verified_params,
    save_epoch_snapshot,
    verify_state,
)
from .trainer import Trainer
from .worker import LocalModelServer, LocalWorkerPool


class Learner:
    """``Learner(args).run()`` trains to ``epochs`` epochs; ``args`` is a
    normalised config (``env_args`` and ``train_args``).  It runs on the
    card unless ``device`` names another device; ``remote`` serves worker
    machines over TCP in place of local actor threads."""

    # seconds the drain waits for remote connections that linger after
    # the learner answered their last job request with None
    DRAIN_GRACE = 30.0

    def __init__(self, args: Dict[str, Any], net=None, device=None, remote: bool = False):
        train_args = dict(args["train_args"])
        train_args["env"] = args["env_args"]
        self.args = train_args
        self.device = resolve_device(device)
        random.seed(self.args["seed"])

        prepare_env(args["env_args"])
        self.env = make_env(args["env_args"])
        update_episodes = self.args["update_episodes"]
        self.eval_rate = max(self.args["eval_rate"], update_episodes ** 0.85 / update_episodes)
        self.shutdown_flag = False
        self.model_dir = self.args["model_dir"]
        self.module = net if net is not None else self.env.net()
        init_variables(self.module, self.args["seed"])

        self.model_epoch = self.args["restart_epoch"]
        auto_resumed = False
        if self.model_epoch < 0:
            # the newest snapshot that verifies, older ones where the newest
            # is corrupt; 0 = a fresh start
            self.model_epoch = latest_verified_epoch(self.model_dir)
            auto_resumed = self.model_epoch > 0
            print(f"auto-resume (restart_epoch: -1): epoch {self.model_epoch}"
                  if auto_resumed else
                  "auto-resume (restart_epoch: -1): no verified snapshot; fresh start")
        if self.model_epoch > 0:
            self.module.load_state_dict(
                load_verified_params(self.model_dir, self.model_epoch, pre_verified=auto_resumed))
        # the device planes are set up before anything starts, so a
        # misconfiguration fails the run here
        self._setup_device_planes()

        self.generation_results: Dict[int, tuple] = {}
        self.num_episodes = 0
        self.num_returned_episodes = 0
        self.results: Dict[int, tuple] = {}
        self.results_per_opponent: Dict[int, Dict[str, tuple]] = {}
        self.num_results = 0
        # in-flight jobs of vanished worker connections, handed back (remote)
        self.jobs_lost = {"g": 0, "e": 0}

        self.trainer = Trainer(self.args, self.module, self.device)
        # the configured plane; an shm pipeline may still fall back to
        # threads when it starts, so each record reads the live mode.  The
        # codec accelerator is built here, before any batcher is forked
        print("batch pipeline: %s configured (num_batchers=%d); codec accelerator %s, C fill %s"
              % (self.trainer.batcher.mode, self.args["num_batchers"],
                 "on" if codec.get_accel() is not None else "off",
                 "on" if batch._fill_accel() is not None else "off"))
        if self.model_epoch > 0:
            state_path = os.path.join(self.model_dir, "state.ckpt")
            if not os.path.exists(state_path):
                print(f"{state_path} not found; resuming with a fresh optimizer")
            elif verify_state(self.model_dir, self.model_epoch) is False:
                print(f"{state_path} fails digest verification; resuming with a fresh optimizer")
            else:
                self.trainer.load_state(state_path, self.model_epoch)
        self.model_server = LocalModelServer(self.module, make_env(args["env_args"]), self.args,
                                             self.device)
        self.model_server.publish(self.model_epoch, self.trainer.state_host["params"])
        self.remote = remote
        if remote:
            from .server import WorkerServer

            self.worker = WorkerServer(self.args, self.handle, self.model_server)
        else:
            self.worker = LocalWorkerPool(self.args, self.handle, self.model_server)

        self._requests: queue.Queue = queue.Queue()
        self._active_workers = 0
        self._shutdown_t0 = 0.0
        self._epoch_t0 = time.time()
        self._epoch_steps0 = self.trainer.steps  # nonzero after a resume
        self._epoch_episodes0 = 0
        self._trainer_thread: Optional[threading.Thread] = None
        self._metrics_tail_checked = False
        self._next_update_episodes = self.args["minimum_episodes"] + update_episodes

    def _vector_env(self, key: str):
        vector_env = getattr(self.env, "vector_env", None)
        if vector_env is None:
            raise ValueError(f"{key} set but env {self.args['env'].get('env')} exposes no "
                             "vector_env()")
        return vector_env()

    def _setup_device_planes(self) -> None:
        """The rollout and the evaluator of the device twin, each
        with a copy of the module on this learner's device."""
        self._device_games = int(self.args["device_rollout_games"])
        self._device_roll = None
        self._device_eval = None
        self._rollout_thread: Optional[threading.Thread] = None
        self._rollout_gen = 0
        self._rollout_progress_t = time.monotonic()
        self._rollout_dispatched = False
        self._watchdog_events = {"plane_watchdog_stalls": 0, "plane_watchdog_restarts": 0}
        # the epoch records' plane: "none" once the watchdog has given up
        self._plane = "fused"
        # device episodes and their game steps this epoch
        self._device_epoch_eps = 0
        self._device_epoch_steps = 0
        if self._device_games > 0:
            venv = self._vector_env("device_rollout_games")
            if self.args["observation"] and not hasattr(venv, "observe_mask"):
                raise ValueError(
                    "device_rollout_games with observation: true requires a vector env that "
                    f"records observer views (an observe_mask hook); {venv.__name__} records "
                    "acting players only; use host actors instead"
                )
            from .device_rollout import make_device_rollout

            self._device_roll = make_device_rollout(venv, self.module, self.args,
                                                    self._device_games, device=self.device)
        n_eval = int(self.args["device_eval_games"])
        if n_eval > 0:
            venv = self._vector_env("device_eval_games")
            opp_list = self.args["eval"].get("opponent") or ["random"]
            if not isinstance(opp_list, list):
                opp_list = [opp_list]
            opp = opp_list[0]
            if opp not in ("random", "rulebase") or (
                opp == "rulebase" and not hasattr(venv, "rule_based_action_all")
            ):
                # loudly: a config asking for rulebase curves would otherwise
                # quietly chart another opponent
                print(f"[handyrl_tpu_torch] device eval: opponent '{opp}' unavailable for this "
                      "vector env; evaluating vs 'random' instead")
                opp = "random"
            from .device_eval import DeviceEvaluator

            # DeviceEvaluator refuses an episodic twin at construction
            self._device_eval = DeviceEvaluator(venv, self.module, n_lanes=min(64, max(8, n_eval)),
                                                opponent=opp, device=self.device)

    # -- request plumbing ---------------------------------------------------

    def handle(self, req: str, data: Any, timeout: Optional[float] = None) -> Any:
        """Thread-safe entry point for workers; blocks until served."""
        fut: Future = Future()
        self._requests.put((req, data, fut))
        return fut.result(timeout=timeout)

    # -- bookkeeping --------------------------------------------------------

    def feed_episodes(self, episodes: List[Optional[Dict]]) -> None:
        for episode in episodes:
            if episode is None:
                continue
            for p in episode["args"]["player"]:
                model_id = episode["args"]["model_id"][p]
                outcome = episode["outcome"][p]
                n, r, r2 = self.generation_results.get(model_id, (0, 0, 0))
                self.generation_results[model_id] = n + 1, r + outcome, r2 + outcome ** 2
            self.num_returned_episodes += 1
            if self.num_returned_episodes % 100 == 0:
                print(self.num_returned_episodes, end=" ", flush=True)
        self.trainer.store.extend(episodes)

    def feed_results(self, results: List[Optional[Dict]]) -> None:
        for result in results:
            if result is None:
                continue
            for p in result["args"]["player"]:
                model_id = result["args"]["model_id"][p]
                res = result["result"][p]
                n, r, r2 = self.results.get(model_id, (0, 0, 0))
                self.results[model_id] = n + 1, r + res, r2 + res ** 2
                per_opp = self.results_per_opponent.setdefault(model_id, {})
                n, r, r2 = per_opp.get(result["opponent"], (0, 0, 0))
                per_opp[result["opponent"]] = n + 1, r + res, r2 + res ** 2

    # -- epoch boundary -----------------------------------------------------

    @staticmethod
    def _win_rate(stats) -> tuple:
        n, r, _ = stats
        return (r / (n + 1e-6) + 1) / 2, n

    def _feed_device_eval(self) -> None:
        """Batched on-device matches of the published snapshot, filed in
        the same books as the workers' evaluation results."""
        epoch, params = self.model_server.latest_snapshot()
        counts = self._device_eval.evaluate(params, int(self.args["device_eval_games"]),
                                            self.args["seed"] + 0xE7A1 + self.model_epoch)
        opponent = "device-" + self._device_eval.opponent
        self.feed_results([
            {"args": {"player": [0], "model_id": {0: epoch}},
             "result": {0: outcome}, "opponent": opponent}
            for outcome, n in counts.items() for _ in range(n)
        ])

    def update(self) -> None:
        print()
        print("epoch %d" % self.model_epoch)
        record: Dict[str, Any] = {"epoch": self.model_epoch}

        if self._device_eval is not None:
            try:
                self._feed_device_eval()
            except Exception as exc:  # an evaluation never kills the boundary
                print(f"device eval failed: {type(exc).__name__}: {exc}")

        if self.model_epoch not in self.results:
            print("win rate = n/a (0 games)")
            record["win_rate"] = None
        else:
            def output_wp(name, stats):
                wr, n = self._win_rate(stats)
                tag = " (%s)" % name if name else ""
                print("win rate%s = %.3f (%.1f / %d)" % (tag, wr, wr * n, n))
                record.setdefault("win_rate", {})[name or "total"] = wr

            per_opp = self.results_per_opponent.get(self.model_epoch, {})
            # under device evaluation the record always names each opponent,
            # so a device-<name> rate is told from the host workers' games
            if (self._device_eval is None and len(self.args["eval"].get("opponent", [])) <= 1
                    and len(per_opp) <= 1):
                output_wp("", self.results[self.model_epoch])
            else:
                output_wp("total", self.results[self.model_epoch])
                for key in sorted(per_opp):
                    output_wp(key, per_opp[key])

        if self.model_epoch not in self.generation_results:
            print("generation stats = n/a (0 episodes)")
            record["generation_mean"] = None
        else:
            n, r, r2 = self.generation_results[self.model_epoch]
            mean = r / (n + 1e-6)
            std = max(r2 / (n + 1e-6) - mean ** 2, 0.0) ** 0.5
            print("generation stats = %.3f +- %.3f" % (mean, std))
            record["generation_mean"] = mean
            record["generation_std"] = std

        # the boundary's cost, spent while every actor waits on this thread:
        # the trainer's last step and host snapshot, the save, the publish
        epoch_steps0 = self._epoch_steps0
        t0 = time.perf_counter()
        params, steps = self.trainer.update()
        if self.trainer.error is not None:
            raise RuntimeError("the trainer thread failed") from self.trainer.error
        if params is None:  # no training yet: the snapshot is the initial state
            params = self.trainer.state_host["params"]
        t1 = time.perf_counter()
        save_s, publish_s = self.update_model(params, steps)
        record.update(boundary_snapshot_s=round(t1 - t0, 4), boundary_save_s=round(save_s, 4),
                      boundary_publish_s=round(publish_s, 4),
                      engine_requests=self.model_server.engine.requests_served)

        if steps > epoch_steps0:
            record["loss"] = dict(self.trainer.last_loss)
            record.update(self.trainer.stats)
        # the live mode: an shm pipeline that fell back to threads is not
        # recorded as shm
        record["pipeline"] = self.trainer.batcher.stats()["mode"]
        now = time.time()
        dt = max(now - self._epoch_t0, 1e-6)
        # an epoch closes on returned episodes, not on steps: before the
        # warm-up it holds none, and its record says updates_per_sec 0
        record.update(
            steps=steps,
            episodes=self.num_returned_episodes,
            episodes_per_sec=(self.num_returned_episodes - self._epoch_episodes0) / dt,
            updates_per_sec=(steps - epoch_steps0) / dt,
        )
        if self._device_epoch_eps:
            record["device_episodes"] = self._device_epoch_eps
            record["device_mean_episode_len"] = self._device_epoch_steps / self._device_epoch_eps
            self._device_epoch_eps = 0
            self._device_epoch_steps = 0
        if self._device_games > 0:  # the plane and the watchdog's cumulative events
            record["plane"] = self._plane
            record.update(self._watchdog_events)
        if self.model_server.substituted_snapshots:
            record["serve_snapshot_substituted"] = self.model_server.substituted_snapshots
        if self.remote:  # the remote actor plane's books, cumulative
            record.update(remote_connections=self.worker.connection_count(),
                          jobs_lost=dict(self.jobs_lost),
                          heartbeat_drops=self.worker.silent_drops,
                          blobs_served=[list(b) for b in self.worker.blob_log])
        self._epoch_t0 = now
        self._epoch_steps0 = steps
        self._epoch_episodes0 = self.num_returned_episodes
        self._write_metrics(record)

    def update_model(self, params, steps: int):
        """Save the new epoch's snapshot (atomic, in the manifest), collect
        old ones, and serve it to the actors; returns the seconds the save
        and the publish took."""
        print("updated model(%d)" % steps)
        self.model_epoch += 1
        t0 = time.perf_counter()
        save_epoch_snapshot(self.model_dir, self.model_epoch, params,
                            self.trainer.save_payload(self.model_epoch), steps)
        gc_snapshots(self.model_dir, int(self.args["keep_checkpoints"]))
        t1 = time.perf_counter()
        self.model_server.publish(self.model_epoch, params)
        return t1 - t0, time.perf_counter() - t1

    def _repair_metrics_tail(self, path: str) -> None:
        """Drop a half-written last line left by a killed run before
        appending, so two records never share a line."""
        try:
            with open(path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) == b"\n":
                    return
                back = min(size, 1 << 20)
                f.seek(size - back)
                cut = f.read(back).rfind(b"\n")
                f.truncate(size - back + cut + 1 if cut >= 0 else 0)
            print(f"{path}: dropped a truncated last line before appending", file=sys.stderr)
        except OSError:
            pass  # the append below reports an unusable file

    def _write_metrics(self, record: Dict[str, Any]) -> None:
        """One write per record, flushed and fsynced: a kill costs at most
        the last line."""
        path = self.args.get("metrics_path")
        if not path:
            return
        if not self._metrics_tail_checked:
            self._metrics_tail_checked = True
            if os.path.exists(path):
                self._repair_metrics_tail(path)
        record.setdefault("ts", round(time.time(), 6))
        record.setdefault("t_mono", round(time.monotonic(), 6))
        line = json.dumps(record, default=float) + "\n"
        with open(path, "a") as f:
            f.write(line)
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass

    # -- server loop --------------------------------------------------------

    def _assign_role(self) -> Dict[str, Any]:
        args: Dict[str, Any] = {"model_id": {}}
        players = self.env.players()
        if self.num_results < self.eval_rate * self.num_episodes:
            args["role"] = "e"
            me = players[self.num_results % len(players)]
            args["player"] = [me]
            args["model_id"] = {p: (self.model_epoch if p == me else -1) for p in players}
            self.num_results += 1
        else:
            args["role"] = "g"
            args["player"] = players
            args["model_id"] = {p: self.model_epoch for p in players}
            self.num_episodes += 1
        return args

    def _workers_active(self) -> bool:
        """The drain: remote mode counts live connections (for at most
        ``DRAIN_GRACE`` seconds after the shutdown), local mode threads."""
        if self.remote:
            if self._shutdown_t0 and time.time() - self._shutdown_t0 > self.DRAIN_GRACE:
                return False
            return self.worker.connection_count() > 0
        return self._active_workers > 0

    def _serve_request(self, req: str, data: Any):
        if req == "args":
            # data None: one local worker; an int n: a gather prefetching n
            if self.shutdown_flag:
                self._active_workers -= 1
                return None
            if data is None:
                return self._assign_role()
            return [self._assign_role() for _ in range(int(data))]
        if req == "episode":
            self.feed_episodes(data if isinstance(data, list) else [data])
        elif req == "device_episodes":
            # on-device generation bypasses role assignment; counting its
            # episodes as generation jobs keeps the eval_rate balance
            self.feed_episodes(data)
            self.num_episodes += len(data)
            self._device_epoch_eps += len(data)
            self._device_epoch_steps += sum(ep["steps"] for ep in data)
        elif req == "result":
            self.feed_results(data if isinstance(data, list) else [data])
        elif req == "jobs_lost":
            # a worker connection vanished with jobs in flight: hand their
            # counts back, so the balance re-dispatches them
            for role in ("g", "e"):
                self.jobs_lost[role] += int(data.get(role, 0))
            self.num_episodes = max(0, self.num_episodes - int(data.get("g", 0)))
            self.num_results = max(0, self.num_results - int(data.get("e", 0)))
        return None

    def server(self) -> None:
        print("started server")
        self._shutdown_t0 = 0.0
        try:
            while self._workers_active() or not self.shutdown_flag:
                if self.shutdown_flag and not self._shutdown_t0:
                    self._shutdown_t0 = time.time()
                try:
                    req, data, fut = self._requests.get(timeout=0.3)
                except queue.Empty:
                    continue
                fut.set_result(self._serve_request(req, data))

                if self.num_returned_episodes >= self._next_update_episodes and not self.shutdown_flag:
                    self._next_update_episodes += self.args["update_episodes"]
                    self.update()
                    if 0 <= self.args["epochs"] <= self.model_epoch:
                        self.shutdown_flag = True
        finally:
            self.trainer.stop()
            if self.remote:
                self.worker.shutdown()
            self.model_server.stop()
            # futures enqueued after the loop's last pass: resolve them so no
            # worker waits forever
            while True:
                try:
                    _, _, fut = self._requests.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_result(None)
            if self._trainer_thread is not None:
                self._trainer_thread.join(timeout=60.0)
        print("finished server")

    # -- the device rollout thread and its watchdog --------------------------

    def _start_rollout_thread(self) -> threading.Thread:
        """(Re)start the rollout thread under a new generation token; a
        superseded generation exits at its next liveness check."""
        self._rollout_gen += 1
        gen = self._rollout_gen
        self._rollout_progress_t = time.monotonic()
        # stall detection arms after this generation's first block: its
        # first call builds the lanes and warms the allocator
        self._rollout_dispatched = False
        thread = threading.Thread(target=self._device_rollout_loop, args=(gen,), daemon=True,
                                  name=f"device-rollout-{gen}")
        self._rollout_thread = thread
        thread.start()
        return thread

    def _rollout_live(self, gen: int) -> bool:
        return not self.shutdown_flag and self._rollout_gen == gen

    def _rollout_beat(self) -> None:
        """The watchdog's heartbeat: every block, backpressure sleep and
        wait on the server loop counts as progress."""
        self._rollout_progress_t = time.monotonic()

    def _watchdog_loop(self) -> None:
        """Restart a rollout thread that died, or made no progress for
        plane_stall_timeout seconds, up to plane_max_restarts times; past
        that, give up on device generation loudly: the host actors go on,
        and every later epoch record says ``plane: "none"``."""
        timeout = float(self.args["plane_stall_timeout"])
        max_restarts = int(self.args["plane_max_restarts"])
        restarts = 0
        tick = max(0.05, min(1.0, timeout / 4.0))
        while not self.shutdown_flag:
            time.sleep(tick)
            thread = self._rollout_thread
            if self.shutdown_flag or thread is None:
                continue
            dead = not thread.is_alive()
            stall_s = time.monotonic() - self._rollout_progress_t
            stalled = stall_s > timeout and self._rollout_dispatched
            if not (dead or stalled):
                continue
            reason = ("thread died" if dead
                      else f"no progress for {stall_s:.1f}s (> plane_stall_timeout)")
            self._watchdog_events["plane_watchdog_stalls"] += 1
            print(f"[handyrl_tpu_torch] plane watchdog: rollout plane unhealthy ({reason})",
                  file=sys.stderr)
            if restarts >= max_restarts:
                print("[handyrl_tpu_torch] plane watchdog: restart budget exhausted; giving up on "
                      "the rollout thread (host actors keep generating)", file=sys.stderr)
                self._plane = "none"
                return
            restarts += 1
            self._watchdog_events["plane_watchdog_restarts"] += 1
            print(f"[handyrl_tpu_torch] plane watchdog: restarting rollout thread "
                  f"({restarts}/{max_restarts})", file=sys.stderr)
            self._start_rollout_thread()

    def _device_rollout_loop(self, gen: int) -> None:
        """Generate device self-play blocks up to each epoch boundary.
        ``gen`` is the thread's generation token; a restarted generation
        draws another stream than the one it replaces."""
        rng = torch.Generator(device=self.device).manual_seed(
            self.args["seed"] + 0x5EED + 0x1009 * (gen - 1))
        roll = self._device_roll
        try:
            # grad mode is per thread
            with torch.inference_mode():
                self._device_rollout_inner(roll, rng, gen)
        finally:
            if hasattr(roll, "drain") and self._rollout_gen == gen:
                roll.drain()

    def _device_rollout_inner(self, roll, rng: torch.Generator, gen: int) -> None:
        loaded = None
        while self._rollout_live(gen):
            if self.num_returned_episodes >= self._next_update_episodes:
                # backpressure: the epoch's budget is met; let the trainer run
                time.sleep(0.02)
                self._rollout_beat()
                continue
            epoch, params = self.model_server.latest_snapshot()
            episodes = roll.generate(params if epoch != loaded else None, rng)
            loaded = epoch
            self._rollout_dispatched = True
            self._rollout_beat()
            for ep in episodes:
                ep["args"]["model_id"] = {p: epoch for p in ep["players"]}
            if not self._rollout_live(gen):
                return
            if not episodes:
                continue
            # submit once and wait on the same future: the server loop can be
            # busy for a long time at an epoch boundary, which is no stall
            fut: Future = Future()
            self._requests.put(("device_episodes", episodes, fut))
            while not fut.done():
                try:
                    fut.result(timeout=5.0)
                except FutureTimeoutError:
                    if not self._rollout_live(gen):
                        return  # the server loop has ended; nothing to feed
                self._rollout_beat()

    def run(self) -> int:
        """Train to ``epochs`` epochs (or until stopped); returns 0."""
        self._trainer_thread = threading.Thread(target=self.trainer.run, daemon=True,
                                                name="trainer")
        self._trainer_thread.start()
        try:
            self.worker.run()
        except BaseException:
            self.trainer.stop()  # the batch pipeline's processes and segment go with it
            raise
        if not self.remote:
            self._active_workers = len(self.worker.threads)
        if self._device_roll is not None:
            self._start_rollout_thread()
            threading.Thread(target=self._watchdog_loop, daemon=True, name="plane-watchdog").start()
        try:
            self.server()
        finally:
            self.shutdown_flag = True
            if self._rollout_thread is not None:
                # let the block in flight finish and its copies land
                self._rollout_thread.join(timeout=120.0)
        return 0


def train_main(args: Dict[str, Any], device=None) -> int:
    """``--train``: one learner with local actor threads, on the card
    unless ``device`` says otherwise."""
    return Learner(args, device=device).run()


def train_server_main(args: Dict[str, Any], device=None) -> int:
    """``--train-server``: one learner serving remote worker machines
    (``--worker``) over TCP, on the card unless ``device`` says otherwise."""
    return Learner(args, device=device, remote=True).run()
