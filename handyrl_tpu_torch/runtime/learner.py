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
card (runtime/device_eval.py), filed as opponent ``device-<name>``.
With ``device_replay: true`` the rollout thread's records never leave the
card: each block goes into the rings of runtime/device_replay.py, only
its counters come back (one block late) to feed the books, the trainer
samples its batches from the rings, and host workers only evaluate, local
ones at most ``eval_rate`` of the episodes made.

SIGTERM or SIGINT (handlers installed by ``run`` on the main thread; a
second signal is ignored) drains the run: the trainer stops mid-epoch,
the workers get no further job, a final manifest-verified checkpoint is
written within ``drain_deadline_seconds``, and ``run`` returns 75
(``EXIT_RESUMABLE``) for a relaunch with ``restart_epoch: -1``.  A learner
driven from another thread reaches the drain by calling
``_drain_handler``.  ``trace.enabled`` arms the span tracer
(utils/trace.py) at construction; ``HANDYRL_FAULT_WEDGE_ROLLOUT`` wedges
the rollout thread for its watchdog to find.

Under ``obs_int8`` the env's quantize spec goes to the train step as
``args['_obs_quant']``.  Under ``flywheel.enabled`` (flywheel/) an ingest
thread pulls harvested episodes from the serving tier into
``feed_episodes``, each boundary adopts a new rollback signal of the
quality plane (the trainer rolls back on its own thread), and
``gc_snapshots`` spares the epochs the serving tier routes.
``HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH=N`` saves epoch N's snapshot with
negated params while training goes on clean.  ``autovec_verify_games: N``
plays N random step-parity games of an autovec-lifted twin
(envs/autovec.py) on the learner's device before training.  The league
(league/learner.py) overrides three seams: ``_make_model_server``,
``_epoch_hook`` and ``_gc_pinned``.

A learner of several processes (``distributed.num_processes`` > 1, one
``--train`` per rank, ``train_main`` joining the group first) trains one
model: every rank has its own actors (Python's ``random`` seeded ``seed +
1009 * rank``), its own rings and its own share of the global batch; the
coordinator (rank 0) alone resumes from the manifest (the others take its
verdict), writes checkpoints and metrics.jsonl, and decides the epochs,
which reach the others through the trainer's cadence.  The health plane
and the collective watchdog (parallel/health.py) bound a lost or wedged
peer: the coordinator drain-saves a verified checkpoint and every
survivor exits 75 (``HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH`` and
``HANDYRL_FAULT_WEDGE_PROCESS`` inject both).  With
``distributed.actor_hosts`` > 0 the coordinator serves the plane gateway
(runtime/plane.py): actor hosts' record blocks land in its rings, and
each boundary's params are published to them, versioned by step count.
Under ``seq_attention: ring`` (a mesh with an ``sp`` axis) only the
leader of each ``sp`` group (its index 0) runs actors, the store and the
batch pipeline; the other ranks of the group start no actors and train on
the leader's broadcast batches, on their own shards of the window.  The
cadence, the health plane and the watchdog stay over every rank.  The
split plane (``plane: split``) is not ported (ROADMAP A8).
"""

from __future__ import annotations

import json
import os
import queue
import random
import signal
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional

import torch

from ..envs import make_env, prepare_env
from ..models import init_variables
from ..utils import resolve_device, trace
from ..utils.trace import trace_span
from . import batch, codec, faults
from .checkpoint import (
    gc_snapshots,
    latest_verified_epoch,
    load_verified_params,
    save_epoch_snapshot,
    verify_state,
)
from .trainer import Trainer
from .worker import LocalModelServer, LocalWorkerPool


# a job request answered later (see Learner._eval_budget_spent)
_DEFERRED = object()

# the exit status after a preemption drain: a verified resume point is on
# disk and the run wants a relaunch with restart_epoch: -1 (EX_TEMPFAIL)
EXIT_RESUMABLE = 75


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
        # the rank of a learner of several processes (train_main has joined
        # the group); one process sees a count of 1 and none of it applies
        from ..parallel.distributed import is_coordinator, process_count, process_index

        self._dist_nprocs = process_count()
        self._dist_rank = process_index() if self._dist_nprocs > 1 else 0
        self._dist_follower = self._dist_nprocs > 1 and not is_coordinator()
        # the ranks' mesh; under seq_attention: ring the ranks of an sp
        # group past its leader (sp index 0) start no actors and keep no
        # store: their batches are the leader's (runtime/trainer.py)
        self.mesh = None
        self._sp_member = False
        self._data_shards = self._dist_nprocs
        if self._dist_nprocs > 1:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(self.args.get("mesh"))
            if self.args.get("seq_attention") == "ring":
                self._sp_member = self.mesh.coords(self._dist_rank).get("sp", 0) > 0
                self._data_shards = self._dist_nprocs // self.mesh.shape.get("sp", 1)
        # each rank's actors play other games; the model's init stays the
        # base seed's on every rank, so the params start identical
        random.seed(self.args["seed"] + 1009 * self._dist_rank)
        self._fault_kill_proc = faults.kill_process_at_epoch()
        self._fault_wedge_proc = faults.wedge_process_at_epoch()
        self._health = None
        self._collective_watchdog = None
        self._host_faulted = False
        # the epoch counter, the checkpoint files and the fault flag: the
        # main loop's boundary and a host fault's drain (on a health,
        # watchdog or trainer thread) may meet, and the manifest is a
        # read-modify-write; once the fault's drain has begun no boundary
        # saves, so the drain stays the newest verified epoch
        self._ckpt_lock = threading.RLock()
        self._drain_saved = False
        self._plane_gateway = None
        self._rank_metrics = bool((self.args.get("observability") or {}).get("rank_metrics", True))
        if trace.configure(self.args["trace"], rank=self._dist_rank):
            print(f"trace: spans -> {trace.current_path()} (rank {self._dist_rank})")
        # the preemption drain (run() installs the handlers)
        self.drain_deadline = float(self.args["drain_deadline_seconds"])
        self._drain_requested = False
        self._drain_stopped = False
        self._drain_t0 = 0.0
        self._prev_handlers: Dict[int, Any] = {}

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
            # is corrupt; 0 = a fresh start.  Under several ranks only the
            # coordinator scans (it owns the files) and every rank resumes
            # its verdict; a rank that cannot read that epoch fails loudly
            if self._dist_nprocs > 1:
                from ..parallel.distributed import broadcast_resume_epoch

                local = 0 if self._dist_follower else latest_verified_epoch(self.model_dir)
                self.model_epoch = broadcast_resume_epoch(local)
            else:
                self.model_epoch = latest_verified_epoch(self.model_dir)
            auto_resumed = self.model_epoch > 0 and not self._dist_follower
            print(f"auto-resume (restart_epoch: -1): epoch {self.model_epoch}"
                  if self.model_epoch > 0 else
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

        if self.args.get("obs_int8"):
            # the spec the generators quantize with, for the train step's
            # dequantize (forward_prediction reads args['_obs_quant'])
            from ..models.quantize import obs_quant_spec

            self.env.reset()
            self.args["_obs_quant"] = obs_quant_spec(
                self.env, obs=self.env.observation(self.env.players()[0]))
        self.trainer = Trainer(self.args, self.module, self.device, mesh=self.mesh)
        self.trainer.device_replay = self._replay
        self._setup_distributed()
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
        self.model_server = self._make_model_server(args)
        router = getattr(self.model_server, "_router", None)
        if router is not None and getattr(router, "weight_dtype", "") == "int8":
            # an int8 router's publish calibrates on this learner's episodes
            from ..models.quantize import calibration_batches_from_store

            store = self.trainer.store
            router.calibration_source = lambda: calibration_batches_from_store(
                store, router.calibration_batches)
        self.model_server.publish(self.model_epoch, self.trainer.state_host["params"])
        self._setup_gateway()
        self.remote = remote
        if remote:
            from .server import WorkerServer

            self.worker = WorkerServer(self.args, self.handle, self.model_server)
        else:
            self.worker = LocalWorkerPool(self.args, self.handle, self.model_server)

        # the data flywheel: the ingest thread (started by run()) and the
        # quality plane's rollback signal, whose seq is read here so a signal
        # left by an earlier run is never applied
        self._flywheel_cfg = dict(self.args.get("flywheel") or {})
        self._flywheel_ingestor = None
        self.flywheel_rollbacks = 0
        self._flywheel_rollback_seq = 0
        if self._flywheel_cfg.get("enabled"):
            from ..flywheel import read_rollback_signal

            sig = read_rollback_signal(self.model_dir)
            self._flywheel_rollback_seq = int(sig.get("seq", 0)) if sig else 0
        self._fault_poison_epoch = faults.poison_snapshot_epoch()

        self._requests: queue.Queue = queue.Queue()
        self._deferred: List[Future] = []   # job requests waiting on the eval budget
        self._active_workers = 0
        self._shutdown_t0 = 0.0
        self._epoch_t0 = time.time()
        self._epoch_steps0 = self.trainer.steps  # nonzero after a resume
        self._epoch_episodes0 = 0
        self._trainer_thread: Optional[threading.Thread] = None
        self._metrics_tail_checked = False
        self._next_update_episodes = self.args["minimum_episodes"] + update_episodes

    def _setup_distributed(self) -> None:
        """Under several ranks: the trainer's cadence over the ``dp`` mesh,
        the collective watchdog and the health plane (both started by
        ``run``), and the disarm at the agreed finish."""
        if self._dist_nprocs <= 1:
            return
        from ..parallel.distributed import DistributedCadence, backend
        from ..parallel.health import CollectiveWatchdog, HostHealthPlane

        dist_args = dict(self.args.get("distributed") or {})
        mesh = self.mesh
        self.trainer.cadence = DistributedCadence(mesh)
        timeout = float(dist_args.get("collective_timeout") or 0.0)
        if timeout > 0:
            self._collective_watchdog = CollectiveWatchdog(
                timeout, lambda reason: self._host_fault(reason, "collective_timeout"))
            self.trainer.collective_watchdog = self._collective_watchdog
        if dist_args.get("coordinator_address"):
            self._health = HostHealthPlane(dist_args, self._dist_rank, self._dist_nprocs,
                                           lambda reason, kind: self._host_fault(reason, kind))
        # the agreed stop or drain reaches every rank in one broadcast: from
        # there a peer's silence is teardown, not a fault
        self.trainer.on_agreed_finish = self._disarm_host_fault
        self.trainer.on_collective_fault = lambda reason: self._host_fault(reason, "peer_loss")
        self.dist_backend = backend()
        print("distributed learner: process %d/%d (%s) on %s, backend %s, mesh %s, health "
              "plane %s, collective watchdog %s"
              % (self._dist_rank, self._dist_nprocs,
                 "follower" if self._dist_follower else "coordinator", self.device,
                 self.dist_backend, mesh.shape,
                 "on" if (self._health and self._health.enabled) else "off",
                 f"{timeout:.0f}s" if timeout > 0 else "off"), flush=True)
        seq = self.trainer.ctx.seq_group
        if seq is not None:
            print("distributed learner: process %d in sp group %s at index %d (%s)"
                  % (self._dist_rank, seq.ranks, seq.index,
                     "its leader: actors, store and batches" if seq.is_leader
                     else "a member: no actors, the leader's batches"), flush=True)

    def _setup_gateway(self) -> None:
        """``distributed.actor_hosts`` > 0: the coordinator serves the plane
        gateway (followers never do: the hosts dial the one port derived
        from the coordinator's), publishing its initial params at version
        ``steps``.  The gateway's records land in the device rings."""
        dist_args = dict(self.args.get("distributed") or {})
        if int(dist_args.get("actor_hosts") or 0) <= 0 or self._dist_follower:
            return
        if self._replay is None:
            raise ValueError(
                "distributed.actor_hosts > 0 needs device_replay: true on the learner tier — "
                "actor-host record batches land in the device replay rings")
        from .plane import PlaneGateway

        self._plane_gateway = PlaneGateway(dist_args, on_records=self._gateway_on_records)
        self._plane_gateway.publish(self.trainer.state_host["params"], self.trainer.steps)

    def _vector_env(self, key: str):
        vector_env = getattr(self.env, "vector_env", None)
        if vector_env is None:
            raise ValueError(f"{key} set but env {self.args['env'].get('env')} exposes no "
                             "vector_env()")
        return vector_env()

    def _setup_device_planes(self) -> None:
        """The rollout and the evaluator of the device twin, each
        with a copy of the module on this learner's device."""
        # each data shard's rank runs its share of the lanes (none on an sp
        # group's members: they make no episodes)
        self._device_games = (0 if self._sp_member else
                              int(self.args["device_rollout_games"]) // self._data_shards)
        self._device_roll = None
        self._replay = None
        self._device_eval = None
        self._rollout_thread: Optional[threading.Thread] = None
        self._rollout_gen = 0
        self._rollout_progress_t = time.monotonic()
        self._rollout_dispatched = False
        self._watchdog_events = {"plane_watchdog_stalls": 0, "plane_watchdog_restarts": 0}
        self._fault_wedge = faults.wedge_rollout()
        # the epoch records' plane: "none" once the watchdog has given up
        self._plane = "fused"
        # device episodes and their game steps this epoch
        self._device_epoch_eps = 0
        self._device_epoch_steps = 0
        if self._device_games > 0:
            venv = self._vector_env("device_rollout_games")
            n_verify = int(self.args["autovec_verify_games"])
            if n_verify > 0 and getattr(venv, "__autovec__", False):
                # an autovec-lifted twin: refuse to train on a divergent lift
                # (random step-parity games against the numpy rules; raises
                # AutovecError naming the observable that diverged)
                venv.verify(n_verify, int(self.args["seed"]), device=self.device)
                print(f"autovec twin verified: {venv.__name__} parity over {n_verify} "
                      "random games")
            if self.args["observation"] and not hasattr(venv, "observe_mask"):
                raise ValueError(
                    "device_rollout_games with observation: true requires a vector env that "
                    f"records observer views (an observe_mask hook); {venv.__name__} records "
                    "acting players only; use host actors instead"
                )
            if self.args["device_replay"]:
                # the data stays on the card: rollout records -> rings ->
                # sampled batches; DeviceReplay checks the env, the net and
                # the window mode here, at startup
                from .device_replay import DeviceReplay
                from .device_rollout import StreamingDeviceRollout

                self._replay = DeviceReplay(venv, self.module, self.args, self._device_games,
                                            slots=self.args["device_replay_slots"],
                                            device=self.device)
                self._device_roll = StreamingDeviceRollout(
                    venv, self.module, self.args, n_lanes=self._device_games,
                    k_steps=self.args["device_replay_k_steps"], device=self.device)
            else:
                from .device_rollout import make_device_rollout

                self._device_roll = make_device_rollout(venv, self.module, self.args,
                                                        self._device_games, device=self.device)
        n_eval = 0 if self._sp_member else int(self.args["device_eval_games"])
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
        with trace_span("eval.device", plane="eval", epoch=self.model_epoch):
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
        with trace_span("epoch.snapshot_wait", plane="learner"):
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
        # recorded as shm; under device_replay no host pipeline runs
        if self._replay is None:
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
        self._dist_record(record, steps)
        if trace.enabled():
            record.update(trace.trace_stats())
        if self.remote:  # the remote actor plane's books, cumulative
            record.update(remote_connections=self.worker.connection_count(),
                          jobs_lost=dict(self.jobs_lost),
                          heartbeat_drops=self.worker.silent_drops,
                          blobs_served=[list(b) for b in self.worker.blob_log])
        self._epoch_t0 = now
        self._epoch_steps0 = steps
        self._epoch_episodes0 = self.num_returned_episodes
        self._flywheel_epoch(record)
        self._epoch_hook(record)
        self._write_metrics(record)

    # -- the seams a subclass overrides (league/learner.py) -------------------

    def _make_model_server(self, args: Dict[str, Any]):
        """The server actors resolve model ids through; the league's serves
        frozen opponents from resident router engines."""
        return LocalModelServer(self.module, make_env(args["env_args"]), self.args, self.device)

    def _epoch_hook(self, record: Dict[str, Any]) -> None:
        """Called at each epoch boundary after the new epoch's snapshot is
        saved, just before its metrics record is written."""

    def _gc_pinned(self):
        """Epochs the checkpoint GC must never collect (the league's
        population)."""
        return ()

    def _gc_pin_set(self):
        """The pin set of every ``gc_snapshots`` call: the subclass's pins
        and the epochs the serving tier routes (SERVING.json)."""
        from ..flywheel.quality import serving_pinned_epochs

        pins = set(self._gc_pinned())
        pins |= serving_pinned_epochs(self.model_dir)
        return tuple(sorted(pins))

    def _flywheel_epoch(self, record: Dict[str, Any]) -> None:
        """The boundary's flywheel books: the ingest counters into the
        record, and a new rollback signal (seq-gated: each once) handed to
        the trainer."""
        if not self._flywheel_cfg.get("enabled"):
            return
        if self._flywheel_ingestor is not None:
            record.update(self._flywheel_ingestor.stats())
        from ..flywheel import read_rollback_signal

        sig = read_rollback_signal(self.model_dir)
        seq = int(sig.get("seq", 0)) if sig else 0
        if sig and seq > self._flywheel_rollback_seq:
            self._flywheel_rollback_seq = seq
            target = int(sig.get("target_epoch", 0))
            print(f"flywheel: serving tier flagged epoch {sig.get('bad_epoch')} "
                  f"({sig.get('reason')}); requesting trainer rollback to verified epoch "
                  f"{target or 'newest'}", flush=True)
            self.trainer.request_rollback(target)
            self.flywheel_rollbacks += 1
        record["flywheel_rollbacks"] = self.flywheel_rollbacks

    def update_model(self, params, steps: int):
        """Save the new epoch's snapshot (atomic, in the manifest), collect
        old ones, and serve it to the actors; returns the seconds the save
        and the publish took."""
        print("updated model(%d)" % steps)
        with self._ckpt_lock:
            self.model_epoch += 1
        self._dist_fault_hooks()
        save_params = params
        if self._fault_poison_epoch is not None and self.model_epoch == self._fault_poison_epoch:
            # fault injection (runtime/faults.py): the SAVED snapshot is negated,
            # digest-valid and loadable, so only the flywheel's live gate can
            # catch it; the published and trained params stay clean
            print(f"[fault] poison_snapshot: epoch {self.model_epoch} snapshot saved with "
                  "NEGATED params (training params stay clean)", flush=True)
            save_params = {k: -v if v.is_floating_point() else v for k, v in params.items()}
        t0 = time.perf_counter()
        # one rank owns the checkpoint files
        with self._ckpt_lock:
            if not self._dist_follower and not self._host_faulted:
                with trace_span("checkpoint.save", plane="learner", epoch=self.model_epoch):
                    save_epoch_snapshot(self.model_dir, self.model_epoch, save_params,
                                        self.trainer.save_payload(self.model_epoch), steps)
                gc_snapshots(self.model_dir, int(self.args["keep_checkpoints"]),
                             pin=self._gc_pin_set())
        t1 = time.perf_counter()
        self.model_server.publish(self.model_epoch, params)
        if self._plane_gateway is not None and steps > self._plane_gateway.version:
            # a reference: the gateway packs it at the first poll, off this thread
            self._plane_gateway.publish(params, steps)
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
        if not path or self._dist_follower:   # rank 0 writes metrics.jsonl
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
        # device_replay: generation lives on the card (a host episode could
        # not enter the rings: it would be stored, never trained on, and
        # race the epoch cadence), so host workers only evaluate
        if self._replay is not None or self.num_results < self.eval_rate * self.num_episodes:
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

    def _eval_budget_spent(self) -> bool:
        """Under device_replay a local worker's job request waits while the
        evaluations handed out reach ``eval_rate`` of the episodes made (the
        JAX learner answers every request with an evaluation).  A worker
        playing a game in Python holds the interpreter between the rollout
        thread's launches, each of which must take it back: on the card,
        workers evaluating without pause slowed a Geister rollout launch
        from ~0.3 s to 15-85 s (PERF.md, PR 9).  Remote workers run in
        processes of their own and are answered at once."""
        return (self._replay is not None and not self.remote
                and self.num_results >= self.eval_rate * self.num_episodes)

    def _serve_request(self, req: str, data: Any):
        if req == "args":
            # data None: one local worker; an int n: a gather prefetching n
            if self.shutdown_flag:
                self._active_workers -= 1
                return None
            if data is None:
                if self._eval_budget_spent():
                    return _DEFERRED
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
        elif req == "device_counts":
            # device_replay: episodes never reach the host; the rollout
            # thread reports the rings' ingest counters, which feed the same
            # books as feed_episodes (cadence, generation stats, eval_rate)
            n, P = data["episodes"], data["players"]
            st = self.generation_results.get(data["model_id"], (0, 0, 0))
            self.generation_results[data["model_id"]] = (
                st[0] + n * P, st[1] + data["outcome_sum"], st[2] + data["outcome_sq_sum"])
            self.num_returned_episodes += n
            self.num_episodes += n
            self._device_epoch_eps += n
            self._device_epoch_steps += data["game_steps"]
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
                if self._drain_tick():
                    break
                if self.shutdown_flag and not self._shutdown_t0:
                    self._shutdown_t0 = time.time()
                while self._deferred and (self.shutdown_flag or not self._eval_budget_spent()):
                    self._deferred.pop(0).set_result(self._serve_request("args", None))
                try:
                    req, data, fut = self._requests.get(timeout=0.3)
                except queue.Empty:
                    if self._dist_follower:   # an sp member has no worker to wake it
                        self._follower_boundary()
                    continue
                reply = self._serve_request(req, data)
                if reply is _DEFERRED:
                    self._deferred.append(fut)
                else:
                    fut.set_result(reply)

                if self._dist_follower:
                    self._follower_boundary()
                elif self.num_returned_episodes >= self._next_update_episodes and not self.shutdown_flag:
                    if self._dist_nprocs > 1 and not self.trainer._warmed_up():
                        # a boundary before the warm-up is this rank's alone
                        # (a follower's boundary is the cadence's snapshot):
                        # counting it would put the ranks' epochs apart
                        continue
                    self._next_update_episodes += self.args["update_episodes"]
                    self.update()
                    shutdown = 0 <= self.args["epochs"] <= self.model_epoch
                    # under the cadence: release the trainer's boundary with
                    # the decision, so every rank stops or goes on together
                    self.trainer.proceed(shutdown)
                    if shutdown:
                        self.shutdown_flag = True
        finally:
            if self._plane_gateway is not None:
                self._plane_gateway.begin_stop()   # the actor hosts hear "stop" and leave 0
            self.trainer.stop()
            if self.remote:
                self.worker.shutdown()
            self.model_server.stop()
            # futures enqueued after the loop's last pass: resolve them so no
            # worker waits forever
            for fut in self._deferred:
                fut.set_result(None)
            while True:
                try:
                    _, _, fut = self._requests.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_result(None)
            if self._trainer_thread is not None:
                # several ranks: the thread may still be in the last agreed
                # broadcast, waiting for a slower rank
                timeout = 120.0 if self._dist_nprocs > 1 else 60.0
                if self._drain_requested:
                    # bounded by what is left of the deadline: a wedged
                    # trainer cannot eat it, and the checkpoint then saves the
                    # last consistent snapshot
                    left = self.drain_deadline - (time.time() - self._drain_t0)
                    timeout = max(5.0, min(timeout, left))
                self._trainer_thread.join(timeout=timeout)
            if self._drain_requested:
                self._write_drain_checkpoint()
        print("finished server")

    # -- the preemption drain -------------------------------------------------

    def _drain_handler(self, signum, frame) -> None:
        """SIGTERM/SIGINT: raise the flags and let the loops drain; a second
        signal while draining is ignored."""
        if self._drain_requested:
            return
        self._drain_requested = True
        self._drain_t0 = time.time()
        self.shutdown_flag = True
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        print(f"[handyrl_tpu_torch] {name} received: draining (final verified checkpoint "
              f"within {self.drain_deadline:.0f}s, then exit {EXIT_RESUMABLE} for a "
              "restart_epoch: -1 relaunch)", file=sys.stderr, flush=True)

    def _install_signal_handlers(self) -> None:
        """Only the main thread may install handlers; a learner run from
        another thread reaches the drain through ``_drain_handler``."""
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._drain_handler)
            except (ValueError, OSError):
                pass

    def _restore_signal_handlers(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers = {}

    def _drain_tick(self) -> bool:
        """The drain's per-iteration step: stop the trainer once; True when
        the deadline is spent with workers still attached (the loop ends)."""
        if not self._drain_requested:
            return False
        if not self._drain_stopped:
            self._drain_stopped = True
            self.trainer.request_drain()
        if time.time() - self._drain_t0 > self.drain_deadline:
            print("[handyrl_tpu_torch] drain deadline exceeded; forcing shutdown (the "
                  "checkpoint still lands from the last consistent state)", file=sys.stderr)
            return True
        return False

    def _write_drain_checkpoint(self) -> None:
        """The drain's final save, through the same atomic, manifest-recorded
        path as every boundary, so ``restart_epoch: -1`` resumes it.  The
        coordinator's alone under several ranks, and written once."""
        if self._dist_follower:
            return
        with self._ckpt_lock:
            if self._drain_saved:
                return
            self._drain_saved = True
            self.model_epoch += 1
            epoch = self.model_epoch
            params, payload, steps = self.trainer.drain_payload(epoch)
            with trace_span("checkpoint.save", plane="learner", epoch=epoch):
                save_epoch_snapshot(self.model_dir, epoch, params, payload, steps)
            gc_snapshots(self.model_dir, int(self.args["keep_checkpoints"]),
                         pin=self._gc_pin_set())
        print(f"[handyrl_tpu_torch] drain checkpoint: epoch {epoch} at step {steps} "
              "(manifest-verified; resume with restart_epoch: -1)", file=sys.stderr, flush=True)

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
            self.args["seed"] + 0x5EED + 0x1009 * (gen - 1) + 1009 * self._dist_rank)
        roll = self._device_roll
        try:
            # grad mode is per thread
            with torch.inference_mode():
                if self._replay is not None:
                    self._device_replay_inner(roll, rng, gen)
                else:
                    self._device_rollout_inner(roll, rng, gen)
        finally:
            if self._rollout_gen == gen:  # a superseded thread's successor owns them
                if self._replay is not None:
                    self._replay.drain()
                elif hasattr(roll, "drain"):
                    roll.drain()

    def _maybe_wedge(self, gen: int, blocks: int) -> bool:
        """HANDYRL_FAULT_WEDGE_ROLLOUT: after N blocks this generation stops
        beating (a wedged launch) until it is superseded or shut down.
        True when the caller should return."""
        w = self._fault_wedge
        if w is None or blocks < w[0] or (not w[1] and gen != 1):
            return False
        print(f"[fault] wedging rollout thread generation {gen} after {blocks} blocks "
              "(HANDYRL_FAULT_WEDGE_ROLLOUT)", file=sys.stderr)
        while self._rollout_live(gen):
            time.sleep(0.05)   # no beat: the watchdog must notice
        return True

    def _device_rollout_inner(self, roll, rng: torch.Generator, gen: int) -> None:
        loaded = None
        blocks = 0
        while self._rollout_live(gen):
            if self._maybe_wedge(gen, blocks):
                return
            if self.num_returned_episodes >= self._next_update_episodes:
                # backpressure: the epoch's budget is met; let the trainer run
                time.sleep(0.02)
                self._rollout_beat()
                continue
            epoch, params = self.model_server.latest_snapshot()
            episodes = roll.generate(params if epoch != loaded else None, rng)
            loaded = epoch
            blocks += 1
            self._rollout_dispatched = True
            self._rollout_beat()
            for ep in episodes:
                ep["args"]["model_id"] = {p: epoch for p in ep["players"]}
            if not self._rollout_live(gen):
                return
            if not episodes:
                continue
            if not self._submit(("device_episodes", episodes), gen):
                return

    def _device_replay_inner(self, roll, rng: torch.Generator, gen: int) -> None:
        """Streaming rollout -> ring ingest on the card; only the ingests'
        counters reach the host, one ingest late (``ingest_counted(defer=
        True)``), and go to the server loop for the books.  ``epoch_fifo``
        holds the model epoch of each ingest in flight, so the counters that
        come back are booked under the params that played them."""
        replay = self._replay
        loaded = None
        pending_steps = 0   # game steps of ingests that finished no episode
        epoch_fifo: deque = deque()
        blocks = 0
        try:
            while self._rollout_live(gen):
                if self._maybe_wedge(gen, blocks):
                    return
                gateway = self._plane_gateway
                if (self.num_returned_episodes >= self._next_update_episodes
                        or (gateway is not None and gateway.actor_hosts > 0)):
                    # backpressure: the epoch's budget is met, or an actor host
                    # feeds the rings (one source at a time); let the trainer run
                    time.sleep(0.02)
                    self._rollout_beat()
                    continue
                epoch, params = self.model_server.latest_snapshot()
                records = roll.launch(params if epoch != loaded else None, rng)
                loaded = epoch
                epoch_fifo.append(epoch)
                stats = replay.ingest_counted(records, defer=True)
                blocks += 1
                self._rollout_dispatched = True
                self._rollout_beat()
                if not self._rollout_live(gen):
                    return
                if stats is None:
                    continue
                stats_epoch = epoch_fifo.popleft()
                n = int(stats["episodes"])
                pending_steps += int(stats["game_steps"])
                if n == 0:
                    continue   # the steps wait in pending_steps for the next report
                counts = {"episodes": n, "players": roll.venv.num_players,
                          "model_id": stats_epoch, "game_steps": pending_steps,
                          "outcome_sum": float(stats["outcome_sum"].sum()),
                          "outcome_sq_sum": float(stats["outcome_sq_sum"])}
                pending_steps = 0
                if not self._submit(("device_counts", counts), gen):
                    return
        finally:
            # settle the deferred tail; book it only while the run is live
            # (a watchdog restart): at shutdown it could push the books over
            # the next boundary and conjure an extra epoch
            try:
                left = replay.flush_counted()
            except Exception:
                left = None
            if left and not self.shutdown_flag and (left["episodes"] > 0 or pending_steps):
                self._submit(("device_counts", {
                    "episodes": int(left["episodes"]), "players": roll.venv.num_players,
                    "model_id": int(epoch_fifo[0]) if epoch_fifo else self.model_epoch,
                    "game_steps": pending_steps + int(left["game_steps"]),
                    "outcome_sum": float(left["outcome_sum"]),
                    "outcome_sq_sum": float(left["outcome_sq_sum"])}), gen)

    def _submit(self, request, gen: int) -> bool:
        """Hand ``(req, data)`` to the server loop and wait on its future: the
        loop can be busy for a long time at an epoch boundary, which is no
        stall.  False once this generation is no longer live."""
        fut: Future = Future()
        self._requests.put(request + (fut,))
        while not fut.done():
            try:
                fut.result(timeout=5.0)
            except FutureTimeoutError:
                if not self._rollout_live(gen):
                    return False  # the server loop has ended; nothing to feed
            self._rollout_beat()
        return True

    def run(self) -> int:
        """Train to ``epochs`` epochs (or until stopped); returns 0, or
        ``EXIT_RESUMABLE`` (75) after a preemption drain."""
        self._install_signal_handlers()
        if self._health is not None:
            self._health.start()
        if self._collective_watchdog is not None:
            self._collective_watchdog.start()
        if self._plane_gateway is not None:
            self._plane_gateway.start()
        try:
            self._trainer_thread = threading.Thread(target=self.trainer.run, daemon=True,
                                                    name="trainer")
            self._trainer_thread.start()
            try:
                if not self._sp_member:
                    self.worker.run()
            except BaseException:
                self.trainer.stop()  # the batch pipeline's processes and segment go with it
                raise
            if not self.remote:
                self._active_workers = len(self.worker.threads)
            if self._device_roll is not None:
                self._start_rollout_thread()
                threading.Thread(target=self._watchdog_loop, daemon=True,
                                 name="plane-watchdog").start()
            self._start_flywheel_ingest()
            try:
                self.server()
            finally:
                self.shutdown_flag = True
                if self._rollout_thread is not None:
                    # let the block in flight finish and its copies land;
                    # under a drain, within what is left of its deadline
                    timeout = 120.0
                    if self._drain_requested:
                        left = self.drain_deadline - (time.time() - self._drain_t0)
                        timeout = max(5.0, min(timeout, left))
                    self._rollout_thread.join(timeout=timeout)
        finally:
            if self._flywheel_ingestor is not None:
                self._flywheel_ingestor.stop()
            if self._plane_gateway is not None:
                self._plane_gateway.stop()
            self._disarm_host_fault()
            if self._health is not None:
                self._health.stop()
            self._restore_signal_handlers()
            trace.shutdown()   # the ring's tail; nothing when tracing is off
        from ..parallel.distributed import is_initialized, params_crc32

        if is_initialized():
            # the ranks' params are bit for bit the same: each prints its
            # fingerprint, which equals that of the coordinator's last save
            print("distributed learner: process %d params crc32 %08x at step %d"
                  % (self._dist_rank, params_crc32(self.trainer.state_host["params"]),
                     self.trainer.state_host["steps"]), flush=True)
        return EXIT_RESUMABLE if self._drain_requested else 0

    # -- several processes: the follower's boundary, faults, the gateway -------

    def _follower_boundary(self) -> None:
        """A follower's epoch boundaries are the coordinator's: the trainer's
        queue holds a snapshot only once the cadence ended the epoch on
        every rank.  An agreed drain is adopted here, so this rank exits 75
        too; an agreed stop, once its snapshot is consumed, drains the
        workers."""
        if self.trainer.drain_agreed and not self._drain_requested:
            self._drain_requested = True
            self._drain_t0 = time.time()
            self.shutdown_flag = True
            print(f"[handyrl_tpu_torch] coordinator-agreed drain: shutting down within "
                  f"{self.drain_deadline:.0f}s and exiting {EXIT_RESUMABLE} for the "
                  "coordinated relaunch", file=sys.stderr, flush=True)
        elif not self._drain_requested and not self.trainer.update_queue.empty():
            # the local rollout's budget follows the agreed epochs
            self._next_update_episodes += self.args["update_episodes"]
            self.update()
        elif (self.trainer.finished and self.trainer.update_queue.empty()
              and not self._drain_requested):
            self.shutdown_flag = True

    def _dist_record(self, record: Dict[str, Any], steps: int) -> None:
        """The epoch record's keys of a run of several processes: the
        backend, the cumulative health counters and the per-rank
        aggregates (a follower's snapshot rides its next heartbeat), and
        the gateway's books."""
        if self._dist_nprocs > 1:
            record["dist_processes"] = self._dist_nprocs
            record["dist_backend"] = self.dist_backend
            record.update(self._dist_events())
            if self._health is not None and self._rank_metrics:
                snap = self._rank_snapshot(steps)
                if self._dist_follower:
                    self._health.offer_metrics(snap)
                else:
                    record.update(self._health.rank_aggregates(snap))
        gateway = self._plane_gateway
        if gateway is not None:
            record["dist_actor_hosts"] = int(gateway.actor_hosts)
            record["dist_actor_host_losses"] = int(gateway.actor_host_losses)
            record.update(plane_record_batches=gateway.record_batches,
                          plane_record_bytes=gateway.record_bytes,
                          plane_record_span_s=round(gateway.record_span_s, 4),
                          plane_bytes_out=gateway.bytes_out,
                          plane_param_version=gateway.version,
                          plane_param_fetches=gateway.param_fetches)

    def _rank_snapshot(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """This rank's per-epoch snapshot for the coordinator's rank_*
        aggregates (small: it rides a heartbeat line)."""
        stats = self.trainer.stats or {}
        return {"epoch": self.model_epoch,
                "steps": int(self.trainer.steps if steps is None else steps),
                "train_steps_per_sec": stats.get("train_steps_per_sec"),
                "input_wait_frac": stats.get("input_wait_frac")}

    def _dist_events(self) -> Dict[str, int]:
        """Cumulative health counters for the dist_* keys."""
        health_ev = self._health.events if self._health is not None else {}
        wd = self._collective_watchdog
        return {"dist_heartbeat_misses": int(health_ev.get("heartbeat_misses", 0)),
                "dist_collective_timeouts": 1 if (wd is not None and wd.fired) else 0,
                "dist_peer_loss_drains": int(health_ev.get("peer_losses", 0))
                + int(health_ev.get("coordinator_losses", 0))}

    def _disarm_host_fault(self) -> None:
        """The agreed stop or drain broadcast returned: every rank is past
        its last collective, so the detectors stand down before the ranks'
        teardowns drift apart."""
        if self._health is not None:
            self._health.disarm()
        if self._collective_watchdog is not None:
            self._collective_watchdog.stop()

    def _host_fault(self, reason: str, kind: str) -> None:
        """A peer is lost or a collective wedged (on a health or watchdog
        thread, while the trainer may wait in a collective that never
        completes and cannot be cancelled): the coordinator drain-saves
        from the last consistent host snapshot, and every rank leaves by
        ``os._exit(75)``, since the interpreter's teardown would wait on the
        wedged thread.  75 asks the supervisor to relaunch every rank with
        ``restart_epoch: -1``."""
        from ..parallel.health import announce_fault

        with self._ckpt_lock:   # a boundary's save in flight lands first
            if self._host_faulted:
                return
            self._host_faulted = True
        announce_fault(reason, kind, EXIT_RESUMABLE)
        try:
            if not self._dist_follower:
                record: Dict[str, Any] = {"epoch": self.model_epoch,
                                          "dist_processes": self._dist_nprocs,
                                          "dist_backend": getattr(self, "dist_backend", None)}
                record.update(self._dist_events())
                if self._health is not None and self._rank_metrics:
                    try:
                        record.update(self._health.rank_aggregates(self._rank_snapshot()))
                    except Exception:
                        pass   # the drain save lands regardless
                self._write_metrics(record)
                self._write_drain_checkpoint()
        except Exception:
            import traceback

            traceback.print_exc()
            print("[handyrl_tpu_torch] host-fault drain save failed (above); the previous "
                  "epoch's verified checkpoint remains the resume point", file=sys.stderr)
        # the batch pipeline's children and segment go before the process,
        # within a bound: the trainer thread may be stuck for good
        stopper = threading.Thread(target=self.trainer.batcher.stop, daemon=True)
        stopper.start()
        stopper.join(timeout=10.0)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(EXIT_RESUMABLE)

    def _dist_fault_hooks(self) -> None:
        """The rank-scoped fault injections, at each boundary's publish."""
        kill = self._fault_kill_proc
        if kill is not None and self.model_epoch >= kill[0] and self._dist_rank == kill[1]:
            print(f"[fault] killing process rank {self._dist_rank} at epoch {self.model_epoch} "
                  "(HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH)", file=sys.stderr, flush=True)
            os._exit(1)
        wedge = self._fault_wedge_proc
        if wedge is not None and self.model_epoch >= wedge[0] and self._dist_rank == wedge[1]:
            print(f"[fault] wedging process rank {self._dist_rank} at epoch {self.model_epoch} "
                  "(HANDYRL_FAULT_WEDGE_PROCESS): heartbeats stop, collectives stop, threads "
                  "stay up", file=sys.stderr, flush=True)
            if self._health is not None:
                self._health.stop_heartbeats()
            self.trainer._fault_wedge_process = True
            while True:   # the frozen host never comes back
                time.sleep(60.0)

    def _gateway_on_records(self, records: Dict[str, Any]) -> None:
        """An actor host's record block (on a gateway serve thread): its
        lane width checked, ingested into this rank's rings, and its
        counters booked through the server loop, as the rollout thread's
        are.  ``ingest_counted`` reads its stats at once (the deferred
        FIFO is the rollout thread's)."""
        widths = {x.shape[1] for x in records.values()}
        if widths != {self._device_games}:
            raise ValueError(
                f"plane gateway: record batch lane width {sorted(widths)} != this learner's "
                f"{self._device_games} per-process lanes (device_rollout_games / "
                "num_processes must match on both tiers)")
        stats = self._replay.ingest_counted(records, source="gateway")
        episodes = int(stats["episodes"])
        if episodes <= 0 and int(stats["game_steps"]) <= 0:
            return
        counts = {"episodes": episodes, "players": self._replay.venv.num_players,
                  "model_id": self.model_epoch, "game_steps": int(stats["game_steps"]),
                  "outcome_sum": float(stats["outcome_sum"].sum()),
                  "outcome_sq_sum": float(stats["outcome_sq_sum"])}
        # fire and forget: the serve thread keeps answering its host; the
        # server loop books the counts when it gets there
        self._requests.put(("device_counts", counts, Future()))

    def _start_flywheel_ingest(self) -> None:
        """Start the harvest ingest (flywheel/ingest.py) when the flywheel is
        on and the mix takes served episodes; they enter through the
        request queue as a worker's episodes do."""
        cfg = self._flywheel_cfg
        if not cfg.get("enabled") or float(cfg.get("harvest_fraction", 0.5)) <= 0.0:
            return
        from ..flywheel import HarvestIngestor
        from ..serving.client import ServingClient

        host = str(cfg.get("harvest_host", "127.0.0.1"))
        port = int(cfg.get("harvest_port", 0)) or int(self.args["serving"].get("port", 9997))

        def submit(episodes):
            self.handle("episode", episodes, timeout=60.0)

        self._flywheel_ingestor = HarvestIngestor(
            dict(cfg, update_episodes=self.args.get("update_episodes", 0)), submit,
            lambda: self.model_epoch, lambda: ServingClient(host, port, timeout=10.0),
        ).start()
        print(f"flywheel: harvest ingest armed ({host}:{port}, fraction "
              f"{cfg.get('harvest_fraction', 0.5)})", flush=True)


def train_main(args: Dict[str, Any], device=None) -> int:
    """``--train``: one learner with local actor threads, on the card
    unless ``device`` says otherwise.  With ``distributed.coordinator_address``
    set, this process first joins the group as its rank (on its placed
    card, or ``device``) and leaves it after the run."""
    from ..parallel.distributed import init_distributed, shutdown_distributed

    dist_args = args["train_args"].get("distributed") or {}
    if not dist_args.get("coordinator_address"):
        return Learner(args, device=device).run()
    _rank, placed = init_distributed(dist_args, device)
    try:
        return Learner(args, device=placed).run()
    finally:
        shutdown_distributed()


def train_server_main(args: Dict[str, Any], device=None) -> int:
    """``--train-server``: one learner serving remote worker machines
    (``--worker``) over TCP, on the card unless ``device`` says otherwise."""
    return Learner(args, device=device, remote=True).run()
