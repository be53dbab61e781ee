"""The fleet's autoscaler: the replica count driven by the shed-rate SLO.

Counterpart of ``handyrl_tpu/fleet/autoscale.py``.  The router's stats
polls leave each replica's last ``serve_*`` record on its ``_Replica``;
the autoscaler windows them per tick (shed delta over request delta is
the fleet's shed rate, the mean queue depth its pressure before shedding
starts) and decides with hysteresis:

* up when the shed rate crosses ``shed_slo`` or the mean depth per replica
  ``depth_high``, but never while an earlier spawn is still warming and
  never within ``cooldown_s`` of the last action;
* down only after ``scale_down_after_s`` of calm (no shed, mean depth
  under ``depth_low``), and never below ``min_replicas``.

A spawned replica is admitted only once warm (the router's probe); a
retired one leaves through the router's session migration, losing no
session.  A replica factory is anything with ``spawn() -> ReplicaSpec``,
``stop(spec)`` and ``close()``.  ``ProcessReplicaFactory`` starts serving
processes of its own on this host, from the ``spawn`` start method (a
parent that has touched CUDA must never fork), each holding a
``ModelRouter`` and a ``ServingServer`` on the card.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .router_tier import ReplicaSpec

__all__ = ["AutoscaleDecider", "Autoscaler", "ProcessReplicaFactory"]

# the defaults of config.py's fleet.autoscale, for callers with a bare dict
_DEFAULTS: Dict[str, Any] = {
    "enabled": False,
    "min_replicas": 1,
    "max_replicas": 4,
    "interval_s": 1.0,
    "shed_slo": 0.01,
    "depth_high": 64.0,
    "depth_low": 1.0,
    "scale_down_after_s": 30.0,
    "cooldown_s": 10.0,
    "warm_timeout_s": 120.0,
}


def _knob(cfg: Dict[str, Any], key: str):
    return cfg.get(key, _DEFAULTS[key])


class AutoscaleDecider:
    """The decision alone: windowed signals in, ``"up"``, ``"down"`` or
    None out; no socket, no thread, and ``now`` is an argument."""

    def __init__(self, cfg: Dict[str, Any]):
        cfg = dict(cfg or {})
        self.min_replicas = int(_knob(cfg, "min_replicas"))
        self.max_replicas = int(_knob(cfg, "max_replicas"))
        self.shed_slo = float(_knob(cfg, "shed_slo"))
        self.depth_high = float(_knob(cfg, "depth_high"))
        self.depth_low = float(_knob(cfg, "depth_low"))
        self.scale_down_after_s = float(_knob(cfg, "scale_down_after_s"))
        self.cooldown_s = float(_knob(cfg, "cooldown_s"))
        self._last_action_t: Optional[float] = None
        self._calm_since: Optional[float] = None

    def decide(self, now: float, replicas: int, warming: int,
               shed_rate: float, depth_mean: float) -> Optional[str]:
        """One tick.  ``replicas`` counts every non-edge replica, the
        warming ones included; ``warming`` those connected, not admitted."""
        if replicas < self.min_replicas:
            # below the floor: restore it whatever the load or the cooldown
            self._calm_since = None
            self._last_action_t = now
            return "up"
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
        overloaded = shed_rate > self.shed_slo or depth_mean > self.depth_high
        if overloaded:
            self._calm_since = None
            if replicas < self.max_replicas and warming == 0 and not in_cooldown:
                self._last_action_t = now
                return "up"
            return None
        calm = shed_rate <= 0.0 and depth_mean < self.depth_low
        if not calm:
            self._calm_since = None
            return None
        if self._calm_since is None:
            self._calm_since = now
        if (replicas > self.min_replicas and warming == 0 and not in_cooldown
                and now - self._calm_since >= self.scale_down_after_s):
            self._last_action_t = now
            self._calm_since = None
            return "down"
        return None


class Autoscaler:
    """The loop: windows the router's polled stats into (shed rate, mean
    depth), asks the decider, and calls the router's ``scale_up`` or
    ``scale_down``.  Started by ``FleetRouter.run``; ``stop`` joins it."""

    def __init__(self, router, cfg: Dict[str, Any]):
        self.router = router
        self.cfg = dict(cfg or {})
        self.interval_s = float(_knob(self.cfg, "interval_s"))
        self.decider = AutoscaleDecider(self.cfg)
        # each replica's previous cumulative counters, by name
        self._prev: Dict[str, Dict[str, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="fleet-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=300.0)

    def signals(self):
        """(replicas, warming, shed_rate, depth_mean) over the window since
        the previous call, from the router's last polled stats."""
        reps = [r for r in self.router._reps() if not r.is_edge]
        live = [r for r in reps if r.alive and not r.sealed]
        warming = sum(1 for r in live if not r.admitted)
        shed_d = req_d = 0.0
        depths: List[float] = []
        seen = set()
        for rep in live:
            if not rep.admitted:
                continue
            stats = dict(rep._last_stats)
            name = rep.spec.name
            seen.add(name)
            prev = self._prev.get(name, {})
            shed_d += max(0.0, float(stats.get("serve_shed") or 0.0)
                          - float(prev.get("serve_shed") or 0.0))
            req_d += max(0.0, float(stats.get("serve_requests") or 0.0)
                         - float(prev.get("serve_requests") or 0.0))
            depths.append(float(stats.get("serve_depth") or 0.0))
            self._prev[name] = stats
        for name in list(self._prev):
            if name not in seen:
                del self._prev[name]
        shed_rate = shed_d / max(1.0, req_d)
        depth_mean = sum(depths) / len(depths) if depths else 0.0
        return len(live), warming, shed_rate, depth_mean

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            if self.router.shutdown_flag:
                return
            try:
                self.tick()
            except Exception as exc:
                # a fleet stuck at the wrong size breaks its SLO: say so
                print(f"fleet: autoscale tick failed: {type(exc).__name__}: {exc}")

    def tick(self) -> Optional[str]:
        replicas, warming, shed_rate, depth_mean = self.signals()
        action = self.decider.decide(time.monotonic(), replicas, warming, shed_rate, depth_mean)
        if action == "up":
            self.router.scale_up(reason=f" (shed_rate={shed_rate:.3f} depth={depth_mean:.1f})")
        elif action == "down":
            self.router.scale_down(reason=f" (calm: depth={depth_mean:.1f})")
        return action


# -- serving processes as replicas ---------------------------------------------


def _spawned_replica_main(pipe, args: Dict[str, Any], device) -> None:
    """A replica process (spawn start method): a serving plane on a free
    port.  It binds first and reports the port, then publishes the newest
    verified snapshot of ``model_dir`` (fresh weights from ``seed`` as id 0
    without one) and warms: the router connects and probes meanwhile, and
    admits it once its engine is live."""
    import torch

    from ..envs import make_env, prepare_env
    from ..models.inference import init_variables
    from ..runtime.checkpoint import latest_verified_epoch, load_verified_params
    from ..serving.router import ModelRouter
    from ..serving.server import ServingServer

    train = args["train_args"]
    env_args = args["env_args"]
    prepare_env(env_args)
    env = make_env(env_args)
    env.reset()
    template_obs = env.observation(env.players()[0])
    model_dir = train.get("model_dir", "models")
    serving_cfg = dict(train.get("serving") or {}, port=0)
    newest = 0
    try:
        newest = latest_verified_epoch(model_dir)
    except Exception as exc:
        print(f"fleet replica: checkpoint scan failed ({exc}); starting fresh", flush=True)
    if newest > 0:
        with torch.device("meta"):   # the router reads only the structure
            module = env.net()
    else:
        module = env.net()
    router = ModelRouter(module, template_obs, serving_cfg, model_dir=model_dir,
                         devices=None if device is None else [device])
    server = ServingServer(router, serving_cfg).run()
    pipe.send(server.bound_port)
    try:
        if newest > 0:
            router.publish(newest, load_verified_params(model_dir, newest, pre_verified=True))
        else:
            router.publish(0, init_variables(module, int(train.get("seed", 0))).state_dict())
        del module
        try:
            pipe.recv()   # until the factory says stop, or is gone
        except (EOFError, OSError):
            pass
    finally:
        server.shutdown()


class ProcessReplicaFactory:
    """Serving processes on this host, started from the ``spawn`` start
    method, on the card unless ``device`` says otherwise.  ``spawn()``
    returns once the child reports its port (listening, not yet warm:
    admission is the router's probe); ``stop(spec)`` asks it to exit and
    reaps it; ``close()`` stops every one."""

    def __init__(self, args: Dict[str, Any], spawn_timeout_s: float = 120.0, device=None):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.args = args
        self.device = None if device is None else str(device)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self._procs: Dict[str, Any] = {}  # spec name -> (process, pipe)
        self._lock = threading.Lock()

    def spawn(self) -> ReplicaSpec:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=_spawned_replica_main,
                                 args=(child, self.args, self.device), daemon=True,
                                 name="fleet-replica")
        proc.start()
        child.close()
        if not parent.poll(self.spawn_timeout_s):
            self._reap(proc, parent)
            raise OSError(f"spawned replica reported no port within {self.spawn_timeout_s:.0f}s")
        try:
            port = int(parent.recv())
        except (EOFError, OSError) as exc:
            self._reap(proc, parent)
            raise OSError(f"spawned replica died before reporting its port ({exc})") from exc
        spec = ReplicaSpec("127.0.0.1", port)
        with self._lock:
            self._procs[spec.name] = (proc, parent)
        return spec

    @staticmethod
    def _reap(proc, pipe) -> None:
        try:
            pipe.send("stop")
        except (BrokenPipeError, OSError):
            pass
        pipe.close()
        proc.join(timeout=30.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10.0)

    def stop(self, spec: ReplicaSpec) -> None:
        with self._lock:
            entry = self._procs.pop(spec.name, None)
        if entry is not None:
            self._reap(*entry)

    def close(self) -> None:
        with self._lock:
            procs, self._procs = list(self._procs.values()), {}
        for proc, pipe in procs:
            try:
                pipe.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for entry in procs:
            self._reap(*entry)
