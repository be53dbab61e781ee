"""Multi-model router: N verified snapshots (or ensembles of them) served at
once, with zero-downtime hot swap.

Counterpart of ``handyrl_tpu/serving/router.py``.  Routing contract:

* ``-1`` (or any id newer than the latest): the latest published model;
* ``0``: the zero-output ``RandomModel``, answered on the host with no
  device work;
* a concrete epoch: that snapshot's resident engine, loaded from the
  checkpoint manifest (digest-verified) on first use; a snapshot that is
  missing or corrupt is served by the latest engine and counted in
  ``substituted``, never swapped in silence;
* a list of ids: an ensemble route, one inference per member engine,
  outputs mean-pooled (``agents.mean_pool_outputs``).

Hot swap: ``publish`` builds the new engine off the hot path (a module of
its own on its device, straight from the state dict), warms its buckets,
then flips the latest pointer under the routing lock.  The old engine
stays resident and serves what it was given; when ``max_models`` evicts
it, it is drained (sealed, everything admitted completed) and stopped on a
background thread, never dropped.

Engines take the router's devices in turn; by default that is the one
device the port resolves (the card unless the caller asks for another).
``serving.weight_dtype: int8`` makes every engine int8-resident
(models/quantize.py), on publish, stage and cold resolve alike, and an
int8 publish records a calibration when ``calibration_source`` is set.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..agents import mean_pool_outputs
from ..models.inference import RandomModel, build_inference_model, module_skeleton
from ..runtime.checkpoint import latest_verified_epoch, load_verified_params
from ..parallel.mesh import PlaneMember
from ..utils import resolve_device
from .batcher import BadRequest, ContinuousBatcher, ServeError, percentiles_ms

__all__ = ["ModelRouter", "EnsembleRoute", "RouteError", "ColdRoute"]

ModelId = Union[int, Sequence[int]]


class RouteError(ServeError):
    """No servable route for the requested model id."""

    kind = "bad_request"


class ColdRoute(Exception):
    """Control flow, not an error: this id needs cold work (a disk load, a
    warm-up, or waiting on another loader).  Raised only under
    ``allow_cold=False``, so the server's dispatch thread can hand the
    request to a worker instead."""


class _InstantRoute:
    """Model id 0: the zero-output RandomModel, answered on the host (its
    futures complete at once)."""

    def __init__(self, random_model: RandomModel):
        self._random = random_model

    def submit(self, obs, hidden=None, deadline=None) -> Future:
        fut: Future = Future()
        fut.set_result(self._random.inference(obs, hidden))
        return fut


class EnsembleRoute:
    """Mean-pooled multi-member route: one submit per member engine, and
    the combined future resolves when the last member lands.  Hidden state
    is not pooled; an ensemble reply has none."""

    def __init__(self, members: List[Tuple[int, ContinuousBatcher]]):
        self.members = members

    def submit(self, obs, hidden=None, deadline=None) -> Future:
        out: Future = Future()
        if hidden is not None:
            out.set_exception(BadRequest(
                "ensemble routes cannot thread recurrent state; track "
                "per-member hidden client-side and submit per member"
            ))
            return out
        futs = [engine.submit(obs, None, deadline) for _, engine in self.members]
        # a member that failed at once (a sealed engine, a shed) fails the
        # combined future now, while the server's retry can still see it
        for f in futs:
            exc = f.exception() if f.done() else None
            if exc is not None:
                out.set_exception(exc)
                return out
        pending = [len(futs)]
        lock = threading.Lock()

        def _one_done(_f):
            with lock:
                pending[0] -= 1
                if pending[0]:
                    return
            for f in futs:
                exc = f.exception()
                if exc is not None:
                    if not out.done():
                        out.set_exception(exc)
                    return
            pooled = mean_pool_outputs([f.result() for f in futs])
            if not out.done():
                out.set_result(pooled)

        for f in futs:
            f.add_done_callback(_one_done)
        return out


class ModelRouter:
    """Routes request model ids to resident ContinuousBatcher engines.

    ``module`` gives the structure of every engine's module: the router
    keeps a copy of it without storage and never reads its tensors.
    ``publish`` takes a state dict (name -> tensor or numpy array)."""

    def __init__(
        self,
        module,
        template_obs,
        serving_cfg: Dict[str, Any],
        model_dir: str = "models",
        devices=None,
    ):
        self.module = module_skeleton(module)
        self.model_dir = model_dir
        self._template_obs = template_obs
        cfg = dict(serving_cfg or {})
        self.max_models = max(1, int(cfg.get("max_models", 4)))
        self.warm_buckets = [int(b) for b in cfg.get("warm_buckets", (1, 8))]
        self._engine_cfg = {
            "max_batch": int(cfg.get("max_batch", 64)),
            "max_wait_ms": float(cfg.get("max_wait_ms", 2.0)),
            "slo_ms": float(cfg.get("slo_ms", 200.0)),
            "shed_policy": cfg.get("shed_policy", "deadline"),
            "queue_bound": int(cfg.get("queue_bound", 1024)),
        }
        # every engine this router builds (publish, stage, cold resolve)
        # goes through build_inference_model: 'int8' keeps int8 codes and
        # fp32 scales resident on the device (models/quantize.py)
        self.weight_dtype = cfg.get("weight_dtype", "float32")
        self.calibration_batches = int(cfg.get("calibration_batches", 4))
        # an owner holding stored episodes sets this (a callable returning
        # batched observation trees); each int8 publish then records the
        # measured fp32-vs-int8 output deviation in last_calibration
        self.calibration_source = None
        self.last_calibration: Optional[Dict[str, float]] = None
        # devices, or plane members (parallel/mesh.py): the league's frozen
        # opponents on the split plane's actor members
        self._devices: List = (
            [d if isinstance(d, PlaneMember) else resolve_device(d) for d in devices]
            if devices is not None else [resolve_device()]
        )
        self._spawned = 0
        self._lock = threading.Lock()
        self._engines: Dict[int, ContinuousBatcher] = {}
        self._touched: Dict[int, float] = {}
        self._latest_id: Optional[int] = None
        self._random: Optional[_InstantRoute] = None
        self._retiring: List[threading.Thread] = []
        # engines popped from the routing table but still draining: stats
        # keep counting them, and their final counters fold into
        # _retired_totals once their serve thread has exited
        self._draining: List[ContinuousBatcher] = []
        self._retired_totals: Dict[str, int] = {}
        # one loader per cold snapshot id: a burst for the same epoch pays
        # one disk load and one warm-up
        self._loading: Dict[int, Future] = {}
        # a cold load or publish racing stop() must not re-register an
        # engine into the cleared table
        self._stopped = False
        self.hot_swaps = 0
        self.substituted = 0
        self.last_warm_ms: Optional[float] = None
        # promotion gate: a staged candidate is resident and addressable,
        # but latest does not flip until promoted; after a promotion the
        # displaced incumbent stays resident as the demote target.  Both
        # are exempt from LRU eviction while they hold these roles.
        self._candidate_id: Optional[int] = None
        self._incumbent_id: Optional[int] = None

    # -- engine construction / hot swap --------------------------------------

    def _spawn(self, params) -> ContinuousBatcher:
        """A started engine for ``params`` on the next device in turn."""
        with self._lock:
            device = self._devices[self._spawned % len(self._devices)]
            self._spawned += 1
        model = build_inference_model(self.module, params, self.weight_dtype,
                                      device.device if isinstance(device, PlaneMember)
                                      else device)
        return ContinuousBatcher(
            model, [device], template_obs=self._template_obs, **self._engine_cfg
        ).start()

    def publish(self, model_id: int, params, warm: bool = True) -> float:
        """Serve ``params`` as ``model_id`` and make it the latest: build and
        warm the standby engine off the hot path, then flip.  Returns the
        warm-up wall ms."""
        engine = self._spawn(params)
        warm_ms = engine.warm(self.warm_buckets, self._template_obs) if warm else 0.0
        self._maybe_calibrate(params, engine.device)
        with self._lock:
            if self._stopped:
                displaced = None
            else:
                prev = self._latest_id
                displaced = self._engines.pop(int(model_id), None)
                if displaced is not None:
                    self._draining.append(displaced)  # atomic with the pop
                self._engines[int(model_id)] = engine
                self._touched[int(model_id)] = time.monotonic()
                self._latest_id = int(model_id)
                if prev is not None and prev != int(model_id):
                    self.hot_swaps += 1
                self.last_warm_ms = warm_ms
                # a direct publish supersedes a gate in flight
                if self._candidate_id == int(model_id):
                    self._candidate_id = None
                if prev is not None and prev != int(model_id):
                    self._incumbent_id = None
            stopped = self._stopped
        if stopped:
            engine.stop()
            raise RouteError("router stopped")
        if displaced is not None:  # a republished id: retire the old engine
            self._retire(displaced)
        self._evict_over_capacity()
        return warm_ms

    def _maybe_calibrate(self, params, device) -> None:
        """An int8 publish replays stored observations through an fp32 and
        an int8 engine of ``params`` and records the measured output
        deviation, never a weight-space bound."""
        if (self.weight_dtype != "int8" or self.calibration_batches <= 0
                or self.calibration_source is None):
            return
        from ..models.quantize import calibration_report

        batches = list(self.calibration_source())[: self.calibration_batches]
        if batches:
            self.last_calibration = calibration_report(self.module, params, batches,
                                                       device=device)

    def maybe_refresh(self) -> Optional[int]:
        """Publish the newest manifest-verified snapshot if it is newer than
        the latest served (the checkpoint watcher's call).  Returns the
        epoch published, or None."""
        newest = latest_verified_epoch(self.model_dir)
        with self._lock:
            current = self._latest_id
        if newest <= 0 or (current is not None and newest <= current):
            return None
        params = load_verified_params(self.model_dir, newest, pre_verified=True)
        self.publish(newest, params)
        return newest

    # -- promotion gate --------------------------------------------------------

    def candidate_id(self) -> Optional[int]:
        with self._lock:
            return self._candidate_id

    def incumbent_id(self) -> Optional[int]:
        with self._lock:
            return self._incumbent_id

    def stage(self, model_id: int, params, warm: bool = True) -> float:
        """publish() without the flip: build and warm an engine for
        ``model_id`` and register it as the candidate route, addressable by
        its id while latest traffic stays on the incumbent."""
        engine = self._spawn(params)
        warm_ms = engine.warm(self.warm_buckets, self._template_obs) if warm else 0.0
        with self._lock:
            if self._stopped:
                displaced = None
            else:
                displaced = self._engines.pop(int(model_id), None)
                if displaced is not None:
                    self._draining.append(displaced)  # atomic with the pop
                self._engines[int(model_id)] = engine
                self._touched[int(model_id)] = time.monotonic()
                self._candidate_id = int(model_id)
                self.last_warm_ms = warm_ms
            stopped = self._stopped
        if stopped:
            engine.stop()
            raise RouteError("router stopped")
        if displaced is not None:
            self._retire(displaced)
        self._evict_over_capacity()
        return warm_ms

    def promote_candidate(self) -> Optional[int]:
        """Flip latest to the staged candidate; the displaced incumbent stays
        resident as the demote target.  Returns the promoted id, or None
        without a candidate."""
        with self._lock:
            candidate = self._candidate_id
            if candidate is None or candidate not in self._engines:
                self._candidate_id = None
                return None
            prev = self._latest_id
            self._latest_id = candidate
            self._candidate_id = None
            self._incumbent_id = prev if prev != candidate else None
            self._touched[candidate] = time.monotonic()
            if prev is not None and prev != candidate:
                self.hot_swaps += 1
        return candidate

    def demote_candidate(self) -> Optional[int]:
        """Drop the staged candidate and retire its engine; latest never
        flipped.  Returns the demoted id, or None without a candidate."""
        with self._lock:
            candidate = self._candidate_id
            self._candidate_id = None
            engine = None
            if candidate is not None:
                engine = self._engines.pop(candidate, None)
                if engine is not None:
                    self._draining.append(engine)  # atomic with the pop
                self._touched.pop(candidate, None)
        if engine is not None:
            self._retire(engine)
        return candidate

    def demote_latest(self) -> Optional[int]:
        """Flip latest back to the resident incumbent and retire the
        regressed engine.  Returns the restored id, or None when there is
        no resident incumbent (the latest then keeps serving)."""
        with self._lock:
            incumbent = self._incumbent_id
            if incumbent is None or incumbent not in self._engines:
                return None
            bad = self._latest_id
            self._latest_id = incumbent
            self._incumbent_id = None
            self._touched[incumbent] = time.monotonic()
            self.hot_swaps += 1
            engine = None
            if bad is not None and bad != incumbent:
                engine = self._engines.pop(bad, None)
                if engine is not None:
                    self._draining.append(engine)  # atomic with the pop
                self._touched.pop(bad, None)
        if engine is not None:
            self._retire(engine)
        return incumbent

    _COUNTER_KEYS = (
        "requests_admitted", "requests_served", "requests_shed",
        "deadline_misses", "batches_served",
    )

    def _fold_retired(self, engine: ContinuousBatcher) -> None:
        stats = engine.stats()
        with self._lock:
            # from live-summed to folded in one step: never counted twice,
            # never missed
            if engine in self._draining:
                self._draining.remove(engine)
            for key in self._COUNTER_KEYS:
                self._retired_totals[key] = self._retired_totals.get(key, 0) + stats[key]

    def _retire(self, engine: ContinuousBatcher) -> None:
        """Drain, stop and fold an engine the caller has already moved from
        ``_engines`` to ``_draining`` under the routing lock."""
        def _drain_then_fold():
            engine.drain_and_stop()
            engine.join()  # its last counter increments come after the drain
            self._fold_retired(engine)

        t = threading.Thread(target=_drain_then_fold, daemon=True, name="serve-retire")
        with self._lock:
            self._retiring = [x for x in self._retiring if x.is_alive()]
            self._retiring.append(t)
        t.start()

    def _evict_over_capacity(self, protect: Optional[int] = None) -> None:
        """Retire LRU engines beyond ``max_models``.  ``protect`` exempts an
        engine a resolve just made, before its own request submits; the
        latest, a staged candidate and a promoted incumbent are pinned."""
        doomed: List[ContinuousBatcher] = []
        with self._lock:
            while len(self._engines) > self.max_models:
                candidates = [
                    k for k in self._engines
                    if k != self._latest_id and k != protect
                    and k != self._candidate_id and k != self._incumbent_id
                ]
                if not candidates:
                    break
                lru = min(candidates, key=lambda k: self._touched.get(k, 0.0))
                engine = self._engines.pop(lru)
                self._draining.append(engine)  # atomic with the pop
                doomed.append(engine)
                self._touched.pop(lru, None)
        for engine in doomed:
            self._retire(engine)

    # -- routing -------------------------------------------------------------

    def resolve(self, model_id: ModelId, allow_cold: bool = True):
        """``(served_key, route)`` for a request's model id.  served_key is
        the id that answers, so a client sees a flip the moment it happens.
        ``allow_cold=False`` raises ColdRoute instead of doing cold work."""
        if isinstance(model_id, (list, tuple)):
            members: List[Tuple[int, ContinuousBatcher]] = []
            for mid in model_id:
                key, engine = self._resolve_single(int(mid), allow_cold)
                if not isinstance(engine, ContinuousBatcher):
                    raise RouteError(f"ensemble member {mid} is not an engine-backed route")
                members.append((key, engine))
            if not members:
                raise RouteError("empty ensemble")
            return tuple(k for k, _ in members), EnsembleRoute(members)
        return self._resolve_single(int(model_id), allow_cold)

    def _resolve_single(self, mid: int, allow_cold: bool = True):
        with self._lock:
            if self._stopped:
                raise RouteError("router stopped")
        if mid == 0:
            with self._lock:
                unbuilt = self._random is None
            if unbuilt and not allow_cold:
                raise ColdRoute(mid)
            return 0, self._ensure_random()
        with self._lock:
            latest = self._latest_id
            if latest is None:
                raise RouteError("no model published yet")
            # a staged candidate usually has an id newer than latest and
            # stays addressable by it
            if mid == self._candidate_id:
                engine = self._engines.get(mid)
                if engine is not None:
                    self._touched[mid] = time.monotonic()
                    return mid, engine
            if mid < 0 or mid >= latest:
                self._touched[latest] = time.monotonic()
                return latest, self._engines[latest]
            engine = self._engines.get(mid)
            if engine is not None:
                self._touched[mid] = time.monotonic()
                return mid, engine
        # an older snapshot: a verified disk load and an engine made on
        # demand, by exactly one loader per id
        if not allow_cold:
            raise ColdRoute(mid)
        with self._lock:
            pending = self._loading.get(mid)
            if pending is None:
                pending = Future()
                self._loading[mid] = pending
                owner = True
            else:
                owner = False
        if not owner:
            engine = pending.result(timeout=600.0)
            if engine is None:  # the loader substituted: so do we, counted
                return self._substitute_latest()
            with self._lock:
                self._touched[mid] = time.monotonic()
            return mid, engine
        try:
            engine = self._spawn(load_verified_params(self.model_dir, mid))
            engine.warm(self.warm_buckets, self._template_obs)
        except Exception:
            # missing, collected or corrupt snapshot (or a failed build):
            # substitute latest, counted, and release the waiters
            with self._lock:
                self._loading.pop(mid, None)
            pending.set_result(None)
            return self._substitute_latest()
        with self._lock:
            if self._stopped:
                registered = None
            else:
                raced = self._engines.get(mid)
                if raced is None:
                    self._engines[mid] = engine
                    registered = engine
                else:
                    # a publish of this id won the race: its engine routes,
                    # ours is stopped (nothing was admitted to it)
                    registered = raced
                self._touched[mid] = time.monotonic()
            self._loading.pop(mid, None)
        pending.set_result(registered)
        if registered is None:
            engine.stop()
            raise RouteError("router stopped")
        if registered is not engine:
            engine.stop()
        else:
            self._evict_over_capacity(protect=mid)
        return mid, registered

    def _substitute_latest(self):
        with self._lock:
            latest = self._latest_id
            engine = None if latest is None else self._engines.get(latest)
            if engine is None:
                raise RouteError("router stopped" if self._stopped else "no model published yet")
            self.substituted += 1
            self._touched[latest] = time.monotonic()
            return latest, engine

    def _ensure_random(self) -> _InstantRoute:
        with self._lock:
            if self._random is not None:
                return self._random
            if self._latest_id is None:
                raise RouteError("no model published yet")
            engine = self._engines[self._latest_id]
        # the output spec from one round trip through the engine
        out = engine.submit(self._template_obs).result(timeout=60.0)
        spec = {
            k: (np.shape(v), np.asarray(v).dtype)
            for k, v in out.items()
            if k != "hidden" and v is not None
        }
        with self._lock:
            if self._random is None:
                self._random = _InstantRoute(RandomModel(spec))
            return self._random

    # -- introspection / teardown --------------------------------------------

    def latest_id(self) -> Optional[int]:
        with self._lock:
            return self._latest_id

    def routes(self) -> List[int]:
        with self._lock:
            return sorted(self._engines)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            # one consistent cut: draining engines and the retired totals
            # under the same acquisition
            engines = list(self._engines.values()) + list(self._draining)
            n_models = len(self._engines)
            retired = dict(self._retired_totals)
        per_engine = [e.stats() for e in engines]
        samples: List[float] = []
        for e in engines:
            samples.extend(e.latencies_ms())
        pct = percentiles_ms(samples)
        total = lambda key: sum(s[key] for s in per_engine) + retired.get(key, 0)
        return {
            "models": n_models,
            # queue pressure now (queued + on the device), a gauge
            "depth": sum(s["depth"] + s["inflight"] for s in per_engine),
            "requests_admitted": total("requests_admitted"),
            "requests_served": total("requests_served"),
            "requests_shed": total("requests_shed"),
            "deadline_misses": total("deadline_misses"),
            "batches_served": total("batches_served"),
            "hot_swaps": self.hot_swaps,
            "substituted": self.substituted,
            "last_warm_ms": self.last_warm_ms,
            "p50_ms": pct[50],
            "p99_ms": pct[99],
        }

    def stop(self, drain: bool = False, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopped = True
            engines = list(self._engines.values())
            self._engines.clear()
            self._touched.clear()
            retiring = list(self._retiring)
        for engine in engines:
            if drain:
                engine.drain_and_stop(timeout)
            else:
                engine.stop()
        for engine in engines:
            engine.join(timeout)  # no serve thread outlives the router
        for t in retiring:
            t.join(timeout)
