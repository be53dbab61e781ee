"""Actor workers, the local worker pool and the model server they draw on.

Counterpart of ``handyrl_tpu/runtime/worker.py``.  Actors are threads in
the learner's process sharing one served model on the card through the
batched inference engine: the env step is cheap host Python, and the
engine turns many actors' single requests into one forward.

Protocol: a worker asks ``('args', None)``, runs one generation or
evaluation job and reports ``('episode', ep)`` / ``('result', res)``.
Model ids: 0 = the zero-output random model, -1 = latest, epoch numbers
otherwise.  The same ``Worker`` runs on a remote worker machine
(runtime/server.py), where its connection is a gather over TCP.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, List

import torch

from ..envs import make_env, prepare_env
from ..models import InferenceModel, RandomModel
from ..utils import resolve_device
from .evaluation import Evaluator
from .generation import Generator
from .inference_engine import BatchedInferenceEngine, EngineStopped


class LocalModelServer:
    """Serves model handles by id to in-process workers.

    The latest model runs behind one ``BatchedInferenceEngine`` shared by
    every actor thread, on a serving module of its own: the trainer updates
    its module in place, so the actors never read it.  ``publish`` copies an
    epoch's weights into the serving module between two batches.  Older
    epochs are loaded from disk on demand; id 0 is the random model."""

    def __init__(self, module, env, args: Dict[str, Any], device=None):
        self.args = args
        self.model_dir = args.get("model_dir", "models")
        self.device = resolve_device(device)
        self._model = InferenceModel(copy.deepcopy(module), self.device)
        env.reset()
        self._random = RandomModel.from_model(self._model, env.observation(env.players()[0]))
        self.engine = BatchedInferenceEngine(
            self._model, max_batch=args.get("inference_batch_size", 64)).start()
        self.model_id = 0
        self._latest: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()
        # requested snapshots served as the latest instead (missing or
        # corrupt file): counted, so eval books scored against the wrong
        # model show up in metrics.jsonl
        self.substituted_snapshots = 0

    def publish(self, model_id: int, state_dict: Dict[str, torch.Tensor]) -> None:
        """Serve ``state_dict`` (a detached copy, e.g. the trainer's epoch
        snapshot) as the latest model, ``model_id``.  The reference is kept:
        a train server serialises what its actors are served from it."""
        with self._lock:
            self.engine.load_state_dict(state_dict)
            self.model_id = model_id
            self._latest = state_dict

    def latest_snapshot(self):
        """(model_id, host state_dict) of the served latest model, read
        together, so a cache keyed by the id never pairs it with newer
        params published in between."""
        with self._lock:
            return self.model_id, self._latest

    def stop(self) -> None:
        self.engine.stop()

    def get(self, model_id: int):
        if model_id == 0:
            return self._random
        with self._lock:
            current = self.model_id
        if model_id < 0 or model_id >= current:
            return self.engine.client()
        from .checkpoint import load_verified_params

        try:
            params = load_verified_params(self.model_dir, model_id)
            module = copy.deepcopy(self._model.module)
            module.load_state_dict(params)
            return InferenceModel(module, self.device)
        except Exception as exc:
            print(f"snapshot {model_id} unavailable ({type(exc).__name__}: {exc}); "
                  "serving the latest model")
            with self._lock:
                self.substituted_snapshots += 1
            return self.engine.client()


class Worker:
    """One actor loop: ask for a job, run it, report."""

    def __init__(self, env, args: Dict[str, Any], conn: Callable,
                 model_server: LocalModelServer, wid: int = 0):
        self.env = env
        self.args = args
        self.conn = conn  # callable (req, data) -> response
        self.model_server = model_server
        self.wid = wid
        self.generator = Generator(env, args)
        self.evaluator = Evaluator(env, args)

    def run(self) -> None:
        while True:
            try:
                args = self.conn("args", None)
            except OSError:
                break  # the transport is gone (a severed or stalled gather)
            if args is None:
                break
            role = args["role"]
            try:
                models = {p: self.model_server.get(mid) for p, mid in args["model_id"].items()}
                if role == "g":
                    self.conn("episode", self.generator.execute(models, args))
                elif role == "e":
                    self.conn("result", self.evaluator.execute(models, args))
            except EngineStopped:
                break  # the learner shut the engine down mid-job
            except OSError:
                break  # the transport is gone; nothing left to report to
            except Exception as exc:
                # a failed job must not kill the actor: a dead thread would
                # shrink the pool and hang the learner's shutdown
                print(f"worker {self.wid} job failed: {type(exc).__name__}: {exc}")
                self.conn("episode" if role == "g" else "result", None)


class LocalWorkerPool:
    """Thread-per-actor pool talking straight to the learner's handler."""

    def __init__(self, args: Dict[str, Any], handler: Callable, model_server: LocalModelServer):
        self.args = args
        self.handler = handler  # the learner's (req, data) -> response
        self.model_server = model_server
        self.threads: List[threading.Thread] = []

    def run(self) -> None:
        prepare_env(self.args["env"])
        for wid in range(self.args["worker"]["num_parallel"]):
            worker = Worker(make_env(self.args["env"]), self.args, self.handler,
                            self.model_server, wid)
            t = threading.Thread(target=worker.run, daemon=True, name=f"actor-{wid}")
            t.start()
            self.threads.append(t)
