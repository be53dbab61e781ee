"""Environment registry and factories: TicTacToe, Geister, ParallelTicTacToe,
HungryGeese and ConnectFour.

An unknown name is treated as a dotted import path, as in the JAX package,
so user environments plug in without registration.  A module may define a
``prepare()`` hook, which ``prepare_env`` runs once per process before the
first ``make_env`` of a learner, worker or evaluation.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

from .base import BaseEnvironment  # noqa: F401  (re-export)

ENVS = {
    "TicTacToe": "handyrl_tpu_torch.envs.tictactoe",
    "Geister": "handyrl_tpu_torch.envs.geister",
    "ParallelTicTacToe": "handyrl_tpu_torch.envs.parallel_tictactoe",
    "HungryGeese": "handyrl_tpu_torch.envs.hungry_geese",
    "ConnectFour": "handyrl_tpu_torch.envs.connect_four",
}


def _resolve(env_args: Dict[str, Any]):
    name = env_args["env"]
    return importlib.import_module(ENVS.get(name, name))


def prepare_env(env_args: Dict[str, Any]) -> None:
    """Run a module-level ``prepare()`` hook once per process, if present."""
    module = _resolve(env_args)
    if hasattr(module, "prepare"):
        module.prepare()


def make_env(env_args: Dict[str, Any]) -> BaseEnvironment:
    return _resolve(env_args).Environment(env_args)
