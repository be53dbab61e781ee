"""Environment registry and factories (TicTacToe and Geister, so far).

An unknown name is treated as a dotted import path, as in the JAX package,
so user environments plug in without registration.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

from .base import BaseEnvironment  # noqa: F401  (re-export)

ENVS = {
    "TicTacToe": "handyrl_tpu_torch.envs.tictactoe",
    "Geister": "handyrl_tpu_torch.envs.geister",
}


def make_env(env_args: Dict[str, Any]) -> BaseEnvironment:
    name = env_args["env"]
    return importlib.import_module(ENVS.get(name, name)).Environment(env_args)
