"""Synchronous trainer: episode store, lr schedule and SGD steps.

The subset of ``handyrl_tpu/runtime/trainer.py`` that the port runs so far:
no daemon thread, batch pipeline, checkpoints or epoch handshake with a
learner.  The lr schedule is the JAX package's (the reference's):
``3e-8 * lr_scale * data_cnt_ema / (1 + steps * 1e-5)``, held for an epoch,
with the data-count EMA updated at the epoch's end from the steps that
were applied.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..parallel import TrainContext
from .batch import make_batch
from .replay import EpisodeStore


class Trainer:
    def __init__(self, args: Dict[str, Any], module, device=None):
        self.args = args
        self.ctx = TrainContext(module, args, device)
        self.store = EpisodeStore(args["maximum_episodes"])
        self.default_lr = 3e-8 * args["lr_scale"]
        self.data_cnt_ema = args["batch_size"] * args["forward_steps"]
        self.steps = 0

    @property
    def lr(self) -> float:
        return self.default_lr * self.data_cnt_ema / (1 + self.steps * 1e-5)

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

    def train_epoch(self, num_steps: int) -> List[Dict[str, float]]:
        """``num_steps`` updates at this epoch's lr; returns their metrics."""
        lr = self.lr
        history = []
        for _ in range(num_steps):
            history.append(self.ctx.train_step(self.sample_batch(), lr))
            self.steps += 1
        data_cnt = sum(m["dcnt"] for m in history)
        applied = sum(1 - m.get("sentinel_bad", 0.0) for m in history)
        if applied > 0:
            self.data_cnt_ema = self.data_cnt_ema * 0.8 + data_cnt / (1e-2 + applied) * 0.2
        return history
