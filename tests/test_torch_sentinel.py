"""The port's divergence sentinel and preemption drain on the CPU, against
the JAX package's (tests/test_sentinel.py).

* ``_sentinel_account``: sequences of per-pull metrics made by hypothesis
  (in-step skips, loss spikes, clean steps, zero ``dcnt``) give the same
  streak, loss EMA, event counts, rollback decisions and skipped counts in
  both packages' trainers (exact: the same float arithmetic).
* The rollback: without a verified snapshot, or with a corrupt manifest,
  the params stay; with one, its params are restored exactly, the Adam
  moments start afresh and the step counter stays.
* ``HANDYRL_FAULT_NAN_AT_STEP`` on a TicTacToe learner: the poisoned steps
  are skipped, the streak rolls back to a verified snapshot, and the run
  finishes with finite losses and params.
* ``HANDYRL_FAULT_SIGTERM_AT_STEP`` on ``train_main`` in a process of its
  own: the drain writes a verified checkpoint and exits 75; a relaunch
  with ``restart_epoch: -1`` resumes there and finishes.
* The sentinel's keys are checked alike by both packages.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.runtime.trainer import Trainer as JaxTrainer
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import init_variables
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.learner import EXIT_RESUMABLE, Learner
from handyrl_tpu_torch.runtime.trainer import SENTINEL_EVENT_KEYS, Trainer

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    for var in ("HANDYRL_FAULT_NAN_AT_STEP", "HANDYRL_FAULT_SIGTERM_AT_STEP"):
        monkeypatch.delenv(var, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class _Books:
    """The attributes ``_sentinel_account`` reads and writes, with a
    rollback that records the decision and resets as both trainers do."""

    def __init__(self, fused, after, factor, decay):
        self.sentinel_events = {k: 0 for k in SENTINEL_EVENT_KEYS}
        self.sentinel_events["sentinel_flywheel_rollbacks"] = 0
        self._sentinel_streak = 0
        self._loss_ema = None
        self._spike_factor = factor
        self._loss_ema_decay = decay
        self.fused = fused
        self.sentinel_rollback_after = after
        self.rollbacks = []

    def _sentinel_rollback(self):
        self.rollbacks.append(self._sentinel_streak)
        self._sentinel_streak = 0
        self._loss_ema = None

    def state(self):
        return (self._sentinel_streak, self._loss_ema, dict(self.sentinel_events),
                list(self.rollbacks))


METRIC = st.one_of(
    st.builds(lambda k: {"sentinel_bad": float(k), "dcnt": 0.0, "total": 0.0},
              st.integers(1, 4)),                                       # in-step skips
    st.builds(lambda d, t: {"sentinel_bad": 0.0, "dcnt": float(d), "total": t},
              st.integers(0, 64), st.floats(-50.0, 50.0)),             # ordinary pulls
    st.builds(lambda d, t: {"sentinel_bad": 0.0, "dcnt": float(d), "total": t},
              st.integers(1, 64), st.floats(1e3, 1e6)),                # spikes
)


@settings(max_examples=200, deadline=None)
@given(epochs=st.lists(st.lists(METRIC, min_size=1, max_size=12), min_size=1, max_size=5),
       fused=st.integers(1, 4), after=st.integers(1, 8),
       factor=st.floats(1.5, 20.0), decay=st.floats(0.05, 0.95))
def test_sentinel_account_matches_the_jax_trainer(epochs, fused, after, factor, decay):
    port, jax_books = _Books(fused, after, factor, decay), _Books(fused, after, factor, decay)
    for fetched in epochs:
        skipped = Trainer._sentinel_account(port, fetched)
        assert skipped == JaxTrainer._sentinel_account(jax_books, fetched)
        assert port.state() == jax_books.state()


def _trainer(tmp_path, **extra):
    args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
        "batch_size": 4, "forward_steps": 4, "num_batchers": 0, "seed": 3,
        "model_dir": str(tmp_path / "models"), **extra}})["train_args"]
    module = init_variables(make_env({"env": "TicTacToe"}).net(), 3)
    return Trainer(args, module, device="cpu")


def _perturb(trainer):
    """Move the params and give Adam moments, as training would."""
    opt = trainer.ctx.optimizer
    for group in opt.param_groups:
        group["lr"] = 1e-2
    for p in trainer.ctx.module.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    assert opt.state


@pytest.mark.parametrize("manifest", ["none", "corrupt"])
def test_rollback_without_a_verified_snapshot_keeps_the_params(tmp_path, manifest):
    trainer = _trainer(tmp_path)
    if manifest == "corrupt":
        os.makedirs(tmp_path / "models")
        (tmp_path / "models" / ckpt.MANIFEST_NAME).write_text("{not json")
    _perturb(trainer)
    before = {k: v.clone() for k, v in trainer.ctx.module.state_dict().items()}
    trainer._sentinel_streak = 9
    trainer._sentinel_rollback()
    after = trainer.ctx.module.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert trainer.sentinel_events["sentinel_rollbacks"] == 0
    assert trainer._sentinel_streak == 0 and trainer._loss_ema is None


def test_rollback_restores_the_verified_snapshot_with_fresh_moments(tmp_path):
    trainer = _trainer(tmp_path)
    snapshot = {k: v.clone() for k, v in trainer.ctx.module.state_dict().items()}
    ckpt.save_epoch_snapshot(str(tmp_path / "models"), 1, snapshot, {"steps": 0}, 0)
    _perturb(trainer)
    assert not all(torch.equal(snapshot[k], v)
                   for k, v in trainer.ctx.module.state_dict().items())
    trainer.steps = 42
    seed_before = trainer._replay_gen.initial_seed()
    trainer._sentinel_streak = 8
    trainer._sentinel_rollback()
    restored = trainer.ctx.module.state_dict()
    assert all(torch.equal(snapshot[k], restored[k]) for k in snapshot)
    assert not trainer.ctx.optimizer.state     # fresh moments
    assert trainer.steps == 42                 # monotone
    assert trainer.sentinel_events["sentinel_rollbacks"] == 1
    assert trainer._replay_gen.initial_seed() != seed_before
    assert all(torch.equal(snapshot[k], trainer.state_host["params"][k]) for k in snapshot)
    # the fresh optimizer drives the module's own parameters
    assert ({id(p) for g in trainer.ctx.optimizer.param_groups for p in g["params"]}
            == {id(p) for p in trainer.ctx.module.parameters()})


def _learner_args(**extra):
    return normalize_args({
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10,
            "update_episodes": 15, "maximum_episodes": 100, "epochs": 4,
            "num_batchers": 1, "eval_rate": 0.2, "worker": {"num_parallel": 2},
            **extra,
        },
    })


def test_nan_injection_skips_rolls_back_and_finishes(tmp_path, monkeypatch):
    """A NaN lr from step 1 on: every poisoned update is skipped, the streak
    rolls back onto a verified snapshot, and the run ends finite."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HANDYRL_FAULT_NAN_AT_STEP", "1:1000000")
    learner = Learner(_learner_args(sentinel_rollback_after=2), device="cpu")
    assert learner.run() == 0
    records = [json.loads(line) for line in open("metrics.jsonl")]
    last = records[-1]
    assert last["steps"] > 1
    assert last["sentinel_skipped_steps"] > 0 and last["sentinel_rollbacks"] >= 1
    for rec in records:
        for v in (rec.get("loss") or {}).values():
            assert np.isfinite(v)
    for v in learner.trainer.state_host["params"].values():
        assert torch.isfinite(v).all()
    assert ckpt.latest_verified_epoch("models") > 0


CHILD = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(2)
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import train_main
    sys.exit(train_main(normalize_args(json.loads(sys.argv[1])), device="cpu"))
""")


def test_sigterm_drains_to_a_verified_checkpoint_and_resumes(tmp_path):
    raw = {"env_args": {"env": "TicTacToe"}, "train_args": {
        "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10, "update_episodes": 15,
        "maximum_episodes": 100, "epochs": 50, "num_batchers": 1, "eval_rate": 0.2,
        "worker": {"num_parallel": 2}, "drain_deadline_seconds": 30.0}}
    env = dict(os.environ, HANDYRL_FAULT_SIGTERM_AT_STEP="6", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(raw)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == EXIT_RESUMABLE, out[-3000:]
    assert "SIGTERM received: draining" in out and "drain checkpoint: epoch" in out
    models = str(tmp_path / "models")
    drain_epoch = ckpt.latest_verified_epoch(models)
    assert drain_epoch > 0 and ckpt.verify_snapshot(models, drain_epoch)
    assert ckpt.verify_state(models, drain_epoch)
    steps = ckpt.load_manifest(models)["epochs"][str(drain_epoch)]["steps"]
    assert steps >= 6

    os.chdir(tmp_path)
    try:
        raw["train_args"].update(epochs=drain_epoch + 1, restart_epoch=-1)
        resumed = Learner(normalize_args(raw), device="cpu")
        assert resumed.model_epoch == drain_epoch
        assert resumed.trainer.steps == steps      # the drain's state.ckpt
        assert resumed.run() == 0
        assert resumed.model_epoch > drain_epoch
    finally:
        os.chdir(ROOT)


def test_drain_handler_from_another_thread_drains(tmp_path, monkeypatch):
    """A learner run off the main thread installs no handler; calling the
    handler drains it all the same, and a second signal is ignored."""
    monkeypatch.chdir(tmp_path)
    learner = Learner(_learner_args(epochs=50), device="cpu")
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("code", learner.run()))
    thread.start()
    deadline = time.monotonic() + 60
    while learner.trainer.steps < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    learner._drain_handler(signal.SIGTERM, None)
    t0 = learner._drain_t0
    learner._drain_handler(signal.SIGINT, None)
    assert learner._drain_t0 == t0
    thread.join(60)
    assert result["code"] == EXIT_RESUMABLE
    assert ckpt.latest_verified_epoch("models") == learner.model_epoch


@pytest.mark.parametrize("key,bad", [("sentinel_rollback_after", 0),
                                     ("sentinel_spike_factor", 1.0),
                                     ("sentinel_loss_ema_decay", 1.0),
                                     ("sentinel_loss_ema_decay", 0.0)])
def test_config_validates_sentinel_knobs_alike(key, bad):
    ok = {"env_args": {"env": "TicTacToe"}, "train_args": {key: 0.5 if "decay" in key else 3}}
    assert normalize_args(ok)["train_args"][key] == jax_normalize_args(ok)["train_args"][key]
    raw = {"env_args": {"env": "TicTacToe"}, "train_args": {key: bad}}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=key):
            normalize(raw)
