"""A host fault's drain save against an epoch boundary's save in flight.

The fault arrives on another thread (the health plane, the collective
watchdog or the trainer's failed collective) while the main loop may be
saving a boundary: the boundary's save lands first, the drain's epoch is
the next one and the newest verified, and no later boundary saves past it.
"""

import os
import threading
import time

import pytest
import torch

from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime import learner as learner_mod
from handyrl_tpu_torch.runtime.learner import EXIT_RESUMABLE, Learner


class _Exited(BaseException):
    pass


def _args():
    return normalize_args({
        "env_args": {"env": "TicTacToe"},
        "train_args": {"batch_size": 8, "forward_steps": 4, "minimum_episodes": 10,
                       "update_episodes": 15, "epochs": 3, "num_batchers": 1,
                       "worker": {"num_parallel": 1}},
    })


@pytest.mark.parametrize("fault_during_save", [True, False])
def test_host_fault_drain_stays_the_newest_verified_epoch(tmp_path, monkeypatch,
                                                          fault_during_save):
    monkeypatch.chdir(tmp_path)
    learner = Learner(_args(), device="cpu")
    exits = []

    def fake_exit(code):
        exits.append(code)
        raise _Exited()

    monkeypatch.setattr(os, "_exit", fake_exit)

    def fault():
        try:
            learner._host_fault("peer process 1 lost (test)", "peer_loss")
        except _Exited:
            pass

    fault_thread = threading.Thread(target=fault)
    real_save = learner_mod.save_epoch_snapshot
    saved = []

    def slow_save(model_dir, epoch, *rest):
        # the fault arrives while the boundary's files are being written
        if fault_during_save and epoch == 1 and not fault_thread.is_alive():
            fault_thread.start()
            time.sleep(0.3)
        saved.append(epoch)
        real_save(model_dir, epoch, *rest)

    monkeypatch.setattr(learner_mod, "save_epoch_snapshot", slow_save)
    params = {k: v.clone() for k, v in learner.trainer.state_host["params"].items()}
    steps = int(learner.trainer.state_host["steps"])
    try:
        learner.update_model(params, steps)
        if not fault_during_save:
            fault_thread.start()
        fault_thread.join(timeout=60)
        assert not fault_thread.is_alive()
        # a boundary after the fault writes nothing: the drain stays newest
        learner.update_model({k: v + 1 for k, v in params.items()}, steps + 1)
        # a second drain request saves nothing more
        learner._write_drain_checkpoint()
    finally:
        learner.trainer.stop()
        learner.model_server.stop()
    assert exits == [EXIT_RESUMABLE]
    assert saved == [1, 2]
    assert ckpt.latest_verified_epoch("models") == 2
    assert ckpt.verify_snapshot("models", 1) and ckpt.verify_snapshot("models", 2)
    assert not os.path.exists("models/3.ckpt")
    drained = ckpt.load_params("models/2.ckpt")
    assert all(torch.equal(drained[k], v) for k, v in params.items())
