"""The port's learner loop and CLI on the CPU (``device="cpu"``): the port's
versions of tests/test_runtime.py's end-to-end run and tests/test_resume.py's
resume, a one-epoch run of a small memory transformer through the masked
attention op (its plain version on the CPU), and the climb test (slow).
"""

import json
import os

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.main import main
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.learner import Learner


@pytest.fixture(autouse=True)
def _few_threads():
    # actor, batcher and trainer threads share the box with other tests
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tiny_args(extra=None):
    return normalize_args({
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "batch_size": 8,
            "forward_steps": 4,
            "minimum_episodes": 10,
            "update_episodes": 15,
            "maximum_episodes": 100,
            "epochs": 2,
            "num_batchers": 1,
            "eval_rate": 0.2,
            "worker": {"num_parallel": 2},
            **(extra or {}),
        },
    })


def _records():
    with open("metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_end_to_end_training(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    learner = Learner(_tiny_args(), device="cpu")
    assert learner.run() == 0
    for name in ("latest.ckpt", "1.ckpt", "2.ckpt", "state.ckpt"):
        assert os.path.exists(f"models/{name}"), name
    assert ckpt.verify_snapshot("models", 1) and ckpt.verify_snapshot("models", 2)
    assert ckpt.verify_state("models", 2)
    records = _records()
    assert [r["epoch"] for r in records] == [0, 1]
    assert records[-1]["steps"] > 0 and records[-1]["pipeline"] == "shm"
    assert learner.num_returned_episodes >= 25
    for key in ("loss", "episodes_per_sec", "updates_per_sec", "train_steps_per_sec",
                "input_wait_frac", "pipe_sample_s", "pipe_assemble_s", "pipe_put_s",
                "boundary_snapshot_s", "boundary_save_s", "boundary_publish_s", "engine_requests"):
        assert key in records[-1], key
    # the served model is the last epoch's snapshot
    snapshot = ckpt.load_params("models/2.ckpt")
    served = learner.model_server.engine.model.module.state_dict()
    assert all(torch.equal(served[k].cpu(), v) for k, v in snapshot.items())
    assert learner.trainer.sentinel_skipped_steps == 0


def test_learner_resume_continues_steps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = Learner(_tiny_args(), device="cpu")
    first.run()
    saved = ckpt.load_manifest("models")["epochs"]["2"]["steps"]
    assert saved > 0

    resumed = Learner(_tiny_args({"restart_epoch": -1, "epochs": 4}), device="cpu")
    assert resumed.model_epoch == 2 and resumed.trainer.steps == saved
    state = ckpt.load_train_state("models/state.ckpt")
    assert resumed.trainer.data_cnt_ema == state["data_cnt_ema"]
    assert resumed.trainer.ctx.optimizer.state_dict()["state"]  # Adam moments came back
    resumed.run()
    assert resumed.trainer.steps > saved
    records = _records()
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]
    assert records[2]["steps"] >= saved and records[-1]["steps"] > records[1]["steps"]
    assert ckpt.latest_verified_epoch("models") == 4


def test_auto_resume_falls_back_past_a_corrupt_snapshot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Learner(_tiny_args(), device="cpu").run()
    with open("models/2.ckpt", "r+b") as f:
        blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        f.seek(0)
        f.write(blob)
    learner = Learner(_tiny_args({"restart_epoch": -1}), device="cpu")
    assert learner.model_epoch == 1
    # state.ckpt was written at epoch 2: a branch, with a fresh optimizer
    assert learner.trainer.steps == 0
    want = ckpt.load_params("models/1.ckpt")
    got = learner.module.state_dict()
    assert all(torch.equal(got[k].cpu(), v) for k, v in want.items())
    learner.model_server.stop()
    with pytest.raises(ckpt.CheckpointError):
        Learner(_tiny_args({"restart_epoch": 2}), device="cpu")


def test_small_transformer_trains_one_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = normalize_args({
        "env_args": {"env": "Geister", "net": "transformer",
                     "net_args": {"d_model": 64, "n_heads": 4, "n_layers": 2, "memory_len": 8}},
        "train_args": {"batch_size": 2, "forward_steps": 32, "observation": True,
                       "seq_attention": "flash", "minimum_episodes": 3, "update_episodes": 3,
                       "epochs": 1, "num_batchers": 1, "worker": {"num_parallel": 2}},
    })
    learner = Learner(args, device="cpu")
    learner.run()
    records = _records()
    assert len(records) == 1 and records[0]["steps"] > 0
    assert np.isfinite(records[0]["loss"]["total"]) and learner.trainer.sentinel_skipped_steps == 0
    assert ckpt.verify_snapshot("models", 1)


CONFIG = """\
env_args:
  env: 'TicTacToe'
train_args:
  batch_size: 8
  forward_steps: 4
  minimum_episodes: 10
  update_episodes: 10
  epochs: 1
  num_batchers: 1
  worker:
    num_parallel: 2
  mesh: {dp: -1}
"""


def test_cli_trains_and_evaluates(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(CONFIG)
    assert main(["--train"], device="cpu") == 0
    assert ckpt.verify_snapshot("models", 1) and len(_records()) == 1
    capsys.readouterr()
    assert main(["--eval", "models/latest.ckpt", "10", "2"], device="cpu") == 0
    assert "total =" in capsys.readouterr().out
    assert main(["--eval", "models/1.ckpt:random", "4", "1"], device="cpu") == 0
    with pytest.raises(ValueError, match="no edge artifact"):   # --edge is ported
        main(["--edge"], device="cpu")
    assert "not ported" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="fleet.replicas is empty"):   # --fleet is ported
        main(["--fleet"], device="cpu")
    assert main(["--bogus"], device="cpu") == 1 and main([], device="cpu") == 1


@pytest.mark.slow
def test_training_learns_tictactoe(tmp_path, monkeypatch):
    """The reference's empirical bar (README.md: the win rate climbs), as
    the JAX package's test_training_learns_tictactoe sets it: over 120
    epochs the late-20 mean win rate against random reaches 0.72 and
    beats the early-20 mean."""
    monkeypatch.chdir(tmp_path)
    args = normalize_args({
        "env_args": {"env": "TicTacToe"},
        "train_args": {
            "batch_size": 64,
            "forward_steps": 8,
            "minimum_episodes": 100,
            "update_episodes": 100,
            "maximum_episodes": 3000,
            "epochs": 120,
            "num_batchers": 1,
            "eval_rate": 0.25,
            "worker": {"num_parallel": 6},
        },
    })
    Learner(args, device="cpu").run()
    win = [(r.get("win_rate") or {}).get("total") for r in _records()]
    win = [w for w in win if w is not None]
    assert len(win) >= 100
    early, late = float(np.mean(win[:20])), float(np.mean(win[-20:]))
    print(f"climb: early-20 {early:.3f}, late-20 {late:.3f}")
    assert late >= 0.72, f"final win rate {late:.3f} (early {early:.3f})"
    assert late > early, f"no climb: early {early:.3f} -> late {late:.3f}"
