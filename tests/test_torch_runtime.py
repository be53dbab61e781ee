"""The port's acting and evaluation runtime and its checkpoints, on the CPU:
the batched inference engine against per-request calls, the stop race,
agents, match play, the eval spec and ``evaluate_mp``'s counts (the port's
versions of tests/test_runtime.py), and the checkpoint manifest.

Engine tolerance: 2e-5 absolute (fp32; a batch of rows may take other
summation blockings than one row).
"""

import os
import threading

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.agents import Agent, EnsembleAgent, RandomAgent, SoftAgent
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import InferenceModel, init_variables
from handyrl_tpu_torch.runtime import BatchedInferenceEngine, EngineStopped, evaluate_mp, exec_match
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.evaluation import parse_eval_spec, wp_func

TOL = dict(rtol=2e-4, atol=2e-5)


def _tictactoe_model(seed=0):
    env = make_env({"env": "TicTacToe"})
    return env, InferenceModel(init_variables(env.net(), seed), device="cpu")


def _run_threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)


def test_inference_engine_matches_direct():
    env, model = _tictactoe_model()
    engine = BatchedInferenceEngine(model, max_batch=8).start()
    rng = np.random.default_rng(0)
    obs = [(rng.random((3, 3, 3)) < 0.4).astype(np.float32) for _ in range(16)]
    results = [None] * 16

    def call(i):
        results[i] = engine.client().inference(obs[i])

    _run_threads(call, 16)
    engine.stop()
    assert engine.requests_served == 16 and engine.batches_served < 16
    for o, r in zip(obs, results):
        direct = model.inference(o)
        assert sorted(r) == sorted(direct) == ["policy", "value"]
        for k in direct:
            np.testing.assert_allclose(r[k], direct[k], **TOL)


def test_inference_engine_matches_direct_with_transformer_hidden():
    """Rows at different steps of their games, and fresh ones (hidden
    None), share batches; outputs and next hidden states equal per-request
    calls."""
    env = make_env({"env": "Geister", "net": "transformer",
                    "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 4}})
    model = InferenceModel(init_variables(env.net(), 1), device="cpu")
    rng = np.random.default_rng(1)

    def obs():
        return {"board": (rng.random((7, 6, 6)) < 0.3).astype(np.float32),
                "scalar": (rng.random(18) < 0.5).astype(np.float32)}

    # per request: a hidden state after k direct steps (k = 0: None)
    requests = []
    for i in range(12):
        hidden = None
        for _ in range(i % 6):
            hidden = model.inference(obs(), hidden if hidden is not None else model.init_hidden())["hidden"]
        requests.append((obs(), hidden))
    engine = BatchedInferenceEngine(model, max_batch=5).start()
    results = [None] * len(requests)

    def call(i):
        results[i] = engine.client().inference(*requests[i])

    _run_threads(call, len(requests))
    engine.stop()
    for (o, h), r in zip(requests, results):
        direct = model.inference(o, h if h is not None else model.init_hidden())
        for k in ("policy", "value", "return"):
            np.testing.assert_allclose(r[k], direct[k], **TOL)
        np.testing.assert_allclose(r["hidden"]["pos"], direct["hidden"]["pos"])
        for a, b in zip(r["hidden"]["layers"], direct["hidden"]["layers"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), **TOL)


def test_engine_weight_swap_lands_between_batches():
    env, model = _tictactoe_model()
    engine = BatchedInferenceEngine(model, max_batch=4).start()
    obs = env.observation(0)
    before = engine.client().inference(obs)
    _, other = _tictactoe_model(seed=7)
    engine.load_state_dict(other.module.state_dict())
    after = engine.client().inference(obs)
    engine.stop()
    np.testing.assert_allclose(after["policy"], other.inference(obs)["policy"], **TOL)
    assert not np.allclose(after["policy"], before["policy"])


def test_engine_submit_stop_race_strands_no_future():
    """submit racing stop() leaves no future pending: each resolves with a
    result or EngineStopped."""
    env, model = _tictactoe_model()
    for _ in range(5):
        engine = BatchedInferenceEngine(model, max_batch=8, max_wait_ms=0.5).start()
        futures, flock, go = [], threading.Lock(), threading.Event()

        def submitter(_):
            go.wait()
            for _ in range(20):
                fut = engine.submit(env.observation(0))
                with flock:
                    futures.append(fut)

        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        go.set()
        engine.stop()  # while the submitters are mid-burst
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        for fut in futures:
            try:
                assert "policy" in fut.result(timeout=30)
            except EngineStopped:
                pass


def test_exec_match_agents():
    env, model = _tictactoe_model()
    outcome = exec_match(env, {0: Agent(model), 1: RandomAgent()})
    assert set(outcome) == {0, 1} and outcome[0] + outcome[1] == 0


def test_soft_agent_samples_legal():
    env, model = _tictactoe_model()
    agent = SoftAgent(model)
    env.reset()
    agent.reset(env)
    for _ in range(5):
        assert agent.action(env, env.turn()) in env.legal_actions(env.turn())


def test_ensemble_agent_pools_members():
    env, model = _tictactoe_model()
    single, double = Agent(model), EnsembleAgent([model, model])
    env.reset()
    single.reset(env)
    double.reset(env)
    obs = env.observation(env.turn())
    np.testing.assert_allclose(single._forward(obs)["policy"], double._forward(obs)["policy"],
                               rtol=1e-5)


def test_parse_eval_spec():
    assert parse_eval_spec("models/1.ckpt") == {"main": "models/1.ckpt", "opponent": "random"}
    assert parse_eval_spec("models/1.ckpt:models/2.ckpt") == {
        "main": "models/1.ckpt", "opponent": "models/2.ckpt"}
    assert parse_eval_spec("a.ckpt+b.ckpt:rulebase") == {"main": "a.ckpt+b.ckpt",
                                                         "opponent": "rulebase"}
    with pytest.raises(ValueError):
        parse_eval_spec("a:b:c")
    assert wp_func({1: 2, 0: 2, -1: 4}) == pytest.approx(0.375)


def test_model_vs_model_eval():
    env, model = _tictactoe_model()
    results = evaluate_mp({"env": "TicTacToe"}, {0: Agent(model), 1: Agent(model)},
                          num_games=6, num_workers=2)
    assert sum(sum(r.values()) for r in results.values()) == 6


def test_evaluate_mp_random_vs_random(capsys):
    results = evaluate_mp({"env": "TicTacToe"}, {0: RandomAgent(), 1: RandomAgent()},
                          num_games=20, num_workers=4)
    assert sum(sum(r.values()) for r in results.values()) == 20
    assert {k: sum(r.values()) for k, r in results.items()} == {"[0, 1]": 10, "[1, 0]": 10}
    assert "total =" in capsys.readouterr().out


def test_load_model_agent_and_eval_vs_baseline(tmp_path):
    from handyrl_tpu_torch.runtime.evaluation import eval_vs_baseline, load_model_agent

    env, model = _tictactoe_model(seed=3)
    path = str(tmp_path / "3.ckpt")
    ckpt.atomic_write_bytes(path, ckpt.to_bytes(model.module.state_dict()))
    agent = load_model_agent(path, env, device="cpu")
    env.reset()
    np.testing.assert_array_equal(agent.model.inference(env.observation(0))["policy"],
                                  model.inference(env.observation(0))["policy"])
    # exported artifacts dispatch on their suffix: .onnx needs onnxruntime
    # (named when missing), the JAX package's .hlo and .tf are refused by name
    import importlib.util

    if importlib.util.find_spec("onnxruntime") is None:
        with pytest.raises(ImportError, match="onnxruntime"):
            load_model_agent(str(tmp_path / "model.onnx"), env, device="cpu")
    for suffix, words in ((".hlo", "StableHLO"), (".tf", "SavedModel")):
        with pytest.raises(ValueError, match=words):
            load_model_agent(str(tmp_path / ("model" + suffix)), env, device="cpu")
    wp, mean = eval_vs_baseline({"env": "TicTacToe"}, agent, "random", num_games=8, num_workers=2)
    assert 0.0 <= wp <= 1.0 and -1.0 <= mean <= 1.0
    with pytest.raises(ValueError, match="opponent"):
        eval_vs_baseline({"env": "TicTacToe"}, agent, "nobody", num_games=2)


def _params(seed):
    return {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(seed)),
            "b": torch.zeros(3)}


def _save(model_dir, epoch):
    payload = {"params": _params(epoch), "opt_state": {"state": {}, "param_groups": []},
               "steps": 10 * epoch, "epoch": epoch, "data_cnt_ema": 1.5}
    ckpt.save_epoch_snapshot(str(model_dir), epoch, _params(epoch), payload, 10 * epoch)


def test_checkpoint_round_trip(tmp_path):
    _save(tmp_path, 1)
    assert sorted(os.listdir(tmp_path)) == ["1.ckpt", "MANIFEST.json", "latest.ckpt", "state.ckpt"]
    assert ckpt.verify_snapshot(str(tmp_path), 1) is True
    assert ckpt.verify_state(str(tmp_path), 1) is True
    loaded = ckpt.load_verified_params(str(tmp_path), 1)
    assert all(torch.equal(loaded[k], v) for k, v in _params(1).items())
    state = ckpt.load_train_state(str(tmp_path / "state.ckpt"))
    assert state["steps"] == 10 and state["epoch"] == 1 and state["data_cnt_ema"] == 1.5
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_corrupt_newest_snapshot_is_refused_and_resume_falls_back(tmp_path):
    for epoch in (1, 2):
        _save(tmp_path, epoch)
    assert ckpt.latest_verified_epoch(str(tmp_path)) == 2
    path = tmp_path / "2.ckpt"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert ckpt.verify_snapshot(str(tmp_path), 2) is False
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load_verified_params(str(tmp_path), 2)
    assert ckpt.latest_verified_epoch(str(tmp_path)) == 1
    (tmp_path / "MANIFEST.json").write_text("{not json")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.latest_verified_epoch(str(tmp_path))


def test_gc_keeps_the_newest_pins_and_the_newest_verified(tmp_path):
    for epoch in range(1, 6):
        _save(tmp_path, epoch)
    assert ckpt.gc_snapshots(str(tmp_path), 0) == []
    assert ckpt.gc_snapshots(str(tmp_path), 2, pin=(2,)) == [1, 3]
    assert sorted(os.listdir(tmp_path)) == [
        "2.ckpt", "4.ckpt", "5.ckpt", "MANIFEST.json", "latest.ckpt", "state.ckpt"]
    assert sorted(ckpt.load_manifest(str(tmp_path))["epochs"], key=int) == ["2", "4", "5"]
    # the newest verified snapshot survives even outside the window
    (tmp_path / "5.ckpt").write_bytes(b"rotten")
    _save(tmp_path, 6)
    (tmp_path / "6.ckpt").write_bytes(b"rotten too")
    assert 4 not in ckpt.gc_snapshots(str(tmp_path), 1)
    assert (tmp_path / "4.ckpt").exists() and ckpt.latest_verified_epoch(str(tmp_path)) == 4
