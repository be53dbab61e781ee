"""The port's on-device evaluation (runtime/device_eval.py) on the CPU
(``device="cpu"``), as the JAX package's tests/test_device_eval.py holds the
JAX one.

* The rule-based twin picks the host greedy agent's move wherever the host
  agent is deterministic (not boxed in).
* The evaluator counts exact outcomes over at least ``num_games`` finished
  matches, on the rank ladder, with the net's seat round-robin; the DRC
  Geister net plays it too, its hidden state advancing for both seats.
* Against the JAX evaluator on the same weights and the same random draws
  of the rule-based twin, the outcome counts are equal.
* A learner with ``device_eval_games`` files the results as opponent
  ``device-<name>``; it refuses an episodic twin at startup and downgrades
  an opponent the twin cannot play to ``random``, loudly.
"""

import json

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs.vector_hungry_geese import VectorHungryGeese as JaxGeese
from handyrl_tpu.runtime.device_eval import DeviceEvaluator as JaxDeviceEvaluator
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.envs import vector_hungry_geese as geese_mod
from handyrl_tpu_torch.envs.hungry_geese import _OPPOSITE, _translate
from handyrl_tpu_torch.envs.vector_geister import VectorGeister
from handyrl_tpu_torch.envs.vector_hungry_geese import MAXLEN, VectorHungryGeese
from handyrl_tpu_torch.envs.vector_tictactoe import VectorTicTacToe
from handyrl_tpu_torch.models import GeeseNet, flax_to_state_dict, init_variables
from handyrl_tpu_torch.runtime import device_eval
from handyrl_tpu_torch.runtime.device_eval import DeviceEvaluator, build_eval_stream_fn
from handyrl_tpu_torch.runtime.learner import Learner


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _host_view(state, lane):
    """The host env's fields (geese bodies, food, last actions) of one lane
    of the twin's state."""
    cells, head_ptr = state["cells"][lane].numpy(), state["head_ptr"][lane].numpy()
    length, last = state["length"][lane].numpy(), state["last_action"][lane].numpy()
    geese = [[int(cells[p][(head_ptr[p] + i) % MAXLEN]) for i in range(length[p])]
             for p in range(4)]
    food = [int(c) for c in np.flatnonzero(state["food"][lane].numpy())]
    return geese, food, {p: int(last[p]) for p in range(4) if last[p] >= 0}


def test_rulebase_device_twin_matches_host():
    gen = torch.Generator().manual_seed(0)
    state = VectorHungryGeese.init(16, gen)
    env = make_env({"env": "HungryGeese"})
    checked = 0
    for it in range(12):
        dev = VectorHungryGeese.rule_based_action_all(state, gen).numpy()
        active = state["active"].numpy()
        for lane in range(16):
            env.geese, env.food, env.last_actions = _host_view(state, lane)
            blocked = {c for g in env.geese for c in g}
            for p in range(4):
                if not active[lane, p] or not env.geese[p]:
                    continue
                last = env.last_actions.get(p)
                valid = [d for d in range(4) if (last is None or d != _OPPOSITE[last])
                         and _translate(env.geese[p][0], d) not in blocked]
                if not valid:
                    continue  # the host's random boxed-in branch
                assert dev[lane, p] == env.rule_based_action(p), (it, lane, p)
                checked += 1
        actions = torch.randint(0, 4, (16, 4), generator=gen)
        state = VectorHungryGeese.step(VectorHungryGeese.reset_done(state, gen), actions, gen)
    assert checked > 200, checked


def test_device_evaluator_counts_and_balance():
    module = init_variables(GeeseNet(filters=8, blocks=2), 0)
    ev = DeviceEvaluator(VectorHungryGeese, module, n_lanes=16, opponent="rulebase", device="cpu")
    counts = ev.evaluate(None, 40, 1)
    assert sum(counts.values()) >= 40
    assert all(-1.0 <= o <= 1.0 and abs(3 * o - round(3 * o)) < 1e-6 for o in counts)  # the ladder
    assert sorted(set(ev._net_seat.tolist())) == [0, 1, 2, 3]
    assert ev._net_seat.device.type == "cpu" and ev.module is not module


def test_device_evaluator_geister_recurrent():
    env = make_env({"env": "Geister"})
    ev = DeviceEvaluator(VectorGeister, init_variables(env.net(), 0), n_lanes=8, opponent="random",
                         k_steps=64, device="cpu")
    counts = ev.evaluate(None, 8, torch.Generator().manual_seed(2), max_calls=8)
    assert sum(counts.values()) >= 8
    assert set(counts) <= {-1.0, 0.0, 1.0}, counts


def test_device_evaluator_counts_match_jax(monkeypatch):
    """The same GeeseNet weights, the rule-based twin's draws of the JAX
    evaluator's keys, and the lane resets' uniforms: equal outcome counts
    (a greedy net is deterministic, and so are the twins given the draws)."""
    from handyrl_tpu.envs import make_env as jax_make_env
    from handyrl_tpu.models import init_variables as jax_init_variables

    jenv = jax_make_env({"env": "HungryGeese"})
    jmodule = jenv.net()
    params = jax.tree.map(np.asarray, jax_init_variables(jmodule, jenv, seed=5)["params"])
    rng = np.random.default_rng(5)
    for name in ("Dense_0", "Dense_1"):
        params[name] = {"kernel": (0.05 * rng.normal(size=params[name]["kernel"].shape)).astype(np.float32)}
    module = GeeseNet()
    module.load_state_dict(flax_to_state_dict(params))
    lanes, k_steps, games = 8, 16, 12

    # the JAX evaluator's key schedule, replayed to produce its draws
    key = jax.random.PRNGKey(7)
    key, k0 = jax.random.split(key)
    uniforms = [jax.random.uniform(k0, (lanes, 77))]
    gumbels = []
    for _ in range(8):
        key, sub = jax.random.split(key)
        for key_t in jax.random.split(sub, k_steps):
            kr, ka, kf = jax.random.split(key_t, 3)
            uniforms.append(jax.random.uniform(kr, (lanes, 77)))
            gumbels.append(jax.random.gumbel(ka, (lanes, 4, 4)))
            k1, k2 = jax.random.split(kf)
            gumbels += [jax.random.gumbel(k1, (lanes, 77)), jax.random.gumbel(k2, (lanes, 77))]
    queues = {"_uniform": [np.asarray(u) for u in uniforms], "_gumbel": [np.asarray(g) for g in gumbels]}

    def draw(name):
        def fn(gen, shape, device):
            out = queues[name].pop(0)
            assert out.shape == tuple(shape)
            return torch.from_numpy(out.copy())
        return fn

    monkeypatch.setattr(geese_mod, "_uniform", draw("_uniform"))
    monkeypatch.setattr(geese_mod, "_gumbel", draw("_gumbel"))
    want = JaxDeviceEvaluator(JaxGeese, jmodule, lanes, "rulebase", k_steps).evaluate(
        params, games, jax.random.PRNGKey(7), max_calls=8)
    got = DeviceEvaluator(VectorHungryGeese, module, lanes, "rulebase", k_steps, device="cpu").evaluate(
        None, games, torch.Generator().manual_seed(0), max_calls=8)
    assert sum(got.values()) >= games
    assert {round(k, 6): v for k, v in got.items()} == {round(k, 6): v for k, v in want.items()}


def test_eval_stream_rejects_unknown_opponents_and_episodic_twins():
    with pytest.raises(ValueError, match="rulebase|random"):
        build_eval_stream_fn(VectorHungryGeese, GeeseNet(filters=8, blocks=1), 8, 8, opponent="self")
    with pytest.raises(ValueError, match="rule_based_action_all"):
        build_eval_stream_fn(VectorGeister, GeeseNet(filters=8, blocks=1), 8, 8, opponent="rulebase")
    with pytest.raises(ValueError, match="episodic"):
        DeviceEvaluator(VectorTicTacToe, GeeseNet(filters=8, blocks=1), 8, device="cpu")
    assert device_eval.ILLEGAL == 1e32


def _config(tmp_path, env_name, train_args):
    return normalize_args({"env_args": {"env": env_name}, "train_args": dict(
        {"batch_size": 8, "forward_steps": 4, "minimum_episodes": 40, "update_episodes": 40,
         "maximum_episodes": 400, "epochs": 2, "num_batchers": 1,
         "worker": {"num_parallel": 1}, "model_dir": str(tmp_path / "models"),
         "metrics_path": str(tmp_path / "metrics.jsonl")}, **train_args)})


def test_learner_files_device_eval_results(tmp_path):
    """HungryGeese with device rollouts and device evaluation vs rulebase:
    every epoch has a win rate, the device results are filed as opponent
    'device-rulebase', and the records carry device_mean_episode_len."""
    cfg = _config(tmp_path, "HungryGeese", {
        "turn_based_training": False, "observation": False, "device_rollout_games": 16,
        "device_eval_games": 8, "eval": {"opponent": ["rulebase"]}})
    learner = Learner(cfg, net=GeeseNet(filters=8, blocks=2), device="cpu")
    assert learner._device_eval.opponent == "rulebase" and learner._device_eval.n_lanes == 8
    learner.run()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(records) == 2 and all("device-rulebase" in r["win_rate"] for r in records)
    for epoch in (0, 1):
        n = learner.results_per_opponent[epoch]["device-rulebase"][0]
        assert n >= 8
    assert any(r.get("device_mean_episode_len", 0) > 1 for r in records)


def test_learner_device_eval_refuses_episodic_twin(tmp_path):
    cfg = _config(tmp_path, "TicTacToe", {"device_rollout_games": 8, "device_eval_games": 8})
    with pytest.raises(ValueError, match="episodic"):
        Learner(cfg, device="cpu")


def test_learner_device_eval_downgrades_to_random_loudly(tmp_path, capsys):
    cfg = _config(tmp_path, "ParallelTicTacToe", {
        "turn_based_training": False, "observation": False, "device_eval_games": 4,
        "eval": {"opponent": ["rulebase"]}})
    learner = Learner(cfg, device="cpu")
    learner.model_server.stop()
    assert learner._device_eval.opponent == "random"
    assert "evaluating vs 'random' instead" in capsys.readouterr().out
