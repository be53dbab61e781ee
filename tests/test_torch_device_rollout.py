"""The port's on-device self-play (runtime/device_rollout.py) on the CPU
(``device="cpu"``), against its host envs and the JAX package.

* Every episode of the episodic and streaming rollouts replays legally
  through the port's host env, with equal observations and outcomes
  (``chip_smoke.replay_episode``, the gate phase 11 runs on the card), as
  the JAX package's tests/test_device_rollout.py replays the JAX ones.
* ``columns_to_episodes`` and ``_streaming_episode`` give the JAX ones'
  episodes on the same records, after decompression, exactly.
* The recorded probs and values are the JAX model's on the recorded
  observations, with the weights carried across by ``flax_to_state_dict``,
  within 1e-5 (rtol and atol), the tolerance the port's net tests hold
  these nets to (the DRC chained over every step of the episode).
* The learner runs with device rollouts: episodes feed the store and count
  towards the epochs; startup refuses what the JAX learner refuses; the
  watchdog restarts a rollout thread that died.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.envs.vector_geister import VectorGeister as JaxGeister
from handyrl_tpu.envs.vector_hungry_geese import VectorHungryGeese as JaxGeese
from handyrl_tpu.envs.vector_parallel_tictactoe import VectorParallelTicTacToe as JaxPTTT
from handyrl_tpu.envs.vector_tictactoe import VectorTicTacToe as JaxTTT
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.runtime import device_rollout as jax_rollout
from handyrl_tpu.runtime.replay import decompress_block as jax_decompress
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import GeeseNet, SimpleConvNet, flax_to_state_dict, init_variables
from handyrl_tpu_torch.runtime import decompress_block, device_rollout
from handyrl_tpu_torch.runtime.device_rollout import (
    DeviceRollout,
    StreamingDeviceRollout,
    build_selfplay_fn,
    columns_to_episodes,
    make_device_rollout,
)
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.utils import softmax, tree_concat

TOL = 1e-5
SIMULTANEOUS = {"turn_based_training": False, "observation": False}
ENVS = {  # env -> (train args, lanes, k_steps, calls)
    "HungryGeese": (SIMULTANEOUS, 12, 8, 5),
    "ParallelTicTacToe": (SIMULTANEOUS, 12, 3, 8),   # k_steps 3: games span calls
    "Geister": ({"observation": True}, 6, 32, 8),
}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _args(env_name, train_args=None):
    cfg = normalize_args({"env_args": {"env": env_name}, "train_args": dict(train_args or {})})
    return dict(cfg["train_args"], env=cfg["env_args"])


def _columns(episode, decompress=decompress_block):
    return tree_concat([decompress(b) for b in episode["blocks"]])


def _assert_same_episode(got, want):
    assert got["steps"] == want["steps"] and got["players"] == want["players"]
    assert got["outcome"] == want["outcome"]
    assert got["args"] == want["args"] and len(got["blocks"]) == len(want["blocks"])
    for a, b in zip(got["blocks"], want["blocks"]):
        a, b = decompress_block(a), jax_decompress(b)
        assert sorted(a) == sorted(b)
        for key in b:
            for x, y in zip(jax.tree.leaves(a[key]), jax.tree.leaves(b[key])):
                assert x.dtype == y.dtype, key
                np.testing.assert_array_equal(x, y, err_msg=key)


def _streaming_episodes(env_name, module=None, seed=0):
    train_args, lanes, k_steps, calls = ENVS[env_name]
    env = make_env({"env": env_name})
    module = module if module is not None else init_variables(env.net(), seed)
    roll = StreamingDeviceRollout(env.vector_env(), module, _args(env_name, train_args),
                                  n_lanes=lanes, k_steps=k_steps, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    episodes = []
    for _ in range(calls):
        episodes += roll.generate(None, gen)
    roll.drain()
    return roll, episodes


# -- legal replays -------------------------------------------------------------


def test_episodic_games_replay_legally_on_host():
    env = make_env({"env": "TicTacToe"})
    roll = DeviceRollout(env.vector_env(), init_variables(env.net(), 0), _args("TicTacToe"),
                         n_games=48, device="cpu")
    episodes = roll.generate(None, torch.Generator().manual_seed(0))
    assert len(episodes) == 48
    steps = [chip_smoke.replay_episode("TicTacToe", ep) for ep in episodes]
    assert sum(steps) == sum(ep["steps"] for ep in episodes) and min(steps) >= 5
    # a played move's prob is a probability; the schema is the Generator's
    cols = _columns(episodes[0])
    assert set(cols) == {"obs", "prob", "action", "amask", "value", "reward", "ret", "tmask",
                         "omask", "turn"}
    assert ((cols["prob"] > 0) & (cols["prob"] <= 1)).all()


@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_streaming_games_replay_legally_on_host(env_name):
    roll, episodes = _streaming_episodes(env_name)
    assert len(episodes) >= 6, len(episodes)
    for i, ep in enumerate(episodes[:40]):
        chip_smoke.replay_episode(env_name, ep, f"episode {i}")
    assert roll.game_steps > 0 and roll.player_steps >= roll.game_steps
    cols = _columns(episodes[0])
    if env_name == "Geister":
        # strict alternation, Black first; both players observe every step;
        # the placement plies offer the 70 layouts; -0.01 per step for both
        T = episodes[0]["steps"]
        assert (cols["tmask"].sum(axis=1) == 1).all() and (cols["omask"] == 1).all()
        assert (cols["tmask"][:, 0] == (np.arange(T) % 2 == 0)).all()
        assert (cols["amask"][0, 0] == 0).sum() == 70 and (cols["amask"][1, 1] == 0).sum() == 70
        np.testing.assert_allclose(cols["reward"], -0.01, atol=1e-7)
    else:
        np.testing.assert_array_equal(cols["omask"], cols["tmask"])   # observation: false


def test_observation_false_records_actors_only():
    """Geister with ``observation: false``: the non-acting player is not
    recorded (omask == tmask), as the host Generator records it."""
    env = make_env({"env": "Geister"})
    roll = StreamingDeviceRollout(env.vector_env(), init_variables(env.net(), 0),
                                  _args("Geister", {"observation": False}), n_lanes=6,
                                  k_steps=32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    episodes = []
    while not episodes:
        episodes += roll.generate(None, gen)
    cols = _columns(episodes[0])
    np.testing.assert_array_equal(cols["omask"], cols["tmask"])


# -- episode assembly against the JAX package ----------------------------------


def test_columns_to_episodes_matches_jax():
    env = make_env({"env": "TicTacToe"})
    args = _args("TicTacToe")
    fn = build_selfplay_fn(env.vector_env(), init_variables(env.net(), 1).eval(), 16, "cpu")
    with torch.inference_mode():
        cols = {k: v.numpy() for k, v in fn(torch.Generator().manual_seed(1)).items()}
    got = columns_to_episodes(cols, env.vector_env(), args)
    want = jax_rollout.columns_to_episodes(cols, JaxTTT, args)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        _assert_same_episode(a, b)


@pytest.mark.parametrize("env_name,jax_twin", [("HungryGeese", JaxGeese), ("Geister", JaxGeister),
                                               ("ParallelTicTacToe", JaxPTTT)])
def test_streaming_episode_matches_jax(monkeypatch, env_name, jax_twin):
    """Every episode the port assembles equals the JAX ``_streaming_episode``
    on the same spans of the same records."""
    pairs = []
    port_fn = device_rollout._streaming_episode

    def both(venv, steps, done_rec, done_k, lane, args):
        got = port_fn(venv, steps, done_rec, done_k, lane, args)
        pairs.append((got, jax_rollout._streaming_episode(jax_twin, list(steps), done_rec, done_k,
                                                          lane, args)))
        return got

    monkeypatch.setattr(device_rollout, "_streaming_episode", both)
    _, episodes = _streaming_episodes(env_name, seed=1)
    assert len(pairs) == len(episodes) >= 6
    for got, want in pairs:
        _assert_same_episode(got, want)


# -- the recorded probs and values against the JAX model -------------------------


def _jax_pair(env_name, seed=3):
    """The JAX net of the env at its defaults and the port's with its
    weights; zero-initialised output layers get small random weights, so the
    outputs depend on the tower."""
    jenv = jax_make_env({"env": env_name})
    jmodule = jenv.net()
    params = jax.tree.map(np.asarray, jax_init_variables(jmodule, jenv, seed=seed)["params"])
    rng = np.random.default_rng(seed)
    for name, layer in params.items():
        if isinstance(layer, dict) and "kernel" in layer and not np.any(layer["kernel"]):
            layer["kernel"] = (0.05 * rng.normal(size=layer["kernel"].shape)).astype(np.float32)
    module = make_env({"env": env_name}).net()
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodule, {"params": params}, module


def _check_acting(cols, t, p, policy, value):
    legal = cols["amask"][t, p]
    probs = softmax(np.asarray(policy, np.float32) - legal)
    np.testing.assert_allclose(cols["prob"][t, p], probs[int(cols["action"][t, p])], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cols["value"][t, p], np.asarray(value).reshape(-1)[0], rtol=TOL,
                               atol=TOL)


def test_recorded_probs_and_values_match_jax_tictactoe():
    jmodule, variables, module = _jax_pair("TicTacToe")
    assert isinstance(module, SimpleConvNet)
    env = make_env({"env": "TicTacToe"})
    roll = DeviceRollout(env.vector_env(), module, _args("TicTacToe"), n_games=8, device="cpu")
    apply = jax.jit(jmodule.apply)
    for ep in roll.generate(None, torch.Generator().manual_seed(2)):
        cols = _columns(ep)
        turn = cols["turn"]
        out = apply(variables, cols["obs"][np.arange(ep["steps"]), turn], None)
        for t in range(ep["steps"]):
            _check_acting(cols, t, int(turn[t]), out["policy"][t], out["value"][t])


def test_recorded_probs_and_values_match_jax_geese():
    jmodule, variables, module = _jax_pair("HungryGeese")
    assert isinstance(module, GeeseNet)
    _, episodes = _streaming_episodes("HungryGeese", module=module, seed=2)
    apply = jax.jit(jmodule.apply)
    checked = 0
    for ep in episodes[:10]:
        cols = _columns(ep)
        for p in range(4):
            out = apply(variables, cols["obs"][:, p], None)
            for t in np.flatnonzero(cols["tmask"][:, p]):
                _check_acting(cols, t, p, out["policy"][t], out["value"][t])
                checked += 1
    assert checked > 40


def test_recorded_probs_and_values_match_jax_drc():
    """The DRC's hidden state per player through a whole episode, zero at
    its start and advanced where the player observed, on the JAX net."""
    jmodule, variables, module = _jax_pair("Geister")
    _, episodes = _streaming_episodes("Geister", module=module, seed=2)
    apply = jax.jit(jmodule.apply)
    ep = min(episodes, key=lambda e: e["steps"])
    cols = _columns(ep)
    hidden = [jmodule.initial_state((1,)) for _ in range(2)]
    for t in range(ep["steps"]):
        for p in range(2):
            if cols["omask"][t, p] == 0:
                continue
            obs = {k: v[t, p][None] for k, v in cols["obs"].items()}
            out = apply(variables, obs, hidden[p])
            hidden[p] = out["hidden"]
            if cols["tmask"][t, p]:
                _check_acting(cols, t, p, out["policy"][0], out["value"][0])
            else:
                np.testing.assert_allclose(cols["value"][t, p], np.asarray(out["value"])[0, 0],
                                           rtol=TOL, atol=TOL)


# -- the rollout choice -----------------------------------------------------------


def test_make_device_rollout_picks_the_rollout(capsys):
    ttt, geister = make_env({"env": "TicTacToe"}), make_env({"env": "Geister"})
    roll = make_device_rollout(ttt.vector_env(), SimpleConvNet(), _args("TicTacToe"), 4, device="cpu")
    assert type(roll) is DeviceRollout and "memoryless" not in capsys.readouterr().err
    stream = make_device_rollout(geister.vector_env(), geister.net(), _args("Geister"), 4, device="cpu")
    assert type(stream) is StreamingDeviceRollout and stream.k_steps == 32
    # a stateful model on the episodic rollout plays without memory: said loudly
    roll = make_device_rollout(ttt.vector_env(), geister.net(), _args("TicTacToe"), 4, device="cpu")
    assert type(roll) is DeviceRollout and "memoryless" in capsys.readouterr().err
    # the rollout's module is its own copy, on its device
    module = SimpleConvNet()
    roll = DeviceRollout(ttt.vector_env(), module, _args("TicTacToe"), 4, device="cpu")
    assert roll.module is not module and not roll.module.training
    roll.load({k: torch.zeros_like(v) for k, v in module.state_dict().items()})
    assert not any(p.any() for p in roll.module.parameters()) and any(p.any() for p in module.parameters())


def test_a_block_that_raises_leaves_the_lanes_as_they_were(monkeypatch):
    env = make_env({"env": "ParallelTicTacToe"})
    roll = StreamingDeviceRollout(env.vector_env(), init_variables(env.net(), 0),
                                  _args("ParallelTicTacToe", SIMULTANEOUS), n_lanes=4, k_steps=2,
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    roll.generate(None, gen)
    state = {k: v.clone() for k, v in roll._state.items()}
    monkeypatch.setattr(env.vector_env(), "step", staticmethod(lambda *a: 1 / 0))
    with pytest.raises(ZeroDivisionError):
        roll.generate(None, gen)
    assert all(torch.equal(state[k], v) for k, v in roll._state.items())


# -- the learner -------------------------------------------------------------------


def _learner_config(tmp_path, env_name, train_args):
    return normalize_args({"env_args": {"env": env_name}, "train_args": dict(
        {"batch_size": 8, "forward_steps": 4, "minimum_episodes": 40, "update_episodes": 40,
         "maximum_episodes": 400, "epochs": 2, "num_batchers": 1, "eval_rate": 0.2,
         "worker": {"num_parallel": 1}, "model_dir": str(tmp_path / "models"),
         "metrics_path": str(tmp_path / "metrics.jsonl")}, **train_args)})


def _records(tmp_path):
    return [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]


def test_learner_with_device_rollouts(tmp_path):
    """Episodic TicTacToe self-play on the device feeds the store and the
    epoch cadence; host workers keep evaluating."""
    learner = Learner(_learner_config(tmp_path, "TicTacToe", {"device_rollout_games": 32}),
                      device="cpu")
    assert type(learner._device_roll) is DeviceRollout
    assert learner._device_roll.module is not learner.module
    learner.run()
    records = _records(tmp_path)
    assert len(records) == 2 and (tmp_path / "models" / "2.ckpt").exists()
    assert learner.num_returned_episodes >= 80
    device = [r for r in records if "device_mean_episode_len" in r]
    assert device and all(5 <= r["device_mean_episode_len"] <= 9 for r in device)
    assert all(r["plane"] == "fused" and r["plane_watchdog_stalls"] == 0 for r in records)
    assert not learner._rollout_thread.is_alive()
    # the device episodes carry the epoch of the params they were played with
    ids = {ep["args"]["model_id"][0] for ep in learner.trainer.store._episodes}
    assert ids <= {0, 1, 2}


def test_remote_learner_with_device_rollouts(tmp_path):
    """``Learner(remote=True)`` (the train server) reaches its epochs on
    device episodes alone, with no worker machine connected."""
    cfg = _learner_config(tmp_path, "HungryGeese", dict(
        SIMULTANEOUS, device_rollout_games=16, worker={"num_parallel": 1, "entry_port": 0,
                                                        "data_port": 0}))
    learner = Learner(cfg, net=GeeseNet(filters=8, blocks=2), device="cpu", remote=True)
    thread = threading.Thread(target=learner.run, daemon=True)
    thread.start()
    thread.join(60.0)
    assert not thread.is_alive(), "the train server did not finish"
    records = _records(tmp_path)
    assert len(records) == 2 and sum(r.get("device_episodes", 0) for r in records) >= 40


# the injected fault kills the first rollout thread, as it is meant to
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_a_rollout_thread_whose_generate_raises_once(tmp_path, monkeypatch):
    calls = []
    generate = StreamingDeviceRollout.generate

    def flaky(self, params, gen):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            raise RuntimeError("injected rollout fault")
        return generate(self, params, gen)

    monkeypatch.setattr(StreamingDeviceRollout, "generate", flaky)
    cfg = _learner_config(tmp_path, "ParallelTicTacToe", dict(SIMULTANEOUS, device_rollout_games=16))
    learner = Learner(cfg, device="cpu")
    learner.run()
    records = _records(tmp_path)
    assert records[-1]["plane_watchdog_stalls"] == records[-1]["plane_watchdog_restarts"] == 1
    assert calls[0] == "device-rollout-1" and calls[-1] == "device-rollout-2"
    assert sum(r.get("device_episodes", 0) for r in records) > 0


# the injected fault kills every rollout thread, as it is meant to
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_that_gives_up_says_so_in_the_records(tmp_path, monkeypatch):
    """Past its restart budget the watchdog leaves generation to the host
    actors, and every later epoch record says ``plane: "none"``."""
    def broken(self, params, gen):
        raise RuntimeError("injected rollout fault")

    monkeypatch.setattr(StreamingDeviceRollout, "generate", broken)
    cfg = _learner_config(tmp_path, "ParallelTicTacToe", dict(
        SIMULTANEOUS, device_rollout_games=16, plane_max_restarts=0, plane_stall_timeout=0.2))
    learner = Learner(cfg, device="cpu")
    learner.run()
    records = _records(tmp_path)
    assert len(records) == 2 and not any(r.get("device_episodes") for r in records)
    assert records[-1]["plane"] == "none"
    assert records[-1]["plane_watchdog_stalls"] == 1 and records[-1]["plane_watchdog_restarts"] == 0


@pytest.mark.parametrize("env_name,train_args,match", [
    ("HungryGeese", dict(SIMULTANEOUS, observation=True), "observer views"),
    # ConnectFour's twin is the autovec lift: episodic, no streaming hooks
    ("ConnectFour", {"device_replay": True}, "streaming hooks"),
])
def test_learner_refuses_at_startup(tmp_path, env_name, train_args, match):
    cfg = _learner_config(tmp_path, env_name, dict(train_args, device_rollout_games=16))
    with pytest.raises(ValueError, match=match):
        Learner(cfg, device="cpu")
    assert not (tmp_path / "models").exists()
