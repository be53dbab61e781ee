"""The simultaneous-move path of the port against the JAX package on the
CPU: HungryGeese and ParallelTicTacToe in lock step, ``GeeseNet``, episodes
and the non-turn-based ``make_batch``, the feed-forward loss on a geese
batch, the scripted agent, and Learner epochs and the CLI on both games.

Both packages' envs draw from Python's ``random``: each lock step runs the
JAX env and then the port's from the same ``random`` state.  Tolerances:
envs, episodes and batches exactly equal (numpy and Python on both sides);
``GeeseNet`` 1e-5 (fp32); the forward prediction and the loss 1e-4 (sums
over a batch).
"""

import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.agents import Agent, RuleBasedAgent
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.main import main
from handyrl_tpu_torch.models import (
    GeeseNet, InferenceModel, RandomModel, SimpleConvNet, flax_to_state_dict, init_variables,
)
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import Generator, evaluate_mp, exec_match, make_batch
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.learner import Learner

GEESE = {"env": "HungryGeese"}
PTTT = {"env": "ParallelTicTacToe"}
SIMULTANEOUS = {"turn_based_training": False, "observation": False}


def _twin(fn_jax, fn_port):
    """Run ``fn_jax`` and then ``fn_port`` from the same ``random`` state;
    both must leave it in the same state."""
    state = random.getstate()
    a = fn_jax()
    after = random.getstate()
    random.setstate(state)
    b = fn_port()
    assert random.getstate() == after
    return a, b


@pytest.fixture(autouse=True)
def _few_threads():
    # actor, batcher and trainer threads share the box with other tests
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", range(3))
def test_hungry_geese_matches_jax_env(seed):
    """Seeded games in lock step: turns, legal actions, every player's
    observation, rule-based choices, rewards, replica deltas, strings and
    outcomes.  Actions mix the rule-based policy and uniform moves, so geese
    reverse, collide and starve."""
    random.seed(seed)
    rng = np.random.default_rng(seed)
    jenv, env = _twin(lambda: jax_make_env(GEESE), lambda: make_env(GEESE))
    for _ in range(4):
        _twin(jenv.reset, env.reset)
        while not jenv.terminal():
            assert not env.terminal()
            assert env.turns() == jenv.turns() and env.players() == jenv.players()
            for p in env.players():
                assert env.legal_actions(p) == jenv.legal_actions(p)
                np.testing.assert_array_equal(env.observation(p), jenv.observation(p))
            np.testing.assert_array_equal(env.observation(None), jenv.observation(None))
            actions = {}
            for p in jenv.turns():
                ja, pa = _twin(lambda: jenv.rule_based_action(p), lambda: env.rule_based_action(p))
                assert ja == pa
                actions[p] = ja if rng.random() < 0.7 else int(rng.integers(4))
            _twin(lambda: jenv.step(actions), lambda: env.step(actions))
            assert env.reward() == jenv.reward()
            assert env.diff_info() == jenv.diff_info() and str(env) == str(jenv)
            replica = make_env(GEESE)
            replica.update(jenv.diff_info(), False)
            for p in env.players():
                np.testing.assert_array_equal(replica.observation(p), jenv.observation(p))
        assert env.terminal() and env.outcome() == jenv.outcome()
        assert env.action2str(2) == jenv.action2str(2) and env.str2action("EAST") == 3


@pytest.mark.parametrize("seed", range(3))
def test_parallel_tictactoe_matches_jax_env(seed):
    random.seed(seed)
    rng = np.random.default_rng(seed)
    jenv, env = jax_make_env(PTTT), make_env(PTTT)
    for _ in range(6):
        env.reset(), jenv.reset()
        replica = make_env(PTTT)
        while not jenv.terminal():
            assert not env.terminal() and env.turns() == jenv.turns() == [0, 1]
            for p in (0, 1, None):
                assert env.legal_actions(p) == jenv.legal_actions(p)
                np.testing.assert_array_equal(env.observation(p), jenv.observation(p))
            legal = jenv.legal_actions()
            actions = {p: int(rng.choice(legal)) for p in jenv.turns()}
            _twin(lambda: jenv.step(actions), lambda: env.step(actions))
            assert env.diff_info() == jenv.diff_info() and str(env) == str(jenv)
            replica.update(jenv.diff_info(), False)
            np.testing.assert_array_equal(replica.cells, env.cells)
        assert env.terminal() and env.outcome() == jenv.outcome()
        with pytest.raises(NotImplementedError):
            env.turn()


def test_registry_builds_every_env_with_its_net():
    nets = {"TicTacToe": SimpleConvNet, "ParallelTicTacToe": SimpleConvNet,
            "HungryGeese": GeeseNet}
    for name, cls in nets.items():
        assert type(make_env({"env": name}).net()) is cls, name
    assert make_env(GEESE).players() == [0, 1, 2, 3] and make_env(GEESE).action_size() == 4


@pytest.fixture(scope="module")
def geese_nets():
    """The JAX GeeseNet at its defaults and the port's with its weights; the
    zero-initialised heads are given small random weights, so the outputs
    depend on the tower."""
    jenv = jax_make_env(GEESE)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=3)
    rng = np.random.default_rng(4)
    params = jax.tree.map(np.asarray, variables["params"])
    for name in ("Dense_0", "Dense_1"):
        kernel = params[name]["kernel"]
        params[name] = {"kernel": (0.002 * rng.normal(size=kernel.shape)).astype(np.float32)}
    module = make_env(GEESE).net()
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodule, {"params": params}, module


def test_geese_net_matches_jax(geese_nets):
    jmodule, variables, module = geese_nets
    assert sum(x.size for x in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in module.parameters())
    rng = np.random.default_rng(5)
    # sparse planes with mass on the borders, where a wrong wrap shows, and a
    # ramp along each axis, where a wrong flatten or transpose shows
    obs = (rng.random((6, 17, 7, 11)) < 0.15).astype(np.float32)
    obs[:, :, 0, :] += 1.0
    obs[:, :, :, -1] += 0.5
    obs += np.linspace(0, 0.3, 11, dtype=np.float32) * np.linspace(0.5, 1, 7, dtype=np.float32)[:, None]
    want = jmodule.apply(variables, obs, None)
    with torch.no_grad():
        got = module(torch.from_numpy(obs), None)
    assert sorted(got) == sorted(want) == ["policy", "value"]
    assert np.abs(np.asarray(want["value"])).max() < 0.99  # not saturated
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_geese_net_starts_uniform():
    """Zero heads: a uniform policy and a zero value at step 0, whether the
    net is fresh or initialised by ``init_variables``."""
    obs = torch.from_numpy(make_env(GEESE).observation(0))[None].repeat(3, 1, 1, 1)
    for module in (GeeseNet(), init_variables(GeeseNet(), seed=7)):
        assert module.Dense_0.zero_init and module.Dense_1.zero_init
        with torch.no_grad():
            out = module(obs)
        assert torch.equal(out["policy"], torch.zeros(3, 4))
        assert torch.equal(out["value"], torch.zeros(3, 1))
    tower = init_variables(GeeseNet(), seed=7).ConvBlock_1.Conv_0.weight
    assert tower.abs().sum() > 0


def _geese_args(**extra):
    cfg = normalize_args({"env_args": GEESE, "train_args": dict(
        SIMULTANEOUS, batch_size=6, forward_steps=8, **extra)})
    return dict(cfg["train_args"], env=cfg["env_args"])


GEESE_SPEC = {"policy": ((4,), np.float32), "value": ((1,), np.float32)}


def test_geese_episodes_are_byte_equal():
    """Simultaneous-move self-play from one seed: the same episodes."""
    args = _geese_args()

    def episodes(env_fn, gen_cls, model_cls):
        gen = gen_cls(env_fn(GEESE), args)
        model = model_cls(GEESE_SPEC)
        random.seed(21)
        return [gen.generate({p: model for p in range(4)}, {"player": [0, 1, 2, 3]})
                for _ in range(3)]

    want = episodes(jax_make_env, JaxGenerator, JaxRandomModel)
    got = episodes(make_env, Generator, RandomModel)
    for g, w in zip(got, want):
        assert g["steps"] == w["steps"] and g["outcome"] == w["outcome"]
        assert g["blocks"] == w["blocks"]


@pytest.fixture(scope="module")
def geese_batch():
    args = _geese_args()
    gen = JaxGenerator(jax_make_env(GEESE), args)
    model = JaxRandomModel(GEESE_SPEC)
    random.seed(8)
    store = JaxEpisodeStore(32)
    store.extend([gen.generate({p: model for p in range(4)}, {"player": [0, 1, 2, 3]})
                  for _ in range(10)])
    windows = [store.sample_window(8, 0, 4) for _ in range(6)]
    state = random.getstate()
    batch = jax_make_batch(windows, args)
    return args, windows, state, batch


def test_non_turn_based_make_batch_matches_jax(geese_batch):
    """One sampled target player per window, drawn from ``random`` in the
    same order: the same batch, key for key."""
    args, windows, state, want = geese_batch
    random.setstate(state)
    got = make_batch(windows, args)
    assert sorted(got) == sorted(want)
    assert got["observation"].shape == (6, 8, 1, 17, 7, 11) and got["outcome"].shape == (6, 1, 1, 1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_geese_prediction_and_loss_match_jax(geese_nets, geese_batch):
    jmodule, variables, module = geese_nets
    args, _, _, batch = geese_batch
    joutputs = jax_forward(jmodule, variables["params"], batch, args)
    jlosses, jdcnt = jax_loss(joutputs, batch, args)
    ctx = TrainContext(module, args, device="cpu")
    losses, dcnt = ctx.loss(ctx.put_batch(batch))
    assert dcnt.item() == float(jdcnt)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_rule_based_agent_plays_the_env_rule():
    env = make_env(GEESE)
    random.seed(2)
    env.reset()
    agent = RuleBasedAgent(seed=0)
    for _ in range(5):
        if env.terminal():
            break
        for p in env.turns():
            state = random.getstate()
            want = env.rule_based_action(p)
            random.setstate(state)
            assert agent.action(env, p) == want
        env.step({p: env.rule_based_action(p) for p in env.turns()})


def test_four_player_match_and_evaluation(capsys):
    """Every seat of a 4-player game gets an agent; ``evaluate_mp`` plays
    the one seat pattern and scores seat 0."""
    model = InferenceModel(init_variables(GeeseNet(filters=8, blocks=2), 0), device="cpu")
    env = make_env(GEESE)
    agents = {0: Agent(model), 1: RuleBasedAgent(), 2: RuleBasedAgent(), 3: RuleBasedAgent()}
    random.seed(4)
    outcome = exec_match(env, agents)
    assert sorted(outcome) == [0, 1, 2, 3] and abs(sum(outcome.values())) < 1e-9
    results = evaluate_mp(GEESE, agents, 6, num_workers=2)
    assert list(results) == ["[0, 1, 2, 3]"] and sum(results["[0, 1, 2, 3]"].values()) == 6
    assert "total =" in capsys.readouterr().out


def _loop_args(env_args, **train):
    return normalize_args({"env_args": env_args, "train_args": dict(
        batch_size=4, forward_steps=4, minimum_episodes=4, update_episodes=4, epochs=1,
        num_batchers=1, worker={"num_parallel": 2}, **train)})


@pytest.mark.parametrize("env_args,net", [
    (GEESE, lambda: GeeseNet(filters=8, blocks=2)),
    (PTTT, lambda: SimpleConvNet(filters=8, blocks=1)),
])
def test_simultaneous_learner_trains_one_epoch(tmp_path, monkeypatch, env_args, net):
    monkeypatch.chdir(tmp_path)
    learner = Learner(_loop_args(env_args, **SIMULTANEOUS), net=net(), device="cpu")
    assert learner.run() == 0
    assert learner.trainer.steps > 0 and learner.trainer.sentinel_skipped_steps == 0
    assert np.isfinite(learner.trainer.last_loss["total"])
    assert ckpt.verify_snapshot("models", 1)


GEESE_CONFIG = """\
env_args:
  env: 'HungryGeese'
train_args:
  turn_based_training: false
  observation: false
  batch_size: 4
  forward_steps: 4
  minimum_episodes: 4
  update_episodes: 4
  epochs: 1
  num_batchers: 1
  worker:
    num_parallel: 2
  eval:
    opponent: ['rulebase']
"""


def test_cli_trains_and_evaluates_hungry_geese(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(GEESE_CONFIG)
    assert main(["--train"], device="cpu") == 0
    assert ckpt.verify_snapshot("models", 1)
    capsys.readouterr()
    assert main(["--eval", "models/latest.ckpt:rulebase", "4", "2"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[0, 1, 2, 3] = " in out and "total =" in out
