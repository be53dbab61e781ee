"""The port's ConnectFour (handyrl_tpu_torch/envs/connect_four.py) against the
JAX package's (``examples/connect_four.py``, ``env: ConnectFour``), on the CPU.

* Seeded random games in lock step: turns, legal actions, every player's
  observation, action strings, replica deltas, rule-based moves and
  outcomes, compared exactly.
* Its net, ``SimpleConvNet(filters=48, blocks=4, num_actions=7)``, with the
  JAX package's weights carried over by ``convert.py``: forward within
  1e-5 (fp32, another summation order and GroupNorm variance formula).
* It trains one tiny epoch through the port's learner.
"""

import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import SimpleConvNet, flax_to_state_dict
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.learner import Learner

C4 = {"env": "ConnectFour"}


@pytest.mark.parametrize("seed", range(4))
def test_connect_four_matches_jax_env(seed):
    rng = random.Random(seed)
    env, jenv = make_env(C4), jax_make_env(C4)
    replica = make_env(C4)
    for _ in range(8):
        env.reset(), jenv.reset()
        replica.update(env.diff_info(0), True)
        while not jenv.terminal():
            assert not env.terminal()
            assert env.turn() == jenv.turn() and env.turns() == jenv.turns()
            assert env.legal_actions() == jenv.legal_actions()
            for p in (0, 1, None):
                np.testing.assert_array_equal(env.observation(p), jenv.observation(p))
            state = random.getstate()
            ours = env.rule_based_action()
            random.setstate(state)
            assert ours == jenv.rule_based_action()
            action = rng.choice(env.legal_actions())
            assert env.action2str(action) == jenv.action2str(action)
            assert env.str2action(env.action2str(action)) == action
            env.play(action), jenv.play(action)
            replica.update(env.diff_info(0), False)
            assert env.diff_info(1) == jenv.diff_info(1)
        assert env.terminal() and env.outcome() == jenv.outcome()
        assert replica.terminal() and replica.outcome() == env.outcome()
        np.testing.assert_array_equal(replica.board, env.board)
        assert str(env) == str(jenv)


def test_connect_four_net_matches_jax():
    jenv = jax_make_env(C4)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=3)
    module = make_env(C4).net()
    assert isinstance(module, SimpleConvNet) and module.blocks == 4
    assert module.Conv_0.out_channels == 48
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    assert sum(x.size for x in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in module.parameters())
    rng = np.random.default_rng(0)
    # stone planes, and dense inputs that make GroupNorm's statistics matter
    obs = np.concatenate([(rng.random((6, 3, 6, 7)) < 0.4).astype(np.float32),
                          rng.normal(size=(6, 3, 6, 7)).astype(np.float32)])
    want = jmodule.apply(variables, obs, None)
    with torch.no_grad():
        got = module(torch.from_numpy(obs), None)
    assert sorted(got) == sorted(want) == ["policy", "value"]
    assert got["policy"].shape == (12, 7)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_connect_four_trains_through_the_learner(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = normalize_args({"env_args": C4, "train_args": {
            "batch_size": 8, "forward_steps": 8, "minimum_episodes": 6, "update_episodes": 6,
            "epochs": 1, "num_batchers": 1, "worker": {"num_parallel": 2}}})
        learner = Learner(args, device="cpu")
        assert learner.run() == 0
    finally:
        torch.set_num_threads(threads)
    assert ckpt.verify_snapshot("models", 1)
    assert learner.num_returned_episodes >= 12
