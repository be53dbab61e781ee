"""The port's twin compiler (``handyrl_tpu_torch/envs/autovec.py``) on the
CPU, one counterpart for each test of ``tests/test_autovec.py``.

Parity, bit for bit (no tolerance: int8 boards, bool masks and exact 0/1
float planes):

1. the port's pure-numpy ``ConnectFourRules`` replay random games in lock
   step with the port's host ``Environment``;
2. ``verify()`` (the ``autovec_verify_games`` self-check) passes for the
   bundled rules;
3. the lifted TicTacToe equals the hand twin ``VectorTicTacToe``, and the
   port's lifts equal the JAX package's lifts of its own rules, and of the
   unchanged ``examples/connect_four.py`` rules, on the same actions.

Every liftability break fails at ``autovectorize`` time as an
``AutovecError`` naming the function, the in-place write included (torch
itself would let it through ``vmap``).  The episodic ``DeviceRollout``
plays the lifted ConnectFour, and the learner's ``autovec_verify_games``
passes on the lift and refuses a broken one.
"""

import json

import numpy as np
import pytest
import torch

from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.envs.autovec import AutovecError, autovectorize
from handyrl_tpu_torch.envs.connect_four import ConnectFourRules, Environment
from handyrl_tpu_torch.envs.tictactoe import TicTacToeRules
from handyrl_tpu_torch.envs.vector_tictactoe import VectorTicTacToe


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _random_actions(legal, rng):
    return np.asarray([rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in legal])


# -- parity ------------------------------------------------------------------------


def test_connect_four_rules_match_scalar_env():
    """The numpy rules are the host env's rules: random games stepped
    through both in lock step."""
    R = ConnectFourRules
    rng = np.random.default_rng(3)
    for _ in range(25):
        env = Environment()
        state = R.init()
        for step in range(R.max_steps):
            assert bool(R.terminal(state, step)) == env.terminal()
            if env.terminal():
                break
            legal = np.flatnonzero(np.asarray(R.legal_mask(state)))
            assert legal.tolist() == env.legal_actions()
            np.testing.assert_array_equal(R.observation(state, step), env.observation(env.turn()))
            a = int(rng.choice(legal))
            state = R.apply(state, a, step)
            env.play(a)
        out = np.asarray(R.outcome(state))
        host = env.outcome()
        assert float(out[0]) == host[0] and float(out[1]) == host[1]


def test_verify_passes_for_bundled_rules():
    autovectorize(TicTacToeRules).verify(16, seed=0, device="cpu")
    autovectorize(ConnectFourRules).verify(16, seed=1, device="cpu")


def test_lift_bit_identical_to_hand_twin():
    V = autovectorize(TicTacToeRules)
    assert (V.num_actions, V.max_steps, V.num_players) == (9, 9, 2)
    rng = np.random.default_rng(0)
    s_a, s_h = V.init(16), VectorTicTacToe.init(16)
    for t in range(V.max_steps):
        assert torch.equal(V.terminal(s_a, t), VectorTicTacToe.terminal(s_h, t))
        la = V.legal_mask(s_a)
        assert torch.equal(la, VectorTicTacToe.legal_mask(s_h))
        obs = V.observation(s_a, t)
        assert obs.dtype == torch.float32
        assert torch.equal(obs, VectorTicTacToe.observation(s_h, t))
        acts = torch.as_tensor(_random_actions(la.numpy(), rng))
        s_a, s_h = V.apply(s_a, acts, t), VectorTicTacToe.apply(s_h, acts, t)
        for k in s_h:
            assert s_a[k].dtype == s_h[k].dtype and torch.equal(s_a[k], s_h[k]), k
    assert torch.equal(V.outcome(s_a), VectorTicTacToe.outcome(s_h))


def _jax_lift_equal(port_rules, jax_rules, n_games, seed):
    """The port's lift of ``port_rules`` against the JAX package's lift of
    ``jax_rules`` on the same random legal actions, every observable bit
    for bit at every step."""
    import jax.numpy as jnp

    from handyrl_tpu.envs.autovec import autovectorize as jax_autovectorize

    P, J = autovectorize(port_rules), jax_autovectorize(jax_rules)
    rng = np.random.default_rng(seed)
    s_p, s_j = P.init(n_games), J.init(n_games)
    for t in range(P.max_steps):
        term = P.terminal(s_p, t).numpy()
        np.testing.assert_array_equal(term, np.asarray(J.terminal(s_j, t)))
        legal = P.legal_mask(s_p).numpy()
        np.testing.assert_array_equal(legal, np.asarray(J.legal_mask(s_j)))
        np.testing.assert_array_equal(P.observation(s_p, t).numpy(),
                                      np.asarray(J.observation(s_j, t)))
        if term.all():
            break
        acts = _random_actions(legal, rng)
        s_p = P.apply(s_p, torch.as_tensor(acts), t)
        s_j = J.apply(s_j, jnp.asarray(acts, jnp.int32), t)
        for k in s_p:
            np.testing.assert_array_equal(s_p[k].numpy(), np.asarray(s_j[k]), err_msg=k)
    np.testing.assert_array_equal(P.outcome(s_p).numpy(), np.asarray(J.outcome(s_j)))


def test_lift_equals_jax_lift_tictactoe():
    from handyrl_tpu.envs.tictactoe import TicTacToeRules as JaxTicTacToeRules

    _jax_lift_equal(TicTacToeRules, JaxTicTacToeRules, 64, 5)


def test_lift_equals_jax_lift_connect_four():
    from examples.connect_four import ConnectFourRules as JaxConnectFourRules

    _jax_lift_equal(ConnectFourRules, JaxConnectFourRules, 64, 6)


def test_port_lifts_the_unchanged_example_rules():
    """``examples/connect_four.py``'s rules, imported unchanged (by this
    test only), lift under the port: verify passes, and the lift equals the
    JAX package's lift of the same class."""
    from examples.connect_four import ConnectFourRules as ExampleRules

    autovectorize(ExampleRules).verify(8, seed=2, device="cpu")
    _jax_lift_equal(ExampleRules, ExampleRules, 32, 7)


def test_lift_is_memoized_and_flagged():
    V = autovectorize(TicTacToeRules)
    assert autovectorize(TicTacToeRules) is V
    assert V.__autovec__ is True and V.rules is TicTacToeRules
    assert V.__name__ == "AutoVecTicTacToeRules"


def test_example_env_vector_twin_is_the_lift():
    assert Environment.vector_env() is autovectorize(ConnectFourRules)
    assert make_env({"env": "ConnectFour"}).vector_env() is autovectorize(ConnectFourRules)


# -- loud diagnostics --------------------------------------------------------------


def _rules(**overrides):
    """A minimal liftable 2-action namespace, with injectable breakage."""

    class Minimal:
        num_actions = 2
        max_steps = 2
        num_players = 2

        @staticmethod
        def init():
            return {"x": np.zeros(2, np.int8)}

        @staticmethod
        def observation(state, step):
            return state["x"].astype(np.float32)

        @staticmethod
        def legal_mask(state):
            return state["x"] == 0

        @staticmethod
        def terminal(state, step):
            return (state["x"] != 0).all() | (step >= 2)

        @staticmethod
        def apply(state, action, step):
            x = np.where(np.arange(2) == action, np.int8(1), state["x"])
            return {"x": x}

        @staticmethod
        def outcome(state):
            return state["x"].astype(np.float32)

    for name, fn in overrides.items():
        setattr(Minimal, name, staticmethod(fn))
    Minimal.__name__ = "Minimal" + "_".join(overrides) if overrides else "Minimal"
    return Minimal


def test_minimal_rules_lift():
    autovectorize(_rules()).verify(4, seed=0, device="cpu")


def _write_copy(state, action, step):
    x = state["x"].copy()
    x[action] = 1                      # in place, into a copy
    return {"x": x}


def _write_input(state, action, step):
    x = state["x"]
    x[action] = 1                      # in place, into the vmap input
    return {"x": x}


def _add_input(state, action, step):
    x = state["x"]
    x += 1                             # an in-place operator
    return {"x": x}


@pytest.mark.parametrize("apply", [_write_copy, _write_input, _add_input],
                         ids=["copy", "input", "iadd"])
def test_inplace_mutation_fails_loudly(apply):
    """JAX refuses an in-place write (its arrays are immutable); torch's
    vmap would let one into the input through, so the lift refuses it,
    naming the function, and the state template is untouched."""
    rules = _rules(apply=apply)
    with pytest.raises(AutovecError, match=r"apply.*immutable"):
        autovectorize(rules)
    assert not rules.init()["x"].any()


def test_value_dependent_branch_fails_loudly():
    def terminal(state, step):
        if state["x"][0] > 0:              # python branch on an array value
            return np.bool_(True)
        return np.bool_(step >= 2)

    with pytest.raises(AutovecError, match="terminal.*control flow on an array value"):
        autovectorize(_rules(terminal=terminal))


def test_missing_torch_api_fails_loudly():
    def outcome(state):
        return np.busday_count("2026-01", "2026-02") * state["x"].astype(np.float32)

    with pytest.raises(AutovecError, match="outcome.*busday_count"):
        autovectorize(_rules(outcome=outcome))


def test_np_random_fails_loudly():
    def apply(state, action, step):
        return {"x": (state["x"] + np.random.randint(2)).astype(np.int8)}

    with pytest.raises(AutovecError, match="np.random"):
        autovectorize(_rules(apply=apply))


def test_shape_unstable_apply_fails_loudly():
    def apply(state, action, step):
        return {"x": np.concatenate([state["x"], state["x"]])}

    with pytest.raises(AutovecError, match="shape/dtype-stable|changes state"):
        autovectorize(_rules(apply=apply))


def test_wrong_legal_mask_spec_fails_loudly():
    def legal_mask(state):
        return (state["x"] == 0).astype(np.float32)

    with pytest.raises(AutovecError, match="legal_mask"):
        autovectorize(_rules(legal_mask=legal_mask))


def test_missing_function_fails_loudly():
    bad = _rules()
    del bad.outcome
    with pytest.raises(AutovecError, match="outcome"):
        autovectorize(bad)


def test_totality_wrapper_freezes_finished_lanes():
    V = autovectorize(_rules())
    state = V.init(3)
    state = V.apply(state, torch.tensor([0, 0, 1]), 0)
    state = V.apply(state, torch.tensor([1, 0, 1]), 1)
    done = V.terminal(state, 1)
    assert done.tolist() == [True, False, False]
    snap = state["x"].clone()
    state2 = V.apply(state, torch.tensor([0, 0, 0]), 1)
    assert torch.equal(state2["x"][done], snap[done])
    assert not torch.equal(state2["x"][~done], snap[~done])
    assert torch.equal(state["x"], snap)   # the input state is never written


# -- the device plane over the lift -------------------------------------------------


def test_device_rollout_plays_the_lifted_connect_four():
    """The episodic DeviceRollout over the lift: every episode replays
    legally through the host env, with the recorded observations and the
    outcome."""
    from handyrl_tpu_torch.runtime.device_rollout import DeviceRollout
    from handyrl_tpu_torch.runtime.replay import decompress_block

    env = make_env({"env": "ConnectFour"})
    args = normalize_args({"env_args": {"env": "ConnectFour"}, "train_args": {}})["train_args"]
    roll = DeviceRollout(env.vector_env(), env.net(), args, 16, device="cpu")
    episodes = roll.generate(None, torch.Generator().manual_seed(0))
    assert len(episodes) == 16
    for ep in episodes:
        cols = [decompress_block(b) for b in ep["blocks"]]
        host = Environment()
        t = 0
        for block in cols:
            for row in range(block["turn"].shape[0]):
                p = int(block["turn"][row])
                assert p == host.turn()
                np.testing.assert_array_equal(block["obs"][row, p], host.observation(p))
                a = int(block["action"][row, p])
                assert a in host.legal_actions()
                host.play(a)
                t += 1
        assert t == ep["steps"] and host.terminal()
        assert ep["outcome"] == host.outcome()


def _verify_cfg(tmp_path, n_verify):
    return normalize_args({"env_args": {"env": "ConnectFour"}, "train_args": {
        "epochs": 1, "minimum_episodes": 16, "update_episodes": 16, "batch_size": 8,
        "forward_steps": 8, "device_rollout_games": 16, "autovec_verify_games": n_verify,
        "batch_pipeline": "thread", "worker": {"num_parallel": 1}, "eval_rate": 0.0,
        "model_dir": str(tmp_path / "models"), "metrics_path": str(tmp_path / "m.jsonl")}})


def test_learner_verifies_the_lift_and_trains(tmp_path, capsys):
    from handyrl_tpu_torch.runtime.learner import Learner

    learner = Learner(_verify_cfg(tmp_path, 8), device="cpu")
    assert "autovec twin verified: AutoVecConnectFourRules parity over 8" in capsys.readouterr().out
    assert learner.run() == 0
    records = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert records[-1]["plane"] == "fused" and np.isfinite(records[-1]["loss"]["total"])
    assert learner._device_roll.timing["launch_ms"] > 0   # the lift played on the device plane


def test_learner_refuses_a_divergent_lift(tmp_path, monkeypatch):
    """A lift whose apply diverges from the numpy rules (it plays for the
    other colour) fails the learner's start with the diverged observable."""
    from handyrl_tpu_torch.runtime.learner import Learner

    good = autovectorize(ConnectFourRules)

    def apply(state, actions, step):
        return good.apply(state, actions, step + 1)

    broken = type("AutoVecBroken", (good,), {"apply": staticmethod(apply)})
    monkeypatch.setattr(Environment, "vector_env", staticmethod(lambda: broken))
    with pytest.raises(AutovecError, match="step-parity failed.*(observation|terminal)"):
        Learner(_verify_cfg(tmp_path, 8), device="cpu")
