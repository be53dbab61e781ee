"""Three faults of the port against the JAX package, repaired, on the CPU.

* C1: an env module's ``prepare()`` hook runs once per process where the
  JAX package runs it: the learner and ``eval_main`` (and the worker pool,
  the remote worker session and the battle client).
* C2: the episode store shrinks under memory pressure exactly as the JAX
  store does on the same inputs (psutil's reading patched to 99%).
* C3: a config key that selects a plane the port lacks is refused on any
  value but its default, naming the ROADMAP item; ``blk_k`` is checked as
  the JAX package checks it.
"""

import importlib
import textwrap

import psutil
import pytest
import torch

from handyrl_tpu.runtime.replay import EpisodeStore as JaxEpisodeStore
from handyrl_tpu_torch.config import NOT_PORTED_KEYS, normalize_args
from handyrl_tpu_torch.runtime.evaluation import eval_main
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.runtime.replay import EpisodeStore


@pytest.fixture
def prepared_env(tmp_path, monkeypatch):
    """A dotted-path env module whose ``prepare()`` counts its calls."""
    name = "prepared_tictactoe_env"
    (tmp_path / f"{name}.py").write_text(textwrap.dedent("""
        from handyrl_tpu_torch.envs.tictactoe import Environment  # noqa: F401

        calls = 0


        def prepare():
            global calls
            calls += 1
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(name)
    module.calls = 0
    yield name, module


def test_prepare_hook_runs_in_the_learner_and_eval_main(prepared_env):
    name, module = prepared_env
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = normalize_args({"env_args": {"env": name}, "train_args": {
            "batch_size": 4, "forward_steps": 4, "minimum_episodes": 2, "update_episodes": 2,
            "epochs": 1, "worker": {"num_parallel": 1}}})
        learner = Learner(args, device="cpu")
        learner.model_server.stop()
        assert module.calls == 1
        module.calls = 0
        eval_main(args, ["random", "2", "1"], device="cpu")
        assert module.calls == 1
    finally:
        torch.set_num_threads(threads)


class _Memory:
    def __init__(self, percent):
        self.percent = percent


def test_store_shrinks_under_memory_pressure_as_the_jax_store(monkeypatch):
    stores = [EpisodeStore(100), JaxEpisodeStore(100)]
    episodes = [{"i": i} for i in range(80)]
    monkeypatch.setattr(psutil, "virtual_memory", lambda: _Memory(50.0))
    for store in stores:
        store.extend(episodes[:50])
    assert [len(s) for s in stores] == [50, 50]
    monkeypatch.setattr(psutil, "virtual_memory", lambda: _Memory(99.0))
    for store in stores:
        store.extend(episodes[50:60])
    # 60 held at 99%: the store keeps int(60 * 95 / 99) = 57, the newest
    assert [len(s) for s in stores] == [57, 57]
    for store in stores:
        store.extend(episodes[60:80])
    assert len(stores[0]) == len(stores[1]) == int(77 * 95 / 99)
    assert list(stores[0]._episodes) == list(stores[1]._episodes) == episodes[80 - len(stores[0]):]


def _value(path, value):
    """A train_args fragment setting the key at ``path`` to ``value``."""
    out = value
    for key in reversed(path):
        out = {key: out}
    return out


NON_DEFAULT = {
    "device_replay": True, "plane": "split", "obs_int8": True, "plane_param_lag_bound": 5,
    "autovec_verify_games": 4, "num_processes": 2, "flywheel": True, "trace": True,
    "profile_dir": "profiles",
}


@pytest.mark.parametrize("path,default,item", NOT_PORTED_KEYS,
                         ids=[".".join(p) for p, _, _ in NOT_PORTED_KEYS])
def test_keys_of_planes_not_ported_are_refused(path, default, item):
    env = {"env": "TicTacToe"}
    normalize_args({"env_args": env, "train_args": _value(path, default)})  # the default passes
    bad = NON_DEFAULT[path[0] if path[0] in NON_DEFAULT else path[-1]]
    with pytest.raises(ValueError, match=f"ROADMAP {item.split()[0]}"):
        normalize_args({"env_args": env, "train_args": _value(path, bad)})


@pytest.mark.parametrize("key,value", [("device_rollout_games", 64), ("device_eval_games", 32)])
def test_device_plane_keys_pass_both_packages_alike(key, value):
    """On-device self-play and evaluation are ported: both packages'
    normalize_args take the key, with the same result for it and for the
    watchdog keys, and both refuse a negative count."""
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    raw = {"env_args": {"env": "HungryGeese"}, "train_args": {key: value}}
    port, jax_args = normalize_args(raw)["train_args"], jax_normalize_args(raw)["train_args"]
    for name in ("device_rollout_games", "device_eval_games", "plane_stall_timeout",
                 "plane_max_restarts"):
        assert port[name] == jax_args[name], name
    assert port[key] == value
    bad = {"env_args": {"env": "HungryGeese"}, "train_args": {key: -1}}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=key):
            normalize(bad)


def test_not_ported_keys_name_the_jax_defaults():
    from handyrl_tpu.config import DEFAULT_TRAIN_ARGS as JAX_DEFAULTS

    for path, default, _ in NOT_PORTED_KEYS:
        value = JAX_DEFAULTS
        for key in path:
            value = value[key]
        assert value == default, path


@pytest.mark.parametrize("blk_k,ok", [(8, True), (128, True), (256, True), (4, False),
                                      (12, False), (96, False)])
def test_blk_k_is_a_power_of_two_at_least_8(blk_k, ok):
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    raw = {"env_args": {"env": "TicTacToe"}, "train_args": {"blk_k": blk_k}}
    for normalize in (normalize_args, jax_normalize_args):
        if ok:
            assert normalize(raw)["train_args"]["blk_k"] == blk_k
        else:
            with pytest.raises(ValueError, match="blk_k"):
                normalize(raw)
