"""Four faults of the port against the JAX package, repaired, on the CPU.

* C1: an env module's ``prepare()`` hook runs once per process where the
  JAX package runs it: the learner and ``eval_main`` (and the worker pool,
  the remote worker session and the battle client).
* C2: the episode store shrinks under memory pressure exactly as the JAX
  store does on the same inputs (psutil's reading patched to 99%).
* C3: a config key that selects a plane the port lacks is refused on any
  value but its default, naming the ROADMAP item; ``blk_k`` is checked as
  the JAX package checks it.
* C4: every key path of the JAX package's ``DEFAULT_TRAIN_ARGS`` is in the
  port's defaults or refused by name in ``NOT_PORTED_KEYS``; a value both
  packages check is refused by both, in the same words.  The keys of a
  learner of several processes (``mesh`` over ``dp``, ``distributed.*``,
  ``observability.rank_metrics``) are acted on and checked as in JAX;
  another mesh axis is refused naming the ROADMAP item.
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


# a value other than the JAX default, by dotted key path
NON_DEFAULT = {
    "plane": "split", "plane_param_lag_bound": 5, "actor_chips": 2, "param_refresh_updates": 5,
}

# the key paths of the int8 rung and the flywheel, ported and acted on: a
# value other than the default that both packages accept, and one the JAX
# package refuses with the words its refusal carries
INT8_AND_FLYWHEEL_KEYS = {
    "obs_int8": (True, "yes", "must be a bool"),
    "flywheel.enabled": (True, 1, "flywheel.enabled"),
    "flywheel.harvest_fraction": (1.0, 2.0, "harvest_fraction must be in"),
    "flywheel.staleness_epochs": (2, 0, "staleness_epochs must be >= 1"),
    "flywheel.harvest_host": ("10.0.0.2", None, None),
    "flywheel.harvest_port": (9000, 70000, "harvest_port"),
    "flywheel.harvest_poll_s": (2.0, 0.0, "harvest_poll_s must be > 0"),
    "flywheel.harvest_max_pull": (8, 0, "harvest_max_pull must be >= 1"),
    "flywheel.harvest_ttl_s": (60.0, -1.0, "harvest_ttl_s must be > 0"),
    "flywheel.harvest_max_open": (16, 0, "harvest_max_open must be >= 1"),
    "flywheel.gate_promotions": (False, "no", "gate_promotions"),
    "flywheel.promote_winrate": (0.6, 1.0, "promote_winrate must be in"),
    "flywheel.promote_games": (8, 0, "promote_games must be >= 1"),
    "flywheel.shadow_fraction": (0.5, -0.1, "shadow_fraction must be in"),
    "flywheel.quality_window": (8, 0, "quality_window must be >= 1"),
    "flywheel.demote_drop": (0.3, 0.0, "demote_drop must be in"),
    "serving.weight_dtype": ("int8", "int4", "weight_dtype"),
    "serving.calibration_batches": (2, -1, "calibration_batches must be >= 0"),
}


@pytest.mark.parametrize("key", sorted(INT8_AND_FLYWHEEL_KEYS))
def test_int8_and_flywheel_keys_act_and_are_checked_as_in_jax(key):
    """Each of these keys is ported: a non-default value passes (and reaches
    the normalised args), it is not in NOT_PORTED_KEYS, and a value the JAX
    package refuses is refused by both packages with the JAX words."""
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    path = tuple(key.split("."))
    good, bad, words = INT8_AND_FLYWHEEL_KEYS[key]
    env = {"env": "TicTacToe"}
    train = normalize_args({"env_args": env, "train_args": _value(path, good)})["train_args"]
    for k in path:
        train = train[k]
    assert train == good
    assert all(path != p for p, _, _ in NOT_PORTED_KEYS)
    if words is None:   # a free-form key: any string passes both packages
        return
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=words):
            normalize({"env_args": env, "train_args": _value(path, bad)})


# the key paths of the league and autovec_verify_games, ported and acted on:
# a value other than the default that both packages accept, and one the JAX
# package refuses with the words its refusal carries
LEAGUE_AND_AUTOVEC_KEYS = {
    "league.pfsp_weighting": ("hard", "fair", "pfsp_weighting"),
    "league.selfplay_rate": (0.5, 1.5, "selfplay_rate must be in"),
    "league.promote_winrate": (0.6, 1.0, "promote_winrate must be in"),
    "league.promote_games": (4, 0, "promote_games must be >= 1"),
    "league.max_population": (8, 1, "max_population must be >= 2"),
    "autovec_verify_games": (4, -1, "autovec_verify_games must be >= 0"),
}


@pytest.mark.parametrize("key", sorted(LEAGUE_AND_AUTOVEC_KEYS))
def test_league_and_autovec_keys_act_and_are_checked_as_in_jax(key):
    """Each of these keys is ported: a non-default value passes both
    packages (and reaches the port's normalised args), it is not in
    NOT_PORTED_KEYS, and a value the JAX package refuses is refused by both
    with the JAX words."""
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    path = tuple(key.split("."))
    good, bad, words = LEAGUE_AND_AUTOVEC_KEYS[key]
    env = {"env": "TicTacToe"}
    for normalize in (normalize_args, jax_normalize_args):
        train = normalize({"env_args": env, "train_args": _value(path, good)})["train_args"]
        for k in path:
            train = train[k]
        assert train == good
        with pytest.raises(ValueError, match=words):
            normalize({"env_args": env, "train_args": _value(path, bad)})
    assert all(path != p for p, _, _ in NOT_PORTED_KEYS)


@pytest.mark.parametrize("path,default,item", NOT_PORTED_KEYS,
                         ids=[".".join(p) for p, _, _ in NOT_PORTED_KEYS])
def test_keys_of_planes_not_ported_are_refused(path, default, item):
    env = {"env": "TicTacToe"}
    normalize_args({"env_args": env, "train_args": _value(path, default)})  # the default passes
    bad = NON_DEFAULT[".".join(path)]
    with pytest.raises(ValueError, match=f"ROADMAP {item.split()[0]}"):
        normalize_args({"env_args": env, "train_args": _value(path, bad)})


REPLAY = {"device_replay": True, "device_rollout_games": 8}
STAGE = {"batch_pipeline": "device"}
# the key, a config that sets it, a config both packages refuse, and the
# refusal's words: the device planes of PRs 8 and 9
DEVICE_PLANE_KEYS = [
    ("device_rollout_games", {"device_rollout_games": 64}, {"device_rollout_games": -1},
     "device_rollout_games"),
    ("device_eval_games", {"device_eval_games": 32}, {"device_eval_games": -1},
     "device_eval_games"),
    ("device_replay", REPLAY, {"device_replay": True}, "device_rollout_games > 0"),
    ("device_replay_slots", dict(REPLAY, device_replay_slots=64),
     dict(REPLAY, device_replay_slots=16), "device_replay_slots must exceed forward_steps"),
    ("device_replay_k_steps", dict(REPLAY, device_replay_k_steps=16),
     dict(REPLAY, device_replay_k_steps=0), "device_replay_k_steps"),
    ("batch_pipeline", STAGE, dict(STAGE, **REPLAY), "redundant under device_replay"),
    ("device_stage_lanes", dict(STAGE, device_stage_lanes=4), dict(STAGE, device_stage_lanes=0),
     "device_stage_lanes"),
    ("device_stage_slots", dict(STAGE, device_stage_slots=256),
     dict(STAGE, device_stage_slots=16), "device_stage_slots must exceed"),
    ("device_stage_chunk", dict(STAGE, device_stage_chunk=32), dict(STAGE, device_stage_chunk=0),
     "device_stage_chunk"),
]
DEVICE_PLANE_NAMES = ("device_rollout_games", "device_eval_games", "plane_stall_timeout",
                      "plane_max_restarts", "device_replay", "device_replay_slots",
                      "device_replay_k_steps", "batch_pipeline", "device_stage_lanes",
                      "device_stage_slots", "device_stage_chunk")


@pytest.mark.parametrize("key,train_args,bad,match", DEVICE_PLANE_KEYS,
                         ids=[f"{k}-{t[k]}" for k, t, _, _ in DEVICE_PLANE_KEYS])
def test_device_plane_keys_pass_both_packages_alike(key, train_args, bad, match):
    """On-device self-play and evaluation and the device data plane are
    ported: both packages' normalize_args take the key, with the same
    result for it and for every other key of those planes, and both refuse
    the same misconfiguration with the same words."""
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    raw = {"env_args": {"env": "HungryGeese"}, "train_args": train_args}
    port, jax_args = normalize_args(raw)["train_args"], jax_normalize_args(raw)["train_args"]
    for name in DEVICE_PLANE_NAMES:
        assert port[name] == jax_args[name], name
    assert port[key] == train_args[key]
    bad = {"env_args": {"env": "HungryGeese"}, "train_args": bad}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
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


def _leaf_paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            yield from _leaf_paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


def test_every_jax_default_key_is_ported_or_refused_by_name():
    """C4: no key of the JAX defaults passes silently.  Each leaf path is
    in the port's defaults, or it (or a prefix of it) is in
    NOT_PORTED_KEYS, where a non-default value is refused naming its
    ROADMAP item."""
    from handyrl_tpu.config import DEFAULT_TRAIN_ARGS as JAX_DEFAULTS
    from handyrl_tpu_torch.config import DEFAULT_TRAIN_ARGS

    port_paths = set(_leaf_paths(DEFAULT_TRAIN_ARGS))
    refused = {path for path, _, _ in NOT_PORTED_KEYS}
    silent = [path for path in _leaf_paths(JAX_DEFAULTS)
              if path not in port_paths
              and not any(path[:i] in refused for i in range(1, len(path) + 1))]
    assert not silent, silent
    # the table above has a non-default value for every refused key
    assert set(NON_DEFAULT) == {".".join(path) for path in refused}


def test_port_defaults_are_the_jax_defaults():
    from handyrl_tpu.config import DEFAULT_TRAIN_ARGS as JAX_DEFAULTS
    from handyrl_tpu_torch.config import DEFAULT_TRAIN_ARGS

    for path in _leaf_paths(DEFAULT_TRAIN_ARGS):
        port, jax_value = DEFAULT_TRAIN_ARGS, JAX_DEFAULTS
        for key in path:
            port, jax_value = port[key], jax_value[key]
        assert port == jax_value, path


# keys the port refuses, at values the JAX package also refuses: the
# same words from both
JAX_CHECKED = [
    ({"actor_chips": 0}, "actor_chips must be >= 1"),
    ({"param_refresh_updates": 0}, "param_refresh_updates must be >= 1"),
    ({"mesh": "dp"}, "mesh must be a non-empty"),
    ({"distributed": {"num_processes": 0}}, "num_processes must be >= 1"),
    ({"distributed": {"role": "observer"}}, "distributed.role"),
    ({"observability": {"rank_metrics": "yes"}}, "rank_metrics"),
    ({"league": {"pfsp_weighting": "fair"}}, "pfsp_weighting"),
    ({"league": {"selfplay_rate": 1.5}}, "selfplay_rate"),
    ({"league": {"promote_winrate": 1.0}}, "promote_winrate"),
    ({"league": {"promote_games": 0}}, "promote_games"),
    ({"league": {"max_population": 1}}, "max_population"),
    ({"flywheel": {"harvest_fraction": 2.0}}, "harvest_fraction"),
    ({"serving": {"calibration_batches": -1}}, "calibration_batches"),
]


@pytest.mark.parametrize("train_args,match", JAX_CHECKED,
                         ids=[".".join(_leaf_paths(t).__next__()) for t, _ in JAX_CHECKED])
def test_values_the_jax_package_refuses_are_refused_alike(train_args, match):
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    raw = {"env_args": {"env": "TicTacToe"}, "train_args": train_args}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
            normalize(raw)


ADDR = {"coordinator_address": "10.0.0.1:1234"}
# the keys of a learner of several processes, ported and acted on: the key,
# a config setting it that both packages accept, a config both refuse, and
# the refusal's words
DISTRIBUTED_KEYS = [
    ("mesh", {"mesh": {"dp": 2}}, {"mesh": ["dp"]}, "mesh must be a non-empty"),
    ("distributed.num_processes", {"distributed": {"num_processes": 2}},
     {"distributed": {"num_processes": 0}}, "num_processes must be >= 1"),
    ("distributed.coordinator_address", {"distributed": ADDR},
     {"distributed": {"coordinator_address": "10.0.0.1"}}, "must be 'host:port'"),
    ("distributed.process_id", {"distributed": {"process_id": 1}},
     {"distributed": {"process_id": -1}}, "process_id must be >= 0"),
    ("distributed.initialization_timeout", {"distributed": {"initialization_timeout": 60.0}},
     {"distributed": {"initialization_timeout": 0.0}}, "initialization_timeout must be > 0"),
    ("distributed.heartbeat_interval", {"distributed": {"heartbeat_interval": 1.0}},
     {"distributed": {"heartbeat_interval": -1.0}}, "heartbeat_interval must be >= 0"),
    ("distributed.heartbeat_timeout", {"distributed": {"heartbeat_timeout": 40.0}},
     {"distributed": {"heartbeat_interval": 5.0, "heartbeat_timeout": 10.0}}, "must exceed 2x"),
    ("distributed.collective_timeout", {"distributed": {"collective_timeout": 60.0}},
     {"distributed": {"collective_timeout": -1.0}}, "collective_timeout must be >= 0"),
    ("distributed.health_port", {"distributed": {"health_port": 7000}},
     {"distributed": {"health_port": 70000}}, "health_port"),
    ("distributed.role", {"device_rollout_games": 8, "distributed": dict(ADDR, role="actor")},
     {"distributed": dict(ADDR, role="actor")}, "role: actor needs device_rollout_games"),
    ("distributed.plane_port", {"distributed": {"plane_port": 7001}},
     {"distributed": {"plane_port": -1}}, "plane_port"),
    ("distributed.actor_hosts", {"distributed": dict(ADDR, actor_hosts=2)},
     {"distributed": {"actor_hosts": 1}}, "need distributed.coordinator_address"),
    ("observability.rank_metrics", {"observability": {"rank_metrics": False}},
     {"observability": {"rank_metrics": "yes"}}, "rank_metrics"),
]


def _at(tree, key):
    for k in key.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("key,train_args,bad,match", DISTRIBUTED_KEYS,
                         ids=[k for k, _, _, _ in DISTRIBUTED_KEYS])
def test_distributed_keys_act_and_are_checked_as_in_jax(key, train_args, bad, match):
    """Each key is ported: not in NOT_PORTED_KEYS, its value reaches the
    normalised args of both packages alike, and a value the JAX package
    refuses is refused by both in the same words."""
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    env = {"env": "TicTacToe"}
    port = normalize_args({"env_args": env, "train_args": train_args})["train_args"]
    jax_args = jax_normalize_args({"env_args": env, "train_args": train_args})["train_args"]
    assert _at(port, key) == _at(jax_args, key) == _at(train_args, key)
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
            normalize({"env_args": env, "train_args": bad})
    assert all(tuple(key.split(".")) != p for p, _, _ in NOT_PORTED_KEYS)


@pytest.mark.parametrize("mesh,extra,match", [
    ({"dp": 2, "mp": 2}, {}, "the axis 'mp' selects a plane that is not ported"),
    ({"sp": 2, "mp": 2}, {"seq_attention": "ring", "forward_steps": 16},
     "the axis 'mp' selects a plane that is not ported"),
    ({"dp": -1, "sp": 4}, {}, "an 'sp' axis shards the window only under seq_attention: 'ring'"),
])
def test_mesh_axes_but_dp_are_refused_by_name(mesh, extra, match):
    """Tensor parallel axes need cards of their own, and an ``sp`` axis
    shards nothing without the ring (the JAX package replicates the step
    across it): both refused naming the ROADMAP item.  A size-1 axis beside
    dp passes, and so does ``sp`` under ``seq_attention: ring``."""
    env = {"env": "TicTacToe"}
    with pytest.raises(ValueError, match="ROADMAP A8") as raised:
        normalize_args({"env_args": env, "train_args": dict(extra, mesh=mesh)})
    assert match in str(raised.value)
    assert normalize_args({"env_args": env, "train_args": {"mesh": {"dp": -1, "mp": 1}}})
    ring = normalize_args({"env_args": env, "train_args": {
        "mesh": {"dp": -1, "sp": 4}, "seq_attention": "ring", "forward_steps": 16}})
    assert ring["train_args"]["mesh"] == {"dp": -1, "sp": 4}


@pytest.mark.parametrize("train_args,match", [
    ({"batch_size": 9}, "must divide evenly across distributed.num_processes"),
    ({"batch_size": 8, "device_rollout_games": 9}, "device_rollout_games=9 must divide"),
])
def test_shards_must_divide_over_the_ranks_as_in_jax(train_args, match):
    from handyrl_tpu.config import normalize_args as jax_normalize_args

    raw = {"env_args": {"env": "TicTacToe"},
           "train_args": dict(train_args, distributed=dict(ADDR, num_processes=2))}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
            normalize(raw)
