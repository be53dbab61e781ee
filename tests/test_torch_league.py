"""The port's league (``handyrl_tpu_torch/league/``) against the JAX
package's on the CPU.

One counterpart for each test of ``tests/test_league.py``.  The books, the
PFSP weights and draws, the registry's JSON and the learner's role dicts
and ``league_*`` records are computed by both packages from the same
inputs and compared exactly: they are host-side bookkeeping, with no
tolerance.  Frozen opponents are served from the port's router engines;
the end-to-end run trains a TicTacToe league at the JAX test's geometry on
the CPU.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from handyrl_tpu import league as jax_league
from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.runtime.checkpoint import record_snapshot as jax_record_snapshot
from handyrl_tpu_torch import league as port_league
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.league import ANCHOR, CANDIDATE, League, Matchmaker, PayoffMatrix
from handyrl_tpu_torch.runtime.checkpoint import record_snapshot

PACKAGES = {"jax": jax_league, "port": port_league}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- the payoff ledger -------------------------------------------------------------


def _pairwise(p):
    p.record_outcome({0: "a", 1: "b"}, {0: 1.0, 1: -1.0})
    p.record_outcome({0: "a", 1: "b"}, {0: -1.0, 1: 1.0})
    for _ in range(2):
        p.record_outcome({0: "a", 1: "b"}, {0: 0.0, 1: 0.0})
    return p.games("a", "b"), p.win_points("a", "b"), p.win_points("b", "a"), p.matches


def _wp_convention(p):
    rng = np.random.default_rng(0)
    for _ in range(200):
        o = float(rng.choice([-1.0, 0.0, 1.0]))
        p.record_outcome({0: "x", 1: "y"}, {0: o, 1: -o})
    return p.win_points("x", "y")


def _placements(p):
    names = {0: "a", 1: "b", 2: "c", 3: "d"}
    p.record_outcome(names, {0: 1.0, 1: 1 / 3, 2: -1 / 3, 3: -1.0})
    first = [p.win_points(a, b) for a in "abcd" for b in "abcd"]
    p.record_outcome(names, {0: 0.5, 1: 0.5, 2: -1.0, 3: -1.0})
    return first, [p.win_points(a, b) for a in "abcd" for b in "abcd"], p.matches


def _self_pair(p):
    p.record_outcome({0: "a", 1: "a"}, {0: 1.0, 1: -1.0})
    return p.games("a", "a"), p.matches


def _forfeit(p):
    p.record_forfeit({0: "a", 1: "b", 2: "c"}, 1)
    return [p.win_points(a, b) for a in "abc" for b in "abc"], p.games("a", "c"), p.forfeits


def _aggregate(p):
    for _ in range(9):
        p.record_score("a", "x", 1.0, -1.0)
    p.record_score("a", "y", -1.0, 1.0)
    return p.aggregate_win_points("a", ["x", "y"])


def _roundtrip_adopt(p):
    p.record_score(CANDIDATE, "x", 1.0, -1.0)
    q = type(p).from_dict(p.to_dict())
    q.adopt(CANDIDATE, "main-3")
    return (q.to_dict(), q.win_points("main-3", "x"), q.win_points(CANDIDATE, "x"),
            q.win_points("x", "main-3"))


def _elo(p):
    for _ in range(20):
        p.record_score("strong", ANCHOR, 1.0, -1.0)
        p.record_score("weak", ANCHOR, -1.0, 1.0)
    return p.elo(["strong", "weak", ANCHOR], anchor=ANCHOR)


@pytest.mark.parametrize("scenario", [_pairwise, _wp_convention, _placements, _self_pair,
                                      _forfeit, _aggregate, _roundtrip_adopt, _elo],
                         ids=lambda f: f.__name__.strip("_"))
def test_payoff_matrix_equals_jax(scenario):
    """Each TestPayoffMatrix scenario on both ledgers: the same books."""
    got = scenario(port_league.PayoffMatrix())
    assert got == scenario(jax_league.PayoffMatrix())


# -- PFSP --------------------------------------------------------------------------


RATES = [[0.5], [1.0], [0.0], [0.2, 0.9], [None, 0.95], [None, 0.3, 0.7, 1.2, -0.1]]


@pytest.mark.parametrize("weighting", ["var", "hard", "even"])
def test_pfsp_weights_equal_jax(weighting):
    for rates in RATES:
        assert port_league.pfsp_weights(rates, weighting) == jax_league.pfsp_weights(
            rates, weighting)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown pfsp weighting"):
            pkg.pfsp_weights([0.5], "nope")


def _draws(pkg, seed, weighting, min_games, n=200):
    p = pkg.PayoffMatrix()
    for _ in range(50):
        p.record_score(CANDIDATE, "solved", 1.0, -1.0)
        p.record_score(CANDIDATE, "peer", 1.0, -1.0)
        p.record_score(CANDIDATE, "peer", -1.0, 1.0)
    p.record_score(CANDIDATE, "fresh", 1.0, -1.0)
    mm = pkg.Matchmaker(p, weighting, seed=seed)
    pool = ["solved", "peer", "fresh", "unplayed"]
    out = [mm.sample_opponent(CANDIDATE, pool, min_games=min_games) for _ in range(n)]
    # the quota fills as the learner records the probes
    for name in ("fresh", "unplayed"):
        for _ in range(3):
            p.record_score(CANDIDATE, name, 1.0, -1.0)
    out += [mm.sample_opponent(CANDIDATE, pool, min_games=min_games) for _ in range(n)]
    return out + [mm.sample_opponent(CANDIDATE, [])]


@pytest.mark.parametrize("weighting,min_games", [("var", 0), ("hard", 0), ("even", 0),
                                                 ("var", 3)])
def test_matchmaker_draws_equal_jax(weighting, min_games):
    """The same seed and ledger give the same 200 + 200 opponents: the probe
    quota, the Laplace smoothing and the RNG stream are the JAX package's."""
    port = _draws(port_league, 7, weighting, min_games)
    assert port == _draws(jax_league, 7, weighting, min_games)
    assert port[-1] is None
    if weighting == "var" and min_games == 0:
        assert port[:200].count("peer") > port[:200].count("solved")


def test_probe_quota_prevents_starvation():
    p = PayoffMatrix()
    p.record_score(CANDIDATE, "anchor", 1.0, -1.0)
    for _ in range(50):
        p.record_score(CANDIDATE, "peer", 1.0, -1.0)
        p.record_score(CANDIDATE, "peer", -1.0, 1.0)
    mm = Matchmaker(p, "var", seed=2)
    draws = [mm.sample_opponent(CANDIDATE, ["anchor", "peer"], min_games=3) for _ in range(50)]
    assert draws.count("anchor") == 50


# -- the registry ------------------------------------------------------------------


def _league_ops(pkg, model_dir):
    lg = pkg.League(model_dir, {"max_population": 3})
    lg.payoff.record_score(CANDIDATE, ANCHOR, 1.0, -1.0)
    lg.freeze_candidate(3, steps=123)
    lg.payoff.record_outcome({0: CANDIDATE, 1: "main-3"}, {0: 0.0, 1: 0.0})
    lg.add("exp-5", 5, role="exploiter", frozen_at_step=9)
    lg.freeze_candidate(7, steps=456)
    lg.save()
    return lg


def test_league_json_is_byte_equal_to_jax(tmp_path):
    """The same League operations write the same LEAGUE.json, byte for
    byte, and each package reloads the other's file."""
    for name, pkg in PACKAGES.items():
        _league_ops(pkg, str(tmp_path / name))
    port_bytes = (tmp_path / "port" / "LEAGUE.json").read_bytes()
    assert port_bytes == (tmp_path / "jax" / "LEAGUE.json").read_bytes()
    assert json.loads(port_bytes)["version"] == 1
    lg = League(str(tmp_path / "jax"), {"max_population": 3})
    assert set(lg.members) == {ANCHOR, "main-3", "exp-5", "main-7"}
    assert lg.promotions == 2 and lg.frozen_epochs() == [3, 5, 7]
    assert [m.name for m in lg.opponent_pool()] == [ANCHOR, "exp-5", "main-7"]
    assert lg.payoff.win_points("main-3", ANCHOR) == 1.0


def test_fresh_league_seeds_anchor(tmp_path):
    lg = League(str(tmp_path))
    assert ANCHOR in lg.members and lg.members[ANCHOR].role == "anchor"
    assert [m.name for m in lg.opponent_pool()] == [ANCHOR]
    assert not (tmp_path / "LEAGUE.json").exists()


def test_freeze_persist_resume(tmp_path):
    lg = League(str(tmp_path))
    lg.payoff.record_score(CANDIDATE, ANCHOR, 1.0, -1.0)
    lg.freeze_candidate(3, steps=123)
    lg2 = League(str(tmp_path))
    assert set(lg2.members) == {ANCHOR, "main-3"} and lg2.promotions == 1
    assert lg2.payoff.win_points("main-3", ANCHOR) == 1.0
    assert lg2.frozen_epochs() == [3]


def test_load_drops_unverifiable_member(tmp_path, capsys):
    """A member whose snapshot fails the port's digest check is dropped
    loudly and its books are kept, as the JAX package drops it."""
    for name, pkg, record in (("port", port_league, record_snapshot),
                              ("jax", jax_league, jax_record_snapshot)):
        model_dir = tmp_path / name
        lg = pkg.League(str(model_dir))
        lg.add("main-7", 7)
        lg.payoff.record_score("main-7", ANCHOR, 1.0, -1.0)
        lg.save()
        (model_dir / "7.ckpt").write_bytes(b"corrupt")
        record(str(model_dir), 7, 1, {"7.ckpt": (0xDEAD, 999)})
    capsys.readouterr()
    lg2 = League(str(tmp_path / "port"))
    assert "main-7" not in lg2.members
    out = capsys.readouterr().out
    assert "dropping member 'main-7'" in out and "digest" in out
    assert lg2.payoff.win_points("main-7", ANCHOR) == 1.0
    assert set(lg2.members) == set(jax_league.League(str(tmp_path / "jax")).members)


@pytest.mark.parametrize("damage", ["unreadable", "corrupt"])
def test_bad_registry_fails_loudly_with_the_jax_words(tmp_path, damage):
    """An existing LEAGUE.json that cannot be read or parsed is refused by
    both packages with the same words (a fresh league would empty the GC
    pin set); only a missing file means fresh."""
    messages = []
    for name, pkg in PACKAGES.items():
        model_dir = tmp_path / name
        lg = pkg.League(str(model_dir))
        lg.add("main-2", 2)
        lg.save()
        path = model_dir / "LEAGUE.json"
        saved = path.read_bytes()
        if damage == "unreadable":
            path.unlink()
            path.mkdir()    # open() raises IsADirectoryError, for any uid
        else:
            path.write_bytes(saved[: len(saved) // 2])
        with pytest.raises(RuntimeError) as err:
            pkg.League(str(model_dir))
        messages.append(str(err.value).replace(str(model_dir), "DIR"))
        if damage == "unreadable":
            path.rmdir()
        path.write_bytes(saved)
        assert "main-2" in pkg.League(str(model_dir)).members
    assert messages[0] == messages[1]
    assert ("cannot be read" if damage == "unreadable" else "is corrupt") in messages[0]


def test_non_owner_never_writes(tmp_path):
    lg = League(str(tmp_path))
    lg.owner = False
    lg.add("main-1", 1)
    lg.save()
    assert not (tmp_path / "LEAGUE.json").exists()


def test_pool_caps_but_keeps_anchor_and_newest(tmp_path):
    lg = League(str(tmp_path), {"max_population": 3})
    for epoch in (1, 2, 3, 4):
        lg.add(f"main-{epoch}", epoch)
    assert [m.name for m in lg.opponent_pool()] == [ANCHOR, "main-3", "main-4"]
    assert lg.frozen_epochs() == [1, 2, 3, 4]


def test_reserved_and_duplicate_names_refused_with_the_jax_words(tmp_path):
    for name, pkg in PACKAGES.items():
        lg = pkg.League(str(tmp_path / name))
        with pytest.raises(ValueError, match="reserved"):
            lg.add(CANDIDATE, 5)
        lg.add("main-5", 5)
        with pytest.raises(ValueError, match="already"):
            lg.add("main-5", 5)
        with pytest.raises(ValueError, match="role"):
            lg.add("weird", 6, role="boss")


def test_learner_gc_call_sites_all_pass_pin():
    """Every gc_snapshots call of the port's learner carries the pin set:
    the boundary's and the drain's alike."""
    import ast
    import inspect

    from handyrl_tpu_torch.runtime import learner as learner_mod

    tree = ast.parse(inspect.getsource(learner_mod))
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", getattr(node.func, "attr", None)) == "gc_snapshots"]
    assert len(calls) >= 2
    for call in calls:
        assert any(kw.arg == "pin" for kw in call.keywords), call.lineno


def test_gc_snapshots_pins_league_epochs(tmp_path):
    from handyrl_tpu_torch.runtime.checkpoint import gc_snapshots

    for e in range(1, 8):
        (tmp_path / f"{e}.ckpt").write_bytes(b"x" * 8)
    assert set(gc_snapshots(str(tmp_path), keep=2, pin=(3, 4))) == {1, 2, 5}
    assert sorted(int(p.name.split(".")[0]) for p in tmp_path.glob("*.ckpt")) == [3, 4, 6, 7]


# -- the learner -------------------------------------------------------------------


def _train(tmp_path, **over):
    train = {
        "batch_size": 8, "forward_steps": 4, "update_episodes": 8, "minimum_episodes": 8,
        "maximum_episodes": 500, "num_batchers": 0, "batch_pipeline": "thread", "epochs": 2,
        "eval_rate": 0.0, "worker": {"num_parallel": 2},
        "metrics_path": os.path.join(str(tmp_path), "metrics.jsonl"),
        "model_dir": os.path.join(str(tmp_path), "models"),
        "league": {"promote_winrate": 0.52, "promote_games": 4, "selfplay_rate": 0.25},
    }
    train.update(over)
    return {"env_args": {"env": "TicTacToe"}, "train_args": train}


def _learners(tmp_path, **over):
    """The JAX LeagueLearner and the port's, each over a model dir of its
    own, from one config."""
    from handyrl_tpu.league.learner import LeagueLearner as JaxLeagueLearner
    from handyrl_tpu_torch.league.learner import LeagueLearner

    out = {}
    for name in ("jax", "port"):
        raw = _train(tmp_path / name, **over)
        if name == "jax":
            out[name] = JaxLeagueLearner(jax_normalize_args(raw))
        else:
            out[name] = LeagueLearner(normalize_args(raw), device="cpu")
    return out


def _stop(learners):
    for learner in learners.values():
        learner.model_server.stop()
        learner.trainer.stop()


def test_assign_role_equals_jax(tmp_path):
    """With a frozen member in the pool, 50 role dicts of the port's
    learner equal the JAX learner's: selfplay slice, seat rotation, the
    PFSP opponent and the epochs stamped on each seat."""
    learners = _learners(tmp_path)
    try:
        roles = {}
        for name, learner in learners.items():
            learner.league.add("main-0", 0)
            learner.model_epoch = 1
            learner.league.payoff.record_score(CANDIDATE, ANCHOR, 1.0, -1.0)
            roles[name] = [learner._assign_role() for _ in range(50)]
        assert roles["port"] == roles["jax"]
        matches = [r for r in roles["port"] if r.get("league", {}).get("mode") == "match"]
        assert matches and {r["player"][0] for r in matches} == {0, 1}
        assert any(r.get("league", {}).get("mode") == "selfplay" for r in roles["port"])
    finally:
        _stop(learners)


def _match_episode(compress_block):
    T, P, A = 4, 2, 9
    rng = np.random.default_rng(3)
    cols = {
        "obs": rng.random((T, P, 3, 3, 3)).astype(np.float32),
        "prob": np.full((T, P), 0.5, np.float32),
        "action": rng.integers(0, A, (T, P)).astype(np.int32),
        "amask": np.zeros((T, P, A), np.float32),
        "value": rng.random((T, P)).astype(np.float32),
        "reward": np.zeros((T, P), np.float32),
        "ret": np.zeros((T, P), np.float32),
        "tmask": np.ones((T, P), np.float32),
        "omask": np.ones((T, P), np.float32),
        "turn": np.arange(T, dtype=np.int32) % P,
    }
    return {
        "args": {"player": [1], "model_id": {0: 0, 1: 1},
                 "league": {"mode": "match", "seats": {0: "main-0", 1: CANDIDATE}}},
        "steps": T, "players": [0, 1], "outcome": {0: -1.0, 1: 1.0},
        "blocks": [compress_block(cols), compress_block(cols)],
    }


def test_mask_non_candidate_equals_jax():
    """The frozen seat's tmask/omask are zeroed, everything else kept: the
    decoded columns equal the JAX package's."""
    from handyrl_tpu.league.learner import LeagueLearner as JaxLeagueLearner
    from handyrl_tpu.runtime.replay import compress_block as jax_compress
    from handyrl_tpu.runtime.replay import decompress_block as jax_decompress
    from handyrl_tpu_torch.league.learner import LeagueLearner
    from handyrl_tpu_torch.runtime.replay import compress_block, decompress_block

    port, jax_ep = _match_episode(compress_block), _match_episode(jax_compress)
    LeagueLearner._mask_non_candidate(port, [1])
    JaxLeagueLearner._mask_non_candidate(jax_ep, [1])
    for blk, jblk in zip(port["blocks"], jax_ep["blocks"]):
        got, want = decompress_block(blk), jax_decompress(jblk)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["tmask"][:, 0].tolist() == [0.0] * 4 and got["tmask"][:, 1].tolist() == [1.0] * 4
        assert got["omask"][:, 0].tolist() == [0.0] * 4


def test_feed_masks_opponent_and_records_payoff(tmp_path):
    from handyrl_tpu_torch.league.learner import LeagueLearner
    from handyrl_tpu_torch.runtime.replay import compress_block, decompress_block

    learner = LeagueLearner(normalize_args(_train(tmp_path)), device="cpu")
    try:
        episode = _match_episode(compress_block)
        learner.feed_episodes([episode, None])
        assert learner.league.payoff.win_points(CANDIDATE, "main-0") == 1.0
        assert learner.league.payoff.win_points("main-0", CANDIDATE) == 0.0
        out = decompress_block(episode["blocks"][0])
        assert out["tmask"][:, 0].tolist() == [0.0] * 4 and out["prob"][:, 0].tolist() == [0.5] * 4
        assert len(learner.trainer.store) == 1
    finally:
        learner.model_server.stop()
        learner.trainer.stop()


def test_epoch_hook_records_equal_jax(tmp_path):
    """The same ledger gives the same league_* record values at three
    boundaries: gate closed (too few games), gate passed (a promotion,
    books handed to main-1), and the next candidate's fresh books."""
    learners = _learners(tmp_path)
    try:
        records = {"jax": [], "port": []}
        for name, learner in learners.items():
            payoff = learner.league.payoff
            for step, (wins, losses) in enumerate(((2, 1), (5, 1), (1, 3))):
                for _ in range(wins):
                    payoff.record_outcome({0: CANDIDATE, 1: ANCHOR}, {0: 1.0, 1: -1.0})
                for _ in range(losses):
                    payoff.record_outcome({0: CANDIDATE, 1: ANCHOR}, {0: -1.0, 1: 1.0})
                learner.model_epoch = step + 1
                record = {}
                learner._epoch_hook(record)
                records[name].append(record)
            records[name].append(sorted(learner.league.members))
        assert records["port"] == records["jax"]
        assert records["port"][1]["league_promotions"] == 1
        assert "main-2" in records["port"][-1]
        saved = json.loads((tmp_path / "port" / "models" / "LEAGUE.json").read_text())
        assert saved == json.loads((tmp_path / "jax" / "models" / "LEAGUE.json").read_text())
    finally:
        _stop(learners)


def test_league_model_server_routes_frozen_through_router(tmp_path):
    """Frozen epochs resolve to resident router engines (one disk load,
    reused), latest keeps the shared engine, id 0 is the RandomModel, and
    a missing snapshot is served by the latest, counted."""
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.league.learner import LeagueModelServer, RouterOpponent
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.runtime.checkpoint import save_epoch_snapshot

    args = dict(normalize_args(_train(tmp_path))["train_args"])
    env = make_env({"env": "TicTacToe"})
    module = env.net()
    init_variables(module, 0)
    server = LeagueModelServer(module, env, args, device="cpu")
    assert server._router.max_models >= args["league"]["max_population"] + 1
    engines = []
    try:
        params = {k: v.detach().clone() for k, v in module.state_dict().items()}
        save_epoch_snapshot(args["model_dir"], 1, params, {"note": 1}, 1)
        server.publish(1, params)
        server.publish(2, params)
        frozen = server.get(1)
        assert isinstance(frozen, RouterOpponent)
        env.reset()
        obs = env.observation(0)
        assert np.shape(frozen.inference(obs)["policy"])[-1] == 9
        assert 1 in server._router.routes()
        engines = list(server._router._engines.values())
        assert not isinstance(server.get(2), RouterOpponent)
        assert server.get(0) is server._random
        served = server._router._engines[1].stats()["requests_served"]
        server.get(1).inference(obs)
        assert server._router._engines[1].stats()["requests_served"] == served + 1
        before = server.substituted_snapshots
        os.unlink(os.path.join(args["model_dir"], "1.ckpt"))
        server._router._engines.pop(1).stop()
        RouterOpponent(server, 1).inference(obs)
        assert server.substituted_snapshots == before + 1
    finally:
        server.stop()
    # the router joined its engines' serve threads: none is left in torch
    assert engines and not any(e._thread.is_alive() for e in engines)


def test_league_learner_refuses_future_members(tmp_path):
    from handyrl_tpu_torch.league.learner import LeagueLearner

    lg = League(os.path.join(str(tmp_path), "models"))
    lg.add("main-9", 9)
    lg.save()
    with pytest.raises(ValueError, match="main-9.*restart_epoch: -1"):
        LeagueLearner(normalize_args(_train(tmp_path)), device="cpu")


def test_league_end_to_end(tmp_path):
    """A TicTacToe league at the JAX test's geometry on the CPU grows a
    population through the gate: >= 2 promotions, each frozen member's
    books covering the pool of its time, the registry reloading, the
    league_* keys in metrics.jsonl, and every frozen epoch kept by GC."""
    from handyrl_tpu_torch.league.learner import LeagueLearner

    random.seed(0)
    cfg = normalize_args(_train(
        tmp_path, epochs=8, update_episodes=24, minimum_episodes=16, keep_checkpoints=2,
        league={"promote_winrate": 0.4, "promote_games": 3, "selfplay_rate": 0.15,
                "pfsp_weighting": "var"}))
    learner = LeagueLearner(cfg, device="cpu")
    assert learner.run() == 0
    members = learner.league.members
    frozen = sorted((m for m in members.values() if m.role == "frozen"), key=lambda m: m.epoch)
    assert len(frozen) >= 2 and learner.league.promotions >= 2
    payoff = learner.league.payoff
    for i, m in enumerate(frozen):
        earlier = [ANCHOR] + [x.name for x in frozen[:i]]
        assert payoff.coverage(m.name, earlier) == 1.0, (m.name, earlier)
        assert all(payoff.games(m.name, b) >= 3 for b in earlier)
    model_dir = cfg["train_args"]["model_dir"]
    for m in frozen:   # keep_checkpoints 2 would have collected them
        assert os.path.exists(os.path.join(model_dir, f"{m.epoch}.ckpt")), m.name
    lg2 = League(model_dir)
    assert set(lg2.members) == set(members) and lg2.payoff.matches == payoff.matches
    records = [json.loads(line) for line in open(cfg["train_args"]["metrics_path"])]
    last = records[-1]
    for key in ("league_population", "league_pool", "league_matches", "league_forfeits",
                "league_payoff_coverage", "league_candidate_wp", "league_promotions"):
        assert key in last, key
    assert last["league_population"] >= 3 and last["league_promotions"] >= 2
    assert any(r.get("league_elo_spread") is not None for r in records)
    assert all(np.isfinite(r["loss"]["total"]) for r in records if "loss" in r)
    assert learner.model_server.substituted_snapshots == 0


def test_main_league_runs_the_league(tmp_path, monkeypatch):
    """``main(["--league"], device="cpu")`` and its alias ``-l`` run the
    league's learner from config.yaml."""
    import yaml

    from handyrl_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    cfg = _train(tmp_path, epochs=1, league={"promote_winrate": 0.3, "promote_games": 1})
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    assert main(["--league"], device="cpu") == 0
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert records and "league_matches" in records[-1]
    assert (tmp_path / "models" / "LEAGUE.json").exists()
    alias = tmp_path / "alias"
    alias.mkdir()
    monkeypatch.chdir(alias)
    (alias / "config.yaml").write_text(yaml.safe_dump(_train(alias, epochs=1)))
    assert main(["-l"], device="cpu") == 0
    assert (alias / "models" / "LEAGUE.json").exists()
