"""The port's data flywheel (``handyrl_tpu_torch/flywheel/``) against the JAX
package's on the CPU.

Every unit scenario feeds the same frames, outcome streams and blobs to the
JAX object and to the port's and asserts the same results: harvested
episodes byte for byte (the zlib blocks, through the wire codec), the same
drops and counters, the same gate verdicts, rollback signals and pinned
epochs.  A harvested episode also equals the self-play encoding of its
trajectory byte for byte in both packages.  The e2e runs the port's
``ServingServer`` with a ``FlywheelPlane`` over a CPU router and a port
``Learner`` on served traffic only (no self-play worker), with one snapshot
poisoned: it is staged, fails the gate or is demoted, the learner rolls
back, and the incumbent survives ``gc_snapshots``.  Exact comparisons
throughout (no tolerance): these are host-side books and bytes.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.flywheel import harvest as jax_harvest
from handyrl_tpu.flywheel import ingest as jax_ingest
from handyrl_tpu.flywheel import quality as jax_quality
from handyrl_tpu.runtime import codec as jax_codec
from handyrl_tpu.runtime.checkpoint import save_epoch_snapshot as jax_save
from handyrl_tpu.runtime.generation import Generator as JaxGenerator
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.flywheel import harvest as port_harvest
from handyrl_tpu_torch.flywheel import ingest as port_ingest
from handyrl_tpu_torch.flywheel import quality as port_quality
from handyrl_tpu_torch.runtime import codec as port_codec
from handyrl_tpu_torch.runtime.checkpoint import save_epoch_snapshot as port_save
from handyrl_tpu_torch.runtime.generation import Generator
from handyrl_tpu_torch.utils import softmax

PACKAGES = {
    "jax": (jax_harvest, jax_ingest, jax_quality, JaxGenerator, jax_make_env, jax_codec),
    "port": (port_harvest, port_ingest, port_quality, Generator, make_env, port_codec),
}


def _targs(**over):
    cfg = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": over})
    args = dict(cfg["train_args"])
    args["env"] = cfg["env_args"]
    return args


def _gen_args(targs=None):
    targs = targs or _targs()
    return {"gamma": targs["gamma"], "compress_steps": targs["compress_steps"],
            "observation": targs["observation"], "obs_int8": bool(targs.get("obs_int8", False))}


class _DetModel:
    """A fixed-weight policy/value head, a pure function of the observation."""

    def __init__(self, seed=7):
        self.W = np.random.RandomState(seed).randn(27, 9).astype(np.float32)

    def inference(self, obs, hidden=None):
        flat = np.asarray(obs, np.float32).reshape(-1)
        return {"policy": np.tanh(flat @ self.W).astype(np.float32),
                "value": np.asarray([np.tanh(float(flat.sum()))], np.float32), "hidden": None}

    def init_hidden(self):
        return None


def _selfplay_episode(pkg, seed, targs, model_id=7):
    _, _, _, gen_cls, mk_env, _ = PACKAGES[pkg]
    env = mk_env({"env": "TicTacToe"})
    model = _DetModel()
    players = env.players()
    random.seed(seed)
    args = {"player": players, "model_id": {p: model_id for p in players}}
    return gen_cls(env, targs).generate({p: model for p in players}, args)


def _harvest_episode(pkg, seed, targs, served=7, obs_spec_fn=None):
    """The self-play trajectory of ``seed`` replayed through the recorder's
    capture seams, as a scripted client's frames would drive it."""
    harvest, _, _, _, mk_env, _ = PACKAGES[pkg]
    env = mk_env({"env": "TicTacToe"})
    model = _DetModel()
    rec = harvest.HarvestRecorder(_gen_args(targs), obs_spec_fn=obs_spec_fn)
    players = env.players()
    sids = {p: f"parity-s{p}" for p in players}
    hid = rec.open_episode(players, [sids[p] for p in players])
    random.seed(seed)
    env.reset()
    while not env.terminal():
        turn_players = env.turns()
        actions, legal_lists, moves = [None] * len(players), [None] * len(players), {}
        for p in turn_players:
            j = players.index(p)
            obs = env.observation(p)
            rec.capture_request(sids[p], obs)
            out = model.inference(obs)
            rec.capture_reply(sids[p], served, {"policy": out["policy"], "value": out["value"]})
            logits = np.asarray(out["policy"], np.float32)
            legal = env.legal_actions(p)
            amask = np.full_like(logits, 1e32)
            amask[legal] = 0.0
            probs = softmax(logits - amask)
            action = random.choices(legal, weights=probs[legal])[0]
            actions[j], legal_lists[j], moves[p] = int(action), list(legal), action
        turn = turn_players[0] if turn_players else None
        env.step(moves)
        reward = env.reward()
        rec.step(hid, actions, legal_lists, [reward.get(p) for p in players], turn)
    outcome = env.outcome()
    return rec.close(hid, [float(outcome.get(p, 0.0)) for p in players])


@pytest.mark.parametrize("seed", [11, 23, 37])
@pytest.mark.parametrize("obs_int8", [False, True])
def test_harvested_episode_equals_selfplay_and_jax_byte_for_byte(seed, obs_int8):
    from handyrl_tpu_torch.models.quantize import obs_quant_spec

    targs = _targs(obs_int8=obs_int8)
    spec_fn = (lambda obs: obs_quant_spec(make_env({"env": "TicTacToe"}), obs=obs)
               ) if obs_int8 else None
    ep_self = _selfplay_episode("port", seed, targs)
    ep_harv = _harvest_episode("port", seed, targs, obs_spec_fn=spec_fn)
    jax_self = _selfplay_episode("jax", seed, dict(targs, mesh={"dp": 1}))
    assert ep_harv["blocks"] == ep_self["blocks"] == jax_self["blocks"]
    assert ep_harv["steps"] == ep_self["steps"] and ep_harv["outcome"] == ep_self["outcome"]
    # through the wire codec the harvest_pull frame carries, in both packages
    wire = port_codec.loads(port_codec.dumps(ep_harv))
    assert wire["blocks"] == ep_self["blocks"]
    assert jax_codec.loads(port_codec.dumps(ep_harv))["blocks"] == jax_self["blocks"]
    assert ep_harv["args"]["harvest"] is True and ep_harv["model_epoch"] == 7
    if obs_int8:
        np.testing.assert_array_equal(ep_harv["obs_scale"], ep_self["obs_scale"])
        np.testing.assert_array_equal(ep_harv["obs_zero"], jax_self["obs_zero"])
    if not obs_int8:   # the JAX recorder builds the same bytes from the same frames
        assert _harvest_episode("jax", seed, dict(targs, mesh={"dp": 1}))["blocks"] == \
            ep_harv["blocks"]


def _valid_row(rec, hid, sid="sa", player_slot=0, n_players=2):
    obs = np.zeros((3, 3, 3), np.float32)
    rec.capture_request(sid, obs)
    rec.capture_reply(sid, 3, {"policy": np.zeros(9, np.float32),
                               "value": np.zeros(1, np.float32)})
    actions = [None] * n_players
    legal = [None] * n_players
    actions[player_slot], legal[player_slot] = 4, [0, 4, 8]
    return rec.step(hid, actions, legal, [None] * n_players, player_slot)


def _recorder_scenarios(pkg):
    """Every guard of the recorder, driven by the same frames; returns what
    each step answered and the counters."""
    harvest = PACKAGES[pkg][0]
    log = []

    def answer(fn, *a):
        try:
            out = fn(*a)
        except harvest.HarvestError as exc:
            return ("HarvestError", str(exc).split(" ")[0])
        if isinstance(out, dict):
            return ("episode", out["steps"], out["blocks"], out["model_epoch"])
        return out

    rec = harvest.HarvestRecorder(_gen_args())
    log += [answer(rec.open_episode, [], []), answer(rec.open_episode, [0, 1], ["only"]),
            answer(rec.step, "h999", [0], [[0]], [None], 0), answer(rec.close, "h999", [1.0])]
    # arity mismatch, an action without a captured policy
    hid = rec.open_episode([0, 1], ["sa", "sb"])
    log += [_valid_row(rec, hid), answer(rec.step, hid, [0], [[0]], [None], 0),
            answer(rec.close, hid, [1.0, -1.0])]
    hid = rec.open_episode([0, 1], ["sc", "sd"])
    log += [answer(rec.step, hid, [0, None], [[0, 1], None], [None, None], 0),
            answer(rec.close, hid, [1.0, -1.0])]
    # truncations: no outcome, a mis-sized one, no step
    for sids, outcome, rows in ((["se", "sf"], None, 1), (["sg", "sh"], [1.0], 1),
                                (["si", "sj"], [1.0, -1.0], 0)):
        hid = rec.open_episode([0, 1], sids)
        if rows:
            _valid_row(rec, hid, sid=sids[0])
        log.append(answer(rec.close, hid, outcome))
    # kept episodes and the pull
    for sid in ("p1", "p2"):
        hid = rec.open_episode([0], [sid])
        _valid_row(rec, hid, sid=sid, n_players=1)
        log.append(answer(rec.close, hid, [1.0]))
    eps, counts = rec.pull(max_episodes=1)
    log += [[e["blocks"] for e in eps], counts]
    log += [len(rec.pull(8)[0]), rec.pull()[0], rec.stats()]
    # the TTL sweep and the open-episode cap
    ttl = harvest.HarvestRecorder(_gen_args(), ttl_s=5.0)
    hid = ttl.open_episode([0, 1], ["a", "b"])
    log += [ttl.sweep(now=time.monotonic() + 1.0), ttl.sweep(now=time.monotonic() + 60.0),
            answer(ttl.close, hid, [1.0, -1.0]), ttl.stats()]
    cap = harvest.HarvestRecorder(_gen_args(), max_open=2)
    h1 = cap.open_episode([0], ["m1"])
    cap.open_episode([0], ["m2"])
    cap.open_episode([0], ["m3"])
    log += [cap.stats(), answer(cap.close, h1, [1.0])]
    return log


def test_recorder_guards_match_jax(capsys):
    port, jax = _recorder_scenarios("port"), _recorder_scenarios("jax")
    assert port == jax
    counts = port[-4 - 4 - 2]   # the last pull's books
    assert counts["flywheel_dropped_malformed"] == 2
    assert counts["flywheel_dropped_truncated"] == 3 and counts["flywheel_episodes"] == 2
    out = capsys.readouterr().out
    assert "malformed" in out and "truncated" in out


def _blob(epoch):
    return {"args": {}, "steps": 1, "players": [0], "outcome": {0: 1.0}, "blocks": [b""],
            "model_epoch": epoch}


def _ingest_scenarios(pkg):
    ingest = PACKAGES[pkg][1]
    log = []

    def make(fraction, update_episodes, staleness, epoch):
        got, box = [], [epoch]
        ing = ingest.HarvestIngestor(
            {"harvest_fraction": fraction, "update_episodes": update_episodes,
             "staleness_epochs": staleness, "harvest_poll_s": 0.01, "harvest_max_pull": 8},
            submit=got.extend, current_epoch=lambda: box[0], make_client=lambda: None)
        return ing, got, box

    ing, got, _ = make(1.0, 0, 4, 10)
    log += [ing.ingest([{"bogus": 1}, "not-a-dict", _blob(10)]), len(got), ing.stats()]
    ing, got, _ = make(1.0, 0, 4, 10)
    log += [ing.ingest([_blob(6)]), ing.ingest([_blob(7)]), ing.stats(),
            [e["model_epoch"] for e in got]]
    ing, got, box = make(0.5, 8, 100, 5)
    log += [ing.epoch_budget, ing.ingest([_blob(5) for _ in range(6)]),
            ing.ingest([_blob(5)])]
    box[0] = 6
    log += [ing.ingest([]), len(got), ing.stats()]
    ing, got, _ = make(1.0, 8, 4, 10)
    log += [ing.epoch_budget, ing.ingest([_blob(10) for _ in range(50)]), len(got)]
    return log


def test_ingest_guards_match_jax(capsys):
    port, jax = _ingest_scenarios("port"), _ingest_scenarios("jax")
    assert port == jax
    assert port[0] == 1 and port[2]["flywheel_ingest_malformed"] == 2
    assert port[10:13] == [3, 7, {"flywheel_ingested": 7, "flywheel_ingest_stale": 0,
                                  "flywheel_ingest_malformed": 0}]


def test_ingest_poll_reconnects_after_transport_faults():
    """The poll loop reconnects through utils/retry.py: a serving tier that
    refuses connections, then drops one mid-pull, then serves, loses no
    episode that reached the learner and raises nothing."""
    attempts, got = [], []

    class _Client:
        def __init__(self, fail):
            self.fail = fail

        def harvest_pull(self, n):
            if self.fail:
                self.fail = False
                raise ConnectionResetError("dropped")
            return ([_blob(3)] if not got else []), {"flywheel_episodes": 1}

        def close(self):
            pass

    def make_client():
        attempts.append(1)
        if len(attempts) <= 2:
            raise ConnectionRefusedError("not up yet")
        return _Client(fail=len(attempts) == 3)

    ing = port_ingest.HarvestIngestor({"harvest_fraction": 1.0, "harvest_poll_s": 0.01},
                                      submit=got.extend, current_epoch=lambda: 3,
                                      make_client=make_client).start()
    deadline = time.monotonic() + 30
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    ing.stop()
    assert [e["model_epoch"] for e in got] == [3]
    assert len(attempts) >= 4 and ing.stats()["flywheel_episodes"] == 1
    assert not ing._thread.is_alive()


class _StubRouter:
    """The routing table of ModelRouter's gate surface."""

    def __init__(self, template=None):
        self._template = template
        self._latest = self._candidate = self._incumbent = None
        self.staged = []
        self.refreshed = None

    def latest_id(self):
        return self._latest

    def candidate_id(self):
        return self._candidate

    def incumbent_id(self):
        return self._incumbent

    def _params_template(self):
        return self._template

    def stage(self, model_id, params, warm=True):
        self._candidate = int(model_id)
        self.staged.append((int(model_id), float(np.asarray(params["w"]).reshape(-1)[0])))

    def promote_candidate(self):
        self._incumbent, self._latest = self._latest, self._candidate
        self._candidate = None
        return self._latest

    def demote_candidate(self):
        demoted, self._candidate = self._candidate, None
        return demoted

    def demote_latest(self):
        bad = self._latest
        self._latest, self._incumbent = self._incumbent, None
        return bad

    def maybe_refresh(self):
        return self.refreshed


def _save(pkg, model_dir, epoch, fill):
    if pkg == "jax":
        jax_save(model_dir, epoch, {"w": np.full((2, 2), fill, np.float32)}, {"test": 0}, 0)
    else:
        port_save(model_dir, epoch, {"w": torch.full((2, 2), fill)}, {"test": 0}, 0)


# (outcome stream, saves, tick) scripts of the gate and the sentinel: each
# item is ("save", epoch, fill), ("out", epoch, outcome) or ("tick",)
GATE_SCRIPTS = {
    "promote": ({}, None, [("save", 1, 1.0), ("tick",), ("tick",),
                           ("out", 1, 1.0), ("out", 1, 1.0), ("out", 1, 1.0), ("out", 1, -1.0),
                           ("tick",)]),
    "gate_fail": ({}, 5, [("save", 6, 6.0), ("tick",)] + [("out", 6, -1.0)] * 4
                  + [("tick",), ("tick",)]),
    "sentinel": ({"promote_games": 2}, 1, [("out", 1, 1.0)] * 3 + [
        ("save", 2, 2.0), ("tick",), ("out", 2, 1.0), ("out", 2, 1.0), ("tick",)]
        + [("out", 2, -1.0)] * 3 + [("tick",), ("tick",)]),
    "canary": ({"promote_games": 2, "quality_window": 3}, 1, [("out", 1, 1.0)] * 3 + [
        ("save", 2, 2.0), ("tick",), ("out", 2, 1.0), ("out", 2, 1.0), ("tick",)]
        + [("out", 2, 1.0), ("tick",)] * 12 + [("out", 2, -1.0), ("tick",)] * 20),
    "gate_off": ({"gate_promotions": False}, None, [("tick",)]),
}


def _gate_run(pkg, model_dir, over, latest, script):
    quality = PACKAGES[pkg][2]
    router = _StubRouter()
    router._latest = latest
    router.refreshed = 4
    cfg = {"gate_promotions": True, "promote_winrate": 0.6, "promote_games": 4,
           "quality_window": 3, "demote_drop": 0.1}
    cfg.update(over)
    qc = quality.QualityController(router, model_dir, cfg)
    events = []
    for step in script:
        if step[0] == "save":
            _save(pkg, model_dir, step[1], step[2])
        elif step[0] == "out":
            qc.record_outcome(step[1], step[2])
        else:
            events.append(qc.tick())
    stats = qc.stats_record()
    routes = (router.latest_id(), router.candidate_id(), router.incumbent_id())
    return (events, stats, router.staged, routes, quality.read_rollback_signal(model_dir),
            sorted(quality.serving_pinned_epochs(model_dir)))


@pytest.mark.parametrize("name", sorted(GATE_SCRIPTS))
def test_gate_and_sentinel_verdicts_match_jax(tmp_path, name):
    over, latest, script = GATE_SCRIPTS[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    got = _gate_run("port", str(tmp_path / "port"), over, latest, script)
    want = _gate_run("jax", str(tmp_path / "jax"), over, latest, script)
    assert got == want
    events, stats, _, routes, signal, _ = got
    expect = {"promote": ("quality_promotions", 1), "gate_fail": ("quality_gate_failures", 1),
              "sentinel": ("quality_demotions", 1), "canary": ("quality_demotions", 0),
              "gate_off": ("quality_promotions", 0)}[name]
    assert stats[expect[0]] == expect[1]
    if name == "gate_fail":
        assert signal == {"seq": 1, "bad_epoch": 6, "target_epoch": 5, "reason": "gate_failed"}
    if name == "sentinel":
        assert signal["reason"] == "quality_regression" and routes[0] == 1
    if name == "gate_off":
        assert events == ["published epoch 4"]


def test_ledger_signals_and_pins_match_jax(tmp_path):
    def run(pkg, d):
        quality = PACKAGES[pkg][2]
        ledger = quality.QualityLedger(window=8)
        for epoch, outcome in ((0, 1.0), (-1, 1.0), (2, 1.0), (2, -1.0), (3, 0.0)):
            ledger.record(epoch, outcome)
        qc = quality.QualityController(_StubRouter(), d, {})
        try:
            qc.record_outcome("five", "lost")
            bad = None
        except ValueError as exc:
            bad = str(exc)
        seqs = [quality.write_rollback_signal(d, 3, 2, "gate_failed"),
                quality.write_rollback_signal(d, 5, 4, "quality_regression")]
        pins = []
        for state in ((3, None, 2), (0, -1, 4)):
            quality.write_serving_state(d, *state)
            pins.append(sorted(quality.serving_pinned_epochs(d)))
        return (ledger.total_games(), ledger.games(2), ledger.win_points(2), ledger.ema(2),
                ledger.snapshot(), bad, seqs, quality.read_rollback_signal(d), pins)

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert run("port", str(tmp_path / "a")) == run("jax", str(tmp_path / "b"))


@pytest.mark.parametrize("knob, value, match", [
    ("harvest_fraction", 1.5, "must be in \\[0, 1\\]"),
    ("staleness_epochs", 0, "staleness_epochs"),
    ("promote_winrate", 1.0, "must be in \\(0, 1\\)"),
    ("harvest_port", "9997", "TCP port"),
    ("harvest_poll_s", 0.0, "must be > 0"),
    ("gate_promotions", 1, "must be a bool"),
])
def test_flywheel_config_validation_matches_jax(knob, value, match):
    raw = {"env_args": {"env": "TicTacToe"}, "train_args": {"flywheel": {knob: value}}}
    for normalize in (normalize_args, jax_normalize_args):
        with pytest.raises(ValueError, match=match):
            normalize(raw)


# -- the e2e: served traffic only, a poisoned snapshot ------------------------


def _harvest_game(client, env, rng, model=-1):
    players = env.players()
    sids = [client.open_session() for _ in players]
    hid = client.harvest_open(players, sids)
    env.reset()
    while not env.terminal():
        turn_players = env.turns()
        actions, legal_lists, moves = [None] * len(players), [None] * len(players), {}
        for p in turn_players:
            j = players.index(p)
            reply = client.infer(env.observation(p), model=model, sid=sids[j])
            logits = np.asarray(reply["out"]["policy"], np.float32).reshape(-1)
            legal = list(env.legal_actions(p))
            amask = np.full_like(logits, 1e32)
            amask[legal] = 0.0
            probs = softmax(logits - amask)
            action = rng.choices(legal, weights=[float(probs[a]) for a in legal])[0]
            actions[j], legal_lists[j], moves[p] = int(action), legal, int(action)
        turn = turn_players[0] if turn_players else None
        env.step(moves)
        reward = env.reward()
        client.harvest_step(hid, actions, legal_lists, [reward.get(p) for p in players], turn)
    outcome = env.outcome()
    kept = client.harvest_close(hid, [float(outcome.get(p, 0.0)) for p in players])
    for sid in sids:
        client.close_session(sid)
    return kept


def test_flywheel_e2e_on_the_cpu(tmp_path, monkeypatch):
    """A port ServingServer with the flywheel, scripted clients playing
    harvest games and reporting outcomes, and a port Learner training on the
    harvested episodes only; epoch 2's snapshot is poisoned."""
    from handyrl_tpu_torch.flywheel import FlywheelPlane
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.learner import Learner
    from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingError, ServingServer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH", "2")
    fly = {"enabled": True, "harvest_fraction": 1.0, "staleness_epochs": 8,
           "harvest_poll_s": 0.1, "harvest_max_pull": 256, "promote_winrate": 0.45,
           "promote_games": 6, "quality_window": 8, "demote_drop": 0.25, "shadow_fraction": 1.0}
    serving = {"port": 0, "slo_ms": 5000.0, "shed_policy": "none", "max_batch": 8,
               "max_wait_ms": 1.0, "warm_buckets": [1, 2], "watch_interval": 0.1,
               "stats_interval": 0.0}
    env = make_env({"env": "TicTacToe"})
    module = env.net()
    env.reset()
    router = ModelRouter(module, env.observation(0), serving, model_dir="models",
                         devices=["cpu"])
    router.publish(0, init_variables(module, 0).state_dict())
    plane = FlywheelPlane(router, "models", fly, _gen_args())
    server = ServingServer(router, serving, flywheel=plane).run()
    stop, errors, kept = threading.Event(), [], []

    def client_loop(idx):
        rng = random.Random(100 + idx)
        game_env = make_env({"env": "TicTacToe"})
        client = ServingClient("127.0.0.1", server.bound_port)
        try:
            g = 0
            while not stop.is_set():
                g += 1
                try:
                    kept.append(_harvest_game(client, game_env, rng))
                    if g % 2 == 0:   # the served epoch's books
                        served = client.infer(game_env.observation(0))["model"]
                        if isinstance(served, int) and served > 0:
                            # the scripted verdict: clean snapshots win their
                            # games, the poisoned one loses them
                            client.report_outcome(served, -1.0 if served == 2 else 1.0)
                except ServingError:
                    continue
        except Exception as exc:
            if not stop.is_set():
                errors.append(f"{type(exc).__name__}: {exc}")
        finally:
            client.close()

    threads = [threading.Thread(target=client_loop, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
            "batch_size": 16, "forward_steps": 4, "minimum_episodes": 16,
            "update_episodes": 16, "epochs": 4, "num_batchers": 1, "keep_checkpoints": 1,
            "worker": {"num_parallel": 0}, "metrics_path": "metrics.jsonl",
            "flywheel": dict(fly, harvest_port=server.bound_port)}})
        learner = Learner(args, device="cpu")
        deadline = time.monotonic() + 240
        learner_thread = threading.Thread(target=learner.run, daemon=True)
        learner_thread.start()
        # the gate's verdict on the poisoned epoch 2 reaches the learner at a
        # later boundary
        while learner_thread.is_alive() and time.monotonic() < deadline:
            learner_thread.join(0.5)
        assert not learner_thread.is_alive(), "the learner did not finish"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        server.shutdown()
    assert not errors, errors
    records = [json.loads(line) for line in open("metrics.jsonl")]
    assert all(np.isfinite(r["loss"]["total"]) for r in records if r.get("loss"))
    assert max(r.get("flywheel_ingested", 0) for r in records) >= 16
    assert server.errors.get("error", 0) == 0
    quality = plane.quality
    assert quality.gate_failures + quality.demotions >= 1, quality.stats_record()
    signal = port_quality.read_rollback_signal("models")
    assert signal is not None and signal["bad_epoch"] == 2
    assert max(r.get("flywheel_rollbacks", 0) for r in records) >= 1
    assert learner.trainer.sentinel_events["sentinel_flywheel_rollbacks"] >= 1
    # the incumbent the serving tier routes survived gc_snapshots (keep 1)
    for epoch in port_quality.serving_pinned_epochs("models"):
        assert ckpt.verify_snapshot("models", epoch) is not False
        assert (tmp_path / "models" / f"{epoch}.ckpt").exists()
