"""The port's on-card replay (runtime/device_replay.py) on the CPU, against
the JAX package's and against the port's own host path.

* The same records (the port's streaming rollouts, as numpy) go into the
  JAX ``DeviceReplay`` and the port's: the rings after every ingest are
  equal leaf for leaf, through a ring wrap and with one ingest longer than
  the ring; the ingest stats are equal (counts exactly, outcome sums
  within 1e-5: fp32 sums in another order); ``_eligibility`` is equal.
* With the JAX draws of the same key put in place of the port's
  (``_draw_starts``, ``_draw_players``), ``_sample_batch`` and
  ``_sample_batch_turn`` equal the JAX ones key by key: ints and bools
  exactly, floats within 1e-6.
* The port's sampled windows equal the port's ``make_batch`` on the same
  episode, window start and target player (JAX
  ``test_sampled_windows_match_make_batch``), within 1e-6.
* One ``train_fn`` update from equal rings and converted params matches
  JAX's: the loss within 1e-5 relative, the updated params within 1e-5
  relative (plus 1e-2 * lr absolute) where the first gradient is >= 1e-6
  and within lr elsewhere (Adam's first step is sign-like there and
  rounding may flip it), for GeeseNet ff, the DRC turn mode and the small
  transformer's turn mode with ``seq_attention: flash`` (the port's plain
  B1 against JAX's Pallas kernel in interpret mode).
* The return-to-go of rows far past the episode end stays finite (zero),
  where the JAX closed form overflows to NaN.
* Deferred stats equal synchronous ones; a batch is a copy (a later ingest
  leaves it alone); rings stay plain tensors when the first ingest runs in
  inference mode; the constructor refuses what the JAX one refuses, with
  the same messages; the learner runs end to end under ``device_replay:
  true`` (HungryGeese with local workers, which only evaluate; Geister
  as a train server with no worker).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.envs.vector_geister import VectorGeister as JaxGeister
from handyrl_tpu.envs.vector_hungry_geese import VectorHungryGeese as JaxGeese
from handyrl_tpu.envs.vector_tictactoe import VectorTicTacToe as JaxTTT
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.models.nets import GeeseNet as JaxGeeseNet
from handyrl_tpu.models.nets import GeisterNet as JaxGeisterNet
from handyrl_tpu.parallel import TrainContext as JaxTrainContext
from handyrl_tpu.parallel import make_mesh
from handyrl_tpu.runtime import device_replay as jax_replay_mod
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import GeeseNet, GeisterNet, flax_to_state_dict, init_variables
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import device_replay
from handyrl_tpu_torch.runtime.batch import make_batch
from handyrl_tpu_torch.runtime.device_replay import DeviceReplay, _eligibility
from handyrl_tpu_torch.runtime.device_rollout import _streaming_episode, build_streaming_fn
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.utils import tree_leaves

LR = 1e-3
GEESE = {"turn_based_training": False, "observation": False, "batch_size": 8,
         "forward_steps": 8, "burn_in_steps": 0}
GEISTER = {"turn_based_training": True, "observation": True, "batch_size": 4,
           "forward_steps": 4, "burn_in_steps": 4}
TRANSFORMER = {"net": "transformer",
               "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 8}}
# env -> (train args, lanes, k_steps, calls, slots, port net); calls * k_steps > slots
SETUPS = {
    "HungryGeese": (GEESE, 8, 32, 10, 192, lambda: GeeseNet(filters=8, blocks=2)),
    "Geister": (GEISTER, 4, 32, 16, 256,
                lambda: GeisterNet(filters=8, drc_layers=1, drc_repeats=1)),
}
JAX_TWINS = {"HungryGeese": JaxGeese, "Geister": JaxGeister}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _args(env_name, train_args, normalize=normalize_args, env_args=None):
    cfg = normalize({"env_args": dict({"env": env_name}, **(env_args or {})),
                     "train_args": dict(train_args, mesh={"dp": 1})})
    return dict(cfg["train_args"], env=cfg["env_args"])


@functools.lru_cache(maxsize=None)
def _records(env_name):
    """The port's streaming records of one setup: a list of numpy (K, B,
    ...) chunks, and the finished episodes with their [lane, g0, g1] spans,
    assembled by the port's host path."""
    train_args, lanes, k_steps, calls, _, net = SETUPS[env_name]
    args = _args(env_name, train_args)
    venv = make_env({"env": env_name}).vector_env()
    module = init_variables(net(), 0).eval()
    fn = build_streaming_fn(venv, module, lanes, k_steps, use_observe_mask=args["observation"])
    gen = torch.Generator().manual_seed(1)
    chunks = []
    with torch.inference_mode():
        state = venv.init(lanes, gen, "cpu")
        hidden = module.initial_state((lanes, venv.num_players))
        for _ in range(calls):
            state, hidden, rec = fn(state, hidden, gen)
            chunks.append({k: v.numpy() for k, v in rec.items()})
    full = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    episodes = []
    for b in range(lanes):
        g0 = 0
        for g1 in np.flatnonzero(full["done"][:, b]):
            g1 = int(g1)
            episodes.append((b, g0, g1, _streaming_episode(venv, [(full, g0, g1 + 1)], full, g1,
                                                           b, args)))
            g0 = g1 + 1
    assert len(episodes) >= 8, len(episodes)
    return chunks, episodes, args, venv


def _replays(env_name, chunks, args, venv):
    """A JAX and a port DeviceReplay fed the same chunks; each ingest's stats."""
    train_args, lanes, _, _, slots, _ = SETUPS[env_name]
    jax_venv = JAX_TWINS[env_name]
    jmodule = jax_make_env({"env": env_name}).net()
    jreplay = jax_replay_mod.DeviceReplay(jax_venv, jmodule, _args(env_name, train_args,
                                                                  jax_normalize_args),
                                          make_mesh({"dp": 1}), lanes, slots=slots)
    replay = DeviceReplay(venv, SETUPS[env_name][5](), args, lanes, slots=slots, device="cpu")
    stats = []
    for chunk in chunks:
        jstats = jax.tree.map(np.asarray, jreplay.ingest(chunk))
        stats.append((replay.ingest(chunk).numpy(), jstats))
    return jreplay, replay, stats


@pytest.fixture(scope="module", params=sorted(SETUPS))
def data(request):
    # made before the function fixture _few_threads, so it limits the
    # threads itself: a worker of a parallel run shares the cores
    env_name = request.param
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        chunks, episodes, args, venv = _records(env_name)
        jreplay, replay, stats = _replays(env_name, chunks, args, venv)
    finally:
        torch.set_num_threads(threads)
    return {"env": env_name, "chunks": chunks, "episodes": episodes, "args": args,
            "venv": venv, "jreplay": jreplay, "replay": replay, "stats": stats}


def _assert_rings_equal(rings, jrings):
    jrings = jax.tree.map(np.asarray, jrings)
    assert rings["g"] == int(jrings["g"])
    for key in ("ep_start_g", "ep_end_g", "valid", "cur_start_g"):
        assert rings[key].numpy().dtype == jrings[key].dtype, key
        np.testing.assert_array_equal(rings[key].numpy(), jrings[key], err_msg=key)
    assert sorted(rings["rec"]) == sorted(jrings["rec"])
    for key, ring in rings["rec"].items():
        assert ring.numpy().dtype == jrings["rec"][key].dtype, key
        np.testing.assert_array_equal(ring.numpy(), jrings["rec"][key], err_msg=key)


def _assert_stats_equal(stats, jstats):
    for key in ("episodes", "game_steps", "player_steps"):
        assert int(stats[key]) == int(jstats[key]), key
    for key in ("outcome_sum", "outcome_sq_sum"):
        np.testing.assert_allclose(stats[key], jstats[key], rtol=1e-6, atol=1e-5, err_msg=key)


# -- ingest and eligibility ------------------------------------------------------


def test_rings_and_stats_equal_jax_through_a_wrap(data):
    G = sum(c["done"].shape[0] for c in data["chunks"])
    assert G > data["replay"].slots, "the ring must wrap"
    _assert_rings_equal(data["replay"].rings, data["jreplay"].rings)
    for stats, jstats in data["stats"]:
        _assert_stats_equal(stats, jstats)
    assert sum(int(s["episodes"]) for s, _ in data["stats"]) == len(data["episodes"])


@pytest.mark.parametrize("split", [50, 250])
def test_an_ingest_longer_than_the_ring_equals_jax(split):
    """Two ingests of 50 + 270 and 250 + 70 steps into 192 slots: the JAX
    scan writes every step, the port only the last S of a block."""
    chunks, _, args, venv = _records("HungryGeese")
    full = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    parts = [{k: v[:split] for k, v in full.items()}, {k: v[split:] for k, v in full.items()}]
    jreplay, replay, stats = _replays("HungryGeese", parts, args, venv)
    _assert_rings_equal(replay.rings, jreplay.rings)
    for s, js in stats:
        _assert_stats_equal(s, js)


def test_eligibility_equals_jax(data):
    args = data["args"]
    ok = _eligibility(data["replay"].rings, args["forward_steps"], args["burn_in_steps"])
    jok = jax_replay_mod._eligibility(data["jreplay"].rings, args["forward_steps"],
                                      args["burn_in_steps"])
    assert ok.any()
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert data["replay"].eligible_count() == int(np.asarray(jok).sum())


# -- sampling ------------------------------------------------------------------


def _use_jax_draws(monkeypatch, info, slots):
    """Put the JAX draws of one sample in place of the port's."""
    flat = torch.as_tensor(info["lane"].astype(np.int64) * slots + info["slot"].astype(np.int64))
    player = torch.as_tensor(info["player"].astype(np.int64))
    monkeypatch.setattr(device_replay, "_draw_starts", lambda gen, ok, n: flat[:n].clone())
    monkeypatch.setattr(device_replay, "_draw_players", lambda gen, n, P, device: player[:n].clone())


MASKS = ("episode_mask", "turn_mask", "observation_mask", "action_mask")


def _assert_batch_equal(batch, jbatch, rows=None):
    assert sorted(batch) == sorted(jbatch)
    for key in jbatch:
        got, want = tree_leaves(batch[key]), jax.tree.leaves(jbatch[key])
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            g = g.numpy() if rows is None else g.numpy()[rows]
            w = np.asarray(w)
            assert g.shape == w.shape, (key, g.shape, w.shape)
            if w.dtype.kind in "biu" or key in MASKS:
                assert g.dtype == w.dtype, key
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)


def test_sampled_batch_equals_jax(data, monkeypatch):
    jbatch, info = data["jreplay"].sample(jax.random.PRNGKey(7), 24, with_info=True)
    _use_jax_draws(monkeypatch, info, data["replay"].slots)
    batch, port_info = data["replay"].sample(torch.Generator(), 24, with_info=True)
    np.testing.assert_array_equal(port_info["lane"], info["lane"])
    np.testing.assert_array_equal(port_info["slot"], info["slot"])
    _assert_batch_equal(batch, jbatch)


def test_step_returns_stay_finite_far_past_the_episode_end():
    """A window reaching 600 rows past its episode's end (forward_steps 512
    over ~170-ply Geister games): the port's return-to-go stays finite and
    zero past the end, and on live rows equals the host path's reverse
    accumulation; the JAX product gives NaN there (0 * inf)."""
    venv = make_env({"env": "Geister"}).vector_env()
    ep_end = torch.tensor([9], dtype=torch.int32)
    gstep = torch.arange(610, dtype=torch.int32)[None]
    live_b = gstep <= ep_end[:, None]
    w = {"ep_end": ep_end, "gstep": gstep, "live_b": live_b, "live": live_b.float()}
    reward, ret = device_replay._step_returns(venv, 0.8, w)
    assert torch.isfinite(ret).all() and not ret[0, 10:].any() and not reward[0, 10:].any()
    acc, want = 0.0, []
    for _ in range(10):
        acc = -0.01 + 0.8 * acc
        want.append(acc)
    np.testing.assert_allclose(ret[0, :10].numpy(), want[::-1], rtol=1e-5)
    _, jret = jax_replay_mod._step_returns(JaxGeister, 0.8, {k: v.numpy() for k, v in w.items()})
    assert np.isnan(np.asarray(jret)[0, 500:]).all()
    np.testing.assert_allclose(ret[0, :10].numpy(), np.asarray(jret)[0, :10], rtol=1e-6)


def _host_window(ep, train_start, args):
    """The sample_window dict of the replay for a forced train_start."""
    fwd, cs = args["forward_steps"], args["compress_steps"]
    start = max(0, train_start - args["burn_in_steps"])
    end = min(train_start + fwd, ep["steps"])
    first_block, last_block = start // cs, (end - 1) // cs + 1
    return {"args": ep["args"],
            "outcome": np.asarray([ep["outcome"][p] for p in ep["players"]], np.float32),
            "players": ep["players"], "blocks": ep["blocks"][first_block:last_block],
            "base": first_block * cs, "start": start, "end": end, "train_start": train_start,
            "total": ep["steps"]}


def test_sampled_windows_match_make_batch(data, monkeypatch):
    """Each sampled row equals the port's make_batch of the same episode,
    window start and target player (the host path on the same records)."""
    replay, args = data["replay"], data["args"]
    S, G = replay.slots, replay.rings["g"]
    batch, info = replay.sample(torch.Generator().manual_seed(3), 32, with_info=True)
    for i in range(32):
        lane, slot, player = (int(info[k][i]) for k in ("lane", "slot", "player"))
        gs0 = G - 1 - ((G - 1 - slot) % S)
        hits = [e for e in data["episodes"] if e[0] == lane and e[1] <= gs0 <= e[2]]
        assert hits, f"row {i} maps to no finished episode"
        _, g0, _, ep = hits[0]
        train_start = gs0 - g0
        assert train_start <= max(0, ep["steps"] - args["forward_steps"])
        if player >= 0:
            monkeypatch.setattr("handyrl_tpu_torch.runtime.batch.random.randrange",
                                lambda _n, p=player: p)
        host = make_batch([_host_window(ep, train_start, args)], args)
        for key in host:
            for hl, dl in zip(tree_leaves(host[key]), tree_leaves(batch[key])):
                np.testing.assert_allclose(dl.numpy()[i:i + 1], hl, rtol=0, atol=1e-6,
                                           err_msg=f"{key} row {i}")


def test_a_batch_is_a_copy_of_the_rings(data):
    """The rings are written in place: a batch sampled before an ingest is
    left as it was."""
    chunks, args = data["chunks"], data["args"]
    _, lanes, _, _, slots, net = SETUPS[data["env"]]
    replay = DeviceReplay(data["venv"], net(), args, lanes, slots=slots, device="cpu")
    for chunk in chunks[:-2]:
        replay.ingest(chunk)
    batch = replay.sample(torch.Generator().manual_seed(0), 16)
    kept = [leaf.clone() for leaf in tree_leaves(batch)]
    for chunk in chunks[-2:]:
        replay.ingest(chunk)
    assert all(torch.equal(leaf, k) for leaf, k in zip(tree_leaves(batch), kept))


def test_rings_are_plain_tensors_under_inference_mode(data):
    """The rollout thread ingests in inference mode; the trainer samples and
    back-propagates outside it."""
    _, lanes, _, _, slots, net = SETUPS[data["env"]]
    replay = DeviceReplay(data["venv"], net(), data["args"], lanes, slots=slots, device="cpu")
    with torch.inference_mode():
        for chunk in data["chunks"]:
            replay.ingest({k: torch.from_numpy(v) for k, v in chunk.items()})
    assert not any(t.is_inference() for t in tree_leaves(replay.rings) if torch.is_tensor(t))
    ctx = TrainContext(net(), data["args"], device="cpu")
    metrics = replay.train_fn(ctx, 2)(torch.Generator().manual_seed(1), LR)
    assert np.isfinite(metrics["total"]) and metrics["dcnt"] > 0 and metrics["sentinel_bad"] == 0


def test_ingest_counted_deferred_matches_sync(data):
    _, lanes, _, _, slots, net = SETUPS[data["env"]]
    sync = DeviceReplay(data["venv"], net(), data["args"], lanes, slots=slots, device="cpu")
    deferred = DeviceReplay(data["venv"], net(), data["args"], lanes, slots=slots, device="cpu")
    returned = 0
    for chunk in data["chunks"]:
        sync.ingest_counted(chunk)
        out = deferred.ingest_counted(chunk, defer=True)
        returned += int(out["episodes"]) if out is not None else 0
        assert deferred.counters["episodes"] <= sync.counters["episodes"]
    tail = deferred.flush_counted()
    assert tail is not None and deferred.flush_counted() is None
    returned += tail["episodes"]
    assert deferred.counters == sync.counters
    assert returned == sync.counters["episodes"] == len(data["episodes"])


# -- one update from the rings against JAX -----------------------------------------


def _train_pair(env_name, env_args=None, train_args=None):
    """(JAX module, JAX params, port module) of the setup's net, the weights
    carried across."""
    if env_args:
        jmodule = jax_make_env(dict({"env": env_name}, **env_args)).net()
        module = make_env(dict({"env": env_name}, **env_args)).net()
    elif env_name == "HungryGeese":
        jmodule, module = JaxGeeseNet(filters=8, blocks=2), GeeseNet(filters=8, blocks=2)
    else:
        jmodule = JaxGeisterNet(filters=8, drc_layers=1, drc_repeats=1)
        module = GeisterNet(filters=8, drc_layers=1, drc_repeats=1)
    params = jax_init_variables(jmodule, jax_make_env({"env": env_name}), seed=5)["params"]
    params = jax.tree.map(np.asarray, params)
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodule, params, module


@pytest.mark.parametrize("case", ["HungryGeese", "Geister", "Geister-transformer-flash"])
def test_train_fn_update_matches_jax(case, monkeypatch):
    env_name = case.split("-")[0]
    train_args, _, _, _, slots, _ = SETUPS[env_name]
    env_args = TRANSFORMER if "transformer" in case else None
    extra = {"seq_attention": "flash"} if env_args else {}
    chunks, _, _, venv = _records(env_name)
    args = _args(env_name, dict(train_args, **extra), env_args=env_args)
    jargs = _args(env_name, dict(train_args, **extra), jax_normalize_args, env_args)
    jmodule, params, module = _train_pair(env_name, env_args)
    jreplay = jax_replay_mod.DeviceReplay(JAX_TWINS[env_name], jmodule, jargs,
                                          make_mesh({"dp": 1}), SETUPS[env_name][1], slots=slots)
    replay = DeviceReplay(venv, module, args, SETUPS[env_name][1], slots=slots, device="cpu")
    for chunk in chunks:
        jreplay.ingest(chunk)
        replay.ingest(chunk)

    key = jax.random.PRNGKey(11)
    _, info = jreplay.sample(key, args["batch_size"], with_info=True)   # train_fn's own draws
    jctx = JaxTrainContext(jmodule, jargs, make_mesh({"dp": 1}))
    jstate, jmetrics = jreplay.train_fn(jctx, 1)(jctx.init_state(params), key, LR)
    jnew = flax_to_state_dict(jax.tree.map(np.asarray, jax.device_get(jstate["params"])))

    _use_jax_draws(monkeypatch, info, slots)
    ctx = TrainContext(module, args, device="cpu")
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    batch = replay.sample(torch.Generator(), args["batch_size"])
    losses, _ = ctx.loss(batch)
    losses["total"].backward()
    small = {n: p.grad.abs().numpy() < 1e-6 for n, p in module.named_parameters()}
    ctx.optimizer.zero_grad(set_to_none=True)
    metrics = replay.train_fn(ctx, 1)(torch.Generator(), LR)

    assert metrics["sentinel_bad"] == 0.0 == float(jmetrics["sentinel_bad"])
    assert metrics["dcnt"] == float(jmetrics["dcnt"]) > 0
    np.testing.assert_allclose(metrics["total"], float(jmetrics["total"]), rtol=1e-5, atol=1e-7)
    moved = 0.0
    for n, p in module.named_parameters():
        got, want, s = p.detach().numpy(), jnew[n].numpy(), small[n]
        np.testing.assert_allclose(got[~s], want[~s], rtol=1e-5, atol=1e-2 * LR, err_msg=n)
        assert np.all(np.abs(got[s] - before[n].numpy()[s]) <= LR * (1 + 1e-3)), n
        moved = max(moved, float(np.abs(got - before[n].numpy()).max()))
    assert moved > 0


# -- the constructor's checks ---------------------------------------------------------


@pytest.mark.parametrize("env_name,train_args,net,match", [
    ("TicTacToe", {}, None, "compact-record"),
    ("Geister", {"turn_based_training": True, "observation": False}, None, "observation: true"),
    ("Geister", {"turn_based_training": True, "observation": True, "burn_in_steps": 4,
                 "forward_steps": 12}, None, "device_replay_slots must exceed"),
    ("Geister", {"turn_based_training": False}, None, "simultaneous-move"),
    ("HungryGeese", {"turn_based_training": False}, "Geister", "recurrent nets"),
    ("HungryGeese", {"turn_based_training": False, "burn_in_steps": 2}, None, "burn_in_steps: 0"),
])
def test_device_replay_refuses_what_jax_refuses(env_name, train_args, net, match):
    net_env = net or env_name
    messages = []
    for replay_cls, make, normalize, twin, extra in (
            (DeviceReplay, make_env, normalize_args, make_env({"env": env_name}).vector_env(),
             {"device": "cpu"}),
            (jax_replay_mod.DeviceReplay, jax_make_env, jax_normalize_args,
             {"TicTacToe": JaxTTT, **JAX_TWINS}[env_name], {})):
        args = _args(env_name, train_args, normalize)
        module = make({"env": net_env}).net()
        pos = (twin, module, args) + ((make_mesh({"dp": 1}),) if not extra else ())
        with pytest.raises(ValueError, match=match) as err:
            replay_cls(*pos, 4, slots=16, **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# -- the learner ------------------------------------------------------------------------


def _learner_config(tmp_path, env_name, train_args):
    return normalize_args({"env_args": {"env": env_name}, "train_args": dict(
        train_args, minimum_episodes=10, update_episodes=40, maximum_episodes=1000, epochs=2,
        eval_rate=0.0, device_rollout_games=8, device_replay=True, device_replay_slots=256,
        device_replay_k_steps=16, worker={"num_parallel": 1, "entry_port": 0, "data_port": 0},
        model_dir=str(tmp_path / "models"), metrics_path=str(tmp_path / "metrics.jsonl"))})


@pytest.mark.parametrize("env_name", ["HungryGeese", "Geister"])
def test_learner_device_replay_end_to_end(tmp_path, env_name):
    """Epochs advance on the rings' counters alone: no host episode is
    stored, the books come from the ingest stats, checkpoints land.
    HungryGeese runs local workers, which are only asked to evaluate, at
    most ``eval_rate`` of the episodes made;
    Geister runs as a train server with no worker connected (the host
    Geister evaluations would hold the interpreter here)."""
    train_args, _, _, _, _, net = SETUPS[env_name]
    learner = Learner(_learner_config(tmp_path, env_name, train_args), net=net(), device="cpu",
                      remote=env_name == "Geister")
    assert learner.trainer.device_replay is learner._replay is not None
    roles = []
    assign = learner._assign_role
    learner._assign_role = lambda: (lambda a: roles.append(a["role"]) or a)(assign())
    learner.run()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(records) == 2 and records[-1]["steps"] > 0
    assert all(np.isfinite(r["loss"]["total"]) for r in records if "loss" in r)
    assert sum(r["device_episodes"] for r in records) == records[-1]["episodes"] >= 50
    assert all(r["device_mean_episode_len"] > 1 for r in records)
    assert all(r["plane"] == "fused" and r["plane_watchdog_stalls"] == 0 for r in records)
    assert all("pipeline" not in r and r["input_wait_frac"] == 0.0 for r in records if "loss" in r)
    assert records[0]["generation_mean"] is not None
    assert len(learner.trainer.store) == 0, "device_replay must not store host episodes"
    assert set(roles) <= {"e"} and (roles or env_name == "Geister")
    # the local workers wait for the eval budget rather than evaluate non-stop
    assert learner.num_results <= learner.eval_rate * learner.num_episodes + 1
    assert (tmp_path / "models" / "2.ckpt").exists()
    assert not learner._rollout_thread.is_alive()
