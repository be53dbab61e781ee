"""The port's host-born episode stage and ``batch_pipeline: device``
(runtime/device_replay.py ``DeviceEpisodeStage``, runtime/device_batch.py)
on the CPU, against the JAX package's and the port's own host path.

* The same episodes (the port's Generator with a uniform policy) go into
  the JAX stage and the port's: equal rings leaf for leaf (observation
  leaves flattened in sorted-key order into ``obs<i>``), equal spans, lane
  balance, staged totals and chunk counts, equal ingest counters (counts
  exactly, outcome sums within 1e-5).
* With the JAX draws in place of the port's, a stage's sampled batch equals
  the JAX one key by key (ints and masks exactly, floats within 1e-6), and
  each row equals the port's ``make_batch`` on the same episode, window
  start and target player, within 1e-6.
* ``add_blob`` stages what ``add_episode`` stages, bit for bit.
* ``DeviceBatchPipeline`` feeds the trainer (a (k, B, ...) stack under
  ``fused_steps``) with the pipelines' stats vocabulary; ``make_pipeline``
  builds it, and degrades loudly to shm when the stage refuses the
  configuration; the learner trains end to end on it.
"""

import json
import random
import threading

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.parallel import make_mesh
from handyrl_tpu.runtime.device_replay import DeviceEpisodeStage as JaxStage
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import GeeseNet, RandomModel
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import codec, device_replay
from handyrl_tpu_torch.runtime.batch import make_batch
from handyrl_tpu_torch.runtime.device_batch import DeviceBatchPipeline
from handyrl_tpu_torch.runtime.device_replay import DeviceEpisodeStage
from handyrl_tpu_torch.runtime.generation import Generator
from handyrl_tpu_torch.runtime.learner import Learner
from handyrl_tpu_torch.runtime.replay import EpisodeStore
from handyrl_tpu_torch.runtime.shm_batch import ShmBatchPipeline
from handyrl_tpu_torch.runtime.trainer import PIPE_STAT_KEYS, make_pipeline
from handyrl_tpu_torch.utils import tree_leaves

FF = {"turn_based_training": False, "observation": False, "batch_size": 8, "forward_steps": 8}
TURN = {"turn_based_training": True, "observation": True, "batch_size": 4, "forward_steps": 4,
        "burn_in_steps": 2}
# name -> (env, train args, episodes, lanes, chunk, slots, actions)
CASES = {
    "ff-HungryGeese": ("HungryGeese", FF, 40, 4, 8, 256, 4),
    "turn-TicTacToe": ("TicTacToe", TURN, 16, 2, 8, 64, 9),
    "turn-Geister": ("Geister", TURN, 6, 2, 32, 128, 214),
}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _args(env_name, train_args, normalize=normalize_args):
    cfg = normalize({"env_args": {"env": env_name}, "train_args": dict(train_args, mesh={"dp": 1})})
    return dict(cfg["train_args"], env=cfg["env_args"])


def _episodes(env_name, n, args, actions, seed=0):
    random.seed(seed)
    env = make_env({"env": env_name})
    model = RandomModel({"policy": ((actions,), np.float32), "value": ((1,), np.float32)})
    gen = Generator(env, args)
    players = env.players()
    episodes = []
    while len(episodes) < n:
        ep = gen.generate({p: model for p in players},
                          {"player": players, "model_id": {p: 1 for p in players}})
        if ep is not None:
            episodes.append(ep)
    return episodes


def _stages(case, episodes=None):
    env_name, train_args, n, lanes, chunk, slots, actions = CASES[case]
    args = _args(env_name, train_args)
    episodes = episodes or _episodes(env_name, n, args, actions)
    jstage = JaxStage(jax_make_env({"env": env_name}).net(),
                      _args(env_name, train_args, jax_normalize_args), make_mesh({"dp": 1}),
                      n_lanes=lanes, slots=slots, chunk_steps=chunk, track_episodes=True)
    stage = DeviceEpisodeStage(make_env({"env": env_name}).net(), args, n_lanes=lanes,
                               slots=slots, chunk_steps=chunk, track_episodes=True, device="cpu")
    for s in (jstage, stage):
        for ep in episodes:
            s.add_episode(ep)
        s.flush()
        s.drain()
    return {"case": case, "args": args, "episodes": episodes, "stage": stage, "jstage": jstage}


@pytest.fixture(scope="module", params=sorted(CASES))
def staged(request):
    return _stages(request.param)


def test_stage_equals_jax(staged):
    stage, jstage = staged["stage"], staged["jstage"]
    assert stage.chunks_flushed == jstage.chunks_flushed > 0
    assert stage.episodes_staged == jstage.episodes_staged == len(staged["episodes"])
    assert stage.steps_staged == jstage.steps_staged
    assert stage._qtotal == jstage._qtotal and stage._qlen == jstage._qlen
    for lane in range(stage.n_lanes):
        assert [(g0, g1, id(ep)) for g0, g1, ep in stage.spans[lane]] == \
            [(g0, g1, id(ep)) for g0, g1, ep in jstage.spans[lane]]
    # the ring g of the next step equals the steps ever queued, lane by lane
    longest = max(e["steps"] for e in staged["episodes"])
    assert max(stage._qtotal) - min(stage._qtotal) <= longest
    rings = stage.replay.rings
    jrings = jax.tree.map(np.asarray, jstage.replay.rings)
    assert rings["g"] == int(jrings["g"]) == stage.chunks_flushed * stage.chunk_steps
    for key in ("ep_start_g", "ep_end_g", "valid", "cur_start_g"):
        np.testing.assert_array_equal(rings[key].numpy(), jrings[key], err_msg=key)
    assert sorted(rings["rec"]) == sorted(jrings["rec"])
    for key, ring in rings["rec"].items():
        assert ring.numpy().dtype == jrings["rec"][key].dtype, key
        np.testing.assert_array_equal(ring.numpy(), jrings["rec"][key], err_msg=key)
    counters, jcounters = stage.replay.counters, jstage.replay.counters
    for key in ("episodes", "game_steps", "player_steps"):
        assert counters[key] == jcounters[key], key
    for key in ("outcome_sum", "outcome_sq_sum"):
        assert abs(counters[key] - jcounters[key]) <= 1e-5, key


def test_stage_sample_equals_jax(staged, monkeypatch):
    stage, jstage = staged["stage"], staged["jstage"]
    jbatch, info = jstage.replay.sample(jax.random.PRNGKey(5), 16, with_info=True)
    S = stage.slots
    flat = torch.as_tensor(info["lane"].astype(np.int64) * S + info["slot"].astype(np.int64))
    player = torch.as_tensor(info["player"].astype(np.int64))
    monkeypatch.setattr(device_replay, "_draw_starts", lambda gen, ok, n: flat.clone())
    monkeypatch.setattr(device_replay, "_draw_players", lambda gen, n, P, device: player.clone())
    batch = stage.replay.sample(torch.Generator(), 16)
    assert sorted(batch) == sorted(jbatch)
    for key in jbatch:
        got, want = tree_leaves(batch[key]), jax.tree.leaves(jbatch[key])
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            if w.dtype.kind in "biu" or key.endswith("_mask"):
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)


def _host_window(ep, train_start, args):
    fwd, cs = args["forward_steps"], args["compress_steps"]
    start = max(0, train_start - args["burn_in_steps"])
    end = min(train_start + fwd, ep["steps"])
    first_block, last_block = start // cs, (end - 1) // cs + 1
    return {"args": ep["args"],
            "outcome": np.asarray([ep["outcome"][p] for p in ep["players"]], np.float32),
            "players": ep["players"], "blocks": ep["blocks"][first_block:last_block],
            "base": first_block * cs, "start": start, "end": end, "train_start": train_start,
            "total": ep["steps"]}


def test_stage_windows_match_make_batch(staged, monkeypatch):
    stage, args = staged["stage"], staged["args"]
    S, G = stage.slots, stage.replay.rings["g"]
    batch, info = stage.replay.sample(torch.Generator().manual_seed(2), 24, with_info=True)
    for i in range(24):
        lane, slot, player = (int(info[k][i]) for k in ("lane", "slot", "player"))
        gs0 = G - 1 - ((G - 1 - slot) % S)
        hits = [s for s in stage.spans[lane] if s[0] <= gs0 <= s[1]]
        assert hits, f"row {i} maps to no staged episode"
        g0, _, ep = hits[0]
        train_start = gs0 - g0
        assert train_start <= max(0, ep["steps"] - args["forward_steps"])
        if player >= 0:
            monkeypatch.setattr("handyrl_tpu_torch.runtime.batch.random.randrange",
                                lambda _n, p=player: p)
        host = make_batch([_host_window(ep, train_start, args)], args)
        for key in host:
            hl, gl = tree_leaves(host[key]), tree_leaves(batch[key])
            assert len(hl) == len(gl), key
            for h, g in zip(hl, gl):
                np.testing.assert_allclose(g.numpy()[i:i + 1], h, rtol=0, atol=1e-6,
                                           err_msg=f"{key} row {i}")


def test_blob_path_equals_decoded_path():
    env_name, train_args, _, lanes, chunk, slots, actions = CASES["turn-Geister"]
    args = _args(env_name, train_args)
    episodes = _episodes(env_name, 4, args, actions, seed=3)
    stages = []
    for use_blob in (False, True):
        stage = DeviceEpisodeStage(make_env({"env": env_name}).net(), args, n_lanes=lanes,
                                   slots=slots, chunk_steps=chunk, device="cpu")
        for ep in episodes:
            stage.add_blob(codec.dumps(ep)) if use_blob else stage.add_episode(ep)
        stage.flush()
        stage.drain()
        stages.append(stage)
    a, b = stages
    assert a.episodes_staged == b.episodes_staged == 4 and a.chunks_flushed == b.chunks_flushed > 0
    for x, y in zip(tree_leaves(a.replay.rings), tree_leaves(b.replay.rings)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    ba = a.replay.sample(torch.Generator().manual_seed(9), 8)
    bb = b.replay.sample(torch.Generator().manual_seed(9), 8)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(ba), tree_leaves(bb)))


def test_stage_refuses_what_jax_refuses():
    cases = [("TicTacToe", {"turn_based_training": True, "observation": False}, "TicTacToe",
              "observation"),
             ("HungryGeese", {"turn_based_training": False}, "Geister", "recurrent"),
             ("HungryGeese", {"turn_based_training": False, "burn_in_steps": 2}, "HungryGeese",
              "burn_in_steps: 0")]
    for env_name, train_args, net_env, match in cases:
        messages = []
        with pytest.raises(ValueError, match=match) as err:
            DeviceEpisodeStage(make_env({"env": net_env}).net(), _args(env_name, train_args),
                               device="cpu")
        messages.append(str(err.value))
        with pytest.raises(ValueError, match=match) as err:
            JaxStage(jax_make_env({"env": net_env}).net(),
                     _args(env_name, train_args, jax_normalize_args), make_mesh({"dp": 1}))
        messages.append(str(err.value))
        assert messages[0] == messages[1]


# -- the pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("fused", [1, 2])
def test_device_pipeline_feeds_the_train_step(fused):
    args = _args("HungryGeese", dict(FF, batch_size=4, fused_steps=fused, device_stage_lanes=2,
                                     device_stage_chunk=4, device_stage_slots=256))
    episodes = _episodes("HungryGeese", 8, args, 4)
    store = EpisodeStore(100)
    ctx = TrainContext(GeeseNet(filters=8, blocks=2), args, device="cpu")
    stop = threading.Event()
    pipe = DeviceBatchPipeline(args, store, ctx, stop)
    store.extend(episodes[:4])
    pipe.start()
    store.extend(episodes[4:])   # the live feed rides the subscription
    try:
        batch = pipe.batch()
        lead = (fused, 4) if fused > 1 else (4,)
        assert batch["action"].shape[:len(lead) + 1] == lead + (8,)
        metrics = ctx.train_steps(batch, 1e-5) if fused > 1 else ctx.train_step(batch, 1e-5)
        assert np.isfinite(metrics["total"]) and metrics["dcnt"] > 0
        deadline = 30
        while pipe.stats()["episodes_staged"] < len(episodes) and deadline:
            threading.Event().wait(0.1)
            deadline -= 0.1
        stats = pipe.stats()
        assert stats["mode"] == "device" and stats["batches"] == fused
        assert stats["episodes_staged"] == len(episodes)
        assert all(key in stats for key in PIPE_STAT_KEYS)
    finally:
        pipe.stop()
    assert pipe.batch() is None


def test_make_pipeline_builds_the_device_plane_or_degrades_loudly(capsys):
    args = _args("HungryGeese", dict(FF, batch_size=4, batch_pipeline="device"))
    store = EpisodeStore(10)
    ctx = TrainContext(GeeseNet(filters=8, blocks=2), args, device="cpu")
    assert isinstance(make_pipeline(args, store, ctx), DeviceBatchPipeline)
    # a recurrent net in ff mode: the stage refuses, the plane falls back to shm, loudly
    bad = _args("Geister", dict(FF, batch_size=4, batch_pipeline="device"))
    gctx = TrainContext(make_env({"env": "Geister"}).net(),
                        dict(bad, turn_based_training=True, observation=True), device="cpu")
    pipe = make_pipeline(bad, store, gctx)
    assert isinstance(pipe, ShmBatchPipeline)
    assert "device batch pipeline unavailable" in capsys.readouterr().err


def test_learner_with_the_device_pipeline(tmp_path):
    """HungryGeese device rollouts feed host episodes into the store; the
    stage uploads them once and the trainer takes its batches from the
    rings: every record says pipeline 'device'."""
    cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": dict(
        FF, minimum_episodes=8, update_episodes=24, maximum_episodes=1000, epochs=2,
        eval_rate=0.0, device_rollout_games=8, batch_pipeline="device", device_stage_lanes=2,
        device_stage_chunk=16, device_stage_slots=256, worker={"num_parallel": 1},
        model_dir=str(tmp_path / "models"), metrics_path=str(tmp_path / "metrics.jsonl"))})
    learner = Learner(cfg, net=GeeseNet(filters=8, blocks=2), device="cpu")
    assert isinstance(learner.trainer.batcher, DeviceBatchPipeline)
    learner.run()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(records) == 2 and records[-1]["steps"] > 0
    assert all(r["pipeline"] == "device" for r in records)
    trained = [r for r in records if "loss" in r]
    assert trained and all(np.isfinite(r["loss"]["total"]) for r in trained)
    assert any("input_wait_warmup_s" in r for r in trained)
    assert sum(r["pipe_batches"] for r in trained) > 0
    assert learner.trainer.batcher.stats()["chunks_flushed"] > 0
    assert (tmp_path / "models" / "2.ckpt").exists()
