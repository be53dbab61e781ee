"""A learner of several processes and an actor host, as processes, on the CPU.

Every test spawns the port in child processes (tests/torch_mp_child.py, no
JAX there) joined by a gloo group on free localhost ports; each child is
bounded by ``communicate(timeout=...)`` and killed at its expiry.

* A 2-rank data-parallel train step (a 2-layer d_model 64 transformer at
  T16, and ``SimpleConvNet``) equals the JAX package's one-process step on
  the same global batch and params.  Tolerances: against the port's own
  one-process step, metrics 1e-5 of max(1, |x|) and gradients 1e-5 of the
  largest |gradient| of the model (fp32 sums taken in another order);
  against JAX, losses rtol 1e-4 and params after Adam within 1e-2 * lr
  where |grad| >= 1e-6 (tests/test_torch_train.py's), gradients rtol 1e-3
  with an atol of 1e-5 of the model's largest |gradient| (the two packages'
  attention and convolution sum in other orders).  The ranks' params are bit for bit the
  same after three steps, and the step sums (never averages) the ranks'
  gradients, as the JAX loss, a sum, requires.
* The 2-rank learner on TicTacToe: both ranks take the same steps, end
  with equal params, and only rank 0 writes models/ and metrics.jsonl.
* The resume epoch is the coordinator's.
* A sentinel rollback lands the same bytes on both ranks.
* ``HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH=1:1``: the survivor drain-saves a
  verified checkpoint and exits 75; a relaunch resumes on both ranks.
* An actor host feeds a learner's rings through the plane gateway; the
  learner survives its SIGKILL, and a SIGKILLed learner ends it with 75.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.parallel import TrainContext as JaxTrainContext
from handyrl_tpu.parallel import make_mesh as jax_make_mesh
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.parallel.train_step import trim_burn_in as jax_trim
from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import flax_to_state_dict, init_variables
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.parallel.distributed import params_crc32
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree

ROOT = Path(__file__).resolve().parent.parent
CHILD = str(Path(__file__).resolve().parent / "torch_mp_child.py")
LR = 1e-3


def _free_port():
    """A port p with p + 1 (the health plane) and p + 2 (the gateway) free too."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port > 65000:
            continue
        try:
            for p in (port + 1, port + 2):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return port
        except OSError:
            continue
    raise RuntimeError("no three free ports in a row")


def _spawn(args, cwd=None, env=None):
    environ = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p), **(env or {}))
    environ.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, CHILD, *args], cwd=cwd, env=environ,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout):
    """(returncode, stdout, stderr) of each child; all are killed once
    ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for proc in procs:
            o, e = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((proc.returncode, o, e))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        raise
    return out


def _explain(results):
    return "\n".join(f"--- rc {rc}\n{o[-2000:]}\n{e[-3000:]}" for rc, o, e in results)


# -- the data-parallel step against the JAX package's one-process step ---------

TRANSFORMER = {
    "env_args": {"env": "Geister", "net": "transformer",
                 "net_args": {"d_model": 64, "n_heads": 2, "n_layers": 2, "memory_len": 8}},
    "train_args": {"batch_size": 4, "forward_steps": 16, "burn_in_steps": 0, "compress_steps": 4,
                   "observation": True, "batch_pipeline": "thread", "mesh": {"dp": 1}},
}
CONV = {"env_args": {"env": "TicTacToe"},
        "train_args": {"batch_size": 8, "forward_steps": 16, "batch_pipeline": "thread",
                       "mesh": {"dp": 1}}}


def _case(raw, seed, heads, episodes, players):
    jcfg, cfg = jax_normalize_args(raw), normalize_args(raw)
    jargs = dict(jcfg["train_args"], env=jcfg["env_args"])
    args = dict(cfg["train_args"], env=cfg["env_args"])
    jenv = jax_make_env(jargs["env"])
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=seed)
    gen = JaxGenerator(jenv, jargs)
    model = JaxRandomModel(heads)
    import random

    random.seed(seed)
    store = JaxEpisodeStore(64)
    store.extend([gen.generate({p: model for p in players}, {"player": players})
                  for _ in range(episodes)])
    T, B = jargs["forward_steps"], jargs["batch_size"]
    batch = jax_make_batch([store.sample_window(T, 0, 4) for _ in range(B)], jargs)
    return jargs, args, jmodule, variables, batch


def test_two_rank_step_equals_the_jax_one_process_step(tmp_path):
    cases = {
        "transformer": _case(TRANSFORMER, 1, {"policy": ((214,), np.float32),
                                              "value": ((1,), np.float32),
                                              "return": ((1,), np.float32)}, 3, [0, 1]),
        "conv": _case(CONV, 3, {"policy": ((9,), np.float32), "value": ((1,), np.float32)},
                      16, [0, 1]),
    }
    inputs = {name: {"params": {k: v.numpy() for k, v in flax_to_state_dict(
                  jax.tree.map(np.asarray, variables["params"])).items()},
                     "batch": batch}
              for name, (_, _, _, variables, batch) in cases.items()}
    (tmp_path / "inputs.npz").write_bytes(_pack_tree(inputs))
    (tmp_path / "cases.json").write_text(json.dumps(
        {name: args for name, (_, args, _, _, _) in cases.items()}))
    port = _free_port()
    results = _finish([_spawn(["step", str(tmp_path), str(r), str(port)]) for r in (0, 1)], 90)
    assert all(rc == 0 for rc, _, _ in results), _explain(results)
    ranks = [_unpack_tree((tmp_path / f"rank{r}.npz").read_bytes()) for r in (0, 1)]

    for name, (jargs, args, jmodule, variables, batch) in cases.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        # both ranks hold the global step: the same metrics, gradients,
        # params, and after three steps the same bytes
        assert int(r0["crc"][0]) == int(r1["crc"][0]), name
        for key in ("metrics", "grads", "params1"):
            for k in r0[key]:
                assert np.array_equal(r0[key][k], r1[key][k]), (name, key, k)
        # one flat fp32 bucket: every gradient and the 6 metrics
        n_params = sum(v.size for v in r0["grads"].values())
        assert int(r0["bucket_bytes"][0]) == 4 * (n_params + 6)

        # the port's one-process step on the global batch
        module = make_env(args["env"]).net()
        module.load_state_dict({k: torch.from_numpy(v) for k, v in inputs[name]["params"].items()})
        ctx = TrainContext(module, args, device="cpu")
        metrics = ctx.train_step(batch, LR).fetch()
        for k, v in metrics.items():
            assert abs(float(r0["metrics"][k]) - v) <= 1e-5 * max(1.0, abs(v)), (name, k)
        scale = max(float(p.grad.abs().max()) for p in module.parameters())
        for n, p in module.named_parameters():
            assert np.max(np.abs(r0["grads"][n] - p.grad.numpy())) <= 1e-5 * scale, (name, n)
            np.testing.assert_allclose(r0["params1"][n], p.detach().numpy(), rtol=0,
                                       atol=1e-2 * LR, err_msg=f"{name} {n}")

        # the JAX package's one-process step on the global batch
        def jtotal(params):
            outputs = jax_forward(jmodule, params, batch, jargs)
            losses, _ = jax_loss(outputs, jax_trim(batch, 0), jargs)
            return losses["total"], losses

        (_, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(variables["params"])
        jgrads = {k: v.numpy() for k, v in flax_to_state_dict(
            jax.tree.map(np.asarray, jgrads)).items()}
        norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                 for g in jgrads.values())))
        coef = min(1.0, 4.0 / (norm + 1e-6))   # the step's clip at 4.0
        for k in ("p", "v", "ent", "total"):
            np.testing.assert_allclose(float(r0["metrics"][k]), float(jlosses[k]), rtol=1e-4,
                                       err_msg=f"{name} {k}")
        jscale = coef * max(float(np.max(np.abs(g))) for g in jgrads.values())
        for n, g in jgrads.items():
            np.testing.assert_allclose(r0["grads"][n], g * coef, rtol=1e-3, atol=1e-5 * jscale,
                                       err_msg=f"{name} {n}")
        jctx = JaxTrainContext(jmodule, jargs, jax_make_mesh({"dp": 1}))
        jstate, jmetrics = jctx.train_step(jctx.init_state(variables["params"]),
                                           jctx.put_batch(batch), LR)
        assert float(r0["metrics"]["dcnt"]) == float(jmetrics["dcnt"])
        assert float(r0["metrics"]["sentinel_bad"]) == float(jmetrics["sentinel_bad"]) == 0.0
        jnew = {k: v.numpy() for k, v in flax_to_state_dict(
            jax.tree.map(np.asarray, jax.device_get(jstate["params"]))).items()}
        for n, before in inputs[name]["params"].items():
            delta, jdelta = r0["params1"][n] - before, jnew[n] - before
            big = np.abs(jgrads[n]) >= 1e-6
            assert np.all(np.abs(delta[big] - jdelta[big]) <= 1e-2 * LR), (name, n)
            assert np.all(np.abs(delta[~big]) <= LR * (1 + 1e-3)), (name, n)


# -- the learner of two processes -----------------------------------------------

def _ttt_config(port, **train):
    return {"env_args": {"env": "TicTacToe"}, "train_args": dict({
        "batch_size": 8, "forward_steps": 4, "minimum_episodes": 10, "update_episodes": 10,
        "epochs": 2, "batch_pipeline": "thread", "worker": {"num_parallel": 1},
        "distributed": {"coordinator_address": f"127.0.0.1:{port}", "num_processes": 2,
                        "heartbeat_interval": 1.0, "heartbeat_timeout": 10.0,
                        "initialization_timeout": 60.0}}, **train)}


def _ranks(tmp_path, config, env=None, timeout=90):
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    procs = [_spawn(["cli"], cwd=str(tmp_path), env=dict(env or {}, PROCESS_ID=str(r)))
             for r in (0, 1)]
    return _finish(procs, timeout)


def _crc_lines(results):
    return [[line for line in o.splitlines() if "params crc32" in line] for _, o, _ in results]


def test_two_rank_learner_takes_the_same_steps_and_only_rank0_writes(tmp_path):
    results = _ranks(tmp_path, _ttt_config(_free_port()))
    assert [rc for rc, _, _ in results] == [0, 0], _explain(results)
    lines = _crc_lines(results)
    assert len(lines[0]) == len(lines[1]) == 1
    crc0, crc1 = (line[0].split("crc32 ")[1] for line in lines)
    assert crc0 == crc1   # the same crc and the same step count
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(r["dist_processes"] == 2 and r["dist_backend"] == "gloo" for r in records)
    trained = [r for r in records if "loss" in r]
    assert trained and all(r["dist_allreduce_calls"] > 0 for r in trained)
    assert records[-1]["rank_reports"] >= 1
    assert "coordinator" in results[0][1] and "follower" in results[1][1]
    # only the coordinator wrote: one models/ and one metrics.jsonl, and the
    # last snapshot holds the params both ranks ended with
    assert sorted(os.listdir(tmp_path)) == ["config.yaml", "metrics.jsonl", "models"]
    saved = ckpt.load_params(str(tmp_path / "models" / "2.ckpt"))
    assert f"{params_crc32(saved):08x}" == crc0.split()[0]


def test_ranks_resume_the_coordinators_epoch(tmp_path):
    port = _free_port()
    results = _finish([_spawn(["resume", str(r), str(port), str(local)])
                       for r, local in ((0, 7), (1, 3))], 60)
    assert [rc for rc, _, _ in results] == [0, 0], _explain(results)
    assert all("agreed epoch 7" in o for _, o, _ in results)


def test_sentinel_rollback_lands_the_same_bytes_on_both_ranks(tmp_path):
    """Every step's lr is NaN on both ranks: the sentinel skips them, the
    streak reaches ``sentinel_rollback_after``, and the coordinator's
    manifest verdict (a planted verified epoch 1 at first, this run's own
    saves later) and its params reach the follower through the agreement:
    both end on the same bytes, those of the last save."""
    module = init_variables(make_env({"env": "TicTacToe"}).net(), 123)
    planted = {k: v.detach().clone() for k, v in module.state_dict().items()}
    ckpt.save_epoch_snapshot(str(tmp_path / "models"), 1, planted,
                             {"params": planted, "epoch": 1}, 0)
    config = _ttt_config(_free_port(), restart_epoch=0, sentinel_rollback_after=2)
    results = _ranks(tmp_path, config, env={"HANDYRL_FAULT_NAN_AT_STEP": "0:100000"})
    assert [rc for rc, _, _ in results] == [0, 0], _explain(results)
    assert all("rolled back to verified epoch 1 on every process" in e for _, _, e in results)
    # the same bytes on both ranks, and the rolled-back params are what the
    # coordinator saved last (every later step was skipped)
    crcs = {line[0].split("crc32 ")[1].split()[0] for line in _crc_lines(results)}
    latest = ckpt.load_params(str(tmp_path / "models" / "latest.ckpt"))
    assert crcs == {f"{params_crc32(latest):08x}"}
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert records[-1]["sentinel_rollbacks"] >= 1


def test_a_lost_rank_drains_to_75_and_the_relaunch_resumes(tmp_path):
    config = _ttt_config(_free_port(), epochs=3)
    results = _ranks(tmp_path, config, env={"HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH": "1:1"})
    codes = [rc for rc, _, _ in results]
    assert codes == [75, 1], _explain(results)
    assert "host fault" in results[0][2] and "drain checkpoint: epoch 2" in results[0][2]
    assert ckpt.latest_verified_epoch(str(tmp_path / "models")) == 2
    # the relaunch of both ranks resumes the drained epoch and finishes
    config = _ttt_config(_free_port(), epochs=3, restart_epoch=-1)
    results = _ranks(tmp_path, config)
    assert [rc for rc, _, _ in results] == [0, 0], _explain(results)
    assert all("auto-resume (restart_epoch: -1): epoch 2" in o for _, o, _ in results)
    assert len({line[0].split("crc32 ")[1] for line in _crc_lines(results)}) == 1


# -- an actor host over the plane gateway -----------------------------------------

def _geister(port, **dist):
    return {"env_args": {"env": "Geister", "net": "transformer",
                         "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2,
                                      "memory_len": 8}},
            "train_args": {"observation": True, "batch_size": 4, "forward_steps": 8,
                           "minimum_episodes": 4, "update_episodes": 6, "epochs": 3,
                           "eval_rate": 0.0, "device_rollout_games": 8, "device_replay": True,
                           "device_replay_slots": 128, "device_replay_k_steps": 16,
                           "worker": {"num_parallel": 1},
                           "distributed": dict({"coordinator_address": f"127.0.0.1:{port}",
                                                "num_processes": 1, "actor_hosts": 1,
                                                "heartbeat_interval": 1.0,
                                                "heartbeat_timeout": 3.0}, **dist)}}


def _start_pair(tmp_path, port):
    (tmp_path / "learner").mkdir(parents=True)
    (tmp_path / "actor").mkdir()
    (tmp_path / "learner" / "config.yaml").write_text(yaml.safe_dump(_geister(port)))
    (tmp_path / "actor" / "config.yaml").write_text(yaml.safe_dump(_geister(port, role="actor")))
    learner = _spawn(["cli"], cwd=str(tmp_path / "learner"))
    actor = _spawn(["cli"], cwd=str(tmp_path / "actor"))
    return learner, actor


def _wait_for(path, predicate, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if path.exists():
            records = [json.loads(line) for line in path.read_text().splitlines() if line]
            if predicate(records):
                return records
        time.sleep(0.2)
    return None


def test_actor_host_feeds_the_rings_and_losses_are_bounded(tmp_path):
    # the learner survives its actor host's SIGKILL: its own rollout takes over
    learner, actor = _start_pair(tmp_path / "a", _free_port())
    metrics = tmp_path / "a" / "learner" / "metrics.jsonl"
    fed = _wait_for(metrics, lambda rs: any(r.get("plane_record_batches", 0) > 0
                                            and r.get("plane_param_fetches", 0) > 0 for r in rs),
                    60)
    actor.send_signal(signal.SIGKILL)
    results = _finish([learner, actor], 90)
    assert fed is not None and results[0][0] == 0, _explain(results)
    assert "params -> version" in results[1][1]
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert records[-1]["dist_actor_host_losses"] >= 1 and records[-1]["dist_actor_hosts"] == 0
    versions = [r["plane_param_version"] for r in records]
    assert versions == sorted(versions) and versions[-1] > versions[0]
    # a SIGKILLed learner: the actor host announces it and exits 75
    learner, actor = _start_pair(tmp_path / "b", _free_port())
    fed = _wait_for(tmp_path / "b" / "learner" / "metrics.jsonl",
                    lambda rs: any(r.get("plane_record_batches", 0) > 0 for r in rs), 60)
    learner.send_signal(signal.SIGKILL)
    results = _finish([learner, actor], 60)
    assert fed is not None and results[1][0] == 75, _explain(results)
    assert "host fault (learner_loss)" in results[1][2]
