"""Sequence-parallel training (``seq_attention: ring``) on CPU ranks.

The port runs in child processes (tests/torch_mp_child.py, no JAX there)
joined by a gloo group on free localhost ports, each bounded by
``communicate(timeout=...)``; the JAX side runs here, on tests/conftest.py's
8-device CPU mesh.

* One train step on ``{'sp': 2}`` (tests/test_transformer.py's ring case:
  the TicTacToe transformer, B8, T8, the JAX package's weights through
  ``convert``) against JAX's ring ``TrainContext`` on ``{'dp': 1, 'sp': 2}``
  (total, p, v, dcnt within rtol 2e-4 / atol 2e-5) and against JAX's one-chip
  einsum step (8e-3 / 1e-4); the updated params against JAX's ring step's
  (Adam's first step: within 1e-2 * lr where the gradient is not tiny);
  both ranks' params bit for bit the same.
* ``--train`` on two ranks with ``seq_attention: ring``: both exit 0 with
  the same params CRC32, which the last checkpoint holds; only rank 0
  wrote; the rank of sp index 1 ran no actor and took its leader's batches.
* A peer lost inside the ring: rank 1 leaves at a ring shift mid-epoch;
  rank 0's ``ring_shift`` raises ``CollectiveError`` (no hang), and the
  learner drains a verified checkpoint and exits 75.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import yaml

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import InferenceModel as JaxInferenceModel
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.parallel import TrainContext as JaxTrainContext
from handyrl_tpu.parallel import make_mesh as jax_make_mesh
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.models import flax_to_state_dict
from handyrl_tpu_torch.parallel.distributed import params_crc32
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree

ROOT = Path(__file__).resolve().parent.parent
CHILD = str(Path(__file__).resolve().parent / "torch_mp_child.py")
LR = 1e-3
STEP_CONFIG = {
    "env_args": {"env": "TicTacToe", "net": "transformer"},
    "train_args": {"batch_size": 8, "forward_steps": 8, "burn_in_steps": 0, "compress_steps": 4,
                   "observation": True, "seq_forward": True, "batch_pipeline": "thread",
                   "seq_attention": "ring", "mesh": {"sp": 2}},
}


def _free_port():
    """A port p with p + 1 (the health plane) and p + 2 free too."""
    import socket

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
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _explain(results):
    return "\n".join(f"--- rc {rc}\n{o[-2000:]}\n{e[-3000:]}" for rc, o, e in results)


def _jax_batch(jargs):
    """tests/test_transformer.py's ring case: 6 random-play episodes, B8 x T8."""
    env = jax_make_env(jargs["env"])
    module = env.net()
    variables = jax_init_variables(module, env)
    env.reset()
    random_model = JaxRandomModel.from_model(JaxInferenceModel(module, variables),
                                             env.observation(env.players()[0]))
    store = JaxEpisodeStore(64)
    gen = JaxGenerator(env, jargs)
    gen_args = {"player": env.players(), "model_id": {p: 0 for p in env.players()}}
    import random

    random.seed(0)
    while len(store) < 6:
        ep = gen.generate({p: random_model for p in env.players()}, gen_args)
        if ep is not None:
            store.extend([ep])
    windows = []
    while len(windows) < jargs["batch_size"]:
        w = store.sample_window(jargs["forward_steps"], jargs["burn_in_steps"],
                                jargs["compress_steps"])
        if w is not None:
            windows.append(w)
    return module, variables, jax_make_batch(windows, jargs)


def test_ring_train_step_on_two_ranks_equals_jax_ring_and_one_chip(tmp_path):
    jcfg, cfg = jax_normalize_args(STEP_CONFIG), normalize_args(STEP_CONFIG)
    jargs = dict(jcfg["train_args"], env=jcfg["env_args"])
    args = dict(cfg["train_args"], env=cfg["env_args"])
    module, variables, batch = _jax_batch(jargs)
    params = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, variables["params"])).items()}
    (tmp_path / "inputs.npz").write_bytes(_pack_tree({"params": params, "batch": batch}))
    (tmp_path / "args.json").write_text(json.dumps(args))
    port = _free_port()
    procs = [_spawn(["ringstep", str(tmp_path), str(r), str(port)]) for r in (0, 1)]

    # the JAX side meanwhile
    results = {}
    jctx = JaxTrainContext(module, jargs, jax_make_mesh({"dp": 1, "sp": 2}))
    jstate, jmetrics = jctx.train_step(jctx.init_state(variables["params"]),
                                       jctx.put_batch(batch), LR)
    results["ring"] = jax.device_get(jmetrics)
    one = dict(jargs, seq_attention="einsum", mesh={"dp": 1})
    jctx1 = JaxTrainContext(module, one, jax_make_mesh({"dp": 1}))
    _, jmetrics1 = jctx1.train_step(jctx1.init_state(variables["params"]),
                                    jctx1.put_batch(batch), LR)
    results["single_chip"] = jax.device_get(jmetrics1)

    def jgrad_of(params):
        from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
        from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
        from handyrl_tpu.parallel.train_step import trim_burn_in as jax_trim

        outputs = jax_forward(module, params, batch, dict(jargs, seq_attention="einsum"))
        return jax_loss(outputs, jax_trim(batch, 0), jargs)[0]["total"]

    jgrads = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jax.jit(jax.grad(jgrad_of))(variables["params"]))).items()}
    jnew = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(jstate["params"]))).items()}

    done = _finish(procs, 90)
    assert all(rc == 0 for rc, _, _ in done), _explain(done)
    ranks = [_unpack_tree((tmp_path / f"rank{r}.npz").read_bytes()) for r in (0, 1)]
    assert int(ranks[0]["crc"][0]) == int(ranks[1]["crc"][0])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]   # reduced: the same on both
    # the ring's books: per layer 1 forward and 2 backward shifts per rank
    assert int(ranks[0]["ring"][0]) == 3 * module.n_layers
    got = ranks[0]["metrics"]
    assert np.isfinite(float(got["total"])) and float(got["sentinel_bad"]) == 0.0
    for k in ("total", "p", "v", "dcnt"):
        np.testing.assert_allclose(float(got[k]), float(results["ring"][k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(got[k]), float(results["single_chip"][k]), rtol=8e-3,
                                   atol=1e-4, err_msg=k)

    # the updated params against JAX's ring step's: Adam's first step moves
    # each weight by ~lr * sign(gradient)
    for n, before in params.items():
        delta, jdelta = ranks[0]["params"][n] - before, jnew[n] - before
        big = np.abs(jgrads[n]) >= 1e-6
        assert np.all(np.abs(delta[big] - jdelta[big]) <= 1e-2 * LR), n
        assert np.all(np.abs(delta[~big]) <= LR * (1 + 1e-3)), n


# -- the learner ----------------------------------------------------------------

def _ring_config(port, **train):
    return {"env_args": {"env": "TicTacToe", "net": "transformer",
                         "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2,
                                      "memory_len": 8}},
            "train_args": dict({
                "batch_size": 4, "forward_steps": 8, "burn_in_steps": 0, "observation": True,
                "minimum_episodes": 8, "update_episodes": 8, "epochs": 2,
                "batch_pipeline": "thread", "worker": {"num_parallel": 1},
                "seq_attention": "ring", "mesh": {"sp": 2},
                "distributed": {"coordinator_address": f"127.0.0.1:{port}", "num_processes": 2,
                                "heartbeat_interval": 1.0, "heartbeat_timeout": 10.0,
                                "initialization_timeout": 60.0}}, **train)}


def _ranks(tmp_path, config, env=None, timeout=90):
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    procs = [_spawn(["cli"], cwd=str(tmp_path), env=dict(env or {}, PROCESS_ID=str(r)))
             for r in (0, 1)]
    return _finish(procs, timeout)


def test_ring_learner_on_two_ranks_ends_with_equal_params_and_rank0_writes(tmp_path):
    results = _ranks(tmp_path, _ring_config(_free_port()))
    assert [rc for rc, _, _ in results] == [0, 0], _explain(results)
    crcs = [[line.split("crc32 ")[1] for line in o.splitlines() if "params crc32" in line]
            for _, o, _ in results]
    assert len(crcs[0]) == len(crcs[1]) == 1 and crcs[0] == crcs[1]
    saved = ckpt.load_params(str(tmp_path / "models" / "2.ckpt"))
    assert f"{params_crc32(saved):08x}" == crcs[0][0].split()[0]
    assert sorted(os.listdir(tmp_path)) == ["config.yaml", "metrics.jsonl", "models"]
    # rank 1 is the sp group's member: no actor, its leader's batches
    assert "sp group [0, 1] at index 0 (its leader" in results[0][1]
    assert "sp group [0, 1] at index 1 (a member" in results[1][1]
    assert "batch pipeline: sp-member" in results[1][1]
    assert "started server" in results[1][1] and "batch pipeline: thread" in results[0][1]
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    trained = [r for r in records if "loss" in r]
    assert trained and all(r["dist_ring_shifts"] == 3 * 2 and r["dist_ring_bytes"] > 0
                           and r["dist_ring_ms"] >= 0 for r in trained)
    assert all(np.isfinite(r["loss"]["total"]) for r in trained)


def test_a_peer_lost_inside_the_ring_raises_and_drains_to_75(tmp_path):
    # rank 1 leaves at its 10th ring shift: inside the first steps' rings
    config = _ring_config(_free_port(), epochs=4)
    results = _ranks(tmp_path, config, env={"RING_EXIT_AT_SHIFT": "10:1"})
    assert [rc for rc, _, _ in results] == [75, 1], _explain(results)
    err0 = results[0][2]
    assert "leaves at ring shift 10" in results[1][2]
    assert "host fault" in err0 and "ring_shift" in err0, err0[-3000:]
    drained = [line for line in err0.splitlines() if "drain checkpoint: epoch" in line]
    assert drained, err0[-3000:]
    assert ckpt.latest_verified_epoch(str(tmp_path / "models")) >= 1
