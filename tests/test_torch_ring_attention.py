"""The port's ring attention against the JAX package's, on the CPU.

The port's side runs in child processes (tests/torch_mp_child.py ``ring``,
no JAX there), one rank each, joined by a gloo group on free localhost
ports and bounded by ``communicate(timeout=...)``; the JAX side runs here,
on tests/conftest.py's 8-device CPU mesh.  Inputs are made with numpy from
a seed (tests/test_parallel.py's shapes: B2, T16, H2, D4).

* Forward: the port's ``masked_ring_self_attention`` over 2 and 4 ranks
  and over ``{'dp': 2, 'sp': 2}`` against JAX's ``masked_ring_self_attention``
  on ``{'sp': n}`` and against JAX's ``masked_attention_reference``, at
  windows 1 << 30 and 6; the plain causal and full ring against
  ``full_attention_reference``.  Tolerance 2e-5 (tests/test_parallel.py's).
* Backward: each rank's gradients through the hand-written backward of the
  shard op against ``jax.grad`` of JAX's references, 1e-4.
* The transformer's seq mode on shards with burn-in 6 over a shard
  boundary at 4 (sp 2, T 8): its parameter gradients, summed over the
  ranks, equal ``jax.grad`` of the JAX net's on the whole window (1e-4 of
  the largest), and the warm-up steps' observation gradients are zero: no
  gradient reaches a warm-up key or value.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.ops import full_attention_reference as jax_full_reference
from handyrl_tpu.ops import masked_ring_self_attention as jax_masked_ring
from handyrl_tpu.ops.flash_attention import masked_attention_reference as jax_masked_reference
from handyrl_tpu.parallel import make_mesh as jax_make_mesh
from handyrl_tpu_torch.models import flax_to_state_dict
from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree

ROOT = Path(__file__).resolve().parent.parent
CHILD = str(Path(__file__).resolve().parent / "torch_mp_child.py")
B, T, H, D = 2, 16, 2, 4
NET_ENV = {"env": "Geister", "net": "transformer",
           "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 8}}
NET_ROWS, NET_T, NET_BURN_IN = 2, 8, 6


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp_path, cases, inputs, nprocs, timeout=60):
    """The ``ring`` child on ``nprocs`` ranks, started; ``collect()`` gives
    each rank's results (the JAX side runs here meanwhile)."""
    (tmp_path / "inputs.npz").write_bytes(_pack_tree(inputs))
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    environ = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    environ.pop("JAX_PLATFORMS", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, CHILD, "ring", str(tmp_path), str(r), str(port),
                               str(nprocs)], env=environ, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(nprocs)]
    deadline = time.monotonic() + timeout

    def collect():
        results = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                results.append((proc.returncode, out, err))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        assert all(rc == 0 for rc, _, _ in results), "\n".join(
            f"--- rc {rc}\n{o[-2000:]}\n{e[-3000:]}" for rc, o, e in results)
        return [_unpack_tree((tmp_path / f"rank{r}.npz").read_bytes()) for r in range(nprocs)]

    return collect


def _attention_case(seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    key_mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    slopes = (2.0 ** -np.arange(1, H + 1)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "dout": dout, "key_mask": key_mask, "slopes": slopes}


def _cases(meshes):
    cases, inputs = {}, {}
    for i, mesh in enumerate(meshes):
        tag = "_".join(f"{a}{s}" for a, s in mesh.items())
        for window in (1 << 30, 6):
            name = f"masked_{tag}_w{window}"
            cases[name] = {"kind": "masked", "mesh": mesh, "window": window}
            inputs[name] = _attention_case(10 * i + (window == 6))
        for causal in (True, False):
            name = f"plain_{tag}_{'causal' if causal else 'full'}"
            cases[name] = {"kind": "plain", "mesh": mesh, "causal": causal}
            inputs[name] = _attention_case(10 * i + 5 + causal)
    return cases, inputs


def _blocks(ranks, name, key):
    """The whole (B, T, ...) array from each rank's block (rows by its dp
    position, time by its sp position)."""
    dp = 1 + max(int(r[name]["coords"][0]) for r in ranks)
    sp = 1 + max(int(r[name]["coords"][1]) for r in ranks)
    shape = ranks[0][name][key].shape
    out = np.zeros((shape[0] * dp, shape[1] * sp) + shape[2:], np.float32)
    for r in ranks:
        i, j = (int(c) for c in r[name]["coords"])
        out[i * shape[0]:(i + 1) * shape[0], j * shape[1]:(j + 1) * shape[1]] = r[name][key]
    return out


def _jax_attention(cases, inputs):
    """Per case: JAX's whole output, its ring's (masked cases) and the
    gradients of ``(out * dout).sum()``."""
    want = {}
    for name, case in cases.items():
        x = {k: jnp.asarray(v) for k, v in inputs[name].items()}
        if case["kind"] == "masked":
            def ref(q, k, v):
                return jax_masked_reference(q, k, v, x["key_mask"], x["slopes"],
                                            window=case["window"])
            sp = case["mesh"]["sp"]
            jring = jax_masked_ring(x["q"], x["k"], x["v"], x["key_mask"], x["slopes"],
                                    jax_make_mesh({"sp": sp}), window=case["window"])
        else:
            def ref(q, k, v):
                return jax_full_reference(q, k, v, causal=case["causal"])
            jring = None
        grad = jax.jit(jax.grad(lambda q, k, v: (ref(q, k, v) * x["dout"]).sum(),
                                argnums=(0, 1, 2)))
        grads = grad(x["q"], x["k"], x["v"])
        want[name] = (np.asarray(ref(x["q"], x["k"], x["v"])),
                      None if jring is None else np.asarray(jring), grads)
    return want


def _check_attention(ranks, cases, want):
    for name, case in cases.items():
        ref, jring, grads = want[name]
        for r in ranks:   # every rank returns the whole output
            np.testing.assert_allclose(r[name]["out"], ref, rtol=2e-5, atol=2e-5, err_msg=name)
            if jring is not None:
                np.testing.assert_allclose(r[name]["out"], jring, rtol=2e-5, atol=2e-5,
                                           err_msg=name)
        for key, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(_blocks(ranks, name, key), np.asarray(g), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {key}")
        # a forward rotates n - 1 times, a backward n (its last shift carries
        # only the fp32 dK/dV accumulators home): the whole-output forward,
        # then the shard op's forward and backward
        n = case["mesh"]["sp"]
        assert all(int(r[name]["ring"][0]) == 3 * n - 2 for r in ranks), name


def _net_case():
    rng = np.random.default_rng(7)
    jenv = jax_make_env(NET_ENV)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=5)
    obs = {"board": (rng.random((NET_ROWS, NET_T, 7, 6, 6)) < 0.3).astype(np.float32),
           "scalar": (rng.random((NET_ROWS, NET_T, 18)) < 0.5).astype(np.float32)}
    key_mask = (rng.random((NET_ROWS, NET_T)) < 0.8).astype(np.float32)
    dout = {"policy": rng.standard_normal((NET_ROWS, NET_T, 214)).astype(np.float32),
            "value": rng.standard_normal((NET_ROWS, NET_T, 1)).astype(np.float32),
            "return": rng.standard_normal((NET_ROWS, NET_T, 1)).astype(np.float32)}
    params = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, variables["params"])).items()}
    return jmodule, variables, {"params": params, "obs": obs, "key_mask": key_mask,
                                "dout": dout}


def test_masked_and_plain_ring_over_two_ranks_and_the_burn_in_net(tmp_path):
    cases, inputs = _cases([{"sp": 2}])
    jmodule, variables, net = _net_case()
    cases["net"] = {"kind": "net", "mesh": {"sp": 2}, "env": NET_ENV, "burn_in": NET_BURN_IN}
    inputs["net"] = net
    collect = _start_ranks(tmp_path, cases, inputs, 2)
    attention = {k: v for k, v in cases.items() if k != "net"}
    want = _jax_attention(attention, inputs)

    def loss(params):
        outs = jmodule.apply({"params": params}, net["obs"], None, seq=True,
                             key_mask=jnp.asarray(net["key_mask"]), burn_in=NET_BURN_IN)
        return sum((outs[k] * net["dout"][k])[:, NET_BURN_IN:].sum() for k in net["dout"])

    jgrads = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(variables["params"]))).items()}
    ranks = collect()
    _check_attention(ranks, attention, want)
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        got = sum(r["net"]["grads"][name] for r in ranks)   # each rank's token part
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
    # no gradient reaches a warm-up key or value: the warm-up steps' inputs
    # feed nothing else the loss reads (their own outputs are cut)
    t = NET_T // 2
    for key in net["obs"]:
        whole = np.concatenate([r["net"]["obs_grads"][key] for r in ranks], axis=1)
        assert whole.shape[1] == NET_T
        assert np.all(whole[:, :NET_BURN_IN] == 0), key
        assert np.any(whole[:, NET_BURN_IN:] != 0), key
    assert t < NET_BURN_IN   # the shard boundary lies inside the burn-in


def test_masked_and_plain_ring_over_four_ranks_and_dp_by_sp(tmp_path):
    cases, inputs = _cases([{"sp": 4}, {"dp": 2, "sp": 2}])
    collect = _start_ranks(tmp_path, cases, inputs, 4)
    want = _jax_attention(cases, inputs)
    _check_attention(collect(), cases, want)


def test_ring_shard_refuses_to_run_without_a_group():
    import torch

    from handyrl_tpu_torch.ops import masked_ring_attention_shard, ring_attention_shard

    q = torch.zeros(1, 4, 1, 4)
    with pytest.raises(ValueError, match="needs the sp group"):
        masked_ring_attention_shard(q, q, q, torch.ones(1, 4), torch.ones(1, 4),
                                    torch.ones(1), None)
    with pytest.raises(ValueError, match="needs the sp group"):
        ring_attention_shard(q, q, q, None)
