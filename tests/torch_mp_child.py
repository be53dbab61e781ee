"""The child processes of tests/test_torch_multiprocess.py.

Run as ``python tests/torch_mp_child.py MODE ARGS...`` with the repo on
``PYTHONPATH``; each imports the port only (never JAX), on the CPU, and
joins a gloo group where the mode needs one:

* ``step WORKDIR RANK PORT``: three data-parallel train steps of each case
  in ``WORKDIR/inputs.npz`` on this rank's half of the global batch; writes
  the first step's metrics, reduced gradients and params, and the params'
  CRC32 after three steps, to ``WORKDIR/rank{RANK}.npz``.
* ``resume RANK PORT LOCAL``: joins the group and prints the epoch that
  ``broadcast_resume_epoch(LOCAL)`` agrees on.
* ``ring WORKDIR RANK PORT NPROCS``: each case of ``WORKDIR/cases.json``
  (inputs in ``inputs.npz``) on its mesh: the whole output of
  ``masked_ring_self_attention`` / ``ring_self_attention``, and this rank's
  block of the gradients of ``(shard_out * dout).sum()`` through the shard
  op; for a ``net`` case the small transformer's seq mode on this rank's
  shard with burn-in, its parameter gradients (this rank's part) and its
  observations' gradient; writes ``WORKDIR/rank{RANK}.npz``.
* ``ringstep WORKDIR RANK PORT``: one train step of ``seq_attention:
  ring`` on ``{'sp': 2}`` from ``WORKDIR/inputs.npz``; writes the metrics,
  the updated params and their CRC32.
* ``cli``: ``main(["--train"], device="cpu")`` from the working directory,
  which holds config.yaml; the exit code is the run's.  With
  ``RING_EXIT_AT_SHIFT=N:R`` in the environment, rank R leaves (exit 1) at
  its N-th ring shift: a peer lost inside the ring.
"""

import json
import os
import sys

import numpy as np

LR = 1e-3


def _group(rank: int, port: int, nprocs: int = 2):
    from handyrl_tpu_torch.parallel import distributed

    distributed.init_distributed({"coordinator_address": f"127.0.0.1:{port}",
                                  "num_processes": nprocs, "process_id": rank,
                                  "initialization_timeout": 60.0}, device="cpu")
    return distributed


def step(workdir: str, rank: int, port: int) -> int:
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree
    from handyrl_tpu_torch.utils import tree_map

    torch.set_num_threads(1)
    distributed = _group(rank, port)
    with open(os.path.join(workdir, "inputs.npz"), "rb") as f:
        inputs = _unpack_tree(f.read())
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, args in cases.items():
        module = make_env(args["env"]).net()
        module.load_state_dict({k: torch.from_numpy(v) for k, v in inputs[name]["params"].items()})
        ctx = TrainContext(module, args, device="cpu")
        batch = inputs[name]["batch"]
        half = batch["action"].shape[0] // 2
        local = tree_map(lambda x: x[rank * half:(rank + 1) * half], batch)
        metrics = ctx.train_step(local, LR).fetch()
        grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
        params1 = {n: p.detach().clone() for n, p in module.named_parameters()}
        for _ in range(2):
            ctx.train_step(local, LR).fetch()
        out[name] = {"metrics": {k: np.float64(v) for k, v in metrics.items()},
                     "grads": grads, "params1": params1,
                     "crc": np.array([distributed.params_crc32(module.state_dict())],
                                     dtype=np.int64),
                     "bucket_bytes": np.array([ctx.grad_reduce.stats()["bucket_bytes"]])}
    with open(os.path.join(workdir, f"rank{rank}.npz"), "wb") as f:
        f.write(_pack_tree(out))
    distributed.shutdown_distributed()
    return 0


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def ring(workdir: str, rank: int, port: int, nprocs: int) -> int:
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.ops import ring_attention as ra
    from handyrl_tpu_torch.parallel.mesh import make_mesh
    from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree

    torch.set_num_threads(1)
    distributed = _group(rank, port, nprocs)
    with open(os.path.join(workdir, "inputs.npz"), "rb") as f:
        inputs = _unpack_tree(f.read())
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, case in cases.items():
        x = _tensors(inputs[name])
        mesh = make_mesh(case["mesh"])
        mesh.build_groups()
        sp = mesh.group("sp")
        coords = mesh.coords(rank)
        res = {"coords": np.array([coords.get("dp", 0), coords["sp"]])}
        if case["kind"] == "net":
            module = make_env(case["env"]).net()
            module.load_state_dict(x["params"])
            T = x["key_mask"].shape[1]
            t = T // sp.size
            cut = slice(sp.index * t, (sp.index + 1) * t)
            obs = {k: v[:, cut].clone().requires_grad_() for k, v in x["obs"].items()}
            outs = module(obs, None, seq=True, key_mask=x["key_mask"][:, cut],
                          burn_in=case["burn_in"], ring=sp)
            loss = sum((sp.gather(outs[k], dim=1) * x["dout"][k])[:, case["burn_in"]:].sum()
                       for k in x["dout"])
            loss.backward()
            res["grads"] = {n: p.grad for n, p in module.named_parameters()}
            res["obs_grads"] = {k: v.grad for k, v in obs.items()}
            out[name] = res
            continue
        if case["kind"] == "masked":
            whole = ra.masked_ring_self_attention(x["q"], x["k"], x["v"], x["key_mask"],
                                                  x["slopes"], mesh, window=case["window"])
        else:
            whole = ra.ring_self_attention(x["q"], x["k"], x["v"], mesh, causal=case["causal"])
        counts = torch.cumsum(x["key_mask"], dim=1)
        q, k, v = (ra._shard(mesh, x[n], "sp", "dp").requires_grad_() for n in "qkv")
        dout = ra._shard(mesh, x["dout"], "sp", "dp")
        if case["kind"] == "masked":
            km, c = (ra._shard(mesh, y, "sp", "dp") for y in (x["key_mask"], counts))
            shard = ra.masked_ring_attention_shard(q, k, v, km, c, x["slopes"], sp,
                                                   float(case["window"]))
        else:
            shard = ra.ring_attention_shard(q, k, v, sp, case["causal"])
        (shard * dout).sum().backward()
        res.update(out=whole.detach(), dq=q.grad, dk=k.grad, dv=v.grad,
                   ring=np.array([sp.stats()["shifts"], sp.stats()["bytes"]]))
        out[name] = res
    with open(os.path.join(workdir, f"rank{rank}.npz"), "wb") as f:
        f.write(_pack_tree(out))
    distributed.shutdown_distributed()
    return 0


def ringstep(workdir: str, rank: int, port: int) -> int:
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime.plane import _pack_tree, _unpack_tree

    torch.set_num_threads(1)
    distributed = _group(rank, port)
    with open(os.path.join(workdir, "inputs.npz"), "rb") as f:
        inputs = _unpack_tree(f.read())
    with open(os.path.join(workdir, "args.json")) as f:
        args = json.load(f)
    module = make_env(args["env"]).net()
    module.load_state_dict(_tensors(inputs["params"]))
    ctx = TrainContext(module, args, device="cpu")
    # every rank of the sp group holds the group's whole batch
    metrics = ctx.train_step(inputs["batch"], LR).fetch()
    out = {"metrics": {k: np.float64(v) for k, v in metrics.items()},
           "params": {n: p.detach() for n, p in module.named_parameters()},
           "crc": np.array([distributed.params_crc32(module.state_dict())], dtype=np.int64),
           "ring": np.array([ctx.seq_group.stats()["shifts"], ctx.seq_group.stats()["bytes"]])}
    with open(os.path.join(workdir, f"rank{rank}.npz"), "wb") as f:
        f.write(_pack_tree(out))
    distributed.shutdown_distributed()
    return 0


def _exit_at_shift(spec: str) -> None:
    """``N:R``: rank R's N-th ring shift exits the process before sending."""
    from handyrl_tpu_torch.parallel import distributed

    at, victim = (int(x) for x in spec.split(":"))
    if int(os.environ.get("PROCESS_ID", "0")) != victim:
        return
    shift, calls = distributed.ring_shift, [0]

    def dying_shift(*args, **kwargs):
        calls[0] += 1
        if calls[0] >= at:
            print(f"[test] rank {victim} leaves at ring shift {calls[0]}", file=sys.stderr,
                  flush=True)
            os._exit(1)
        return shift(*args, **kwargs)

    distributed.ring_shift = dying_shift


def resume(rank: int, port: int, local: int) -> int:
    distributed = _group(rank, port)
    print("agreed epoch", distributed.broadcast_resume_epoch(local), flush=True)
    distributed.shutdown_distributed()
    return 0


def cli() -> int:
    import torch

    from handyrl_tpu_torch.main import main

    torch.set_num_threads(1)
    if os.environ.get("RING_EXIT_AT_SHIFT"):
        _exit_at_shift(os.environ["RING_EXIT_AT_SHIFT"])
    return main(["--train"], device="cpu")


if __name__ == "__main__":
    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "step":
        sys.exit(step(rest[0], int(rest[1]), int(rest[2])))
    if mode == "ring":
        sys.exit(ring(rest[0], int(rest[1]), int(rest[2]), int(rest[3])))
    if mode == "ringstep":
        sys.exit(ringstep(rest[0], int(rest[1]), int(rest[2])))
    if mode == "resume":
        sys.exit(resume(int(rest[0]), int(rest[1]), int(rest[2])))
    sys.exit(cli())
