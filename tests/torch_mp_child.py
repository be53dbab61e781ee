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
* ``cli``: ``main(["--train"], device="cpu")`` from the working directory,
  which holds config.yaml; the exit code is the run's.
"""

import json
import os
import sys

import numpy as np

LR = 1e-3


def _group(rank: int, port: int):
    from handyrl_tpu_torch.parallel import distributed

    distributed.init_distributed({"coordinator_address": f"127.0.0.1:{port}",
                                  "num_processes": 2, "process_id": rank,
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


def resume(rank: int, port: int, local: int) -> int:
    distributed = _group(rank, port)
    print("agreed epoch", distributed.broadcast_resume_epoch(local), flush=True)
    distributed.shutdown_distributed()
    return 0


def cli() -> int:
    import torch

    from handyrl_tpu_torch.main import main

    torch.set_num_threads(1)
    return main(["--train"], device="cpu")


if __name__ == "__main__":
    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "step":
        sys.exit(step(rest[0], int(rest[1]), int(rest[2])))
    if mode == "resume":
        sys.exit(resume(int(rest[0]), int(rest[1]), int(rest[2])))
    sys.exit(cli())
