"""Command line of the port, run from a directory that holds config.yaml:

    python -m handyrl_tpu_torch.main --train            # learner + local actors
    python -m handyrl_tpu_torch.main --train-server     # learner serving worker machines
    python -m handyrl_tpu_torch.main --worker [NUM_PARALLEL]
    python -m handyrl_tpu_torch.main --eval MODELS NUM_GAMES NUM_WORKERS
    python -m handyrl_tpu_torch.main --eval-server [NUM_GAMES]
    python -m handyrl_tpu_torch.main --eval-client AGENT [HOST] [N_GAMES]
    python -m handyrl_tpu_torch.main --serve            # the inference serving plane
    python -m handyrl_tpu_torch.main --fleet            # the fleet over --serve replicas
    python -m handyrl_tpu_torch.main --edge [ARTIFACT]  # an exported .pt2 as edge capacity

It reads the config.yaml the JAX package's ``main.py`` reads (``--worker``
reads ``worker_args.server_address`` and the entry port; ``--eval-server``
and ``--eval-client`` ``train_args.battle_port``; ``--serve`` the
``serving`` block) and runs on the card.  ``main(argv, device="cpu")``
runs on the CPU from Python; the command line has no device flag.
``--serve`` and ``--train`` exit 75 after a SIGTERM drain.  ``--fleet``
reads ``train_args.fleet``: it fronts ``fleet.replicas`` (each started with
``--serve``) and, with ``fleet.autoscale.enabled``, spawns and retires
serving processes of its own on the card.  ``--edge`` serves an artifact
of ``python -m handyrl_tpu_torch.models.export`` (``fleet.edge_model``
when none is given) on ``fleet.edge_port``.  The JAX CLI's league mode is
not ported yet: it exits 1 naming its ROADMAP item.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from .config import normalize_args

NOT_PORTED = {
    "--league": "ROADMAP A10, item 6 (the league)",
    "-l": "ROADMAP A10, item 6 (the league)",
}


def load_args(path: str = "config.yaml") -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return normalize_args(yaml.safe_load(f) or {})


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """``argv`` is the command line after the program name."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("Please set mode of HandyRL-TPU.")
        return 1
    mode = argv[0]
    if mode in ("--train", "-t"):
        from .runtime.learner import train_main

        return train_main(load_args(), device=device)
    if mode in ("--train-server", "-ts"):
        from .runtime.learner import train_server_main

        return train_server_main(load_args(), device=device)
    if mode in ("--worker", "-w"):
        from .runtime.server import worker_main

        # worker_main reads NUM_PARALLEL where sys.argv holds it, at [2]
        worker_main(load_args(), ["main", *argv], device=device)
        return 0
    if mode in ("--eval", "-e"):
        from .runtime.evaluation import eval_main

        eval_main(load_args(), argv[1:], device=device)
        return 0
    if mode in ("--eval-server", "-es"):
        from .runtime.battle import eval_server_main

        eval_server_main(load_args(), argv[1:])
        return 0
    if mode in ("--eval-client", "-ec"):
        from .runtime.battle import eval_client_main

        eval_client_main(load_args(), argv[1:], device=device)
        return 0
    if mode in ("--serve", "-s"):
        from .serving.server import serve_main

        return serve_main(load_args(), device=device)
    if mode in ("--fleet", "-f"):
        from .fleet.router_tier import fleet_main

        # its replicas are processes of their own: the device names theirs
        return fleet_main(load_args(), device=device)
    if mode == "--edge":
        from .fleet.edge import edge_main

        args = load_args()
        if len(argv) > 1:
            args["edge_model"] = argv[1]
        return edge_main(args, device=device)
    if mode in NOT_PORTED:
        print(f"mode {mode} is not ported to handyrl_tpu_torch yet ({NOT_PORTED[mode]})")
        return 1
    print("Unknown mode %s" % mode)
    return 1


if __name__ == "__main__":
    sys.exit(main())
