"""Command line of the port, run from a directory that holds config.yaml:

    python -m handyrl_tpu_torch.main --train            # learner + local actors
    python -m handyrl_tpu_torch.main --eval MODELS NUM_GAMES NUM_WORKERS

It reads the config.yaml the JAX package's ``main.py`` reads and runs on
the card.  ``main(argv, device="cpu")`` runs on the CPU from Python; the
command line has no device flag.  The JAX CLI's other modes are not ported
yet: each exits 1 saying so.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from .config import normalize_args

NOT_PORTED = {
    "--train-server": "ROADMAP A9", "-ts": "ROADMAP A9",
    "--worker": "ROADMAP A9", "-w": "ROADMAP A9",
    "--eval-server": "ROADMAP A9", "-es": "ROADMAP A9",
    "--eval-client": "ROADMAP A9", "-ec": "ROADMAP A9",
    "--serve": "ROADMAP A10", "-s": "ROADMAP A10",
    "--fleet": "ROADMAP A10", "-f": "ROADMAP A10",
    "--edge": "ROADMAP A10",
    "--league": "ROADMAP A10", "-l": "ROADMAP A10",
}


def load_args(path: str = "config.yaml") -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return normalize_args(yaml.safe_load(f) or {})


def main(argv: Optional[List[str]] = None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("Please set mode of HandyRL-TPU.")
        return 1
    mode = argv[0]
    if mode in ("--train", "-t"):
        from .runtime.learner import train_main

        return train_main(load_args(), device=device)
    if mode in ("--eval", "-e"):
        from .runtime.evaluation import eval_main

        eval_main(load_args(), argv[1:], device=device)
        return 0
    if mode in NOT_PORTED:
        print(f"mode {mode} is not ported to handyrl_tpu_torch yet ({NOT_PORTED[mode]})")
        return 1
    print("Unknown mode %s" % mode)
    return 1


if __name__ == "__main__":
    sys.exit(main())
