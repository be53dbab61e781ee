"""Training configuration: defaults and validation for the keys the port reads.

The subset of ``handyrl_tpu/config.py`` that the ported modules use, with
the same names and defaults, so one config.yaml ``train_args`` block
configures both packages.  Keys of the JAX package that the port does not
read yet are accepted and passed through untouched.  One default differs:
``batch_pipeline`` is ``'thread'``, the only assembly plane ported; a
config that names another one is refused, not quietly given threads.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

VALID_TARGETS = ("MC", "TD", "UPGO", "VTRACE")
REMAT_RUNGS = ("auto", "none", "attn", "block")

DEFAULT_TRAIN_ARGS: Dict[str, Any] = {
    "turn_based_training": True,
    "observation": False,
    "gamma": 0.8,
    "forward_steps": 16,
    "burn_in_steps": 0,
    "compress_steps": 4,
    "entropy_regularization": 1.0e-1,
    "entropy_regularization_decay": 0.1,
    "update_episodes": 200,
    "batch_size": 128,
    "minimum_episodes": 400,
    "maximum_episodes": 100000,
    "epochs": -1,            # -1 = run until stopped
    "num_batchers": 2,
    "eval_rate": 0.1,
    "worker": {"num_parallel": 6},
    "lambda": 0.7,
    "policy_target": "TD",
    "value_target": "TD",
    "eval": {"opponent": ["random"]},
    "seed": 0,
    # 0 = fresh start; N > 0 = resume from models/{N}.ckpt (digest-checked);
    # -1 = resume from the newest snapshot that verifies
    "restart_epoch": 0,
    # epoch snapshots kept on disk (0 = all); latest/state always survive
    "keep_checkpoints": 100,
    "model_dir": "models",
    "metrics_path": "metrics.jsonl",
    # the most actor requests the inference engine runs in one forward
    "inference_batch_size": 64,
    # device batches the pipeline's put thread keeps ready
    "prefetch_batches": 2,
    "batch_pipeline": "thread",
    # feed-forward nets run only on the live prefix of each window
    "compact_padding": True,
    # a step whose loss, gradient norm or lr is not finite leaves the
    # params and the Adam moments untouched
    "sentinel": True,
    # whole-window attention training for models that set supports_seq
    "seq_forward": True,
    # 'auto' (the masked flash kernel for windows >= flash_min_t, the
    # exact einsum below), 'flash' or 'einsum'
    "seq_attention": "auto",
    "flash_min_t": 128,
    # query rows per chunk of the attention backward's recompute
    "blk_q": 128,
    # the seq path's remat ladder: 'none', 'attn' (checkpoint the attention
    # sublayer), 'block' (the attention+FFN block), or 'auto' ('none' on
    # this backend); true/false collapse to 'block'/'none'.  The RNN branch
    # reads it as on/off per time step ('attn'/'block' on, 'none' off),
    # 'auto' on for every device but the CPU
    "remat": "auto",
    # the JAX package's switch to unroll its RNN training scan (an XLA
    # compile knob): accepted and checked ('auto', true, false) so one
    # config serves both packages, and ignored, since eager PyTorch steps
    # the recurrence in a Python loop either way
    "unroll": "auto",
    # 'bfloat16' runs forward and backward in bf16 over fp32 master weights
    "compute_dtype": "float32",
    "lr_scale": 1.0,
}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def validate_args(args: Dict[str, Any]) -> Dict[str, Any]:
    train = args["train_args"]
    for key in ("policy_target", "value_target"):
        if train[key] not in VALID_TARGETS:
            raise ValueError(f"{key}={train[key]!r} not one of {VALID_TARGETS}")
    for key in ("forward_steps", "batch_size", "compress_steps", "update_episodes"):
        if train[key] <= 0:
            raise ValueError(f"train_args.{key} must be positive, got {train[key]}")
    if train["burn_in_steps"] < 0:
        raise ValueError("train_args.burn_in_steps must be >= 0")
    if train["restart_epoch"] < -1:
        raise ValueError("train_args.restart_epoch must be >= -1 (-1 = auto-resume)")
    if train["keep_checkpoints"] < 0:
        raise ValueError("train_args.keep_checkpoints must be >= 0 (0 = keep all)")
    if not 0.0 <= train["eval_rate"] <= 1.0:
        raise ValueError("train_args.eval_rate must be in [0, 1]")
    if int(train["num_batchers"]) < 0:
        raise ValueError("train_args.num_batchers must be >= 0")
    if int(train["worker"]["num_parallel"]) < 1:
        raise ValueError("train_args.worker.num_parallel must be >= 1")
    pipeline = train["batch_pipeline"]
    if pipeline != "thread":
        later = {"shm": "ROADMAP A5 (shared-memory batchers)",
                 "device": "ROADMAP A7 (the device data plane)"}
        raise ValueError(
            f"train_args.batch_pipeline={pipeline!r}: only 'thread' is ported; "
            + (f"'{pipeline}' waits for {later[pipeline]}" if pipeline in later
               else "one of ('thread', 'shm', 'device')")
        )
    if train["seq_attention"] not in ("auto", "flash", "einsum"):
        raise ValueError(
            f"train_args.seq_attention={train['seq_attention']!r} not one of "
            "('auto', 'flash', 'einsum'); 'ring' is not ported yet"
        )
    if int(train["flash_min_t"]) < 1:
        raise ValueError("train_args.flash_min_t must be >= 1")
    b = int(train["blk_q"])
    if b < 8 or (b & (b - 1)):
        raise ValueError(f"train_args.blk_q must be a power of two >= 8, got {b}")
    rv = train["remat"]
    # bool first: membership would take the ints 0/1 through ==
    if not (isinstance(rv, bool) or rv in REMAT_RUNGS):
        raise ValueError(
            f"train_args.remat={rv!r} not one of ('auto', true, false, 'none', 'attn', 'block')"
        )
    uv = train["unroll"]
    if not (isinstance(uv, bool) or uv in ("auto", None)):
        raise ValueError(f"train_args.unroll={uv!r} not one of ('auto', true, false)")
    if train["compute_dtype"] not in ("float32", "bfloat16"):
        raise ValueError(
            f"train_args.compute_dtype={train['compute_dtype']!r} "
            "not one of ('float32', 'bfloat16')"
        )
    if train["lr_scale"] <= 0:
        raise ValueError(f"train_args.lr_scale must be > 0, got {train['lr_scale']}")
    if "env" not in args.get("env_args", {}):
        raise ValueError("env_args.env is required")
    return args


def normalize_args(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Apply defaults to a raw config dict and validate."""
    train_raw = dict(raw.get("train_args", {}) or {})
    if "attn_mode" in train_raw:  # documented alias of seq_attention
        mode = train_raw.pop("attn_mode")
        if train_raw.get("seq_attention", mode) != mode:
            raise ValueError(
                f"train_args.attn_mode={mode!r} contradicts "
                f"train_args.seq_attention={train_raw['seq_attention']!r} "
                "(attn_mode is an alias; set one)"
            )
        train_raw["seq_attention"] = mode
    args = {
        "env_args": copy.deepcopy(raw.get("env_args", {})),
        "train_args": _deep_merge(DEFAULT_TRAIN_ARGS, train_raw),
    }
    return validate_args(args)
