"""Training configuration: defaults and validation for the keys the port reads.

The subset of ``handyrl_tpu/config.py`` that the ported modules use, with
the same names and defaults, so one config.yaml (``env_args``,
``train_args``, ``worker_args``) configures both packages.  Keys of the JAX
package that the port does not read are accepted and passed through
untouched, except those that select a plane the port lacks: a non-default
value of one of ``NOT_PORTED_KEYS`` is refused, naming the ROADMAP item
that ports it, not quietly run on the plain loop.  Every default is the
JAX package's, ``batch_pipeline: shm`` included; ``device``, the one
assembly plane not ported, is refused too.  On-device self-play and
evaluation (``device_rollout_games``, ``device_eval_games``) are ported, on
the fused plane of one card.
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
    "worker": {
        "num_parallel": 6,
        "entry_port": 9999,
        "data_port": 9998,
        # liveness ping cadence of the remote actor plane, both directions;
        # a peer silent for ~3 intervals is presumed dead (0 disables both)
        "heartbeat_interval": 10.0,
        # the longest stall (no byte of progress) of a gather's send or
        # receive, not a bound on a whole frame: a params blob crossing a
        # slow link stays alive while bytes flow
        "socket_timeout": 60.0,
        # the entry handshake's absolute deadline: a client that connects
        # and stalls is dropped so later joins go on
        "entry_timeout": 10.0,
    },
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
    # the batch-assembly plane: 'shm' forks num_batchers processes that
    # write columnar batches into shared-memory ring slots, off the
    # learner's GIL (runtime/shm_batch.py); 'thread' runs the batchers as
    # threads of the learner, and is what 'shm' degrades to, loudly, when
    # its processes cannot run; 'device' is not ported
    "batch_pipeline": "shm",
    # ring depth in slots of one (B, T, P, ...) batch, raised to
    # 2 * fused_steps + 2 (effective_shm_slots)
    "shm_slots": 6,
    # a batcher process that dies is respawned this many times in a run;
    # past that, or when the ring stays silent this many seconds after a
    # death, the pipeline degrades to threads
    "batcher_max_restarts": 3,
    "batcher_stall_timeout": 60.0,
    # k updates per pull of the pipeline: the batches travel as one
    # stacked group, and the trainer takes them in a row at one lr
    "fused_steps": 1,
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
    # query rows per chunk of the attention backward's recompute; blk_k,
    # the JAX kernel's key block, is checked as there and not read
    "blk_q": 128,
    "blk_k": 128,
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
    # the network battle server's port (--eval-server / --eval-client)
    "battle_port": 9876,
    # on-device self-play: > 0 runs this many persistent lanes (episodic
    # games for a twin without the streaming hooks) of the env's device
    # twin on the card, beside the host actors (runtime/device_rollout.py)
    "device_rollout_games": 0,
    # on-device evaluation at each epoch boundary: > 0 plays this many
    # games of the net against eval.opponent's first entry (rulebase or
    # random) on the card (runtime/device_eval.py)
    "device_eval_games": 0,
    # the rollout thread's watchdog: a thread that dies, or makes no
    # progress for plane_stall_timeout seconds after its first block, is
    # restarted up to plane_max_restarts times
    "plane_stall_timeout": 120.0,
    "plane_max_restarts": 2,
}

DEFAULT_WORKER_ARGS: Dict[str, Any] = {
    "server_address": "",
    "num_parallel": 8,
    "entry_port": 9999,
    # on a severed or stalled connection the worker machine tears its
    # session down and re-enters through the entry port with exponential
    # backoff; rejoin: false joins once
    "rejoin": True,
    "rejoin_backoff": 1.0,
    "rejoin_backoff_max": 60.0,
    # consecutive failed sessions before giving up (-1 = never)
    "max_rejoins": -1,
    # how long each entry attempt retries the TCP connect
    "entry_retry_seconds": 60.0,
}

# keys of the JAX package that select a plane the port lacks: the key's
# path in train_args, its JAX default, and the ROADMAP item that ports it
NOT_PORTED_KEYS = (
    (("device_replay",), False, "A7 (the device data plane)"),
    (("plane",), "fused", "A7 (the device data plane)"),
    (("obs_int8",), False, "A7 (the device data plane)"),
    # acts only under plane: split
    (("plane_param_lag_bound",), 0, "A7 (the device data plane)"),
    # verifies an autovec-lifted twin, and the port has no autovec
    (("autovec_verify_games",), 0, "A7 (the device data plane)"),
    (("distributed", "num_processes"), 1, "A8 (multiple GPUs)"),
    (("flywheel", "enabled"), False, "A10 (serving and the rest)"),
    (("trace", "enabled"), False, "A8 (the learner's fault machinery and tracing)"),
    (("profile_dir",), None, "A8 (the learner's fault machinery and tracing)"),
)


def effective_shm_slots(train: Dict[str, Any]) -> int:
    """The ring depth the shm pipeline allocates: ``shm_slots`` raised so
    the put thread can hold two fused groups in flight while the children
    keep filling.  ``validate_args`` checks ``num_batchers`` against it."""
    return max(int(train.get("shm_slots", 6)), 2 * int(train.get("fused_steps", 1)) + 2, 3)


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
    if pipeline == "device":
        raise ValueError(
            "train_args.batch_pipeline='device' is not ported to handyrl_tpu_torch yet: "
            "ROADMAP A7 (the device data plane)"
        )
    if pipeline not in ("shm", "thread"):
        raise ValueError(
            f"train_args.batch_pipeline={pipeline!r} not one of ('shm', 'thread', 'device')"
        )
    if int(train["fused_steps"]) < 1:
        raise ValueError("train_args.fused_steps must be >= 1")
    if int(train["shm_slots"]) < 2:
        raise ValueError("train_args.shm_slots must be >= 2")
    if int(train["batcher_max_restarts"]) < 0:
        raise ValueError("train_args.batcher_max_restarts must be >= 0")
    if float(train["batcher_stall_timeout"]) <= 0:
        raise ValueError("train_args.batcher_stall_timeout must be > 0")
    # the ring depth promised at any fused_steps (the JAX trainer may clamp
    # fused_steps to 1 at run time, so only that floor is checked there too)
    floor_slots = effective_shm_slots(dict(train, fused_steps=1))
    if pipeline == "shm" and int(train["num_batchers"]) > floor_slots:
        # a child beyond the ring depth would never be dealt a slot
        raise ValueError(
            f"train_args.num_batchers={train['num_batchers']} exceeds the guaranteed shm "
            f"ring depth {floor_slots} (shm_slots={train['shm_slots']}): each batcher "
            "process needs at least one ring slot to hold; raise shm_slots or lower "
            "num_batchers"
        )
    if train["seq_attention"] not in ("auto", "flash", "einsum"):
        raise ValueError(
            f"train_args.seq_attention={train['seq_attention']!r} not one of "
            "('auto', 'flash', 'einsum'); 'ring' is not ported yet"
        )
    if int(train["flash_min_t"]) < 1:
        raise ValueError("train_args.flash_min_t must be >= 1")
    for key in ("blk_q", "blk_k"):
        b = int(train[key])
        if b < 8 or (b & (b - 1)):
            raise ValueError(f"train_args.{key} must be a power of two >= 8, got {b}")
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
    if train["device_rollout_games"] < 0:
        raise ValueError("train_args.device_rollout_games must be >= 0")
    if train["device_eval_games"] < 0:
        raise ValueError("train_args.device_eval_games must be >= 0")
    if train["plane_stall_timeout"] <= 0:
        raise ValueError("train_args.plane_stall_timeout must be > 0")
    if train["plane_max_restarts"] < 0:
        raise ValueError("train_args.plane_max_restarts must be >= 0")
    for path, default, item in NOT_PORTED_KEYS:
        value = train
        for key in path:
            value = value.get(key, default) if isinstance(value, dict) else default
        if value != default:
            raise ValueError(
                f"train_args.{'.'.join(path)}={value!r} selects a plane that is not ported to "
                f"handyrl_tpu_torch yet: ROADMAP {item}"
            )
    worker_args = args.get("worker_args", {})
    if worker_args and float(worker_args.get("entry_retry_seconds", 60.0)) <= 0:
        raise ValueError("worker_args.entry_retry_seconds must be > 0")
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
        "worker_args": _deep_merge(DEFAULT_WORKER_ARGS, raw.get("worker_args", {}) or {}),
    }
    return validate_args(args)
