"""Training configuration: defaults and validation for the keys the port reads.

The subset of ``handyrl_tpu/config.py`` that the ported modules use, with
the same names and defaults, so one config.yaml (``env_args``,
``train_args``, ``worker_args``) configures both packages.  Keys of the JAX
package that the port does not read are accepted and passed through
untouched, except those that select a plane the port lacks: a non-default
value of one of ``NOT_PORTED_KEYS`` is refused, naming the ROADMAP item
that ports it, not quietly run on the plain loop.  Every default is the
JAX package's, ``batch_pipeline: shm`` included.  On-device self-play and
evaluation (``device_rollout_games``, ``device_eval_games``) and the
device data plane (``device_replay``, ``batch_pipeline: device``) are
ported, on the fused plane of one card, and so is the ``serving`` block of
``--serve`` (its int8 weights excepted).
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
    # its processes cannot run; 'device' uploads host-born episodes once
    # into ring buffers on the card and samples and assembles every batch
    # there (runtime/device_batch.py), degrading loudly to 'shm'
    "batch_pipeline": "shm",
    # batch_pipeline: device geometry: episodes queue over this many ring
    # lanes, each lane holds this many steps, and a chunk of this many
    # steps per lane is uploaded at once
    "device_stage_lanes": 8,
    "device_stage_slots": 1024,
    "device_stage_chunk": 64,
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
    # true: keep the self-play data on the card end to end: the rollout's
    # records go into ring buffers on the card, and every batch is sampled
    # and assembled there (runtime/device_replay.py); needs
    # device_rollout_games > 0, and turn_based_training picks the window
    # mode (one target player, or all players with observation: true)
    "device_replay": False,
    # ring length in steps per lane, and game steps per rollout launch
    "device_replay_slots": 1024,
    "device_replay_k_steps": 32,
    # the rollout thread's watchdog: a thread that dies, or makes no
    # progress for plane_stall_timeout seconds after its first block, is
    # restarted up to plane_max_restarts times
    "plane_stall_timeout": 120.0,
    "plane_max_restarts": 2,
    # --serve's SIGTERM drain: the server pushes a draining notice to every
    # peer, waits this long for its sessions to be pulled, and exits 75
    "drain_deadline_seconds": 60.0,
    # the inference serving plane (serving/, --serve)
    "serving": {
        # TCP port of the serving front (0 = a free one)
        "port": 9997,
        # resident snapshot engines beyond which the LRU non-latest engine
        # is retired (drained, never dropped); the latest is always kept
        "max_models": 4,
        # default per-request latency budget (not imposed under
        # shed_policy: none; a request's own slo_ms always holds)
        "slo_ms": 200.0,
        # 'deadline' sheds on a predicted SLO miss (queue waves x the EMA
        # batch time), 'queue' only at queue_bound, 'none' never
        "shed_policy": "deadline",
        # the largest power-of-two bucket of one device batch
        "max_batch": 64,
        # straggler wait once a batch's first request arrived
        "max_wait_ms": 2.0,
        # buckets each engine runs once before it serves (and before a hot
        # swap flips to it)
        "warm_buckets": [1, 8],
        # queued requests per engine (both shed policies enforce it)
        "queue_bound": 1024,
        # a silent client is dropped after this many seconds (0 = never)
        "recv_timeout": 0.0,
        # seconds between manifest polls for an automatic hot swap to a
        # newer verified snapshot (0 = swap only when asked)
        "watch_interval": 0.0,
        # seconds between serve_* records appended to metrics_path (0 = off)
        "stats_interval": 30.0,
        # server-resident sessions: hidden states kept on the device before
        # the LRU spills to the host (0 turns sessions off)
        "session_capacity": 1024,
        # the host spill ring beyond session_capacity; past it the oldest
        # spilled session is dropped (its next infer is an affinity miss)
        "session_spill": 4096,
        # engine weights: 'float32' ('int8' needs models/quantize.py)
        "weight_dtype": "float32",
    },
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
    (("plane",), "fused", "A7 (the device data plane)"),
    # needs models/quantize.py
    (("obs_int8",), False, "A10 (models/quantize.py, int8)"),
    # acts only under plane: split
    (("plane_param_lag_bound",), 0, "A7 (the device data plane)"),
    # verifies an autovec-lifted twin, and the port has no autovec
    (("autovec_verify_games",), 0, "A7 (the device data plane)"),
    (("distributed", "num_processes"), 1, "A8 (multiple GPUs)"),
    (("flywheel", "enabled"), False, "A10 (serving and the rest)"),
    (("serving", "weight_dtype"), "float32", "A10 (models/quantize.py, int8)"),
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
    if pipeline not in ("shm", "thread", "device"):
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
    if pipeline in ("shm", "device") and int(train["num_batchers"]) > floor_slots:  # device degrades to shm
        # a child beyond the ring depth would never be dealt a slot
        raise ValueError(
            f"train_args.num_batchers={train['num_batchers']} exceeds the guaranteed shm "
            f"ring depth {floor_slots} (shm_slots={train['shm_slots']}): each batcher "
            "process needs at least one ring slot to hold; raise shm_slots or lower "
            "num_batchers"
        )
    if pipeline == "device":
        if train["device_replay"]:
            raise ValueError(
                "train_args.batch_pipeline: device is redundant under "
                "device_replay: true (that path never materializes host "
                "episodes, so there is nothing for the stage to upload)"
            )
        if int(train["device_stage_lanes"]) < 1:
            raise ValueError("train_args.device_stage_lanes must be >= 1")
        if int(train["device_stage_chunk"]) < 1:
            raise ValueError("train_args.device_stage_chunk must be >= 1")
        min_slots = train["burn_in_steps"] + train["forward_steps"]
        if int(train["device_stage_slots"]) <= min_slots:
            raise ValueError(
                "train_args.device_stage_slots must exceed burn_in_steps + "
                f"forward_steps = {min_slots}"
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
    if train["device_replay"]:
        if train["device_rollout_games"] <= 0:
            raise ValueError(
                "train_args.device_replay needs device_rollout_games > 0 "
                "(the lane count of the streaming rollout it feeds from)"
            )
        # the env, net and window-mode checks are DeviceReplay's, at the
        # learner's start, where the env and the net are known
        if train["device_replay_slots"] <= train["forward_steps"]:
            raise ValueError("train_args.device_replay_slots must exceed forward_steps")
        if train["device_replay_k_steps"] < 1:
            raise ValueError("train_args.device_replay_k_steps must be >= 1")
    if train["plane_stall_timeout"] <= 0:
        raise ValueError("train_args.plane_stall_timeout must be > 0")
    if train["plane_max_restarts"] < 0:
        raise ValueError("train_args.plane_max_restarts must be >= 0")
    if train["drain_deadline_seconds"] <= 0:
        raise ValueError("train_args.drain_deadline_seconds must be > 0")
    _validate_serving(train["serving"])
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


def _validate_serving(serving: Dict[str, Any]) -> None:
    if serving["shed_policy"] not in ("deadline", "queue", "none"):
        raise ValueError(
            f"train_args.serving.shed_policy={serving['shed_policy']!r} "
            "not one of ('deadline', 'queue', 'none')"
        )
    if int(serving["max_models"]) < 1:
        raise ValueError("train_args.serving.max_models must be >= 1")
    if float(serving["slo_ms"]) <= 0:
        raise ValueError("train_args.serving.slo_ms must be > 0")
    if int(serving["max_batch"]) < 1:
        raise ValueError("train_args.serving.max_batch must be >= 1")
    if float(serving["max_wait_ms"]) < 0:
        raise ValueError("train_args.serving.max_wait_ms must be >= 0")
    if int(serving["queue_bound"]) < 1:
        raise ValueError("train_args.serving.queue_bound must be >= 1")
    buckets = serving["warm_buckets"]
    if not isinstance(buckets, (list, tuple)) or not buckets:
        raise ValueError("train_args.serving.warm_buckets must be a non-empty list of bucket sizes")
    for b in buckets:
        if not isinstance(b, int) or b < 1 or (b & (b - 1)):
            raise ValueError(
                "train_args.serving.warm_buckets entries must be powers of two >= 1 "
                f"(the engine's batch shapes), got {b!r}"
            )
        if b > int(serving["max_batch"]):
            raise ValueError(
                f"train_args.serving.warm_buckets entry {b} exceeds serving.max_batch "
                f"{serving['max_batch']} — it would warm a shape the engine never runs"
            )
    for key in ("recv_timeout", "watch_interval", "stats_interval"):
        if float(serving[key]) < 0:
            raise ValueError(f"train_args.serving.{key} must be >= 0 (0 = off)")
    if not isinstance(serving["port"], int) or not 0 <= serving["port"] <= 65535:
        raise ValueError(f"train_args.serving.port={serving['port']!r} must be a TCP port (0 = a free one)")
    for key in ("session_capacity", "session_spill"):
        if int(serving[key]) < 0:
            raise ValueError(
                f"train_args.serving.{key} must be >= 0 (session_capacity 0 disables the "
                "session cache)"
            )
    if serving["weight_dtype"] not in ("float32", "int8"):
        raise ValueError(
            f"train_args.serving.weight_dtype={serving['weight_dtype']!r} "
            "not one of ('float32', 'int8')"
        )


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
